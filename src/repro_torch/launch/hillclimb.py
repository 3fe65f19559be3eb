"""Hill-climb levers on the dry run: each lever's before / after records.

Port of ``repro.launch.hillclimb``, on the port's dry run
(:mod:`repro_torch.launch.dryrun`) and H100 terms:

  1. gemma2-9b / prefill_32k — window-aware attention work (K1 skips the
     key tiles outside a local layer's window) against the causal pairs
     of the whole sequence: the compute term;
  2. deepseek-v3-671b / train_4k (16 microbatches) — grads reduce-scattered
     onto the parameter shards against all-reduced: the collective term;
  2b. the same cell with bf16 grad accumulation: grad bytes and their
     collectives;
  3. gemma2-9b / decode_32k — the sequence-sharded dense cache (8 kv heads
     do not divide the 16-way model axis: slots split, split-K decode over
     16 strips) against a replicated one: the memory term.

Each lever writes ``$REPRO_TORCH_DRYRUN_OUT/hillclimb/<name>.json``.

  python -m repro_torch.launch.hillclimb [--lever 1|2|3|4]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.analysis.roofline import out_dir
from repro_torch.launch import dryrun as dr


def record(name: str, rec: dict) -> dict:
    os.makedirs(out_dir("hillclimb"), exist_ok=True)
    with open(out_dir("hillclimb", f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if rec.get("ok"):
        c, m, q = rec["collectives"], rec["memory"], rec["cost"]
        state = m["param_bytes"] + m["opt_state_bytes"] + m["grad_bytes"]
        print(f"[{name}] flops={q['flops']:.4g} "
              f"bytes={q['bytes_accessed']:.4g} "
              f"coll={c['total_bytes']:.4g} "
              f"params+opt+grads={state / 2**30:.1f}Gi "
              f"cache={m['cache_bytes'] / 2**30:.2f}Gi", flush=True)
    return rec


def lever1_window_aware_prefill(arch="gemma2-9b") -> tuple:
    before = record("gemma2_prefill32k__before", dr.lower_cell(
        arch, "prefill_32k", window_aware=False))
    after = record("gemma2_prefill32k__after_window_aware", dr.lower_cell(
        arch, "prefill_32k", window_aware=True))
    return before, after


def lever2_grad_sharding(arch="deepseek-v3-671b") -> tuple:
    before = record("deepseek_train4k__before", dr.lower_cell(
        arch, "train_4k", microbatches=16, shard_grads=False))
    after = record("deepseek_train4k__after_shardgrads", dr.lower_cell(
        arch, "train_4k", microbatches=16, shard_grads=True))
    return before, after


def lever2b_bf16_grad_accum(arch="deepseek-v3-671b") -> tuple:
    before = record("deepseek_train4k__after_shardgrads", dr.lower_cell(
        arch, "train_4k", microbatches=16, shard_grads=True))
    after = record("deepseek_train4k__after_bf16accum", dr.lower_cell(
        arch, "train_4k", microbatches=16, shard_grads=True,
        grad_accum_dtype="bfloat16"))
    return before, after


def lever3_seq_sharded_cache(arch="gemma2-9b") -> tuple:
    before = record("gemma2_decode32k__before", dr.lower_cell(
        arch, "decode_32k", cache_seq_shard=False))
    after = record("gemma2_decode32k__after_seqshard", dr.lower_cell(
        arch, "decode_32k", cache_seq_shard=True, decode_splits=16))
    return before, after


LEVERS = {1: lever1_window_aware_prefill, 2: lever2_grad_sharding,
          4: lever2b_bf16_grad_accum, 3: lever3_seq_sharded_cache}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lever", type=int, default=0,
                    help="0 = all; 4 = lever 2b")
    args = ap.parse_args(argv)
    for n, lever in LEVERS.items():
        if args.lever in (0, n):
            lever()
    print("hillclimb measurements done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
