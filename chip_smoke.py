#!/usr/bin/env python3
"""Card check of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line (``"phase": ...``):

1. device  — ``nvidia-smi`` name and power limit (also printed raw on a
             line of its own), torch and CUDA versions;
2. build   — seconds to build the five kernel libraries from
             ``kernels/csrc``, and beside them K1's parent ``mma.sync``
             body at gemma's (256, 256) and DeepSeek's (192, 128)
             (``ParentK1``, from ``benchmarks/torch_k1_variants.py``)
             (nvcc, all in parallel) and the ptxas register / shared-memory
             report; every instantiation of the latent decode body (K4 and
             K2's E != F branch), of K1's plans (both bodies, fp32 and
             bf16, native and MACC exp) and of the parent body must be
             there without a spill;
3. kernels — every case of the prefill (K1, at the GQA head dims and at
             DeepSeek's MLA (E, F) = (192, 128) and (576, 512), at the
             smoke configs' (32, 32) and (48, 32) and gemma's (256, 256)
             with causal masks, history offsets, windows, softcap 50 and a
             ragged m_valid, and cases that stress its 3xTF32 split:
             scores in the hundreds, low mantissa bits that matter, P = M
             = 1024; every case at (256, 256) and (192, 128), LSE cases
             included, also runs the parent body and the plain version in
             float64, and fails if the kernel's float64 distance is above
             twice the parent's), dense split-K decode (K2), paged split-K decode (K3),
             paged MLA latent decode (K4) and K2's E != F branch, MLA decode
             on the dense latent cache (``latent_decode_partials``: 128
             rows at (r, rd) = (512, 64), 4 at (32, 16), kv_len 0, 1, on
             both sides of a chunk edge and M, one-chunk splits, softcap
             50, P = 3 verify, bf16, and cases of both latent kernels
             that stress their 3xTF32 split: scores in the hundreds, low
             mantissa bits, 384 rows at P = 3, 8-token pages that every
             chunk straddles, one split of 512 keys, each with its float64
             distance) kernels against its plain
             torch version on the same inputs, with its tolerance (K2 and
             K3 also at 64 query rows, 8-token pages, splits of exactly
             one chunk, kv_len on both sides of chunk edges, bf16 d64 at P
             = 3, head dims 32 and 256 with softcap, kv_len 0 and 1 and
             ring caches read at eff_len; K4 also at the smoke latent (32,
             16) with 4 heads; and given an operand one element off a
             16-byte boundary, or head dims they are not built for, which
             they must refuse; K3 and K4 also on pools of fp8 e4m3 and
             int8 codes with fp16 scales, against their plain versions and
             against themselves on the fp32 pools the codes decode to,
             which must give the same bits — ``k3_quant_vs_dequant``,
             ``k4_quant_vs_dequant`` — and on code pools they are not built
             for, which they must refuse); K3 against K2 on a permuted pool holding a
             dense cache's rows (``k3_vs_k2``, at head dims 128 and 256)
             and K4 on a permuted latent pool against K4 on the same rows
             in identity page order (``k4_perm_vs_identity``), and the
             dense latent kernel against K4 on a permuted pool holding its
             rows (``k2latent_vs_k4``), all equal
             bits on every row with kv_len >= 1; K2 on the slot strips of
             a sequence-sharded dense cache (``decode_partials@seq_strip``:
             granite's decode data at 2, 4 and 16 strips, a window, a P =
             13 chain and gemma2's d256 data at 16; each strip against its
             plain version, the strips' partials concatenated equal to the
             whole call's bit for bit, and 3 strips of a 4-split sweep
             refused) with one strip's timing row; then each kernel's time at
             the shapes the granite-3-8b, DeepSeek-V3 and gemma2-9b main
             paths give it and at a smoke serving shape (``ms``: CUDA
             events around 20 back-to-back wrapper calls; K2-K4 also
             ``device_ms``: the kernel's own duration from
             ``torch.profiler`` over 20 more calls, without the wrapper's
             host time, or CUDA events where three profiler sessions in a
             row record no launch, said on a ``device_ms_fallback`` line;
             K2 and K3 also ``host_ms``, the wrapper's host
             time per call), beside its plain version's, a library call's
             (``library_ms``: a yardstick the port never calls; for K1
             also SDPA under each fp32 backend and the one the default
             call ran; SDPA has no softcap, so at gemma2's shapes it runs
             the same masks without one) and the least time the card
             could take (``bound_ms``, over the keys the causal and window
             masks leave; K1, K4 and K2's latent branch against the tensor
             cores' 3xTF32 rate, with the FP32 units' beside it; K1 at
             gemma2's and ``mla_forward``'s shapes also the parent body's
             time on the same inputs, ``parent_mma_sync_ms``); K4 also
             at a long context (8 slots of 16384 tokens, its library call
             SDPA with the 128 heads on the query axis of the one latent
             kv head); and the verify shapes of the speculative paths: K2
             and K3 at granite's chain of P = 13 (52 rows a fiber), K4 and
             K2's latent branch at DeepSeek's P = 5 (640 rows), each also
             among the kernel cases (K3 and K4 on fp8 and int8 pools too);
             and K2 and K3 past 64 rows a fiber, at P = 17 and 32 (68 and
             128 rows): cases, timing rows, and the verify read against
             P single-token reads of the same queries (equal bits); and
             hymba-1.5b's shapes (G = 5, head dim 64, window 1024): K1
             cases and timing rows on a windowed and a global layer (with
             the kernel's device time), K2 and K3 on a global cache and a
             ring read at eff_len; and serve_async's shapes: K1 at a
             one-row 128-token quantum after 896 tokens, K3 at a decode
             step beside rows parked mid-prefill, and the quantum's rows
             against the same rows of one P = M = 1024 call (``quantum vs
             chunk``, at (128, 128) G 4 and (64, 64) G 5: the two calls'
             plans differ, the bits must not); every K1 timing row names
             the plan its calls ran (block rows, column blocks, blocks
             launched; ``autotune.prefill_plan``), and the GQA dims'
             rows in the kernels line name the wgmma body as their
             source; and the device-sharded
             pool's kernel branches: K1 (a granite chunk after 896 tokens)
             and K3 (granite's timing data at tp 2, 4 and 8, fp32 and fp8
             pools; gemma2's d256 ring at tp 2) on kv-head shards,
             concatenated against the whole call (exactly 0.0), the latent
             body's page strips at DeepSeek's decode step (16 splits, tp 2
             and 4, fp32 and fp8) on the rank-complete view (the dense
             latent kernel) and on the pool (K4), each strip against its
             plain version and float64, the strips combined against K4
             (``strips_vs_k4``, 0.0), and timing rows of one head shard and
             one strip.  The latent
             split-stress and strip cases pass two gates: kernel vs plain
             within the fp32 tolerance, and the kernel no farther from a
             float64 reference than the plain version plus
             ``F64_SLACK``;
3a. analysis — ``repro_torch.analysis.report.check(impl="cuda")``: the
             declared cascades' pass counts and footprints, and the
             structural probes of ``repro_torch.analysis.lint`` on the
             kernels at the main paths' widths (K1 at granite's prefill,
             K2 / K3 at granite's decode data, fp32 and fp8 pools behind a
             permuted table, K4 and K2's latent branch at DeepSeek's, the
             P = 13 and P = 5 verify chains): with q = 0 every live key
             counted exactly once and its position sums exact, a launch's
             shared memory the same at M and 2M; and the ``trace:*``
             probes, the pass count and live footprint read off the plain
             versions' torch calls (the reference's ``jnp:*`` probes),
             each listed with its passes;
3b. cascades_numeric — ``repro_torch.core``'s torch cascades (3-, 2-,
             1-pass, split-K decode) at granite's prefill shape against
             the float64 3-pass oracle, K1 beside them;
3c. autotune_measured — ``autotune.measure_best`` over the decode splits
             of K2 / K3 (granite) and K4 (DeepSeek): modeled and measured
             choice with their ms, the kernel at the measured choice
             against its plain version, the public op's verify read
             against single-token reads under it (equal bits), the disk
             cache (``build/autotune_measured.json``) read back after
             ``clear_table()``;
4. model   — granite-3-8b at full width cut to 4 layers, fp32: prefill 4
             mixed-length prompts and decode 8 greedy steps with
             ``attn_impl="cuda"`` and ``"torch"`` on the same weights;
             logits difference and token match rate;
5. serve   — ``repro_torch.launch.serve.main --cache-layout both --mesh
             tp=2`` on granite-3-8b at full width (fp32) cut to 10 of its
             40 layers (``SERVE_LAYERS``),
             the mesh two shards on cuda:0: greedy streams equal on the
             dense layout, the paged one and the paged pool sharded on the
             kv heads (``paged_sharded``), every request gets its tokens,
             logits stay finite, and in each leg's timed run K1 launched
             10 x prefill dispatches and K2 (dense) or K3 (paged) 10 x
             decode steps, on the sharded leg 2 x 10 x each; its per-device
             bytes x 2 equal to the totals and the shard tensors' bytes
             making up the pool; ``sharded_vs_paged_tok_per_s``;
6. serve_prefix — the launcher on the paged layout (20 granite layers)
             with a 256-token shared prefix against its prefix-cache-off
             leg: equal
             streams, tokens reused, the pool's invariants audited;
6'. serve_async — open-loop traffic through the launcher's ``--async`` on
             granite-3-8b at full width cut to 20 of its 40 layers
             (``GRANITE_CUT_LAYERS``, as serve_dp, serve_spec and
             serve_swap) (12 requests at 8 req/s, every
             2nd a 1024-token prompt prefilled in 128-token quanta
             between decode steps): every leg's streams (dense,
             paged_noprefix, paged, the synchronous open-loop engine)
             equal, K1 once per layer and prefill dispatch, K2 / K3 once
             per layer and decode step, at least one prefill dispatch per
             quantum on the interleaved legs; TTFT / ITL tails reported;
6''. serve_dp — ``--async --dp 2``: two paged replicas of the one model
             behind the prefix-affinity router on 16 prompts sharing 256
             tokens: the serve_async gates, dp streams equal to the
             synchronous engine's, arrivals routed by prefix, prefix
             tokens reused;
6a. model_spec — granite-3-8b at full width cut to 4 layers: ``verify_step``
             on a P = 13 chain (k = 12, 52 K2 / K3 rows) against 13
             sequential ``decode_step`` calls, dense and paged, ``attn_impl``
             "cuda" and "torch": argmax equal at every chain position,
             logits within 1e-4 of their scale; the attention read's own
             verify-vs-stepwise distance reported;
6b. serve_spec — speculative decoding on 20 layers: the launcher with
             ``--cache-layout both --speculate 12 --duplicates 8`` (8
             prompts of 128-512 tokens and their 8 resends, 64 new
             tokens): streams equal across ``dense``, ``paged`` and
             ``paged_nospec`` (else the first divergent position and the
             non-speculative logits' top-2 gap there, then a failure),
             drafts accepted, no draft page left, and in each speculative
             leg's timed run K2 (dense) / K3 (paged) launched at n_pos = 13
             20 x verify dispatches; accept rate, committed tokens a
             dispatch and the spec / non-spec tok/s reported;
6b'. serve_spec_rows — granite-3-8b at full width cut to 4 layers, the
             serve_spec trace with ``--speculate 16`` and ``31`` (P = 17
             and 32: 68 and 128 rows a fiber): the serve_spec checks, K2 /
             K3 launched at n_pos = P 4 x verify dispatches;
6c. model_quant — the model check on fp8 e4m3 and int8 paged pools (two
             prefill chunks, the second reading the dequantized history,
             8 decode steps through K3's quantized branch);
6d. serve_quant — the launcher on the serve cell's trace with
             ``--cache-layout paged --kv-dtype fp8_e4m3`` and then ``int8``:
             the quantized leg's peak resident KV against the fp32 leg's
             (at most 27 %), ``quant_quality`` reported, K3's quantized
             branch ``QUANT_LAYERS`` x decode steps;
6e. serve_swap — 20-layer granite-3-8b through ``ServeEngine`` on three
             waves (a 256-token shared prefix, unrelated prompts that evict
             it from a 320-page pool, the first wave again) with an 8 GiB
             host swap tier, against a pool that never evicts, unquantized
             and on fp8 pages: at least 16 demotions and promotions, prefix
             hits, equal streams, the host ms of both;
7. model_gemma2 — gemma2-9b at full width cut to 4 layers (two local with
             a 4096-token window, two global), fp32: prompts of 4600 and
             5000 tokens, one prefilled whole and one in 2048-token
             chunks, 8 decode steps past the window, dense and paged, with
             ``attn_impl`` "cuda" and "torch": equal tokens, logits within
             1e-4 of their scale, dense = paged; then the dense leg's 8
             decode steps from its prefilled caches with the parameters
             placed by the ``serve`` rules and the caches by
             ``cache_shardings`` on a (1, 16) mesh of cuda:0
             (``model_gemma2_seq_sharded``: 8 kv heads on a 16-way model
             axis, so every cache splits on its slots and K2 runs on each
             of 16 strips): tokens equal to the unsharded step's, logits
             within 1e-4 of their scale, K2 16 x 4 x 8 strip launches;
8. serve_gemma2 — the launcher (``--cache-layout both``) on all 42 layers
             at full width (fp32, ~37 GB): 4 prompts of 4200-6000 tokens,
             all past the window, 32 new tokens; the serve phase's checks,
             K1 launched 42 x prefill dispatches, K2 / K3 42 x decode
             steps;
9. launcher_defaults — ``python -m repro_torch.launch.serve`` as
             subprocesses from the repo root: with no flags (gemma2-9b-
             smoke on the card), granite-3-8b-smoke paged, gemma-7b-smoke, hymba-1.5b-smoke and
             xlstm-125m-smoke on both layouts and deepseek-v3-671b-smoke
             on the default dense layout: exit code 0, kernels launched
             (xlstm: none), ``outputs_match`` where it compares layouts;
             and pixtral-12b-smoke, which it must refuse (non-zero exit,
             the message that it serves token prompts only); and in the
             same pool the two examples that wrap the launchers:
             ``examples/torch_train_100m.py --steps 5`` (the 100M granite,
             K1 + LSE at (64, 64), G 5: exit 0, the last loss below the
             first, the card's name in its output, K1 launched 2 x 8
             layers x 5 steps) and ``examples/torch_serve_batched.py``
             (the default arch on both layouts: exit 0, ``outputs_match``,
             K1 and K2 / K3 launched on both layouts);
10. model_mla — DeepSeek-V3's first three layers (MLA + dense FFN) at full
             width, fp32, on the dense and the paged layout: two prefill
             chunks (the second at an offset, the absorbed form) and 8
             decode steps with ``attn_impl="cuda"`` and ``"torch"``; dense
             streams equal to paged;
11. serve_mla — the launcher (``--cache-layout both --mesh tp=2``)
             serving that tower: ``outputs_match`` over dense, paged and
             the pool sharded on the latent rank, and in each leg's timed
             run K1 3 x prefill dispatches and the leg's decode kernel
             (dense: K2's latent branch; paged: K4; sharded: the latent
             kernel on each shard's page strip, 2 x 3) x decode steps; the
             serve phase's sharding checks;
12. serve_mla_prefix — that tower with a 256-token shared prefix against
             its prefix-cache-off leg: equal streams, 3840 tokens reused;
13. serve_mla_impls — a short trace on that tower with ``attn_impl``
             "cuda" and "torch": equal greedy streams;
13a. serve_mla_quant — the tower with fp8 e4m3 latents: the launcher's
             ``paged_quant`` leg (K4's quantized branch 3 x decode steps,
             ``quant_quality``), then cuda vs torch streams on fp8 latents;
13b. serve_mla_spec — the serve_spec checks on the tower with
             ``--speculate 4``: K2's latent branch (dense) and K4 (paged)
             at n_pos = 5 (640 rows), 3 x verify dispatches;
13c. model_moe — the model_mla check on DeepSeek-V3 at full width cut to
             4 layers, the fourth its first MoE layer (256 experts of
             2048, top-8, one shared, sigmoid router; 60.4 GB fp32, every
             earlier model freed first), flip-aware: a real token whose
             expert picks differ cuda vs torch is a router flip, which
             fails at a margin (k-th minus (k+1)-th score) >= 1e-5 and
             otherwise takes its row out of the logits check;
13d. serve_moe — the launcher on that tower with the serve_mla trace
             (``--cache-layout both``): dense = paged streams, tok/s,
             TTFT, peak allocated bytes, K1 / K2's latent branch / K4
             launches;
14. model_mla_smoke — the model_mla check on the MLA smoke config with
             its MoE cut: K1 at (48, 32), K4 and K2's latent branch at
             (32, 16);
15. model_hybrid — hymba-1.5b at full width cut to 4 layers (global,
             two windowed of 1024, global; Mamba beside attention in each),
             fp32: prompts of 1300 and 1800 tokens, one prefilled whole
             and one in 512-token chunks, 8 decode steps, dense and paged,
             ``attn_impl`` "cuda" and "torch": equal tokens, logits within
             1e-4 of their scale, dense = paged; and the hoisted SSM
             prefill against the literal one (the reference's
             ``_prefill_ssm``, a step call a token) on the same rows,
             padding and a continuation chunk included, within 1e-5 of
             scale;
16. serve_hymba — the launcher (``--cache-layout both``) on hymba-1.5b
             at full width cut to 16 of its 32 layers (full attention at
             the first, middle and last): 16 requests of 512-1536
             tokens, 32 new; the serve phase's checks (K1 16 x prefill
             dispatches, K2 / K3 16 x decode steps), the SSM state bytes
             (16 x 8 slots x (3200·16 + 3·3200) x 4 B), tok/s and TTFT;
17. serve_xlstm — the launcher on xlstm-125m at full width cut to 3
             layers (mLSTM, sLSTM, mLSTM: both mixers), the same
             trace, both layouts: equal streams, no attention kernel
             launched, no resident KV, the SSM state bytes;
18. model_frontends — musicgen-large at full width cut to 4 layers
             (frames, layernorm, GeLU, MHA at d64) and pixtral-12b-smoke
             (patches): ``forward``, ``prefill`` and ``decode_step`` on
             seeded embeddings, cuda vs torch within 1e-4 of scale;
19. train — K1 with its log-sum-exp output (``kernel_case``s at (64, 64)
             fp32 and bf16, (128, 128), (192, 128), (256, 256) and (32,
             32), each with a window, a softcap and a ragged ``m_valid``,
             and bf16 (64, 64) at the training shape, B 4, 32/32 heads,
             P = M = 1024, causal:
             the LSE within 1e-4 of the plain version's and the output
             equal, bit for bit, to the output without an LSE) and the
             attention Function's (dq, dk, dv) on the card (K1's forward
             against the plain one, both against float64), run with the
             other kernel cases, and timing rows at the training shape:
             K1 + LSE and the recompute backward (against its bound and
             SDPA's fp32 backward); then stablelm-1.6b at full width and
             depth in fp32, batch 4 x 1024: the first step's loss, grad
             norm and every grad leaf with ``attn_impl`` "cuda" against
             "torch", then 4 train steps on that batch (the loss finite
             and falling, K1 2 x 24 a step: forward and remat), step
             seconds, tokens/s and peak memory (``train``); and 3 steps of
             ``launch/train.py``'s ``main`` at its default bf16, its first
             step's loss and grad norm against one ``--attn-impl torch``
             step from the same seed (``train_launcher``), and its
             defaults on a ``--mesh 2x2 --rules fsdp_tp`` of the card
             (``train_launcher_mesh``: K1 4 x 2 a layer and step);
19a. train_sharded — the train phase's run on a (data 2, model 2) mesh of
             cuda:0 under ``fsdp_tp``: the state held as its shards, K1 +
             LSE per data shard and kv-head shard (2 x 2 x 24 x 2 = 192 a
             step), losses within 2e-4 of the train phase's, the first
             grad norm within 1e-5, each position's parameter and
             optimizer bytes equal to its shard tensors', peak memory;
19b. train_elastic — stablelm-1.6b at full width cut to 2 layers: two
             steps on (2, 2), a checkpoint, two more; ``ElasticMeshManager``
             plans (1, 2), a fresh state restores the checkpoint onto it
             and its two steps' losses equal the uninterrupted ones
             within 2e-4;
19c. dryrun — ``repro_torch.launch.dryrun`` with the peaks read off the
             card: stablelm-1.6b at the train phase's shape (fp32, 1 x 1)
             beside its measured step (the compute term at most 1.05 of
             the step seconds), ``--list`` (32 cells) and gemma2-9b
             decode_32k on 16 x 16 and 2 x 16 x 16, nothing allocated;
20. the ``kernels`` line (launches on the main paths, K2 / K3 / K4 / K2's
   latent branch split by n_pos == 1 (decode steps) and n_pos > 1 (verify
   chains), K3 on head shards and the latent strips from the sharded
   legs, errors, times, bounds) and, last, ``{"ok": true, "device":
   {...}}``.

After the build, the kernel block and every phase from 3a on, a
``clocks`` line gives the phase's seconds and the card's SM and memory
clocks, power draw, temperature and active throttle reasons as
``nvidia-smi`` reads them right after it.

Any failed phase raises: the script then exits non-zero and prints no
result line.  It also exits non-zero when no CUDA card is visible or when
the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32
#: non-tensor FLOP/s (K2 and K3 multiply on the FP32 units) and TF32
#: tensor-core FLOP/s (K1 and the latent body of K4 and K2's E != F branch
#: run both products in 3xTF32: three TF32 products per fp32 product)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

#: tolerances: fp32 differs only in summation order; bf16 outputs may
#: differ by one rounding of the output (2 ulps at unit scale)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
#: K1's log-sum-exp output against its plain version's (absolute)
LSE_TOL = 1e-4

#: the head dims whose K1 body the wgmma body took from the mma.sync body
#: last: gemma's and DeepSeek's MLA prefill.  The parent's mma.sync body
#: at these dims is built beside the shipped libraries (``ParentK1``);
#: every K1 case here holds the kernel's float64 distance to at most
#: ``PARENT_F64_RATIO`` times the parent's on the same inputs, and each
#: timing row times the parent beside the kernel
PARENT_K1_DIMS = ((256, 256), (192, 128))
PARENT_F64_RATIO = 2.0


def load_benchmark(name: str):
    """``benchmarks/<name>.py`` of this checkout, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the decode kernels' data builders, shared with the decode variants bench
_data = load_benchmark("torch_decode_data")
_rand = _data.rand
paged_data = _data.paged_data
granite_paged_data = _data.granite_paged_data
gemma2_paged_data = _data.gemma2_paged_data
with_sentinels = _data.with_sentinels
_quantized = _data.quantized


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch, serve) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = serve.device_info(torch.device("cuda", 0))
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], **info)
    return info


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def _err(torch, out, ref, dtype_name):
    atol, rtol = TOL[dtype_name]
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    excess = (diff - (atol + rtol * r.abs())).max().item()
    return diff.max().item(), excess <= 0.0, atol, rtol


class ParentK1:
    """K1's parent body at ``PARENT_K1_DIMS``: the shipped source with
    those dims routed back to the mma.sync body on the tiles they had
    there (``benchmarks/torch_k1_variants.py``'s ``mma_sync_source``),
    its ``nvcc`` started beside the shipped libraries' and awaited by
    :meth:`finish`.  Called like ``fusemax_attention_torch`` at those
    dims; it counts no launch of the port's kernel."""

    def __init__(self):
        self.k1v = load_benchmark("torch_k1_variants")
        src = self.k1v.mma_sync_source(self.k1v.shipped_source(),
                                       PARENT_K1_DIMS, only=True)
        self.procs = self.k1v.start_build(
            {"k1_parent": src}, os.path.join(ROOT, "build", "k1_parent"))
        self.fn = None

    def finish(self) -> dict:
        """Wait for the build; its ptxas report, in the form
        ``_build.ptxas_report`` gives the shipped libraries'."""
        from repro_torch.kernels import _build

        lib = self.k1v.finish_build(self.procs)["k1_parent"]
        self.fn = self.k1v.prefill_fn(lib)
        with open(self.procs["k1_parent"][1]) as fh:
            return _build.parse_ptxas(fh.read())

    def __call__(self, torch, q, k, v, *, scale, causal=False, window=None,
                 softcap=None, q_offset=0, group=1, m_valid=None,
                 exp_impl="native", **_):
        bh, pg, e = q.shape
        f = v.shape[2]
        check((e, f) in PARENT_K1_DIMS, f"no parent body at ({e}, {f})")
        out = torch.empty((bh, pg, f), dtype=q.dtype, device=q.device)
        self.k1v.launch_plan(
            self.fn, self.k1v.mma_sync_plan(bh, pg, e, f), q, k, v, out,
            group=group, q_offset=q_offset, window=window or 0,
            softcap=softcap or 0.0, causal=causal, m_valid=m_valid,
            exp_maccs=exp_impl == "maccs", scale=scale)
        return out


def k1_cases(torch):
    """(name, b, hkv, group, p, m, e, f, dtype, kwargs) for the prefill
    kernel: the GQA head dims, then DeepSeek's MLA prefill (E, F) =
    (192, 128) with its 128 heads one per fiber, and its absorbed latent
    attention (576, 512) with every head in one fiber's group and a
    history offset."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 causal g4 d128", 2, 2, 4, 128, 128, 128, 128, f32,
         dict(causal=True)),
        ("bf16 causal g4 d128", 2, 2, 4, 128, 128, 128, 128, bf16,
         dict(causal=True)),
        ("fp32 causal q_offset=64 g4", 1, 2, 4, 100, 164, 128, 128, f32,
         dict(causal=True, q_offset=64)),
        ("fp32 m_valid=200 of 256 g1 d64", 2, 2, 1, 96, 256, 64, 64, f32,
         dict(m_valid=200)),
        ("fp32 window=48 causal g8 d64", 1, 2, 8, 96, 96, 64, 64, f32,
         dict(causal=True, window=48)),
        ("fp32 softcap=30 causal g4", 1, 2, 4, 128, 128, 128, 128, f32,
         dict(causal=True, softcap=30.0)),
        ("fp32 exp=maccs causal g4", 1, 2, 4, 128, 128, 128, 128, f32,
         dict(causal=True, exp_impl="maccs")),
        ("bf16 causal g1 d128 unaligned", 1, 4, 1, 200, 200, 128, 128, bf16,
         dict(causal=True)),
        ("bf16 window=100 causal g8 d64", 1, 1, 8, 150, 150, 64, 64, bf16,
         dict(causal=True, window=100)),
        ("fp32 mla_forward E192 F128 causal g1 unaligned", 2, 4, 1, 200,
         200, 192, 128, f32, dict(causal=True)),
        ("bf16 mla_forward E192 F128 causal g1", 1, 8, 1, 256, 256, 192, 128,
         bf16, dict(causal=True)),
        ("fp32 mla_forward E192 F128 exp=maccs", 1, 4, 1, 130, 130, 192, 128,
         f32, dict(causal=True, exp_impl="maccs")),
        ("fp32 absorbed E576 F512 g128 q_offset=96", 2, 1, 128, 40, 136, 576,
         512, f32, dict(causal=True, q_offset=96)),
        ("bf16 absorbed E576 F512 g128 q_offset=64", 1, 1, 128, 33, 97, 576,
         512, bf16, dict(causal=True, q_offset=64)),
        ("fp32 absorbed E576 F512 g100 q_offset=37 exp=maccs", 1, 1, 100, 21,
         58, 576, 512, f32, dict(causal=True, q_offset=37,
                                 exp_impl="maccs")),
        ("fp32 absorbed E576 F512 g128 no offset", 1, 1, 128, 24, 24, 576,
         512, f32, dict(causal=True)),
    ]


def k1_dims_cases(torch):
    """K1 at the head dims the smoke configs and gemma reach: (32, 32)
    (every GQA ``-smoke`` config), (48, 32) (the MLA smoke config's
    ``mla_forward``, one head a fiber, and its absorbed tail, the 4 heads
    in one group) and (256, 256) (gemma-7b, gemma2-9b), in fp32 and bf16:
    causal, causal with a history offset, a window of 100 (no multiple of
    the 64-key tile) below M, softcap 50 with and without that window, and
    a ragged ``m_valid``."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for e, f, (hkv, g), (hkv_b, g_b) in (
            (32, 32, (2, 2), (2, 2)), (48, 32, (1, 4), (4, 1)),
            (256, 256, (2, 2), (2, 2))):
        for dtype, (h, gg) in ((f32, (hkv, g)), (bf16, (hkv_b, g_b))):
            dn = "fp32" if dtype == f32 else "bf16"
            tag = f"{dn} E{e} F{f} g{gg}"
            out += [
                (f"{tag} causal", 2, h, gg, 150, 150, e, f, dtype,
                 dict(causal=True)),
                (f"{tag} causal q_offset=90", 1, h, gg, 70, 160, e, f, dtype,
                 dict(causal=True, q_offset=90)),
                (f"{tag} window=100 causal", 1, h, gg, 300, 300, e, f, dtype,
                 dict(causal=True, window=100)),
                (f"{tag} softcap=50 causal", 1, h, gg, 130, 130, e, f, dtype,
                 dict(causal=True, softcap=50.0)),
                (f"{tag} softcap=50 window=100 causal", 1, h, gg, 260, 260, e,
                 f, dtype, dict(causal=True, window=100, softcap=50.0)),
                (f"{tag} m_valid=200 of 256", 2, h, gg, 96, 256, e, f, dtype,
                 dict(m_valid=200)),
            ]
    return out


def k1_split_cases(torch):
    """K1 cases that stress the 3xTF32 split, each with how its inputs
    are made from unit normals: scores in the hundreds (q x 30), values
    whose bits below TF32's mantissa matter (x + x * 2^-12 on q, k and
    v), and one long causal sweep at each of the GQA and MLA head dims."""
    f32 = torch.float32
    return [
        ("fp32 q x30 (scores in the hundreds) causal g4 d128", 1, 2, 4, 128,
         128, 128, 128, f32, dict(causal=True), "q_x30"),
        ("fp32 q x30 absorbed E576 F512 g128 q_offset=40", 1, 1, 128, 24, 64,
         576, 512, f32, dict(causal=True, q_offset=40), "q_x30"),
        ("fp32 x + x*2^-12 causal g4 d128", 1, 2, 4, 128, 128, 128, 128, f32,
         dict(causal=True), "low_bits"),
        ("fp32 x + x*2^-12 mla_forward E192 F128 causal", 1, 4, 1, 200, 200,
         192, 128, f32, dict(causal=True), "low_bits"),
        ("fp32 P=M=1024 causal g4 d128", 1, 2, 4, 1024, 1024, 128, 128, f32,
         dict(causal=True), None),
        ("fp32 P=M=1024 mla_forward E192 F128 causal", 1, 4, 1, 1024, 1024,
         192, 128, f32, dict(causal=True), None),
        ("fp32 P=M=1024 absorbed E576 F512 g16 causal", 1, 1, 16, 1024, 1024,
         576, 512, f32, dict(causal=True), None),
    ]


def k1_wgmma_split_cases(torch):
    """:func:`k1_split_cases`' stresses at the dims the wgmma body took
    from the mma.sync body last (``PARENT_K1_DIMS``): scores in the
    hundreds and low mantissa bits at gemma's (256, 256), scores in the
    hundreds at DeepSeek's MLA prefill, and one long causal sweep at
    (256, 256)."""
    f32 = torch.float32
    return [
        ("fp32 q x30 (scores in the hundreds) causal g2 d256", 1, 2, 2, 160,
         160, 256, 256, f32, dict(causal=True), "q_x30"),
        ("fp32 x + x*2^-12 causal g2 d256", 1, 2, 2, 160, 160, 256, 256, f32,
         dict(causal=True), "low_bits"),
        ("fp32 q x30 (scores in the hundreds) mla_forward E192 F128 causal", 1,
         4, 1, 200, 200, 192, 128, f32, dict(causal=True), "q_x30"),
        ("fp32 P=M=1024 causal g2 d256", 1, 2, 2, 1024, 1024, 256, 256, f32,
         dict(causal=True), None),
    ]


def k1_quantum_vs_chunk_cases(torch, fm) -> list:
    """The rows of a 1024-token prompt's last 128-token quantum (P = 128
    after 896, M = 1024: serve_async's last quantum) against the same rows
    of one P = M = 1024 call on the same q, k and v, fp32, causal: at
    (128, 128) with G 4 (granite: 8 kv heads) and at (64, 64) with G 5
    (hymba: 5 kv heads).  The two calls run different plans (the quantum
    fills the card with smaller blocks and column blocks); a row's
    arithmetic is the plan's key tile's alone, so the bits must be equal
    (``max_abs_diff`` 0.0).  Its inputs come from a generator of its own,
    so that the cases after it draw the inputs they drew before it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    rows = []
    for e, hkv, g in ((128, 8, 4), (64, 5, 5)):
        p_all, p_q, off = 1024, 128, 896
        q = _rand(torch, gen, (hkv, p_all * g, e), torch.float32)
        k = _rand(torch, gen, (hkv, p_all, e), torch.float32)
        v = _rand(torch, gen, (hkv, p_all, e), torch.float32)
        kw = dict(scale=e ** -0.5, causal=True, group=g)
        whole = fm.fusemax_attention_cuda(q, k, v, **kw)
        plan_whole = fm.fusemax_attention_cuda.last_plan
        quantum = fm.fusemax_attention_cuda(
            q[:, off * g:].contiguous(), k, v, q_offset=off, **kw)
        plan_q = fm.fusemax_attention_cuda.last_plan
        torch.cuda.synchronize()
        diff = (quantum - whole[:, off * g:]).abs().max().item()
        rows.append(dict(
            kernel="fusemax_prefill", case=f"quantum vs chunk: P={p_q} after "
            f"{off} vs P=M={p_all}, fp32 E{e} F{e} G{g} Hkv{hkv}",
            e=e, f=e, max_abs_diff=diff,
            plans={n: dict(block_q=pl.block_q, f_split=pl.f_split,
                           blocks=pl.blocks)
                   for n, pl in (("quantum", plan_q), ("chunk", plan_whole))},
            ok=diff == 0.0))
    torch.cuda.empty_cache()
    return rows


def _prep(q, k, v, how):
    if how == "q_x30":
        return q * 30.0, k, v
    if how == "low_bits":
        return tuple(x + x * 2.0 ** -12 for x in (q, k, v))
    return q, k, v


def _causal_ref64(torch, q, k, v, scale, group, q_offset):
    """Causal softmax attention in float64 on the folded layout (every
    row sees at least one key)."""
    pg, m = q.shape[1], k.shape[1]
    s = torch.einsum("bre,bke->brk", q.double(), k.double()) * scale
    qpos = torch.arange(pg, device="cuda") // group + q_offset
    s = s.masked_fill(torch.arange(m, device="cuda")[None, :]
                      > qpos[:, None], float("-inf"))
    return torch.einsum("brk,bkf->brf", torch.softmax(s, -1), v.double())


def _vs_parent(torch, fm, parent, row, q, k, v, out, ref, args) -> dict:
    """A K1 case's fields against the parent body at ``PARENT_K1_DIMS``:
    the kernel's, the parent's and the plain version's distance to the
    plain version run in float64 on the same inputs (``vs_f64``), the
    parent against the plain version, and the case's ``ok`` also holding
    the kernel within ``PARENT_F64_RATIO`` times the parent's distance."""
    old = parent(torch, q, k, v, **args)
    r64 = fm.fusemax_attention_torch(q.double(), k.double(), v.double(),
                                     **args)
    if isinstance(r64, tuple):
        r64 = r64[0]
    torch.cuda.synchronize()
    d = {n: (x.double() - r64).abs().max().item()
         for n, x in (("kernel", out), ("parent_mma_sync", old),
                      ("plain", ref))}
    ok_f64 = d["kernel"] <= PARENT_F64_RATIO * d["parent_mma_sync"]
    return dict(vs_f64=d, ok_vs_f64=ok_f64, ok=row["ok"] and ok_f64,
                parent_max_abs_err=_err(torch, old, ref, row["dtype"])[0])


def run_k1_cases(torch, gen, fm, autotune, cases=None, split_cases=(),
                 parent: Optional[ParentK1] = None) -> list:
    """Every K1 case (``cases`` and ``split_cases``: these instead, in
    :func:`k1_cases`' and :func:`k1_split_cases`' forms) against its
    plain version; the split cases also report the kernel's and the
    plain version's distance to a float64 reference (``vs_f64``, not
    gated).  With ``parent``, every case at
    ``PARENT_K1_DIMS`` also runs the parent body and the plain version in
    float64 (the same function: masks, softcap, ``m_valid`` and exp) and
    passes only if the kernel's float64 distance is at most
    ``PARENT_F64_RATIO`` times the parent's (``ok_vs_f64``)."""
    rows = []
    if cases is None:
        cases = k1_cases(torch) + k1_dims_cases(torch)
        split_cases = k1_split_cases(torch)
    cases = [c + (None, False) for c in cases] + \
        [c + (True,) for c in split_cases]
    for name, b, hkv, g, p, m, e, f, dtype, kw, how, split in cases:
        tile = autotune.attention_params(p * g, m, e, f, impl="cuda")
        q, k, v = _prep(_rand(torch, gen, (b * hkv, p * g, e), dtype),
                        _rand(torch, gen, (b * hkv, m, e), dtype),
                        _rand(torch, gen, (b * hkv, m, f), dtype), how)
        args = dict(scale=e ** -0.5, group=g, block_q=tile.block_q,
                    block_k=tile.block_k, **kw)
        out = fm.fusemax_attention_cuda(q, k, v, **args)
        ref = fm.fusemax_attention_torch(q, k, v, **args)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        rows.append(dict(kernel="fusemax_prefill", case=name, dtype=dn,
                         e=e, f=f, tile=[tile.block_q, tile.block_k],
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
        if parent is not None and (e, f) in PARENT_K1_DIMS:
            rows[-1].update(_vs_parent(torch, fm, parent, rows[-1], q, k, v,
                                       out, ref, args))
        elif split:
            r64 = _causal_ref64(torch, q, k, v, e ** -0.5, g,
                                kw.get("q_offset", 0))
            rows[-1]["vs_f64"] = {
                "kernel": (out.double() - r64).abs().max().item(),
                "plain": (ref.double() - r64).abs().max().item()}
            del r64
    return rows


def k2_cases(torch, ck: int):
    """(name, b, hkv, group, P, M, d, dtype, kv_len, splits, block_k,
    kwargs) for the dense decode kernel; ``ck`` is its chunk (keys per
    ring stage), which the stress cases straddle."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 ragged kv_len incl 0,1 splits=4", 4, 8, 4, 1, 512, 128, f32,
         [0, 1, 300, 512], 4, 128, {}),
        ("bf16 ragged splits=4", 4, 8, 4, 1, 512, 128, bf16,
         [0, 1, 300, 512], 4, 128, {}),
        ("fp32 splits=1 g8 d64", 4, 2, 8, 1, 256, 64, f32,
         [7, 64, 0, 129], 1, 128, {}),
        ("fp32 splits=8 window=100", 4, 4, 4, 1, 1024, 128, f32,
         [1000, 50, 1024, 0], 8, 128, dict(window=100)),
        ("fp32 softcap=50 exp=maccs splits=4", 2, 8, 4, 1, 512, 128, f32,
         [511, 3], 4, 128, dict(softcap=50.0, exp_impl="maccs")),
        ("fp32 P=2 verify rows splits=4", 4, 8, 4, 2, 512, 128, f32,
         [0, 5, 250, 510], 4, 128, {}),
        ("bf16 P=2 verify rows g8 d64 splits=8", 2, 2, 8, 2, 1024, 64, bf16,
         [1, 1022], 8, 128, {}),
        # stress: the most rows (8 row blocks of 8), a split of exactly one
        # chunk, kv_len around chunk edges, bf16 d64 at P = 3
        ("fp32 R=64 (P=16 G=4) d128 splits=4", 3, 2, 4, 16, 512, 128, f32,
         [0, 200, 497], 4, 128, {}),
        (f"fp32 one-chunk splits (split_len {ck}) d64 splits=8", 2, 4, 4, 1,
         8 * ck, 64, f32, [8 * ck, 77], 8, ck, {}),
        ("fp32 kv_len around chunk edges d128 splits=2", 8, 2, 4, 1, 8 * ck,
         128, f32, [ck - 1, ck, ck + 1, 2 * ck - 1, 2 * ck, 2 * ck + 1,
                    4 * ck - 1, 4 * ck + 1], 2, 128, {}),
        ("bf16 d64 P=3 verify rows splits=4", 2, 2, 4, 3, 512, 64, bf16,
         [0, 300], 4, 128, {}),
        # the smoke configs' head dim 32 and gemma's 256 (G = 2): softcap,
        # kv_len 0 and 1, a ring cache (M = window) read at eff_len =
        # min(kv_len, window), verify rows past one row block
        ("fp32 d32 g2 softcap=50 kv_len 0,1 splits=4", 4, 2, 2, 1, 256, 32,
         f32, [0, 1, 200, 256], 4, 128, dict(softcap=50.0)),
        ("bf16 d32 g2 softcap=50 splits=2", 3, 2, 2, 1, 256, 32, bf16,
         [1, 64, 256], 2, 128, dict(softcap=50.0)),
        ("fp32 d32 ring of 64 at eff_len (kv_len past the window) splits=1",
         4, 2, 2, 1, 64, 32, f32, [64, 64, 37, 1], 1, 64,
         dict(softcap=50.0)),
        ("bf16 d32 R=64 (P=16 G=4) splits=4", 2, 2, 4, 16, 256, 32, bf16,
         [5, 200], 4, 128, {}),
        ("fp32 d256 g2 softcap=50 kv_len 0,1 splits=4", 4, 4, 2, 1, 512, 256,
         f32, [0, 1, 300, 512], 4, 128, dict(softcap=50.0)),
        ("bf16 d256 g2 softcap=50 splits=4", 2, 4, 2, 1, 512, 256, bf16,
         [511, 3], 4, 128, dict(softcap=50.0)),
        ("fp32 d256 ring of 256 at eff_len (kv_len past the window) "
         "splits=2", 3, 2, 2, 1, 256, 256, f32, [256, 256, 100], 2, 128,
         dict(softcap=50.0)),
        ("fp32 d256 R=16 (P=4 G=4) splits=4", 2, 2, 4, 4, 512, 256, f32,
         [0, 400], 4, 128, {}),
    ]


def k2_spec_cases(torch, ck: int):
    """:func:`k2_cases` rows at the speculative paths' verify shapes:
    granite's k = 12 drafts, P = 13 chain positions x G = 4 = 52 rows, its
    chains across chunk edges and up to the end of the cache.  They draw
    their inputs from a generator of their own (``main``), so every case
    above keeps its inputs."""
    return [
        ("fp32 P=13 G=4 d128 granite verify (52 rows) splits=4", 4, 2, 4,
         13, 512, 128, torch.float32, [1, ck - 5, 200, 500], 4, 128, {}),
    ]


def run_k2_cases(torch, gen, dec, autotune, cases=None) -> list:
    rows = []
    for (name, b, hkv, g, p, m, d, dtype, kvl, splits, bk,
         kw) in cases or k2_cases(torch, autotune.DECODE_CHUNK):
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k = _rand(torch, gen, (b * hkv, m, d), dtype)
        v = _rand(torch, gen, (b * hkv, m, d), dtype)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=g, **kw)
        out = dec.combine_partials(*dec.decode_partials_cuda(
            q, k, v, kv_len, **args), dtype)
        ref = dec.combine_partials(*dec.decode_partials_torch(
            q, k, v, kv_len, **args), dtype)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        if 0 in kvl and p == 1:
            # kv_len = 0 decodes to exactly 0 (no tile runs), as on the TPU
            zero = torch.tensor(kvl, device="cuda").repeat_interleave(hkv) == 0
            ok = ok and bool((out[zero] == 0).all().item())
        rows.append(dict(kernel="decode_partials", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def _misaligned(torch, t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary (storage offset 1)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def misaligned_cases(torch, gen, dec) -> list:
    """K2 and K3 given an operand one element off a 16-byte boundary must
    raise (they copy 16-byte vectors and have no scalar path)."""
    b, hkv, g, m, d, ps = 2, 2, 4, 64, 128, 16
    q = _rand(torch, gen, (b * hkv, g, d), torch.float32)
    k = _rand(torch, gen, (b * hkv, m, d), torch.float32)
    kp = _rand(torch, gen, (8, ps, hkv, d), torch.float32)
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(b, 4)
    kv_len = torch.tensor([40, 64], dtype=torch.int32, device="cuda")
    common = dict(scale=d ** -0.5, hkv=hkv, splits=1)
    calls = [
        ("decode_partials", "k", lambda: dec.decode_partials_cuda(
            q, _misaligned(torch, k), k, kv_len, block_k=64, **common)),
        ("decode_partials", "q", lambda: dec.decode_partials_cuda(
            _misaligned(torch, q), k, k, kv_len, block_k=64, **common)),
        ("paged_decode_partials", "v_pages",
         lambda: dec.paged_decode_partials_cuda(
             q, kp, _misaligned(torch, kp), table, kv_len, block_k=ps,
             **common)),
    ]
    # the dense latent kernel (K2's E != F branch), krope off by one float
    ql = _rand(torch, gen, (b, 128, MLA_R + MLA_RD), torch.float32)
    ckv = _rand(torch, gen, (b, m, MLA_R), torch.float32)
    kr = _rand(torch, gen, (b, m, MLA_RD), torch.float32)
    calls.append(("latent_decode_partials", "krope",
                  lambda: dec.latent_decode_partials_cuda(
                      ql, ckv, _misaligned(torch, kr), kv_len, scale=0.05,
                      splits=1, block_k=64)))
    rows = []
    for kernel, what, call in calls:
        try:
            call()
            raised = None
        except ValueError as e:
            raised = str(e)
        torch.cuda.synchronize()
        rows.append(dict(kernel=kernel,
                         case=f"misaligned {what} (storage offset 1 element) "
                              f"raises", raised=raised,
                         ok=raised is not None and "16-byte" in raised))
    return rows


def unbuilt_dims_cases(torch, gen, fm, dec) -> list:
    """Each kernel given CUDA tensors at head dims it is not built for must
    raise, never fall back to its plain version: K1 at (E, F) = (96, 96),
    K2 and K3 at D = 96, K4 at (r, rd) = (64, 16), K2's dense latent
    branch at (r, rd) = (48, 16)."""
    f32 = torch.float32
    q = _rand(torch, gen, (2, 64, 96), f32)
    kp = _rand(torch, gen, (4, 16, 2, 96), f32)
    ql = _rand(torch, gen, (1, 4, 80), f32)
    ckv = _rand(torch, gen, (4, 16, 64), f32)
    kr = _rand(torch, gen, (4, 16, 16), f32)
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(1, 4)
    kv_len = torch.tensor([40], dtype=torch.int32, device="cuda")
    dk = dict(scale=0.1, splits=1)
    calls = [
        ("fusemax_prefill", "(E, F) = (96, 96)",
         lambda: fm.fusemax_attention_cuda(q, q, q, scale=0.1, block_q=128,
                                           block_k=64)),
        ("decode_partials", "D = 96", lambda: dec.decode_partials_cuda(
            q[:, :4].contiguous(), q, q, kv_len, hkv=2, block_k=64, **dk)),
        ("paged_decode_partials", "D = 96",
         lambda: dec.paged_decode_partials_cuda(
             q[:, :4].contiguous(), kp, kp, table, kv_len, hkv=2,
             block_k=16, **dk)),
        ("mla_paged_decode_partials", "(r, rd) = (64, 16)",
         lambda: dec.mla_paged_decode_partials_cuda(
             ql, ckv, kr, table, kv_len, block_k=16, **dk)),
        ("latent_decode_partials", "(r, rd) = (48, 16)",
         lambda: dec.latent_decode_partials_cuda(
             ql[..., :64].contiguous(), ckv[:1, :, :48].contiguous(),
             kr[:1], kv_len, block_k=16, **dk)),
    ]
    rows = []
    for kernel, what, call in calls:
        try:
            call()
            raised = None
        except ValueError as e:
            raised = str(e)
        torch.cuda.synchronize()
        rows.append(dict(kernel=kernel,
                         case=f"unbuilt head dims {what} raise",
                         raised=raised,
                         ok=raised is not None and "built for" in raised))
    return rows


def _permuted_table(torch, gen, b, ps, w, n_pages, kvl, n_pos):
    """A block table of distinct random pages per row whose entries past
    the pages ``kv_len + n_pos - 1`` keys need hold the sentinel."""
    table = torch.full((b, w), n_pages, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda").to(
        torch.int32)
    used = 0
    for i, n in enumerate(kvl):
        need = -(-(n + n_pos - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return table


def _paged_inputs(torch, gen, b, hkv, ps, w, n_pages, d, dtype, kvl, n_pos):
    """Random pools and a :func:`_permuted_table`."""
    k = _rand(torch, gen, (n_pages, ps, hkv, d), dtype)
    v = _rand(torch, gen, (n_pages, ps, hkv, d), dtype)
    return k, v, _permuted_table(torch, gen, b, ps, w, n_pages, kvl, n_pos)


def k3_cases(torch, ck: int):
    """(name, b, hkv, group, P, page_size, W, pool pages, d, dtype, kv_len,
    splits, block_k, kwargs) for the paged decode kernel; ``ck`` is its
    chunk (keys per ring stage), which the stress cases straddle."""
    f32, bf16 = torch.float32, torch.bfloat16
    w_edge = 8 * ck // 16
    return [
        ("fp32 ps16 d128 kv_len 0,1,W*ps splits=4", 4, 8, 4, 1, 16, 32, 160,
         128, f32, [0, 1, 300, 512], 4, 16, {}),
        ("bf16 ps16 d128 splits=16", 4, 8, 4, 1, 16, 64, 300, 128, bf16,
         [1, 1024, 517, 0], 16, 16, {}),
        ("fp32 ps64 d64 g8 splits=1", 3, 2, 8, 1, 64, 4, 16, 64, f32,
         [7, 256, 0], 1, 64, {}),
        ("bf16 ps64 d64 block_k=32 splits=4", 2, 4, 2, 1, 64, 8, 24, 64, bf16,
         [512, 65], 4, 32, {}),
        ("fp32 P=2 verify ps16 splits=4", 4, 8, 4, 2, 16, 32, 160, 128, f32,
         [0, 5, 250, 510], 4, 16, {}),
        ("fp32 P=4 verify ps16 d64 g8 splits=16", 2, 2, 8, 4, 16, 64, 140, 64,
         f32, [1, 1020], 16, 16, {}),
        ("bf16 P=3 verify ps64 d128 splits=1", 2, 2, 4, 3, 64, 4, 12, 128,
         bf16, [0, 250], 1, 64, {}),
        ("fp32 softcap=50 exp=maccs ps16 splits=16", 2, 8, 4, 1, 16, 128,
         300, 128, f32, [2048, 3], 16, 16,
         dict(softcap=50.0, exp_impl="maccs")),
        # stress: the most rows, a chunk over several pages, a split of
        # exactly one chunk, kv_len around chunk edges, bf16 d64 at P = 3
        ("fp32 R=64 (P=16 G=4) ps16 d128 splits=4", 2, 2, 4, 16, 16, 32, 80,
         128, f32, [1, 400], 4, 16, {}),
        (f"fp32 ps8: a chunk of {ck} keys spans {ck // 8} pages, splits=2",
         3, 4, 4, 1, 8, 32, 110, 128, f32, [256, 100, 37], 2, 8, {}),
        (f"fp32 one-chunk splits (split_len {ck}) ps16 splits=8", 2, 4, 4, 1,
         16, 8 * ck // 16, 40, 128, f32, [8 * ck, 45], 8, 16, {}),
        ("fp32 kv_len around chunk edges ps16 splits=2", 8, 2, 4, 1, 16,
         w_edge, 8 * w_edge + 8, 128, f32,
         [ck - 1, ck, ck + 1, 2 * ck - 1, 2 * ck, 2 * ck + 1, 4 * ck - 1,
          4 * ck + 1], 2, 16, {}),
        ("bf16 d64 P=3 verify ps16 splits=4", 2, 2, 4, 3, 16, 32, 80, 64,
         bf16, [5, 400], 4, 16, {}),
        # head dims 32 and 256 (G = 2) on permuted pools: softcap, kv_len 0
        # and 1, a ring class (W·ps = window) read at eff_len, verify rows
        ("fp32 d32 ps16 softcap=50 kv_len 0,1 splits=4", 4, 2, 2, 1, 16, 16,
         80, 32, f32, [0, 1, 100, 256], 4, 16, dict(softcap=50.0)),
        ("bf16 d32 ps16 softcap=50 splits=2", 3, 2, 2, 1, 16, 8, 40, 32,
         bf16, [128, 17, 1], 2, 16, dict(softcap=50.0)),
        ("fp32 d32 ring W=4 (window 64) at eff_len splits=1", 4, 2, 2, 1, 16,
         4, 24, 32, f32, [64, 64, 20, 0], 1, 16, dict(softcap=50.0)),
        ("bf16 d32 R=64 (P=16 G=4) ps16 splits=4", 2, 2, 4, 16, 16, 16, 40,
         32, bf16, [5, 200], 4, 16, {}),
        ("fp32 d256 ps16 softcap=50 kv_len 0,1 splits=4", 4, 4, 2, 1, 16, 32,
         160, 256, f32, [0, 1, 300, 512], 4, 16, dict(softcap=50.0)),
        ("bf16 d256 ps16 softcap=50 splits=4", 2, 4, 2, 1, 16, 32, 80, 256,
         bf16, [511, 3], 4, 16, dict(softcap=50.0)),
        ("fp32 d256 ring W=16 (window 256) at eff_len splits=2", 3, 2, 2, 1,
         16, 16, 60, 256, f32, [256, 256, 100], 2, 16, dict(softcap=50.0)),
        ("fp32 d256 R=16 (P=4 G=4) ps16 splits=4", 2, 2, 4, 4, 16, 32, 80,
         256, f32, [0, 400], 4, 16, {}),
    ]


def k3_spec_cases(torch, ck: int):
    """:func:`k3_cases` rows at granite's verify shape (52 rows), chains
    across page and chunk edges; also run on fp8 and int8 pools (as
    :func:`k2_spec_cases`, from their own generator)."""
    return [
        ("fp32 P=13 G=4 ps16 d128 granite verify (52 rows) splits=4", 4, 2,
         4, 13, 16, 32, 110, 128, torch.float32, [1, 10, ck - 5, 500], 4,
         16, {}),
    ]


def k2_rows_cases(torch, ck: int):
    """:func:`k2_cases` rows past 64 query rows a fiber (fault F2 closed):
    granite's k = 16 and k = 31 chains, P = 17 and 32 x G = 4 = 68 and 128
    rows, 9 and 16 row blocks of 8, chains across chunk edges and up to
    the end of the cache.  They draw from a generator of their own
    (``main``), so every earlier case keeps its inputs."""
    f32 = torch.float32
    return [
        ("fp32 R=68 (P=17 G=4) d128 verify past 64 rows splits=4", 3, 2, 4,
         17, 512, 128, f32, [1, ck - 5, 480], 4, 128, {}),
        ("fp32 R=128 (P=32 G=4) d128 verify past 64 rows splits=4", 2, 2,
         4, 32, 512, 128, f32, [0, 470], 4, 128, {}),
    ]


def k3_rows_cases(torch, ck: int):
    """:func:`k3_cases` rows at 68 and 128 query rows a fiber (as
    :func:`k2_rows_cases`), chains across page and chunk edges."""
    f32 = torch.float32
    return [
        ("fp32 R=68 (P=17 G=4) ps16 d128 verify past 64 rows splits=4", 3,
         2, 4, 17, 16, 32, 110, 128, f32, [1, ck + 3, 470], 4, 16, {}),
        ("fp32 R=128 (P=32 G=4) ps16 d128 verify past 64 rows splits=4", 2,
         2, 4, 32, 16, 32, 80, 128, f32, [5, 460], 4, 16, {}),
    ]


def verify_vs_single(torch, gen, dec, p: int,
                     kvl=(1, 37, 200, 470)) -> list:
    """K2 and K3 reading a P-position verify chain (P x G = 4 rows a
    fiber) against P single-token reads of the same queries, position j
    at kv_len + j: the same splits (keyed on M) and block_k, so equal bits
    on every fiber with kv_len >= 1 (0.0) — the bit identity the accept
    rule of speculative decoding rests on, past 64 rows."""
    x = paged_data(torch, gen, len(kvl), 16, 4, 512, 128)
    b, hkv, g, m, d, ps = (x[k] for k in ("b", "hkv", "g", "m", "d", "ps"))
    kvl = list(kvl)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    table = with_sentinels(x["table"], [n + p - 1 for n in kvl], ps,
                           x["k_pages"].shape[0])
    q = _rand(torch, gen, (b * hkv, p * g, d), torch.float32)
    k_f, v_f = x["k"].reshape(b * hkv, m, d), x["v"].reshape(b * hkv, m, d)
    common = dict(scale=d ** -0.5, hkv=hkv, splits=4, rows_per_pos=g)

    def k2(qq, kl, n):
        return dec.combine_partials(*dec.decode_partials_cuda(
            qq, k_f, v_f, kl, block_k=128, n_pos=n, **common),
            torch.float32)

    def k3(qq, kl, n):
        return dec.combine_partials(*dec.paged_decode_partials_cuda(
            qq, x["k_pages"], x["v_pages"], table, kl, block_k=16, n_pos=n,
            **common), torch.float32)

    rows = []
    for kernel, read in (("decode_partials", k2),
                         ("paged_decode_partials", k3)):
        chain = read(q, kv_len, p)
        single = torch.cat([read(q[:, j * g:(j + 1) * g].contiguous(),
                                 kv_len + j, 1) for j in range(p)], dim=1)
        torch.cuda.synchronize()
        diff = (chain - single).abs().max().item()
        rows.append(dict(kernel=kernel, case=f"verify P={p} ({p * g} rows) "
                         f"vs {p} single-token reads", kv_len=kvl,
                         max_abs_diff_live=diff, ok=diff == 0.0))
    return rows


def run_k3_cases(torch, gen, dec, autotune, cases=None) -> list:
    rows = []
    for (name, b, hkv, g, p, ps, w, n_pages, d, dtype, kvl, splits, bk,
         kw) in cases or k3_cases(torch, autotune.DECODE_CHUNK):
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k, v, table = _paged_inputs(torch, gen, b, hkv, ps, w, n_pages, d,
                                    dtype, kvl, p)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=g, **kw)
        out = dec.combine_partials(*dec.paged_decode_partials_cuda(
            q, k, v, table, kv_len, **args), dtype)
        ref = dec.combine_partials(*dec.paged_decode_partials_torch(
            q, k, v, table, kv_len, **args), dtype)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        if 0 in kvl:
            # kv_len = 0 decodes to exactly 0 (no tile runs), as on the TPU
            zero = torch.tensor(kvl, device="cuda").repeat_interleave(hkv) == 0
            if p == 1:
                ok = ok and bool((out[zero] == 0).all().item())
        rows.append(dict(kernel="paged_decode_partials", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def k3_vs_k2(torch, gen, dec, autotune, x=None,
             kvl=(2048, 1500, 1024, 700, 300, 64, 1, 0),
             case="k3_vs_k2") -> dict:
    """K3 on the permuted pool against K2 on the dense cache at the tuned
    splits (granite: 16, K2's block_k 128, K3's 16): equal bits on every
    kv_len >= 1 row."""
    x = granite_paged_data(torch, gen) if x is None else x
    kvl = list(kvl)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n_pages = x["k_pages"].shape[0]
    table = with_sentinels(x["table"], kvl, x["ps"], n_pages)
    dense = autotune.decode_params(x["m"], max(x["g"], 8), x["d"], x["d"])
    paged = autotune.paged_decode_params(x["w"], x["ps"], max(x["g"], 8),
                                         x["d"], x["d"])
    check(dense.splits == paged.splits,
          f"dense {dense} and paged {paged} splits differ")
    b, hkv, g, m, d = x["b"], x["hkv"], x["g"], x["m"], x["d"]
    q_f = x["q"].reshape(b * hkv, g, d)
    common = dict(scale=d ** -0.5, hkv=hkv, splits=dense.splits)
    out2 = dec.combine_partials(*dec.decode_partials_cuda(
        q_f, x["k"].reshape(b * hkv, m, d), x["v"].reshape(b * hkv, m, d),
        kv_len, block_k=dense.block_k, **common), torch.float32)
    out3 = dec.combine_partials(*dec.paged_decode_partials_cuda(
        q_f, x["k_pages"], x["v_pages"], table, kv_len,
        block_k=paged.block_k, **common), torch.float32)
    torch.cuda.synchronize()
    live = torch.tensor(kvl, device="cuda").repeat_interleave(hkv) >= 1
    diff = (out3 - out2).abs()
    row = dict(kernel="paged_decode_partials", case=case, d=d,
               kv_len=kvl, splits=dense.splits, block_k_k2=dense.block_k,
               block_k_k3=paged.block_k,
               max_abs_diff_live=diff[live].max().item(),
               max_abs_diff_all=diff.max().item())
    row["ok"] = row["max_abs_diff_live"] == 0.0
    return row


def time_k3(torch, gen, dec, ops, autotune, x=None,
            kvl=(2048, 1500, 1024, 700, 300, 64, 1, 1900), p=1) -> dict:
    """K3 at a decode step (by default granite-3-8b's: the data of
    :func:`k3_vs_k2`, mixed kv_len, 16 splits); beside it K2 on the same
    rows in the dense layout, and as the library yardstick
    ``gather_pages`` + SDPA on the gathered view.  ``p`` > 1: a
    speculative verify of P chain positions (as :func:`time_k2`), each
    table backing its slot's chain."""
    import torch.nn.functional as F

    x = granite_paged_data(torch, gen) if x is None else x
    kvl = list(kvl)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n_pages = x["k_pages"].shape[0]
    b, hq, hkv, g, m, d, ps, w = (x[k] for k in
                                  ("b", "hq", "hkv", "g", "m", "d", "ps", "w"))
    table = with_sentinels(x["table"], [min(n + p - 1, m) for n in kvl],
                           ps, n_pages)
    tuned = autotune.paged_decode_params(w, ps, max(g, 8), d, d)
    dense = autotune.decode_params(m, max(g, 8), d, d)
    q4 = x["q"] if p == 1 else _rand(torch, gen, (b, hq, p, d),
                                     torch.float32)
    q_f = ops._fold_decode_q(q4, b, hkv, g, d).contiguous()
    vbk = dict(p=p, g=max(g, 8), e=d, f=d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=autotune.verify_block_k(tuned.block_k, **vbk),
                n_pos=p, rows_per_pos=g)
    kp, vp = x["k_pages"], x["v_pages"]
    out = dec.combine_partials(*dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.paged_decode_partials_torch(
        q_f, kp, vp, table, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args))
    dev_ms = device_ms(torch, lambda: dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args), "PagedKV")
    wrapper_ms = host_ms(torch, lambda: dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args))
    plain_ms = time_ms(torch, lambda: dec.paged_decode_partials_torch(
        q_f, kp, vp, table, kv_len, **args), iters=5, warmup=1)
    k_f, v_f = x["k"].reshape(b * hkv, m, d), x["v"].reshape(b * hkv, m, d)

    def k2():
        return dec.decode_partials_cuda(
            q_f, k_f, v_f, kv_len, scale=d ** -0.5, hkv=hkv,
            splits=dense.splits,
            block_k=autotune.verify_block_k(dense.block_k, **vbk), n_pos=p,
            rows_per_pos=g)

    k2_ms = time_ms(torch, k2)
    k2_dev_ms = device_ms(torch, k2, "DenseKV")
    mask = _verify_mask(torch, kv_len, p, m)

    def library():
        kg = ops.gather_pages(kp, table).transpose(1, 2)
        vg = ops.gather_pages(vp, table).transpose(1, 2)
        try:
            return F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, enable_gqa=True)
        except TypeError:
            rep = hq // hkv
            return F.scaled_dot_product_attention(
                q4, kg.repeat_interleave(rep, dim=1),
                vg.repeat_interleave(rep, dim=1), attn_mask=mask)

    library_ms = time_ms(torch, library)
    reads, pairs = _verify_keys(kvl, p, m)
    # each valid key is read once (K and V rows of every kv head), the
    # table and queries once, the fp32 partials written once
    nbytes = (4 * 2 * reads * hkv * d + 4 * table.numel() + 4 * q_f.numel()
              + 4 * b + 4 * b * hkv * tuned.splits * p * g * (d + 2))
    flops = 4 * d * pairs * hq
    row = _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                      shape=f"B{b} Hq{hq} Hkv{hkv} page_size {ps} W {w} pool "
                            f"{n_pages} pages d{d} fp32 kv_len {kvl} splits "
                            f"{tuned.splits} block_k {args['block_k']}"
                            + (f" P={p} ({p * g} rows)" if p > 1 else ""))
    row["k2_ms_same_data"] = k2_ms
    row["plan"] = decode_plan(autotune, p * g, tuned.splits, b * hkv)
    row["device_ms"] = dev_ms
    row["host_ms"] = wrapper_ms
    row["device_share_of_bound"] = row["bound_ms"] / dev_ms
    row["k2_device_ms_same_data"] = k2_dev_ms
    row["k3_over_k2_device"] = dev_ms / k2_dev_ms
    return row


#: DeepSeek-V3's latent: kv_lora_rank and rope_dim
MLA_R, MLA_RD = 512, 64


def _latent_inputs(torch, gen, b, h, p, ps, w, n_pages, dtype, kvl,
                   r=MLA_R, rd=MLA_RD):
    """Folded absorbed queries [b, p*h, r + rd], random latent pools and a
    :func:`_permuted_table`."""
    q = _rand(torch, gen, (b, p * h, r + rd), dtype)
    ckv = _rand(torch, gen, (n_pages, ps, r), dtype)
    kr = _rand(torch, gen, (n_pages, ps, rd), dtype)
    return q, ckv, kr, _permuted_table(torch, gen, b, ps, w, n_pages, kvl, p)


def k4_cases(torch):
    """(name, b, heads, P, page_size, W, pool pages, dtype, kv_len, splits,
    block_k, kwargs[, (r, rd)]) for the paged MLA latent decode kernel at
    DeepSeek's latent (r 512, rd 64) and its smoke config's (r 32, rd 16:
    4 heads, so 4 real rows of a 32-row head block, and 6 score k-steps
    for the 8 warps)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 G128 ps16 kv_len 0,1,aligned,unaligned splits=4", 4, 128, 1,
         16, 32, 160, f32, [0, 1, 256, 333], 4, 16, {}),
        ("bf16 G128 ps16 splits=16", 4, 128, 1, 16, 64, 300, bf16,
         [1, 1024, 517, 0], 16, 16, {}),
        ("fp32 G100 (not a multiple of the 32-row head block) splits=8", 3,
         100, 1, 16, 16, 60, f32, [7, 256, 100], 8, 16, {}),
        ("fp32 G128 P=2 verify splits=4", 3, 128, 2, 16, 32, 120, f32,
         [0, 5, 510], 4, 16, {}),
        ("bf16 G128 P=2 verify splits=2", 2, 128, 2, 16, 16, 40, bf16,
         [1, 254], 2, 16, {}),
        ("fp32 G128 softcap=50 exp=maccs splits=16", 2, 128, 1, 16, 128,
         300, f32, [2048, 3], 16, 16, dict(softcap=50.0, exp_impl="maccs")),
        ("fp32 G20 block_k=8 (sub-page tiles) splits=1", 2, 20, 1, 16, 8, 20,
         f32, [100, 37], 1, 8, {}),
        ("fp32 G128 ps64 block_k=32 splits=2", 2, 128, 1, 64, 8, 20, f32,
         [400, 65], 2, 32, {}),
        ("fp32 r32 rd16 G4 (R=4) kv_len 0,1 splits=4", 4, 4, 1, 16, 16, 80,
         f32, [0, 1, 100, 256], 4, 16, {}, (32, 16)),
        ("bf16 r32 rd16 G4 (R=4) softcap=50 splits=2", 3, 4, 1, 16, 8, 40,
         bf16, [128, 17, 1], 2, 16, dict(softcap=50.0), (32, 16)),
        ("fp32 r32 rd16 G4 P=2 verify splits=4", 2, 4, 2, 16, 16, 40, f32,
         [5, 200], 4, 16, {}, (32, 16)),
    ]


def k4_spec_cases(torch):
    """:func:`k4_cases` rows at DeepSeek's verify shape: k = 4 drafts, P = 5
    x 128 heads = 640 rows, chains that end on, cross and start at page
    (and 16-key chunk) edges; also run on fp8 and int8 pools (as
    :func:`k2_spec_cases`, from their own generator)."""
    return [
        ("fp32 G128 P=5 verify (640 rows) around page edges splits=4", 6,
         128, 5, 16, 32, 120, torch.float32, [1, 12, 15, 16, 17, 300], 4,
         16, {}),
    ]


def run_k4_cases(torch, gen, dec, cases=None) -> list:
    rows = []
    for (name, b, h, p, ps, w, n_pages, dtype, kvl, splits, bk, kw,
         *dims) in cases or k4_cases(torch):
        r, rd = dims[0] if dims else (MLA_R, MLA_RD)
        q, ckv, kr, table = _latent_inputs(torch, gen, b, h, p, ps, w,
                                           n_pages, dtype, kvl, r, rd)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=(r + rd) ** -0.5, splits=splits,
                    block_k=bk, n_pos=p, rows_per_pos=h, **kw)
        out = dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
            q, ckv, kr, table, kv_len, **args), dtype)
        ref = dec.combine_partials(*dec.mla_paged_decode_partials_torch(
            q, ckv, kr, table, kv_len, **args), dtype)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        if 0 in kvl and p == 1:
            # kv_len = 0 decodes to exactly 0 (no tile runs), as on the TPU
            zero = torch.tensor(kvl, device="cuda") == 0
            ok = ok and bool((out[zero] == 0).all().item())
        rows.append(dict(kernel="mla_paged_decode_partials", case=name,
                         dtype=dn, max_abs_err=err, atol=atol, rtol=rtol,
                         ok=ok))
    return rows


def deepseek_decode_data(torch, gen, kvl, b=8, h=128, w=128, r=MLA_R,
                         rd=MLA_RD):
    """A DeepSeek-V3 decode step's latent data (fp32): by default 8 slots,
    128 heads, r 512, rd 64, page_size 16, W 128 (a 2048-token table),
    absorbed queries, and the same latent rows in a pool of b * W pages
    once in identity page order and once permuted, table entries past each
    slot's kv_len holding the sentinel."""
    ps = 16
    n_pages = b * w
    q = _rand(torch, gen, (b, h, r + rd), torch.float32)
    ckv = _rand(torch, gen, (n_pages, ps, r), torch.float32)
    kr = _rand(torch, gen, (n_pages, ps, rd), torch.float32)
    ident = torch.arange(n_pages, device="cuda", dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    ckv_p, kr_p = torch.empty_like(ckv), torch.empty_like(kr)
    ckv_p[perm] = ckv
    kr_p[perm] = kr
    tables = {"identity": with_sentinels(ident.reshape(b, w), kvl, ps,
                                         n_pages),
              "permuted": with_sentinels(
                  perm.to(torch.int32).reshape(b, w).contiguous(), kvl, ps,
                  n_pages)}
    return dict(b=b, h=h, ps=ps, w=w, n_pages=n_pages, q=q, r=r, rd=rd,
                pools={"identity": (ckv, kr), "permuted": (ckv_p, kr_p)},
                tables=tables,
                kv_len=torch.tensor(kvl, dtype=torch.int32, device="cuda"))


def k4_perm_vs_identity(torch, gen, dec, autotune) -> dict:
    """K4 on the permuted pool against K4 on the same rows in identity page
    order, at the tuned geometry: equal bits on every kv_len >= 1 row."""
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 0]
    x = deepseek_decode_data(torch, gen, kvl)
    tuned = autotune.mla_paged_decode_params(x["w"], x["ps"], x["h"], MLA_R,
                                             MLA_RD)
    args = dict(scale=(MLA_R + MLA_RD) ** -0.5, splits=tuned.splits,
                block_k=tuned.block_k)
    outs = {k: dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
        x["q"], *x["pools"][k], x["tables"][k], x["kv_len"], **args),
        torch.float32) for k in ("identity", "permuted")}
    torch.cuda.synchronize()
    live = x["kv_len"] >= 1
    diff = (outs["permuted"] - outs["identity"]).abs()
    row = dict(kernel="mla_paged_decode_partials",
               case="k4_perm_vs_identity", kv_len=kvl, splits=tuned.splits,
               block_k=tuned.block_k,
               max_abs_diff_live=diff[live].max().item(),
               max_abs_diff_all=diff.max().item())
    row["ok"] = row["max_abs_diff_live"] == 0.0
    return row


def _latent_library(torch, ops, q, ckv, kr, kv_len, p: int, h: int,
                    scale: float, table=None, fold_heads: bool = False):
    """The library yardstick of a latent kernel: one SDPA call on the
    latents (gathered through ``table`` on the paged pool, the dense cache
    as it is) with [ckv | krope] built in the call.  ``q`` is the folded
    ``[B, P·H, r + rd]``.  MLA's absorbed attention has ONE kv head:
    ``fold_heads`` passes the P·H query rows along the query axis of that
    one head (q ``[B, 1, P·H, r + rd]``, a per-row mask), so nothing is
    expanded; otherwise the heads go to the head axis against
    ``enable_gqa``."""
    import torch.nn.functional as F

    b, rows, e = q.shape
    r = ckv.shape[-1]
    m = (table.shape[1] * ckv.shape[1]) if table is not None \
        else ckv.shape[1]
    if fold_heads:
        qs, mask = q[:, None], _verify_mask(torch, kv_len, p, m, h)
    else:
        qs = q.reshape(b, p, h, e).transpose(1, 2)        # [B, H, P, e]
        mask = _verify_mask(torch, kv_len, p, m)

    def library():
        cg = ckv if table is None else ops.gather_pages(ckv, table)
        kg = torch.cat([cg, kr if table is None
                        else ops.gather_pages(kr, table)], dim=-1)
        if fold_heads:
            return F.scaled_dot_product_attention(
                qs, kg[:, None], cg[:, None], attn_mask=mask, scale=scale)
        try:
            return F.scaled_dot_product_attention(
                qs, kg[:, None], cg[:, None], attn_mask=mask, scale=scale,
                enable_gqa=True)
        except TypeError:
            return F.scaled_dot_product_attention(
                qs, kg[:, None].expand(b, h, m, e),
                cg[:, None].expand(b, h, m, r), attn_mask=mask, scale=scale)

    return library


def time_k4(torch, gen, dec, ops, autotune,
            kvl=(2048, 1500, 1024, 700, 300, 64, 1, 1900), fold_heads=False,
            p=1, **dims) -> dict:
    """K4 at a decode step (by default DeepSeek-V3's: the data of
    :func:`k4_perm_vs_identity` with the K2/K3 timing kv_len list; ``dims``
    as :func:`deepseek_decode_data` takes them), the permuted pool, the
    tuned geometry; beside it K4 at 4 splits on the same data (a fifth of
    the partials' bytes at DeepSeek's shape), and as the library yardstick
    ``gather_pages`` + SDPA on the gathered view (:func:`_latent_library`;
    ``fold_heads`` at the long-context shape).  ``p`` > 1: a speculative
    verify of P chain positions, P·H rows, each table backing its slot's
    chain.  The bound is the tensor cores' 3xTF32 rate, with the FP32
    units' beside it."""
    kvl = list(kvl)
    w_ = dims.get("w", 128)
    x = deepseek_decode_data(torch, gen, [min(n + p - 1, 16 * w_)
                                          for n in kvl], b=len(kvl), **dims)
    b, h, ps, w = x["b"], x["h"], x["ps"], x["w"]
    r, rd = x["r"], x["rd"]
    ckv, kr = x["pools"]["permuted"]
    table = x["tables"]["permuted"]
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    q = x["q"] if p == 1 else _rand(torch, gen, (b, p * h, r + rd),
                                    torch.float32)
    tuned = autotune.mla_paged_decode_params(w, ps, h, r, rd)
    scale = (r + rd) ** -0.5
    args = dict(scale=scale, splits=tuned.splits,
                block_k=autotune.verify_block_k(tuned.block_k, p=p,
                                                g=max(h, 8), e=r + rd, f=r),
                n_pos=p, rows_per_pos=h)
    splits4 = min(4, w)
    out = dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
        q, ckv, kr, table, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.mla_paged_decode_partials_torch(
        q, ckv, kr, table, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.mla_paged_decode_partials_cuda(
        q, ckv, kr, table, kv_len, **args))
    dev_ms = device_ms(torch, lambda: dec.mla_paged_decode_partials_cuda(
        q, ckv, kr, table, kv_len, **args), "mla_paged_decode_partials_kernel")
    plain_ms = time_ms(torch, lambda: dec.mla_paged_decode_partials_torch(
        q, ckv, kr, table, kv_len, **args), iters=5, warmup=1)
    ms_splits4 = time_ms(torch, lambda: dec.mla_paged_decode_partials_cuda(
        q, ckv, kr, table, kv_len, **dict(args, splits=splits4)))
    library = _latent_library(torch, ops, q, ckv, kr, kv_len, p, h, scale,
                              table=table, fold_heads=fold_heads)
    library_ms = time_ms(torch, library)
    reads, pairs = _verify_keys(kvl, p, w * ps)
    # each valid latent row (ckv and krope) is read once, the queries, the
    # table and kv_len once, the fp32 partials written once
    nbytes = (4 * reads * (r + rd) + 4 * q.numel()
              + 4 * table.numel() + 4 * b
              + 4 * b * tuned.splits * p * h * (r + 2))
    # per valid (key, query row): r + rd multiply-adds for the score, r
    # for the value, both on the tensor cores
    flops = 2 * h * pairs * (2 * r + rd)
    kv_desc = (f"{len(kvl)} x {kvl[0]}" if len(set(kvl)) == 1 else kvl)
    row = _timing_row(ms, plain_ms, library_ms, 0, nbytes, err, ok,
                      shape=f"B{b} H{h} r{r} rd{rd} page_size {ps} "
                            f"W {w} pool {x['n_pages']} pages fp32 kv_len "
                            f"{kv_desc} splits {tuned.splits} block_k "
                            f"{args['block_k']}"
                            + (f" P={p} ({p * h} rows)" if p > 1 else ""),
                      tf32x3_flops=flops)
    row["ms_splits4_same_data"] = ms_splits4
    row["device_ms"] = dev_ms
    row["device_share_of_bound"] = row["bound_ms"] / dev_ms
    row["partials_bytes"] = 4 * b * tuned.splits * p * h * (r + 2)
    row["latent_bytes"] = 4 * reads * (r + rd)
    if fold_heads:
        row["library"] = "SDPA, the P·H query rows on the one latent kv head"
    return row


# ---------------------------------------------------------------------------
# K2's E != F branch: MLA decode on the dense latent cache
# ---------------------------------------------------------------------------

def latent_cases(torch):
    """(name, b, heads, P, M, dtype, kv_len, splits, block_k, kwargs[,
    (r, rd)]) for the dense latent kernel at DeepSeek's latent (r 512, rd
    64: 128 heads, 128 query rows a step, P = 3 verify 384) and its smoke
    config's (r 32, rd 16: 4 heads, 4 and 12 rows): kv_len 0, 1, on both
    sides of a 16-key chunk edge and M; splits of exactly one chunk;
    softcap 50; bf16 queries and latents."""
    f32, bf16 = torch.float32, torch.bfloat16
    edges = [0, 1, 15, 16, 17]
    return [
        ("fp32 G128 kv_len 0,1,15,16,17,M M256 splits=4", 6, 128, 1, 256,
         f32, edges + [256], 4, 64, {}),
        ("fp32 G128 one-chunk splits (split_len 16) splits=8", 3, 128, 1,
         128, f32, [128, 40, 9], 8, 16, {}),
        ("fp32 G128 softcap=50 exp=maccs M2048 tuned splits=16", 2, 128, 1,
         2048, f32, [2048, 3], 16, 128, dict(softcap=50.0,
                                              exp_impl="maccs")),
        ("fp32 G128 P=3 verify (384 rows) splits=4", 3, 128, 3, 256, f32,
         [0, 5, 250], 4, 64, {}),
        ("bf16 G128 kv_len 1,M,unaligned,0 splits=8", 4, 128, 1, 512, bf16,
         [1, 512, 300, 0], 8, 64, {}),
        ("bf16 G128 P=3 verify splits=2", 2, 128, 3, 128, bf16, [17, 100],
         2, 64, {}),
        ("fp32 G100 (not a multiple of the 32-row head block) splits=2", 3,
         100, 1, 128, f32, [7, 128, 100], 2, 64, {}),
        ("fp32 r32 rd16 G4 (R=4) kv_len 0,1,15,16,17,M splits=4", 6, 4, 1,
         64, f32, edges + [64], 4, 16, {}, (32, 16)),
        ("fp32 r32 rd16 G4 one-chunk splits softcap=50 splits=8", 2, 4, 1,
         128, f32, [128, 33], 8, 16, dict(softcap=50.0), (32, 16)),
        ("fp32 r32 rd16 G4 P=3 verify (12 rows) splits=4", 3, 4, 3, 64, f32,
         [0, 16, 60], 4, 16, {}, (32, 16)),
        ("bf16 r32 rd16 G4 softcap=50 splits=2", 3, 4, 1, 256, bf16,
         [256, 17, 1], 2, 64, dict(softcap=50.0), (32, 16)),
    ]


def latent_spec_cases(torch):
    """:func:`latent_cases` rows at DeepSeek's verify shape on the dense
    cache: P = 5, 640 rows, chains around 16-key chunk edges and up to M
    (as :func:`k2_spec_cases`, from their own generator)."""
    return [
        ("fp32 G128 P=5 verify (640 rows) around chunk edges splits=4", 6,
         128, 5, 256, torch.float32, [1, 12, 15, 16, 17, 252], 4, 64, {}),
    ]


def run_latent_cases(torch, gen, dec, cases=None) -> list:
    rows = []
    for (name, b, h, p, m, dtype, kvl, splits, bk, kw,
         *dims) in cases or latent_cases(torch):
        r, rd = dims[0] if dims else (MLA_R, MLA_RD)
        q = _rand(torch, gen, (b, p * h, r + rd), dtype)
        ckv = _rand(torch, gen, (b, m, r), dtype)
        kr = _rand(torch, gen, (b, m, rd), dtype)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=(r + rd) ** -0.5, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=h, **kw)
        out = dec.combine_partials(*dec.latent_decode_partials_cuda(
            q, ckv, kr, kv_len, **args), dtype)
        ref = dec.combine_partials(*dec.latent_decode_partials_torch(
            q, ckv, kr, kv_len, **args), dtype)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        if 0 in kvl and p == 1:
            # kv_len = 0 decodes to exactly 0 (no tile runs), as on the TPU
            zero = torch.tensor(kvl, device="cuda") == 0
            ok = ok and bool((out[zero] == 0).all().item())
        rows.append(dict(kernel="latent_decode_partials", case=name,
                         dtype=dn, rows=p * h, max_abs_err=err, atol=atol,
                         rtol=rtol, ok=ok))
    return rows


def _dense_latents(x):
    """The dense latent cache [B, M, r] / [B, M, rd] that
    :func:`deepseek_decode_data`'s identity-order pool holds (slot b owns
    pages b * W .. b * W + W - 1)."""
    ckv, kr = x["pools"]["identity"]
    m = x["w"] * x["ps"]
    return ckv.reshape(x["b"], m, x["r"]), kr.reshape(x["b"], m, x["rd"])


def k2latent_vs_k4(torch, gen, dec, autotune) -> dict:
    """The dense latent kernel on a DeepSeek decode step's rows against K4
    on a permuted pool holding the same rows, at the same splits (each
    with its own tuned block_k): equal bits on every kv_len >= 1 row —
    the two policies share one body."""
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 0]
    x = deepseek_decode_data(torch, gen, kvl)
    ckv, kr = _dense_latents(x)
    m = ckv.shape[1]
    paged = autotune.mla_paged_decode_params(x["w"], x["ps"], x["h"], MLA_R,
                                             MLA_RD)
    dense = autotune.decode_params(m, x["h"], MLA_R + MLA_RD, MLA_R)
    check(dense.splits == paged.splits,
          f"dense {dense} and paged {paged} splits differ")
    scale = (MLA_R + MLA_RD) ** -0.5
    out4 = dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
        x["q"], *x["pools"]["permuted"], x["tables"]["permuted"],
        x["kv_len"], scale=scale, splits=paged.splits,
        block_k=paged.block_k), torch.float32)
    out2 = dec.combine_partials(*dec.latent_decode_partials_cuda(
        x["q"], ckv, kr, x["kv_len"], scale=scale, splits=dense.splits,
        block_k=dense.block_k), torch.float32)
    torch.cuda.synchronize()
    live = x["kv_len"] >= 1
    diff = (out2 - out4).abs()
    row = dict(kernel="latent_decode_partials", case="k2latent_vs_k4",
               kv_len=kvl, splits=dense.splits, block_k_dense=dense.block_k,
               block_k_k4=paged.block_k,
               max_abs_diff_live=diff[live].max().item(),
               max_abs_diff_all=diff.max().item())
    row["ok"] = row["max_abs_diff_live"] == 0.0
    return row


def latent_split_cases():
    """Cases of both latent kernels that stress the 3xTF32 split of the
    latent body, fp32 at DeepSeek's latent with 128 heads: (name, layout,
    b, P, page_size (paged) or M (dense), W (paged), kv_len, splits,
    block_k, how the inputs are made from unit normals — scores in the
    hundreds (q x 30), bits below TF32's mantissa that matter (x + x *
    2^-12), or plain).  kv_len is off the 16-key chunk everywhere; the
    8-token pages make every chunk straddle two pages of a permuted
    table; one dense split sweeps 512 keys (32 chunks)."""
    return [
        ("fp32 q x30 (scores in the hundreds) G128 ps16 kv_len 333,77",
         "paged", 2, 1, 16, 32, [333, 77], 4, 16, "q_x30"),
        ("fp32 x + x*2^-12 G128 P=3 verify (384 rows) ps16", "paged", 2, 3,
         16, 16, [250, 37], 4, 16, "low_bits"),
        ("fp32 x + x*2^-12 G128 ps8 (each chunk straddles two pages)",
         "paged", 2, 1, 8, 64, [333, 100], 4, 8, "low_bits"),
        ("fp32 q x30 (scores in the hundreds) G128 M512 kv_len 333,77",
         "dense", 2, 1, 512, None, [333, 77], 4, 128, "q_x30"),
        ("fp32 x + x*2^-12 G128 P=3 verify (384 rows) M256", "dense", 2, 3,
         256, None, [250, 37], 4, 64, "low_bits"),
        ("fp32 x + x*2^-12 G128 one split of 512 keys M512", "dense", 2, 1,
         512, None, [500, 511], 1, 128, "low_bits"),
    ]


def _latent_ref64(torch, q, ckv, kr, kv_len, scale, rows_per_pos, n_pos):
    """Softmax attention in float64 on a dense latent view [B, M, r] / [B,
    M, rd]: row i sees the keys below kv_len + i // rows_per_pos (n_pos
    > 1) or kv_len; every row sees at least one key."""
    k = torch.cat([ckv, kr], dim=-1).double()
    s = torch.einsum("bre,bke->brk", q.double(), k) * scale
    rows = torch.arange(q.shape[1], device="cuda")
    lim = kv_len[:, None].long() + (rows // rows_per_pos if n_pos > 1
                                    else 0 * rows)[None, :]
    s = s.masked_fill(torch.arange(k.shape[1], device="cuda")[None, None, :]
                      >= lim[:, :, None], float("-inf"))
    return torch.einsum("brk,bkf->brf", torch.softmax(s, -1), ckv.double())


#: the float64-referenced gate of the latent split-stress cases: the
#: kernel may sit no farther from float64 than the plain fp32 version
#: plus this
F64_SLACK = 1e-5


def run_latent_split_cases(torch, gen, dec) -> list:
    """Every :func:`latent_split_cases` case against its plain version
    (``ok_vs_plain``: within the fp32 tolerance), and the kernel's and the
    plain version's distances to a float64 reference (``vs_f64``) with a
    second gate beside the first: the kernel no farther from float64 than
    the plain version plus :data:`F64_SLACK` (``ok_vs_f64``).  ``ok``
    needs both."""
    rows = []
    h, r, rd = 128, MLA_R, MLA_RD
    scale = (r + rd) ** -0.5
    for (name, layout, b, p, ps_or_m, w, kvl, splits, bk,
         how) in latent_split_cases():
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=scale, splits=splits, block_k=bk, n_pos=p,
                    rows_per_pos=h)
        if layout == "paged":
            ps = ps_or_m
            q, ckv, kr, table = _latent_inputs(
                torch, gen, b, h, p, ps, w, b * w, torch.float32, kvl)
            q, ckv, kr = _prep(q, ckv, kr, how)
            out = dec.mla_paged_decode_partials_cuda(q, ckv, kr, table,
                                                     kv_len, **args)
            ref = dec.mla_paged_decode_partials_torch(q, ckv, kr, table,
                                                      kv_len, **args)
            tb = table.long().clamp(max=b * w - 1)
            dense = (ckv[tb].reshape(b, w * ps, r),
                     kr[tb].reshape(b, w * ps, rd))
            kernel = "mla_paged_decode_partials"
        else:
            m = ps_or_m
            q, ckv, kr = _prep(
                _rand(torch, gen, (b, p * h, r + rd), torch.float32),
                _rand(torch, gen, (b, m, r), torch.float32),
                _rand(torch, gen, (b, m, rd), torch.float32), how)
            out = dec.latent_decode_partials_cuda(q, ckv, kr, kv_len, **args)
            ref = dec.latent_decode_partials_torch(q, ckv, kr, kv_len, **args)
            dense = (ckv, kr)
            kernel = "latent_decode_partials"
        out = dec.combine_partials(*out, torch.float32)
        ref = dec.combine_partials(*ref, torch.float32)
        torch.cuda.synchronize()
        err, ok, atol, rtol = _err(torch, out, ref, "float32")
        r64 = _latent_ref64(torch, q, *dense, kv_len, scale, h, p)
        vs = {"kernel": (out.double() - r64).abs().max().item(),
              "plain": (ref.double() - r64).abs().max().item()}
        f64_ok = vs["kernel"] <= vs["plain"] + F64_SLACK
        rows.append(dict(kernel=kernel, case=name, dtype="float32",
                         rows=p * h, max_abs_err=err, atol=atol, rtol=rtol,
                         ok=ok and f64_ok, ok_vs_plain=ok, ok_vs_f64=f64_ok,
                         f64_slack=F64_SLACK, vs_f64=vs))
        del r64
    return rows


def time_latent(torch, gen, dec, autotune,
                kvl=(2048, 1500, 1024, 700, 300, 64, 1, 1900), p=1,
                **dims) -> dict:
    """The dense latent kernel at a decode step: :func:`time_k4`'s data
    read as a dense cache (by default DeepSeek-V3's: M 2048, 128 heads),
    the tuned geometry; as the library yardstick SDPA on the dense view
    (the concatenation [ckv | krope] built in the call, no gather).
    ``p`` > 1: a speculative verify of P chain positions, P·H rows."""
    from repro_torch.kernels import ops

    kvl = list(kvl)
    x = deepseek_decode_data(torch, gen, kvl, b=len(kvl), **dims)
    b, h, r, rd = x["b"], x["h"], x["r"], x["rd"]
    ckv, kr = _dense_latents(x)
    m = ckv.shape[1]
    kv_len = x["kv_len"]
    q = x["q"] if p == 1 else _rand(torch, gen, (b, p * h, r + rd),
                                    torch.float32)
    tuned = autotune.decode_params(m, max(h, 8), r + rd, r)
    scale = (r + rd) ** -0.5
    args = dict(scale=scale, splits=tuned.splits,
                block_k=autotune.verify_block_k(tuned.block_k, p=p,
                                                g=max(h, 8), e=r + rd, f=r),
                n_pos=p, rows_per_pos=h)
    out = dec.combine_partials(*dec.latent_decode_partials_cuda(
        q, ckv, kr, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.latent_decode_partials_torch(
        q, ckv, kr, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.latent_decode_partials_cuda(
        q, ckv, kr, kv_len, **args))
    dev_ms = device_ms(torch, lambda: dec.latent_decode_partials_cuda(
        q, ckv, kr, kv_len, **args), "latent_decode_partials_kernel")
    plain_ms = time_ms(torch, lambda: dec.latent_decode_partials_torch(
        q, ckv, kr, kv_len, **args), iters=5, warmup=1)
    library_ms = time_ms(torch, _latent_library(torch, ops, q, ckv, kr,
                                                kv_len, p, h, scale))
    reads, pairs = _verify_keys(kvl, p, m)
    # each valid latent row (ckv and krope) is read once, the queries and
    # kv_len once, the fp32 partials written once
    nbytes = (4 * reads * (r + rd) + 4 * q.numel() + 4 * b
              + 4 * b * tuned.splits * p * h * (r + 2))
    # per valid (key, query row): r + rd multiply-adds for the score, r
    # for the value, both on the tensor cores
    flops = 2 * h * pairs * (2 * r + rd)
    row = _timing_row(ms, plain_ms, library_ms, 0, nbytes, err, ok,
                      shape=f"B{b} H{h} r{r} rd{rd} dense M{m} fp32 kv_len "
                            f"{kvl} splits {tuned.splits} block_k "
                            f"{args['block_k']}"
                            + (f" P={p} ({p * h} rows)" if p > 1 else ""),
                      tf32x3_flops=flops)
    row["device_ms"] = dev_ms
    row["device_share_of_bound"] = row["bound_ms"] / dev_ms
    return row


# ---------------------------------------------------------------------------
# quantized pages: K3's and K4's code branches
# ---------------------------------------------------------------------------

#: the code dtypes of quantized pools (``--kv-dtype``) and their short
#: names in the kernel rows
QUANT_KV = {"fp8_e4m3": "fp8", "int8": "int8"}


def run_k3q_cases(torch, gen, dec, autotune, cases=None) -> tuple:
    """K3 on quantized pools: every fp32 case of :func:`k3_cases` (head
    dims 32-256, verify rows, ring classes at eff_len, softcap, kv_len 0,
    permuted pools with sentinels) with its pools quantized to each code
    dtype, against the plain version on the same codes and scales (fp32
    tolerance), and against K3 on the fp32 pool the codes decode to at the
    same splits, which must give the same bits (``k3_quant_vs_dequant``).
    Returns (rows, the k3_quant_vs_dequant row)."""
    rows, worst = [], {}
    for (name, b, hkv, g, p, ps, w, n_pages, d, dtype, kvl, splits, bk,
         kw) in cases or k3_cases(torch, autotune.DECODE_CHUNK):
        if dtype != torch.float32:
            continue
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k, v, table = _paged_inputs(torch, gen, b, hkv, ps, w, n_pages, d,
                                    dtype, kvl, p)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=g, **kw)
        for kv, short in QUANT_KV.items():
            (kc, ks, kd), (vc, vs, vd) = _quantized(torch, (k, v), kv)
            sc = dict(k_scale=ks, v_scale=vs)
            out = dec.combine_partials(*dec.paged_decode_partials_cuda(
                q, kc, vc, table, kv_len, **args, **sc), dtype)
            ref = dec.combine_partials(*dec.paged_decode_partials_torch(
                q, kc, vc, table, kv_len, **args, **sc), dtype)
            deq = dec.combine_partials(*dec.paged_decode_partials_cuda(
                q, kd, vd, table, kv_len, **args), dtype)
            torch.cuda.synchronize()
            err, ok, atol, rtol = _err(torch, out, ref, "float32")
            if 0 in kvl and p == 1:
                zero = torch.tensor(kvl, device="cuda").repeat_interleave(
                    hkv) == 0
                ok = ok and bool((out[zero] == 0).all().item())
            same = (out - deq).abs().max().item()
            worst[kv] = max(worst.get(kv, 0.0), same)
            rows.append(dict(kernel=f"paged_decode_partials@{short}",
                             case=name, dtype="float32", kv_dtype=kv,
                             max_abs_err=err, atol=atol, rtol=rtol,
                             vs_dequant_max_abs_diff=same, ok=ok))
    top = max(worst.values())
    return rows, dict(kernel="paged_decode_partials@quant",
                      case="k3_quant_vs_dequant", cases=len(rows),
                      max_abs_diff_by_kv_dtype=worst, max_abs_diff=top,
                      ok=top == 0.0)


def run_k4q_cases(torch, gen, dec, cases=None) -> tuple:
    """K4 on quantized latent pools: every fp32 case of :func:`k4_cases`
    (DeepSeek's (512, 64) and the smoke (32, 16), verify rows, softcap,
    sub-page tiles, kv_len 0) with its pools quantized to each code dtype
    (one scale per token for the latent and one for the rope key), against
    the plain version and against K4 on the decoded fp32 pools, which must
    give the same bits (``k4_quant_vs_dequant``)."""
    rows, worst = [], {}
    for (name, b, h, p, ps, w, n_pages, dtype, kvl, splits, bk, kw,
         *dims) in cases or k4_cases(torch):
        if dtype != torch.float32:
            continue
        r, rd = dims[0] if dims else (MLA_R, MLA_RD)
        q, ckv, kr, table = _latent_inputs(torch, gen, b, h, p, ps, w,
                                           n_pages, dtype, kvl, r, rd)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=(r + rd) ** -0.5, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=h, **kw)
        for kv, short in QUANT_KV.items():
            (cc, cs, cd), (rc, rs, rdq) = _quantized(torch, (ckv, kr), kv)
            sc = dict(ckv_scale=cs, krope_scale=rs)
            out = dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
                q, cc, rc, table, kv_len, **args, **sc), dtype)
            ref = dec.combine_partials(*dec.mla_paged_decode_partials_torch(
                q, cc, rc, table, kv_len, **args, **sc), dtype)
            deq = dec.combine_partials(*dec.mla_paged_decode_partials_cuda(
                q, cd, rdq, table, kv_len, **args), dtype)
            torch.cuda.synchronize()
            err, ok, atol, rtol = _err(torch, out, ref, "float32")
            if 0 in kvl and p == 1:
                zero = torch.tensor(kvl, device="cuda") == 0
                ok = ok and bool((out[zero] == 0).all().item())
            same = (out - deq).abs().max().item()
            worst[kv] = max(worst.get(kv, 0.0), same)
            rows.append(dict(kernel=f"mla_paged_decode_partials@{short}",
                             case=name, dtype="float32", kv_dtype=kv,
                             max_abs_err=err, atol=atol, rtol=rtol,
                             vs_dequant_max_abs_diff=same, ok=ok))
    top = max(worst.values())
    return rows, dict(kernel="mla_paged_decode_partials@quant",
                      case="k4_quant_vs_dequant", cases=len(rows),
                      max_abs_diff_by_kv_dtype=worst, max_abs_diff=top,
                      ok=top == 0.0)


def quant_refusal_cases(torch, gen, dec) -> list:
    """Code pools the kernels are not built for must raise on CUDA
    tensors, never fall back: K3 with fp8 codes at D = 96, with int8 codes
    and bf16 queries, and with codes but no scales; K4 with fp8 codes at
    (r, rd) = (64, 16) and with bf16 queries."""
    from repro_torch.model.attention import quantize_kv

    f32, fp8 = torch.float32, torch.float8_e4m3fn
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(1, 4)
    kv_len = torch.tensor([40], dtype=torch.int32, device="cuda")
    dk = dict(scale=0.1, splits=1, block_k=16)
    q96 = _rand(torch, gen, (2, 4, 96), f32)
    c96, s96 = quantize_kv(_rand(torch, gen, (4, 16, 2, 96), f32), fp8)
    q128 = _rand(torch, gen, (2, 4, 128), f32)
    c128, s128 = quantize_kv(_rand(torch, gen, (4, 16, 2, 128), f32),
                             torch.int8)
    ql = _rand(torch, gen, (1, 4, 80), f32)
    cl, sl = quantize_kv(_rand(torch, gen, (4, 16, 64), f32), fp8)
    cr, sr = quantize_kv(_rand(torch, gen, (4, 16, 16), f32), fp8)
    qs = _rand(torch, gen, (1, 4, 48), f32)
    cs, ss = quantize_kv(_rand(torch, gen, (4, 16, 32), f32), fp8)
    calls = [
        ("paged_decode_partials", "fp8 codes at D = 96",
         lambda: dec.paged_decode_partials_cuda(
             q96, c96, c96, table, kv_len, hkv=2, k_scale=s96, v_scale=s96,
             **dk)),
        ("paged_decode_partials", "int8 codes with bf16 queries",
         lambda: dec.paged_decode_partials_cuda(
             q128.to(torch.bfloat16), c128, c128, table, kv_len, hkv=2,
             k_scale=s128, v_scale=s128, **dk)),
        ("paged_decode_partials", "int8 codes without scales",
         lambda: dec.paged_decode_partials_cuda(
             q128, c128, c128, table, kv_len, hkv=2, **dk)),
        ("mla_paged_decode_partials", "fp8 codes at (r, rd) = (64, 16)",
         lambda: dec.mla_paged_decode_partials_cuda(
             ql, cl, cr, table, kv_len, ckv_scale=sl, krope_scale=sr, **dk)),
        ("mla_paged_decode_partials", "fp8 codes with bf16 queries",
         lambda: dec.mla_paged_decode_partials_cuda(
             qs.to(torch.bfloat16), cs, cr, table, kv_len, ckv_scale=ss,
             krope_scale=sr, **dk)),
    ]
    rows = []
    for kernel, what, call in calls:
        try:
            call()
            raised = None
        except ValueError as e:
            raised = str(e)
        torch.cuda.synchronize()
        rows.append(dict(kernel=kernel, case=f"{what} raises",
                         raised=raised, ok=raised is not None))
    return rows


def time_k3_quant(torch, gen, dec, ops, autotune, kv_dtype) -> dict:
    """K3 on a quantized pool at granite-3-8b's decode step (the data of
    :func:`time_k3` with its pools quantized to ``kv_dtype``): the kernel,
    its plain version, and as the library yardstick ``gather_pages`` of
    codes and scales, the dequantize and SDPA on the gathered view.  The
    bound counts the codes and the 2-byte scales of every valid key."""
    import torch.nn.functional as F

    from repro_torch.model.attention import dequantize_kv

    x = granite_paged_data(torch, gen)
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n_pages = x["k_pages"].shape[0]
    table = with_sentinels(x["table"], kvl, x["ps"], n_pages)
    b, hq, hkv, g, m, d, ps, w = (x[k] for k in
                                  ("b", "hq", "hkv", "g", "m", "d", "ps", "w"))
    (kc, ks, _), (vc, vs, _) = _quantized(
        torch, (x["k_pages"], x["v_pages"]), kv_dtype)
    tuned = autotune.paged_decode_params(w, ps, max(g, 8), d, d,
                                         elem_bytes=kc.element_size())
    q_f = x["q"].reshape(b * hkv, g, d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=tuned.block_k, k_scale=ks, v_scale=vs)

    def kernel():
        return dec.paged_decode_partials_cuda(q_f, kc, vc, table, kv_len,
                                              **args)

    out = dec.combine_partials(*kernel(), torch.float32)
    ref = dec.combine_partials(*dec.paged_decode_partials_torch(
        q_f, kc, vc, table, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel, "PagedKV")
    wrapper_ms = host_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: dec.paged_decode_partials_torch(
        q_f, kc, vc, table, kv_len, **args), iters=5, warmup=1)
    mask = (torch.arange(m, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]

    def library():
        kg = dequantize_kv(ops.gather_pages(kc, table),
                           ops.gather_pages(ks, table)).transpose(1, 2)
        vg = dequantize_kv(ops.gather_pages(vc, table),
                           ops.gather_pages(vs, table)).transpose(1, 2)
        try:
            return F.scaled_dot_product_attention(
                x["q"], kg, vg, attn_mask=mask, enable_gqa=True)
        except TypeError:
            return F.scaled_dot_product_attention(
                x["q"], kg.repeat_interleave(g, dim=1),
                vg.repeat_interleave(g, dim=1), attn_mask=mask)

    library_ms = time_ms(torch, library)
    live = sum(kvl)
    # each valid key's K and V codes (1 byte a feature) and their fp16
    # scales read once per kv head, the table and queries once, the fp32
    # partials written once
    nbytes = (live * hkv * 2 * (d + 2) + 4 * table.numel() + 4 * q_f.numel()
              + 4 * b + 4 * b * hkv * tuned.splits * g * (d + 2))
    # the dot products, and one dequantizing multiply per code
    flops = 4 * d * live * hq + 2 * d * live * hkv
    row = _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                      shape=f"B{b} Hq{hq} Hkv{hkv} page_size {ps} W {w} pool "
                            f"{n_pages} pages d{d} {kv_dtype} codes + fp16 "
                            f"scales, fp32 queries, kv_len {kvl} splits "
                            f"{tuned.splits} block_k {tuned.block_k}")
    row.update(device_ms=dev_ms, host_ms=wrapper_ms,
               device_share_of_bound=row["bound_ms"] / dev_ms)
    torch.cuda.empty_cache()
    return row


def time_k4_quant(torch, gen, dec, ops, autotune, kv_dtype) -> dict:
    """K4 on a quantized latent pool at DeepSeek-V3's decode step (the data
    of :func:`time_k4` with both latent pools quantized to ``kv_dtype``):
    the kernel, its plain version, and gather + dequantize + SDPA."""
    import torch.nn.functional as F

    from repro_torch.model.attention import dequantize_kv

    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]
    x = deepseek_decode_data(torch, gen, kvl, b=len(kvl))
    b, h, ps, w, r, rd = (x[k] for k in ("b", "h", "ps", "w", "r", "rd"))
    ckv, kr = x["pools"]["permuted"]
    (cc, cs, _), (rc, rs, _) = _quantized(torch, (ckv, kr), kv_dtype)
    table, kv_len, q = x["tables"]["permuted"], x["kv_len"], x["q"]
    tuned = autotune.mla_paged_decode_params(w, ps, h, r, rd,
                                             elem_bytes=cc.element_size())
    scale = (r + rd) ** -0.5
    args = dict(scale=scale, splits=tuned.splits, block_k=tuned.block_k,
                ckv_scale=cs, krope_scale=rs)

    def kernel():
        return dec.mla_paged_decode_partials_cuda(q, cc, rc, table, kv_len,
                                                  **args)

    out = dec.combine_partials(*kernel(), torch.float32)
    ref = dec.combine_partials(*dec.mla_paged_decode_partials_torch(
        q, cc, rc, table, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, kernel)
    dev_ms = device_ms(torch, kernel, "mla_paged_decode_partials_kernel")
    plain_ms = time_ms(torch, lambda: dec.mla_paged_decode_partials_torch(
        q, cc, rc, table, kv_len, **args), iters=5, warmup=1)
    m = w * ps
    mask = (torch.arange(m, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4 = q[:, :, None]

    def library():
        cg = dequantize_kv(ops.gather_pages(cc, table),
                           ops.gather_pages(cs, table))
        kg = torch.cat([cg, dequantize_kv(ops.gather_pages(rc, table),
                                          ops.gather_pages(rs, table))],
                       dim=-1)
        try:
            return F.scaled_dot_product_attention(
                q4, kg[:, None], cg[:, None], attn_mask=mask, scale=scale,
                enable_gqa=True)
        except TypeError:
            return F.scaled_dot_product_attention(
                q4, kg[:, None].expand(b, h, m, r + rd),
                cg[:, None].expand(b, h, m, r), attn_mask=mask,
                scale=scale)

    library_ms = time_ms(torch, library)
    live = sum(kvl)
    # each valid key's latent and rope codes and their two fp16 scales read
    # once, the queries, table and kv_len once, the fp32 partials written
    # once
    nbytes = (live * (r + rd + 4) + 4 * q.numel() + 4 * table.numel()
              + 4 * b + 4 * b * tuned.splits * h * (r + 2))
    # the products on the tensor cores, the dequantizing multiplies on the
    # FP32 units
    flops = 2 * h * live * (2 * r + rd)
    row = _timing_row(ms, plain_ms, library_ms, live * (r + rd), nbytes, err,
                      ok, tf32x3_flops=flops,
                      shape=f"B{b} H{h} r{r} rd{rd} page_size {ps} W {w} "
                            f"pool {x['n_pages']} pages {kv_dtype} codes + "
                            f"fp16 scales, fp32 queries, kv_len {kvl} "
                            f"splits {tuned.splits} block_k "
                            f"{tuned.block_k}")
    row.update(device_ms=dev_ms,
               device_share_of_bound=row["bound_ms"] / dev_ms)
    torch.cuda.empty_cache()
    return row


def _time_k1_shape(torch, gen, fm, autotune, *, b, hq, hkv, p, m, e, f,
                   q_offset, shape, window=None, softcap=None,
                   with_device_ms=False, return_lse=False,
                   parent: Optional[ParentK1] = None) -> dict:
    """K1 at one prefill shape, causal with a history offset (and a window
    and a softcap where given), fp32: the kernel, its plain version, SDPA
    on the same inputs (by default and under each fp32 backend; the window
    as a boolean mask, and never a softcap, which SDPA has not: there it
    is a yardstick of a neighbouring function), and both bounds: the FP32
    units' and the tensor cores' in 3xTF32, which is the one K1 runs
    against, over the (query, key) pairs the causal and window masks
    leave.  ``with_device_ms``: also the kernel's own device time from
    the profiler (:func:`device_ms`).  ``return_lse``: the kernel and
    its plain version also write each row's log-sum-exp (the training
    forward), which the bytes count and ``lse_max_abs_err`` compares.
    ``parent``: at ``PARENT_K1_DIMS`` also the parent body's time on the
    same inputs, in the same call (``parent_mma_sync_ms``)."""
    g = hq // hkv
    q = _rand(torch, gen, (b, hq, p, e), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, e), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, f), torch.float32)
    q_f = (q.reshape(b, hkv, g, p, e).transpose(2, 3)
           .reshape(b * hkv, p * g, e).contiguous())
    k_f, v_f = k.reshape(b * hkv, m, e), v.reshape(b * hkv, m, f)
    tile = autotune.attention_params(p * g, m, e, f, impl="cuda")
    args = dict(scale=e ** -0.5, causal=True, group=g, q_offset=q_offset,
                block_q=tile.block_q, block_k=tile.block_k, window=window,
                softcap=softcap)
    if return_lse:
        args["return_lse"] = True
    out = fm.fusemax_attention_cuda(q_f, k_f, v_f, **args)
    plan = fm.fusemax_attention_cuda.last_plan
    ref = fm.fusemax_attention_torch(q_f, k_f, v_f, **args)
    lse_err = None
    if return_lse:
        (out, lse), (ref, lse_ref) = out, ref
        lse_err = (lse - lse_ref).abs().max().item()
        del lse, lse_ref
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ok = ok and (lse_err is None or lse_err <= LSE_TOL)
    with_parent = parent is not None and (e, f) in PARENT_K1_DIMS
    if with_parent:
        parent_err = _err(torch, parent(torch, q_f, k_f, v_f, **args), ref,
                          "float32")[0]
    del out, ref
    ms = time_ms(torch, lambda: fm.fusemax_attention_cuda(q_f, k_f, v_f,
                                                          **args))
    if with_parent:
        parent_ms = time_ms(torch, lambda: parent(torch, q_f, k_f, v_f,
                                                  **args))
    if return_lse:                      # the same launch without the LSE
        bare = {key: val for key, val in args.items() if key != "return_lse"}
        ms_no_lse = time_ms(torch, lambda: fm.fusemax_attention_cuda(
            q_f, k_f, v_f, **bare))
    plain_ms = time_ms(torch, lambda: fm.fusemax_attention_torch(
        q_f, k_f, v_f, **args), iters=3, warmup=1)
    if q_offset or window is not None:
        kpos = torch.arange(m, device="cuda")[None, :]
        qpos = q_offset + torch.arange(p, device="cuda")[:, None]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        sdpa_kw = dict(attn_mask=mask, scale=e ** -0.5)
    else:
        sdpa_kw = dict(is_causal=True, scale=e ** -0.5)
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, **sdpa_kw))
    backends = _sdpa_backends(torch, q, k, v, **sdpa_kw)
    # query i attends min(q_offset + i + 1, window) keys; each pair costs
    # e MACs for Q.K and f for P.V
    seen = q_offset + 1 + torch.arange(p, dtype=torch.float64)
    if window is not None:
        seen = torch.clamp(seen, max=window)
    pairs = int(seen.sum().item())
    flops = 2 * (e + f) * pairs * hq * b
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + b * hq * p * f
                  + (b * hq * p if return_lse else 0))
    t_fp32 = flops / FP32_FLOPS * 1e3
    t_3xtf32 = 3 * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_3xtf32, t_bytes),
               bound_by="operations" if t_3xtf32 >= t_bytes else "bytes",
               bound_ms_fp32=max(t_fp32, t_bytes),
               bound_ms_3xtf32=max(t_3xtf32, t_bytes),
               share_of_3xtf32_bound=max(t_3xtf32, t_bytes) / ms,
               flops=flops, bytes=nbytes, max_abs_err=err, ok=ok, e=e, f=f,
               tile=[tile.block_q, tile.block_k],
               plan=dict(block_q=plan.block_q, f_split=plan.f_split,
                         blocks=plan.blocks), **backends)
    if return_lse:
        row.update(lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
                   ms_no_lse=ms_no_lse)
    if with_parent:
        row.update(parent_mma_sync_ms=parent_ms,
                   parent_mma_sync_max_abs_err=parent_err,
                   share_of_3xtf32_bound_parent=row["bound_ms"] / parent_ms)
    if with_device_ms:
        row["device_ms"] = device_ms(torch, lambda: fm.fusemax_attention_cuda(
            q_f, k_f, v_f, **args), "fusemax_prefill")
        row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
        # SDPA's own kernels, so the two compare device against device
        row["library_device_ms"] = call_device_ms(
            torch, _sdpa_fn(torch, q, k, v, **sdpa_kw))
    if softcap is not None:
        row["library_note"] = (f"SDPA has no softcap: library_ms is the "
                               f"same shapes and masks without softcap "
                               f"{softcap}, a yardstick, not this function")
    return row


def _sdpa_backends(torch, q, k, v, **kw) -> dict:
    """SDPA on the same inputs under each fp32 backend (memory-efficient
    and math), timed apart, and the backend the default call runs: the
    one whose output equals the default's bit for bit.  A backend that
    refuses ``enable_gqa`` runs on K/V expanded to the query heads before
    the clock starts."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    default = _sdpa_fn(torch, q, k, v, **kw)()
    rep = q.shape[1] // k.shape[1]
    forms = [("enable_gqa", k, v, dict(enable_gqa=True))]
    if rep > 1:
        forms.append(("expanded", k.repeat_interleave(rep, dim=1),
                      v.repeat_interleave(rep, dim=1), {}))
    out = {}
    same = []
    for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("math", SDPBackend.MATH)):
        out[f"library_{name}_ms"] = None
        errors = []
        for form, kk, vv, extra in forms:
            def call(kk=kk, vv=vv, extra=extra, backend=backend):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, kk, vv,
                                                          **extra, **kw)
            try:
                res = call()
            except (RuntimeError, TypeError) as exc:
                errors.append(f"{form}: {str(exc).splitlines()[0][:120]}")
                continue
            if torch.equal(res, default):
                same.append(name)
            del res
            out[f"library_{name}_ms"] = time_ms(torch, call)
            out[f"library_{name}_form"] = form
            break
        if out[f"library_{name}_ms"] is None:
            out[f"library_{name}_error"] = "; ".join(errors)
    out["library_default_backend"] = "/".join(same) or "neither"
    del forms, default
    torch.cuda.empty_cache()
    return out


def time_k1_mla(torch, gen, fm, autotune, parent=None) -> dict:
    """K1 at DeepSeek-V3's two MLA prefill shapes: ``mla_forward`` (4
    prompts of 1024, 128 heads, (E, F) = (192, 128), causal) and the
    absorbed tail (4 rows of a 256-token tail after a 768-token cached
    prefix, the 128 heads in one fiber's group, (576, 512))."""
    fwd = _time_k1_shape(
        torch, gen, fm, autotune, b=4, hq=128, hkv=128, p=1024, m=1024,
        e=192, f=128, q_offset=0, parent=parent,
        shape="B4 H128 (one fiber each) P=M=1024 E192 F128 fp32 causal")
    torch.cuda.empty_cache()
    tail = _time_k1_shape(
        torch, gen, fm, autotune, b=4, hq=128, hkv=1, p=256, m=1024, e=576,
        f=512, q_offset=768,
        shape="B4 H128 in one group (Hkv 1) P=256 after 768 cached, M=1024 "
              "E576 F512 fp32 causal")
    torch.cuda.empty_cache()
    return {"mla_forward": fwd, "mla_absorbed": tail}


def time_gemma2(torch, gen, fm, dec, ops, autotune, parent=None) -> dict:
    """K1, K2 and K3 at gemma2-9b's shapes, fp32: K1 at a prefill dispatch
    of 2 prompts of 8192 (16 q over 8 kv heads, head dim 256, causal,
    softcap 50) on a local layer (window 4096) and a global one; K2 and K3
    at a decode step of 4 slots on a global layer's 8192-token cache
    (kv_len up to 8192, one of them 4096) and on a local layer's ring of
    4096 read at eff_len = min(kv_len, 4096); K3 against K2 on the same
    rows at head dim 256."""
    out = {}
    for where, window in (("gemma2_local", 4096), ("gemma2_global", None)):
        out[f"fusemax_prefill@{where}"] = _time_k1_shape(
            torch, gen, fm, autotune, b=2, hq=16, hkv=8, p=8192, m=8192,
            e=256, f=256, q_offset=0, window=window, softcap=50.0,
            parent=parent, shape=f"B2 Hq16 Hkv8 P=M=8192 d256 fp32 causal softcap 50"
                  + (f" window {window}" if window else ""))
        torch.cuda.empty_cache()
    glob, ring = [8192, 5000, 4096, 1], [4096, 4096, 4096, 1]
    for where, m, kvl in (("gemma2_global", 8192, glob),
                          ("gemma2_ring", 4096, ring)):
        out[f"decode_partials@{where}"] = time_k2(
            torch, gen, dec, autotune, b=4, hq=16, hkv=8, m=m, d=256,
            kvl=kvl)
        out[f"paged_decode_partials@{where}"] = time_k3(
            torch, gen, dec, ops, autotune,
            x=gemma2_paged_data(torch, gen, m), kvl=kvl)
        torch.cuda.empty_cache()
    out["k3_vs_k2_d256"] = k3_vs_k2(
        torch, gen, dec, autotune, x=gemma2_paged_data(torch, gen),
        kvl=[8192, 5000, 1, 0], case="k3_vs_k2 d256 (gemma2)")
    torch.cuda.empty_cache()
    return out


def time_smoke(torch, gen, fm, dec, ops, autotune) -> dict:
    """Each smoke instantiation at a smoke serving shape (4 slots, a
    256-token cache): K1 at (32, 32) on gemma2-9b-smoke's local layer
    (window 64, softcap 50) and at (48, 32) on the MLA smoke config's
    ``mla_forward`` (one head a fiber), K2 and K3 at D = 32, K4 and K2's
    dense latent branch at (32, 16) with 4 heads."""
    kvl = [256, 200, 64, 1]
    out = {
        "fusemax_prefill@smoke_32x32": _time_k1_shape(
            torch, gen, fm, autotune, b=4, hq=4, hkv=2, p=256, m=256, e=32,
            f=32, q_offset=0, window=64, softcap=50.0, with_device_ms=True,
            shape="B4 Hq4 Hkv2 P=M=256 d32 fp32 causal window 64 softcap 50"),
        "fusemax_prefill@smoke_48x32": _time_k1_shape(
            torch, gen, fm, autotune, b=4, hq=4, hkv=4, p=256, m=256, e=48,
            f=32, q_offset=0, with_device_ms=True,
            shape="B4 H4 (one fiber each) P=M=256 E48 F32 fp32 causal"),
        "decode_partials@smoke_d32": time_k2(
            torch, gen, dec, autotune, b=4, hq=4, hkv=2, m=256, d=32,
            kvl=kvl),
        "paged_decode_partials@smoke_d32": time_k3(
            torch, gen, dec, ops, autotune,
            x=paged_data(torch, gen, 4, 4, 2, 256, 32), kvl=kvl),
        "mla_paged_decode_partials@smoke_32x16": time_k4(
            torch, gen, dec, ops, autotune, kvl=kvl, h=4, w=16, r=32, rd=16),
        "decode_partials@latent_smoke_32x16": time_latent(
            torch, gen, dec, autotune, kvl=kvl, h=4, w=16, r=32, rd=16),
    }
    torch.cuda.empty_cache()
    return out


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` launches, CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host ms per call of ``fn`` over ``iters`` calls, warmed up:
    the time to check the operands and enqueue the launch (no sync inside
    the loop); where it exceeds the kernel's device time, back-to-back
    calls run at this pace and :func:`time_ms` reads it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_ms(torch, fn, kernel: str, iters: int = 20,
              warmup: int = 3, tries: int = 3) -> float:
    """Mean device time per launch of ``fn``'s kernel (the CUDA kernel
    records whose name holds ``kernel``), from ``torch.profiler`` over
    ``iters`` calls after ``warmup``: what the card spends, without the
    wrapper's host time between launches that :func:`time_ms` sees.  The
    mean is over the launches the profiler recorded, which may miss one of
    the ``iters``.  CUPTI can also drop a whole session's kernel records:
    such a session is profiled again, up to ``tries`` sessions, and if
    none records a launch the time is CUDA events around the ``iters``
    calls (:func:`time_ms`, an upper bound that holds the host's launch
    time too), said on a line of its own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.device_time_total if hasattr(ev, "device_time_total")
              else ev.cuda_time_total for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and kernel in ev.name]
        check(len(us) <= iters, f"profiler saw {len(us)} launches of "
                                f"{kernel} in {iters} calls")
        if us:
            return sum(us) / 1e3 / len(us)
        print(f"device_ms: profiler session {attempt} of {tries} recorded "
              f"no launch of {kernel} in {iters} calls", file=sys.stderr,
              flush=True)
    ms = time_ms(torch, fn, iters=iters, warmup=0)
    print(json.dumps({"device_ms_fallback": kernel, "sessions": tries,
                      "via": "cuda_events", "ms": ms}), flush=True)
    return ms


def call_device_ms(torch, fn, iters: int = 20, warmup: int = 3,
                   tries: int = 3) -> float:
    """Device time of one call of ``fn`` (a library call) over ``iters``
    calls after ``warmup``: for every CUDA kernel it launches, the mean
    of its recorded launches times its launches a call, summed.  A call
    launches the same kernels each time, but CUPTI drops a few records (at
    SDPA's fp32 kernel 2 of 20 in each session), so a kernel's launches a
    call are its records over ``iters`` rounded up, not its records.  A
    session with no record is profiled again, up to ``tries`` sessions,
    and then the time is CUDA events around the calls (:func:`time_ms`),
    said on a line of its own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, us = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                n[ev.name] = n.get(ev.name, 0) + 1
                us[ev.name] = us.get(ev.name, 0.0) + (
                    ev.device_time_total if hasattr(ev, "device_time_total")
                    else ev.cuda_time_total)
        if n:
            return sum(us[k] / n[k] * -(-n[k] // iters) for k in n) / 1e3
        print(f"call_device_ms: profiler session {attempt} of {tries} "
              f"recorded no kernel in {iters} calls", file=sys.stderr,
              flush=True)
    ms = time_ms(torch, fn, iters=iters, warmup=0)
    print(json.dumps({"device_ms_fallback": "library call", "sessions": tries,
                      "via": "cuda_events", "ms": ms}), flush=True)
    return ms


def _sdpa_fn(torch, q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call on the same inputs (GQA
    through ``enable_gqa`` where this torch has it, else on K/V expanded
    to the query heads before the clock starts)."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        ke = k.repeat_interleave(rep, dim=1)
        ve = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)


def time_async(torch, gen, fm, dec, ops, autotune) -> dict:
    """K1 and K3 at the shapes serve_async gives them: K1 at a 1024-token
    prompt's last 128-token quantum (one row, 32 q over 8 kv heads, head
    dim 128, P = 128 after 896, M = 1024), and K3 at a decode step of 8
    slots in a 640-page pool (max_len 1280) where three rows are parked
    mid-prefill at progress + 1 (129, 641, 1025), four are chats and one
    slot is empty."""
    k1 = _time_k1_shape(
        torch, gen, fm, autotune, b=1, hq=32, hkv=8, p=128, m=1024, e=128,
        f=128, q_offset=896, with_device_ms=True,
        shape="B1 Hq32 Hkv8 P=128 after 896 (a prefill quantum), M=1024 "
              "d128 fp32 causal")
    torch.cuda.empty_cache()
    k3 = time_k3(torch, gen, dec, ops, autotune,
                 x=paged_data(torch, gen, 8, 32, 8, 1280, 128),
                 kvl=(45, 129, 80, 641, 33, 1025, 64, 0))
    torch.cuda.empty_cache()
    return {"fusemax_prefill@async_quantum": k1,
            "paged_decode_partials@async_parked": k3}


def time_k1(torch, gen, fm, autotune) -> dict:
    """K1 at a granite-3-8b prefill dispatch: 4 prompts of 1024, causal,
    32 q heads over 8 kv heads, head dim 128, fp32."""
    row = _time_k1_shape(torch, gen, fm, autotune, b=4, hq=32, hkv=8,
                         p=1024, m=1024, e=128, f=128, q_offset=0,
                         shape="B4 Hq32 Hkv8 P=M=1024 d128 fp32 causal")
    torch.cuda.empty_cache()
    return row


def _verify_keys(kvl, p: int, m: int) -> tuple:
    """(keys read, query-key pairs) of P verify rows per slot: row j of a
    slot with kv_len n attends its first min(n + j, m) keys, and the P
    rows together read the first min(n + p - 1, m) once."""
    reads = sum(min(n + p - 1, m) for n in kvl)
    pairs = sum(min(n + j, m) for n in kvl for j in range(p))
    return reads, pairs


def _verify_mask(torch, kv_len, p: int, m: int, rows_per_pos: int = 1):
    """SDPA's boolean mask for P verify rows ([B, 1, P·rows_per_pos, m]):
    query row i sits at chain position i // rows_per_pos."""
    pos = torch.arange(p * rows_per_pos, device="cuda") // rows_per_pos
    lim = kv_len[:, None].long() + pos[None, :]
    return (torch.arange(m, device="cuda")[None, None, :]
            < lim[..., None])[:, None]


def time_k2(torch, gen, dec, autotune, b=8, hq=32, hkv=8, m=2048, d=128,
            kvl=(2048, 1500, 1024, 700, 300, 64, 1, 1900), p=1) -> dict:
    """K2 at a decode step, fp32, tuned splits; by default granite-3-8b's:
    8 slots, 2048-slot cache, mixed kv_len, 32 q heads over 8 kv heads,
    head dim 128.  ``p`` > 1: a speculative verify of P chain positions
    (P·G rows a fiber, ``block_k`` clamped for verify rows as the model
    path clamps it); the library yardstick then takes the P queries with
    their causal mask."""
    from repro_torch.kernels import ops

    g = hq // hkv
    kvl = list(kvl)
    q = _rand(torch, gen, (b, hq, p, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    tuned = autotune.decode_params(m, max(g, 8), d, d)
    q_f = ops._fold_decode_q(q, b, hkv, g, d).contiguous()
    k_f, v_f = k.reshape(b * hkv, m, d), v.reshape(b * hkv, m, d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=autotune.verify_block_k(tuned.block_k, p=p,
                                                g=max(g, 8), e=d, f=d),
                n_pos=p, rows_per_pos=g)
    out = dec.combine_partials(*dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.decode_partials_cuda(q_f, k_f, v_f,
                                                         kv_len, **args))
    dev_ms = device_ms(torch, lambda: dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, **args), "DenseKV")
    wrapper_ms = host_ms(torch, lambda: dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, **args))
    plain_ms = time_ms(torch, lambda: dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), iters=5, warmup=1)
    mask = _verify_mask(torch, kv_len, p, m)
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, attn_mask=mask))
    reads, pairs = _verify_keys(kvl, p, m)
    # each valid key is read once (K and V rows of every kv head), the
    # queries once, the fp32 partials written once; every query row
    # attends the keys below its chain position
    nbytes = (4 * 2 * reads * hkv * d + 4 * q.numel() + 4 * b
              + 4 * b * hkv * tuned.splits * p * g * (d + 2))
    flops = 4 * d * pairs * hq
    row = _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                      shape=f"B{b} Hq{hq} Hkv{hkv} M{m} d{d} fp32 kv_len "
                            f"{kvl} splits {tuned.splits} block_k "
                            f"{args['block_k']}"
                            + (f" P={p} ({p * g} rows)" if p > 1 else ""))
    return dict(row, device_ms=dev_ms, host_ms=wrapper_ms,
                device_share_of_bound=row["bound_ms"] / dev_ms,
                plan=decode_plan(autotune, p * g, tuned.splits, b * hkv))


def decode_plan(autotune, rows: int, splits: int, fibers: int) -> dict:
    """A K2/K3 launch's plan (``autotune``'s mirror of the kernel's
    layout): rows a block, blocks of rows a (split, fiber), the grid and
    its blocks against the card's SMs."""
    grid = autotune.decode_grid(rows, splits, fibers)
    blocks = grid[0] * grid[1] * grid[2]
    return dict(rows_a_block=autotune.decode_row_block(rows),
                row_blocks=grid[0], grid=list(grid), blocks=blocks,
                sms=autotune.H100_SMS,
                blocks_per_sm=blocks / autotune.H100_SMS)


def _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok, shape,
                tf32x3_flops=0):
    """A timing row's bound: ``flops`` on the FP32 units and
    ``tf32x3_flops`` on the tensor cores in 3xTF32 (three TF32 products
    per fp32 product), against the bytes; with tensor-core work also the
    bound the same products would have on the FP32 units
    (``bound_ms_fp32``) and its parts."""
    t_ops = (flops / FP32_FLOPS + 3 * tf32x3_flops / TF32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops + tf32x3_flops, bytes=nbytes, max_abs_err=err,
               ok=ok)
    if tf32x3_flops:
        t_fp32 = (flops + tf32x3_flops) / FP32_FLOPS * 1e3
        row.update(bound_ms_3xtf32=max(t_ops, t_bytes),
                   bound_ms_fp32=max(t_fp32, t_bytes), ops_ms_3xtf32=t_ops,
                   bytes_ms=t_bytes)
    return row


# ---------------------------------------------------------------------------
# the device-sharded pool: K1 / K3 on head shards, the latent page strips
# ---------------------------------------------------------------------------

#: the shard counts of the head-shard and page-strip kernel cases
K3_SHARD_TPS = (2, 4, 8)
STRIP_TPS = (2, 4)
#: the timing rows' kv_len (the K2 / K3 / K4 timing list)
TIMING_KVL = (2048, 1500, 1024, 700, 300, 64, 1, 1900)


def _heads(t, dim: int, d: int, tp: int):
    """Shard ``d`` of ``tp`` of ``t`` along ``dim``, contiguous (a sharded
    pool keeps each shard as a tensor of its own)."""
    n = t.shape[dim]
    return t.narrow(dim, d * n // tp, n // tp).contiguous()


def head_shard_data(x: dict, tp: int, d: int = 0) -> dict:
    """Shard ``d`` of :func:`paged_data`'s decode step on a pool split on
    the kv-head axis: its query heads (a group each kv head), its kv
    heads of the dense cache and of the pages, the same table."""
    return dict(x, hq=x["hq"] // tp, hkv=x["hkv"] // tp,
                q=_heads(x["q"], 1, d, tp), k=_heads(x["k"], 1, d, tp),
                v=_heads(x["v"], 1, d, tp),
                k_pages=_heads(x["k_pages"], 2, d, tp),
                v_pages=_heads(x["v_pages"], 2, d, tp))


def k3_head_shard_cases(torch, gen, ops) -> list:
    """K3 on each kv-head shard of granite's K3 data (8 slots, 32 / 8
    heads, d128, a 1024-page permuted pool, the timing kv_len) at tp 2, 4
    and 8, on the fp32 pool and on fp8 codes, and of gemma2's d256 ring
    (read at eff_len) at tp 2: the shards' outputs concatenated on the
    heads against K3 on the whole pool, exactly 0.0 (K3's tiles and splits
    never see Hkv)."""
    rows = []
    kvl = list(TIMING_KVL)
    for data, name, tps, lens, codes in (
            (granite_paged_data(torch, gen), "granite d128", K3_SHARD_TPS,
             kvl, (None, "fp8_e4m3")),
            (gemma2_paged_data(torch, gen, 4096), "gemma2 d256 ring of 4096",
             (2,), [4096, 4096, 4096, 1], (None,))):
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        table = with_sentinels(data["table"], lens, data["ps"],
                               data["k_pages"].shape[0])
        for code in codes:
            kp, vp, ks, vs = data["k_pages"], data["v_pages"], None, None
            if code is not None:
                (kp, ks, _), (vp, vs, _) = _quantized(torch, (kp, vp), code)
            whole = ops.fusemax_decode_paged(data["q"], kp, vp, table,
                                             kv_len, impl="cuda", k_scale=ks,
                                             v_scale=vs)
            for tp in tps:
                parts = [ops.fusemax_decode_paged(
                    _heads(data["q"], 1, d, tp), _heads(kp, 2, d, tp),
                    _heads(vp, 2, d, tp), table, kv_len, impl="cuda",
                    k_scale=None if ks is None else _heads(ks, 2, d, tp),
                    v_scale=None if vs is None else _heads(vs, 2, d, tp))
                    for d in range(tp)]
                diff = (torch.cat(parts, dim=1) - whole).abs().max().item()
                rows.append(dict(
                    kernel="paged_decode_partials@head_shards",
                    case=f"K3 on {tp} head shards vs the whole pool, {name}"
                         f", {code or 'fp32'}", tp=tp, kv_len=lens,
                    max_abs_diff=diff, ok=diff == 0.0))
            del whole
    torch.cuda.empty_cache()
    return rows


def k1_head_shard_cases(torch, gen, ops) -> list:
    """K1 on each head shard (tp 2, 4 and 8) of a granite prefill chunk:
    2 rows, 32 / 8 heads, d128, 128 queries after 896 tokens of history
    (M 1024), causal: the shards concatenated against K1 on every head,
    exactly 0.0 (K1's tiles never see Hkv)."""
    q = _rand(torch, gen, (2, 32, 128, 128), torch.float32)
    k = _rand(torch, gen, (2, 8, 1024, 128), torch.float32)
    v = _rand(torch, gen, (2, 8, 1024, 128), torch.float32)
    kw = dict(causal=True, q_offset=896, impl="cuda")
    whole = ops.fusemax_attention(q, k, v, **kw)
    rows = []
    for tp in K3_SHARD_TPS:
        parts = [ops.fusemax_attention(_heads(q, 1, d, tp),
                                       _heads(k, 1, d, tp),
                                       _heads(v, 1, d, tp), **kw)
                 for d in range(tp)]
        diff = (torch.cat(parts, dim=1) - whole).abs().max().item()
        rows.append(dict(kernel="fusemax_prefill", case=f"K1 on {tp} head "
                         f"shards vs every head, B2 Hq32 Hkv8 P=128 after "
                         f"896 d128 causal", tp=tp, max_abs_diff=diff,
                         ok=diff == 0.0))
    return rows


def _strip_ref64(torch, q, ckv, kr, kv_len, scale, lo, hi):
    """Float64 softmax attention of a strip: the keys in [lo, hi) below
    kv_len of a dense latent view; rows with no such key are None."""
    k = torch.cat([ckv[:, lo:hi], kr[:, lo:hi]], dim=-1).double()
    s = torch.einsum("bre,bke->brk", q.double(), k) * scale
    keys = torch.arange(lo, hi, device="cuda")
    s = s.masked_fill((keys[None, :] >= kv_len[:, None].long())[:, None, :],
                      float("-inf"))
    out = torch.einsum("brk,bkf->brf", torch.softmax(s, -1),
                       ckv[:, lo:hi].double())
    return out, kv_len > lo


def strip_data(torch, gen, dec, code=None):
    """DeepSeek's decode-step latents (8 slots, 128 heads, r 512, rd 64,
    W 128, the permuted pool, the timing kv_len) as a sharded decode sees
    them: q [B, H, 1, r + rd], the pools (codes and scales on ``code``),
    the table, and the rank-complete view of the table (dequantized on a
    code pool)."""
    from repro_torch.kernels import ops
    from repro_torch.model.attention import dequantize_kv

    kvl = list(TIMING_KVL)
    x = deepseek_decode_data(torch, gen, kvl)
    b, h, r, rd = x["b"], x["h"], x["r"], x["rd"]
    ckv, kr = x["pools"]["permuted"]
    table = x["tables"]["permuted"]
    cs = krs = None
    if code is not None:
        (ckv, cs, _), (kr, krs, _) = _quantized(torch, (ckv, kr), code)
    view_c, view_k = ops.gather_pages(ckv, table), ops.gather_pages(kr, table)
    if code is not None:
        view_c = dequantize_kv(view_c, ops.gather_pages(cs, table))
        view_k = dequantize_kv(view_k, ops.gather_pages(krs, table))
    return dict(x, kvl=kvl, q4=x["q"].reshape(b, h, 1, r + rd), ckv=ckv,
                kr=kr, cs=cs, krs=krs, table=table, view=(view_c, view_k),
                code=code)


def latent_strip_cases(torch, gen, dec) -> list:
    """The latent body's page strips at DeepSeek's decode step (16 splits)
    at tp 2 and 4, fp32 and fp8 latents: every strip on the rank-complete
    view (the dense latent kernel, what the sharded decode launches) and
    on the pool (K4) against its plain version (within the latent cases'
    fp32 tolerance, and no farther from float64 than the plain version
    plus ``F64_SLACK``); the strips combined in order against K4 on the
    whole table (``strips_vs_k4``: on fp8 the strips sweep the dequantized
    view where K4 dequantizes in its tiles; both 0.0 expected)."""
    from repro_torch.kernels import ops

    rows = []
    for code in (None, "fp8_e4m3"):
        x = strip_data(torch, gen, dec, code)
        b, h, ps, w, r, rd = (x[k] for k in ("b", "h", "ps", "w", "r", "rd"))
        q4, kv_len, table = x["q4"], x["kv_len"], x["table"]
        scale = (r + rd) ** -0.5
        whole = ops.fusemax_mla_decode_paged(
            q4, x["ckv"], x["kr"], table, kv_len, impl="cuda",
            ckv_scale=x["cs"], krope_scale=x["krs"])
        for tp in STRIP_TPS:
            splits, block_k, strips = ops.mla_strips(
                w, ps, h, r, rd, tp, elem_bytes=x["ckv"].element_size())
            for src, label in (("view", "latent_decode_partials@strip"),
                               ("pool", "mla_paged_decode_partials@strip")):
                parts = []
                for d, (first, n) in enumerate(strips):
                    kw = dict(splits=splits, block_k=block_k,
                              split_first=first, n_splits=n, scale=scale)
                    if src == "view":
                        args = (q4, *x["view"], kv_len)
                    else:
                        args = (q4, x["ckv"], x["kr"], kv_len)
                        kw.update(block_table=table, ckv_scale=x["cs"],
                                  krope_scale=x["krs"])
                    got = ops.fusemax_mla_decode_strip(*args, impl="cuda",
                                                       **kw)
                    plain = ops.fusemax_mla_decode_strip(*args, impl="torch",
                                                         **kw)
                    parts.append(got)
                    out = ops.combine_strips([got], q4)[:, :, 0]
                    ref = ops.combine_strips([plain], q4)[:, :, 0]
                    torch.cuda.synchronize()
                    err, ok, atol, rtol = _err(torch, out, ref, "float32")
                    lo, hi = first * (w // splits) * ps, \
                        (first + n) * (w // splits) * ps
                    r64, live = _strip_ref64(torch, q4[:, :, 0], *x["view"],
                                             kv_len, scale, lo, hi)
                    vs = {"kernel": (out.double() - r64)[live].abs().max()
                          .item(), "plain": (ref.double() - r64)[live].abs()
                          .max().item()}
                    f64_ok = vs["kernel"] <= vs["plain"] + F64_SLACK
                    rows.append(dict(
                        kernel=label, case=f"strip {d} of {tp} (splits "
                        f"{first}..{first + n - 1} of {splits}, keys "
                        f"{lo}..{hi - 1}) on the {src}, {code or 'fp32'}",
                        tp=tp, max_abs_err=err, atol=atol, rtol=rtol,
                        ok=ok and f64_ok, ok_vs_plain=ok, ok_vs_f64=f64_ok,
                        f64_slack=F64_SLACK, vs_f64=vs))
                    del r64
                diff = (ops.combine_strips(parts, q4) - whole).abs()
                rows.append(dict(
                    kernel=label, case=f"strips_vs_k4: {tp} strips on the "
                    f"{src} combined vs K4 on the whole table, "
                    f"{code or 'fp32'}", tp=tp, splits=splits,
                    max_abs_diff=diff.max().item(),
                    ok=diff.max().item() == 0.0))
        del x, whole
        torch.cuda.empty_cache()
    return rows


def time_head_shards(torch, gen, dec, ops, autotune) -> dict:
    """K3 on one head shard of granite's K3 timing data at tp 2, 4 and 8
    (:func:`time_k3` on shard 0: its queries, kv heads and pages; the
    bound counts that shard's bytes)."""
    x = granite_paged_data(torch, gen)
    out = {f"paged_decode_partials@head_shard_tp{tp}": dict(
        time_k3(torch, gen, dec, ops, autotune, x=head_shard_data(x, tp)),
        tp=tp) for tp in K3_SHARD_TPS}
    torch.cuda.empty_cache()
    return out


def time_strips(torch, gen, dec, ops, autotune) -> dict:
    """The latent kernel on one page strip of DeepSeek's decode step at tp
    2 and 4 (16 splits: strip 0, the one every slot's keys reach, on the
    rank-complete view, as the sharded decode launches it; every strip's
    ``ms`` beside it), its plain version, SDPA on the strip's keys (the
    library yardstick) and the bound of that strip's keys: latent rows
    read once, the partials of its splits written once, the 3xTF32
    products of its (key, row) pairs."""
    x = strip_data(torch, gen, dec)
    b, h, ps, w, r, rd = (x[k] for k in ("b", "h", "ps", "w", "r", "rd"))
    q4, kv_len, kvl = x["q4"], x["kv_len"], x["kvl"]
    view_c, view_k = x["view"]
    scale = (r + rd) ** -0.5
    out = {}
    for tp in STRIP_TPS:
        splits, block_k, strips = ops.mla_strips(w, ps, h, r, rd, tp)
        split_len = (w // splits) * ps

        def launch(first, n, impl="cuda"):
            return lambda: ops.fusemax_mla_decode_strip(
                q4, view_c, view_k, kv_len, splits=splits, block_k=block_k,
                split_first=first, n_splits=n, scale=scale, impl=impl)

        first, n = strips[0]
        lo, hi = first * split_len, (first + n) * split_len
        got = ops.combine_strips([launch(first, n)()], q4)
        ref = ops.combine_strips([launch(first, n, "torch")()], q4)
        torch.cuda.synchronize()
        err, ok, _, _ = _err(torch, got, ref, "float32")
        ms = time_ms(torch, launch(first, n))
        dev_ms = device_ms(torch, launch(first, n),
                           "latent_decode_partials_kernel")
        plain_ms = time_ms(torch, launch(first, n, "torch"), iters=5,
                           warmup=1)
        q_f = x["q"]
        strip_len = torch.clamp(kv_len - lo, 0, hi - lo).to(torch.int32)
        library_ms = time_ms(torch, _latent_library(
            torch, ops, q_f, view_c[:, lo:hi].contiguous(),
            view_k[:, lo:hi].contiguous(), torch.clamp(strip_len, min=1),
            1, h, scale))
        keys = [max(0, min(k, hi) - lo) for k in kvl]
        reads = sum(keys)
        nbytes = (4 * reads * (r + rd) + 4 * q_f.numel() + 4 * b
                  + 4 * b * n * h * (r + 2))
        flops = 2 * h * reads * (2 * r + rd)
        row = _timing_row(ms, plain_ms, library_ms, 0, nbytes, err, ok,
                          shape=f"strip 0 of {tp}: splits {first}.."
                                f"{first + n - 1} "
                                f"of {splits} (keys {lo}..{hi - 1}) of B{b} "
                                f"H{h} r{r} rd{rd} W {w} page_size {ps}, "
                                f"the rank-complete view, fp32 kv_len {kvl}",
                          tf32x3_flops=flops)
        row.update(tp=tp, device_ms=dev_ms,
                   device_share_of_bound=row["bound_ms"] / dev_ms,
                   ms_by_strip=[time_ms(torch, launch(f, m))
                                for f, m in strips],
                   library="SDPA on the strip's keys")
        out[f"latent_decode_partials@strip_tp{tp}"] = row
    del x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the sequence-sharded dense cache: K2 on slot strips
# ---------------------------------------------------------------------------

#: K2 strip cases: (label, B, Hq, Hkv, M, D, kv_len, P, window, strip
#: counts) — granite's decode data at 2 / 4 / 16 strips, a window, a
#: P = 13 chain, and gemma2's d256 data on its 16-way model axis
K2_STRIP_CASES = (
    ("granite", 8, 32, 8, 2048, 128, TIMING_KVL, 1, None, (2, 4, 16)),
    ("granite window 700", 8, 32, 8, 2048, 128, TIMING_KVL, 1, 700, (4,)),
    ("granite P=13", 8, 32, 8, 2048, 128,
     (2035, 1500, 1024, 700, 300, 64, 1, 1900), 13, None, (4,)),
    ("gemma2 d256", 4, 16, 8, 8192, 256, (8192, 5000, 4601, 300), 1, None,
     (16,)),
)
#: the seq-sharded decode's split count (gemma2's 16-way model axis)
SEQ_SPLITS = 16


def _k2_strip_data(torch, gen, b, hq, hkv, m, d, kvl, p):
    q = _rand(torch, gen, (b, hq, p, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    return q, k, v, torch.tensor(list(kvl), dtype=torch.int32, device="cuda")


def k2_strip_cases(torch, gen, dec) -> list:
    """K2 on the slot strips of a sequence-sharded dense cache
    (:data:`K2_STRIP_CASES`, ``SEQ_SPLITS`` splits): each strip launched on
    a K/V that hold only its keys against its plain version (fp32
    tolerance), and the strips' partials concatenated in strip order
    against K2's whole call on the whole cache (``strips_vs_whole``:
    bit-equal partials, and the combined outputs' max abs difference
    0.0); ``tp`` 3 (not dividing the splits) must raise."""
    from repro_torch.kernels import ops

    rows = []
    for label, b, hq, hkv, m, d, kvl, p, window, tps in K2_STRIP_CASES:
        q, k, v, kv_len = _k2_strip_data(torch, gen, b, hq, hkv, m, d, kvl,
                                         p)
        g = hq // hkv
        for tp in tps:
            splits, block_k, n = ops.seq_strips(m, g, d, d, tp, p=p,
                                                splits=SEQ_SPLITS)
            kw = dict(splits=splits, block_k=block_k, window=window)
            whole = ops.fusemax_decode_strip(q, k, v, kv_len, split_first=0,
                                             n_splits=splits, impl="cuda",
                                             **kw)
            parts = []
            ms = m // tp
            for j in range(tp):
                ks = k[:, :, j * ms:(j + 1) * ms].contiguous()
                vs = v[:, :, j * ms:(j + 1) * ms].contiguous()
                got = ops.fusemax_decode_strip(q, ks, vs, kv_len,
                                               split_first=j * n,
                                               n_splits=n, impl="cuda", **kw)
                plain = ops.fusemax_decode_strip(q, ks, vs, kv_len,
                                                 split_first=j * n,
                                                 n_splits=n, impl="torch",
                                                 **kw)
                parts.append(got)
                out = dec.combine_partials(*got, torch.float32)
                ref = dec.combine_partials(*plain, torch.float32)
                torch.cuda.synchronize()
                err, ok, atol, rtol = _err(torch, out, ref, "float32")
                equal = all(torch.equal(a, b_) for a, b_ in zip(got, plain))
                if tp <= 4 or j in (0, tp - 1):
                    rows.append(dict(
                        kernel="decode_partials@seq_strip",
                        case=f"{label}: strip {j} of {tp} (splits "
                        f"{j * n}..{(j + 1) * n - 1} of {splits}, keys "
                        f"{j * ms}..{(j + 1) * ms - 1})", tp=tp,
                        max_abs_err=err, atol=atol, rtol=rtol, ok=ok,
                        partials_equal_plain=equal))
                elif not ok:
                    rows.append(dict(kernel="decode_partials@seq_strip",
                                     case=f"{label}: strip {j} of {tp}",
                                     tp=tp, max_abs_err=err, ok=False))
            cat = [torch.cat([part[i] for part in parts], dim=1)
                   for i in range(3)]
            bits = all(torch.equal(a, w) for a, w in zip(cat, whole))
            diff = (dec.combine_partials(*cat, torch.float32)
                    - dec.combine_partials(*whole, torch.float32)).abs()
            rows.append(dict(
                kernel="decode_partials@seq_strip",
                case=f"strips_vs_whole: {label}, {tp} strips of {splits} "
                f"splits vs K2 on the whole cache", tp=tp, splits=splits,
                partials_bit_equal=bits, max_abs_diff=diff.max().item(),
                ok=bits and diff.max().item() == 0.0))
        del q, k, v
        torch.cuda.empty_cache()
    x = _k2_strip_data(torch, gen, 2, 8, 2, 96, 64, (96, 50), 1)
    try:
        ops.fusemax_decode_seq_sharded(x[0], list(x[1].chunk(3, 2)),
                                       list(x[2].chunk(3, 2)), x[3],
                                       impl="cuda", splits=4)
        refused = False
    except ValueError as e:
        refused = "tp=3" in str(e) and "splits=4" in str(e)
    rows.append(dict(kernel="decode_partials@seq_strip",
                     case="3 strips of a 4-split sweep must raise",
                     ok=refused))
    return rows


def time_seq_strip(torch, gen, dec, autotune) -> dict:
    """K2 on strip 0 of 16 of gemma2-9b's decode step (4 slots, 16 q over
    8 kv heads, head dim 256, an 8192-slot global cache, ``SEQ_SPLITS``
    splits; strip 0 holds keys 0..511, which every slot reaches), beside
    its plain version, SDPA on the strip's keys (the library yardstick)
    and the bound of that strip: its valid keys' K and V rows read once,
    the queries once, its partials written once; each query row's products
    with those keys on the FP32 units."""
    from repro_torch.kernels import ops

    b, hq, hkv, m, d, tp = 4, 16, 8, 8192, 256, 16
    kvl = [8192, 5000, 4601, 300]
    g = hq // hkv
    q, k, v, kv_len = _k2_strip_data(torch, gen, b, hq, hkv, m, d, kvl, 1)
    splits, block_k, n = ops.seq_strips(m, g, d, d, tp, splits=SEQ_SPLITS)
    ms = m // tp
    ks, vs = k[:, :, :ms].contiguous(), v[:, :, :ms].contiguous()

    def launch(impl="cuda"):
        return lambda: ops.fusemax_decode_strip(
            q, ks, vs, kv_len, splits=splits, block_k=block_k,
            split_first=0, n_splits=n, impl=impl)

    got, ref = launch()(), launch("torch")()
    err, ok, _, _ = _err(torch, dec.combine_partials(*got, torch.float32),
                         dec.combine_partials(*ref, torch.float32),
                         "float32")
    ms_ = time_ms(torch, launch())
    dev_ms = device_ms(torch, launch(), "DenseKV")
    plain_ms = time_ms(torch, launch("torch"), iters=5, warmup=1)
    strip_len = torch.clamp(kv_len, max=ms)
    mask = (torch.arange(ms, device="cuda")[None, :]
            < strip_len[:, None])[:, None, None, :]
    library_ms = time_ms(torch, _sdpa_fn(torch, q, ks, vs, attn_mask=mask))
    reads = sum(min(x, ms) for x in kvl)
    nbytes = (4 * 2 * reads * hkv * d + 4 * q.numel() + 4 * b
              + 4 * b * hkv * n * g * (d + 2))
    flops = 4 * d * reads * hq
    row = _timing_row(ms_, plain_ms, library_ms, flops, nbytes, err, ok,
                      shape=f"strip 0 of {tp} (splits 0..{n - 1} of "
                            f"{splits}, keys 0..{ms - 1}) of B{b} Hq{hq} "
                            f"Hkv{hkv} M{m} d{d} fp32 kv_len {kvl}")
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    return dict(row, tp=tp, device_ms=dev_ms,
                device_share_of_bound=row["bound_ms"] / dev_ms,
                library="SDPA on the strip's keys")


# ---------------------------------------------------------------------------
# 4. model cross-check
# ---------------------------------------------------------------------------

def phase_model(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens = [512, 333, 128, 45]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (len(lens), 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    streams, logits_all = {}, {}
    for name, rt in (("cuda", rt_c), ("torch", rt_t)):
        caches = tf.init_cache(cfg, len(lens), 1024, torch.float32, "cuda")
        lg, caches = tf.prefill(cfg, model, {"inputs": toks}, caches, rt,
                                true_len=true_len)
        kv = true_len.clone()
        out, lgs = [], [lg]
        for _ in range(8):
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            out.append(nxt)
            kv = kv + 1
            lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches, kv,
                                        rt)
            lgs.append(lg)
        streams[name] = torch.stack(out).cpu()
        logits_all[name] = torch.stack(lgs)
        del caches
    torch.cuda.synchronize()
    diff = (logits_all["cuda"] - logits_all["torch"]).abs().max().item()
    scale = logits_all["torch"].abs().max().item()
    match = (streams["cuda"] == streams["torch"]).float().mean().item()
    finite = bool(torch.isfinite(logits_all["cuda"]).all().item())
    rel_tol = 1e-4
    emit("model", config="granite-3-8b n_layers=4 fp32", prompts=lens,
         decode_steps=8, logits_max_abs_diff=diff, logits_max_abs=scale,
         rel_tol=rel_tol, token_match_rate=match, finite=finite)
    check(finite, "non-finite logits in the model cross-check")
    check(diff <= rel_tol * scale,
          f"cuda vs torch logits differ by {diff} > {rel_tol} x {scale}")
    check(match == 1.0, f"greedy token match rate {match} < 1")
    del model, logits_all
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "granite-3-8b", "--cache-layout", "both",
              "--requests", "16", "--slots", "8", "--prompt-len", "128",
              "--prompt-len-max", "1024", "--new-tokens", "64",
              "--max-len", "2048", "--repeats", "1", "--json", ""]

#: shared-prefix trace: 16 prompts of 300..500 tokens opening with the
#: same 256; kernels and cuBLAS are warm from the earlier phases
PREFIX_ARGS = ["--arch", "granite-3-8b", "--cache-layout", "paged",
               "--shared-prefix-len", "256", "--requests", "16", "--slots",
               "8", "--prompt-len", "300", "--prompt-len-max", "500",
               "--new-tokens", "32", "--max-len", "2048", "--repeats", "1",
               "--no-warmup", "--json", ""]

#: the decode kernel each layout's decode steps launch (GQA models; the
#: sharded pool's: K3 on each head shard)
DECODE_KERNEL = {"dense": "decode_partials", "paged": "paged_decode_partials",
                 "paged_noprefix": "paged_decode_partials",
                 "paged_nospec": "paged_decode_partials",
                 "paged_swap": "paged_decode_partials",
                 "paged_quant": "paged_decode_partials",
                 "paged_sharded": "paged_decode_partials"}
#: ... and on an MLA model (dense: K2's E != F branch; paged: K4; the
#: rank-sharded pool: the dense latent kernel on each shard's page strip)
MLA_DECODE_KERNEL = {"dense": "latent_decode_partials",
                     "paged": "mla_paged_decode_partials",
                     "paged_noprefix": "mla_paged_decode_partials",
                     "paged_nospec": "mla_paged_decode_partials",
                     "paged_quant": "mla_paged_decode_partials",
                     "paged_sharded": "latent_decode_partials"}
#: the serve phases' device-sharded pool: ``--mesh tp=2`` over the one
#: card twice (every shard on cuda:0)
SHARD_TP = 2
SHARD_ARGS = ["--mesh", f"tp={SHARD_TP}"]
DECODE_KERNELS = ("decode_partials", "paged_decode_partials",
                  "mla_paged_decode_partials", "latent_decode_partials")


def _counts(fm, dec) -> dict:
    return {"fusemax_prefill": fm.fusemax_attention_cuda.launches,
            "decode_partials": dec.decode_partials_cuda.launches,
            "paged_decode_partials": dec.paged_decode_partials_cuda.launches,
            "mla_paged_decode_partials":
                dec.mla_paged_decode_partials_cuda.launches,
            "latent_decode_partials": dec.latent_decode_partials_cuda.launches,
            # the latent kernels' launches on a strip of their splits (the
            # rank-sharded pool's decode; part of the counts above)
            "latent_decode_partials_strips":
                dec.latent_decode_partials_cuda.launches_strips,
            # K2's launches on a slot strip of a sequence-sharded cache
            "decode_partials_strips": dec.decode_partials_cuda.launches_strips,
            "mla_paged_decode_partials_strips":
                dec.mla_paged_decode_partials_cuda.launches_strips,
            "fusemax_prefill_windowed":
                fm.fusemax_attention_cuda.launches_windowed,
            "fusemax_prefill_by_dims": {
                f"{e}x{f}": n for (e, f), n in
                fm.fusemax_attention_cuda.launches_by_dims.items()},
            # the quantized pools' launches (part of the counts above)
            "paged_decode_partials_by_kv_dtype":
                dict(dec.paged_decode_partials_cuda.launches_by_code),
            "mla_paged_decode_partials_by_kv_dtype":
                dict(dec.mla_paged_decode_partials_cuda.launches_by_code),
            # the decode kernels' launches by draft positions (1: decode
            # steps; P > 1: speculative verify chains)
            "by_n_pos": {k: dict(getattr(dec, k + "_cuda").launches_by_n_pos)
                         for k in DECODE_KERNELS}}


def _zero_counts(fm, dec) -> None:
    fm.fusemax_attention_cuda.launches = 0
    fm.fusemax_attention_cuda.launches_by_dims.clear()
    fm.fusemax_attention_cuda.launches_windowed = 0
    dec.decode_partials_cuda.launches = 0
    dec.paged_decode_partials_cuda.launches = 0
    dec.mla_paged_decode_partials_cuda.launches = 0
    dec.latent_decode_partials_cuda.launches = 0
    dec.latent_decode_partials_cuda.launches_strips = 0
    dec.mla_paged_decode_partials_cuda.launches_strips = 0
    dec.decode_partials_cuda.launches_strips = 0
    dec.paged_decode_partials_cuda.launches_by_code.clear()
    dec.mla_paged_decode_partials_cuda.launches_by_code.clear()
    for k in DECODE_KERNELS:
        getattr(dec, k + "_cuda").launches_by_n_pos.clear()


def _check_legs(metrics, n_layers: int, n_req: int, new_tokens: int,
                vocab: int, decode_kernel: dict = DECODE_KERNEL,
                per_shard: Optional[dict] = None) -> dict:
    """Per layout: every stream complete and in the vocabulary, logits
    finite, and each kernel launched once per layer per dispatch (K1) or
    decode step (``decode_kernel[layout]``: K2 on the dense layout, K3 on
    the paged one; on an MLA model K2's dense latent branch and K4), the
    other decode kernels never.  ``per_shard`` maps a sharded leg to how
    many times a layer launches (K1, its decode kernel) a dispatch or
    step: once per shard where the shards split the work (GQA's head
    shards, MLA's page strips), once where they do not (MLA's prefill)."""
    legs = {}
    per_shard = per_shard or {}
    for lo, m in metrics["layouts"].items():
        disp, timed = m["dispatches"], m["kernel_launches"]
        legs[lo] = dict(tok_per_s=m["tok_per_s"], ttft_s=m["ttft_s"],
                        wall_s=m["wall_s"], warmup_s=m["warmup_s"],
                        steps_per_s=m["steps_per_s"], dispatches=disp,
                        timed_run_launches=timed, prefix=m["prefix"],
                        preemptions=m["preemptions"],
                        cache_bytes=m["memory"]["physical_cache_bytes"],
                        peak_resident_cache_bytes=m["memory"][
                            "peak_resident_cache_bytes"])
        check(m["logits_finite"], f"{lo}: non-finite logits while serving")
        k1_x, dk_x = per_shard.get(lo, (1, 1))
        check(timed["fusemax_prefill"] == k1_x * n_layers * disp["prefill"],
              f"{lo}: K1 launched {timed['fusemax_prefill']} times, "
              f"expected {k1_x} x {n_layers} x {disp['prefill']} prefill "
              f"dispatches")
        dk = decode_kernel[lo]
        check(timed[dk] == dk_x * n_layers * disp["decode_steps"],
              f"{lo}: {dk} launched {timed[dk]} times, expected "
              f"{dk_x} x {n_layers} x {disp['decode_steps']} decode steps")
        for other in set(DECODE_KERNELS) - {dk}:
            check(timed[other] == 0, f"{lo}: {other} launched "
                                     f"{timed[other]} times on this layout")
    for lo, outs in metrics["_outputs_by_layout"].items():
        check(len(outs) == n_req and all(len(o) == new_tokens
                                         for o in outs),
              f"{lo}: streams of lengths {[len(o) for o in outs]}, "
              f"expected {n_req} x {new_tokens}")
        check(all(0 <= t < vocab for o in outs for t in o),
              f"{lo}: token outside the vocabulary")
    check(metrics.get("outputs_match", True) is True,
          f"greedy streams differ across {list(metrics['layouts'])}")
    return legs


def _check_sharded(torch, metrics) -> dict:
    """The sharded leg's pool: tp shards of ``SHARD_ARGS`` on cuda:0 (the
    launcher's ``check_invariants`` at the leg's end held every shard
    tensor to its device and shape), per-device bytes x tp equal to the
    totals, and the shard tensors' own page bytes adding up to the pool."""
    mem = metrics["layouts"]["paged_sharded"]["memory"]
    sh = mem["sharding"]
    check(metrics["mesh"]["devices"] == ["cuda:0"] * SHARD_TP
          and sh["tp"] == SHARD_TP, f"sharded leg on {metrics['mesh']}, "
                                    f"sharding {sh}")
    for k in ("resident_cache_bytes", "peak_resident_cache_bytes",
              "physical_cache_bytes"):
        check(sh["per_device"][k] * SHARD_TP == mem[k],
              f"per-device {k} {sh['per_device'][k]} x {SHARD_TP} != "
              f"{mem[k]}")
    check(sh["shard_bytes"]["per_shard"] * SHARD_TP
          + sh["shard_bytes"]["replicated"] == mem["physical_cache_bytes"],
          f"shard tensors {sh['shard_bytes']} do not make up the pool's "
          f"{mem['physical_cache_bytes']} B")
    return dict(mesh=metrics["mesh"], sharding=sh,
                sharded_vs_paged_tok_per_s=metrics[
                    "sharded_vs_paged_tok_per_s"])


#: granite-3-8b's depth in the serve phase: its 40 layers cut to 10 so
#: that the script keeps a margin under its time limit on a slow host
#: (the phase took 193 s at 40 layers, 104-145 s at 20)
SERVE_LAYERS = 10

#: granite-3-8b's depth in the prefix, async, dp, speculative and swap
#: phases: 20 of its 40 layers, which frees chip_smoke's time for more
#: kernel cases (at 40 layers the five took 13.3, 25.5, 77.2, 41.9 and
#: 52.7 s of an 850 s run); every gate counts launches per layer
GRANITE_CUT_LAYERS = 20


def granite_cut():
    """granite-3-8b at full width, :data:`GRANITE_CUT_LAYERS` layers."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-3-8b"),
                               n_layers=GRANITE_CUT_LAYERS)


def phase_serve(torch, fm, dec, serve) -> dict:
    """The main path: the dense layout, the paged one and the paged pool
    sharded over two shards on the card (``SHARD_ARGS``) on the same
    trace; granite-3-8b at full width, ``SERVE_LAYERS`` of its 40
    layers."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    argv = SERVE_ARGS + SHARD_ARGS
    # the main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(argv, cfg=cfg, devices=["cuda:0"] * SHARD_TP)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       per_shard={"paged_sharded": (SHARD_TP, SHARD_TP)})
    check(list(metrics["layouts"]) == ["dense", "paged", "paged_sharded"]
          and metrics["outputs_match"] is True,
          f"serve legs {list(metrics['layouts'])}, outputs_match "
          f"{metrics.get('outputs_match')}")
    sharded = _check_sharded(torch, metrics)
    emit("serve", args=" ".join(argv), n_layers=cfg.n_layers,
         seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         **sharded, main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    for name in ("fusemax_prefill", "decode_partials",
                 "paged_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    launches["paged_sharded"] = \
        metrics["layouts"]["paged_sharded"]["kernel_launches"]
    return launches


def phase_serve_prefix(torch, fm, dec, serve) -> dict:
    """Shared-prefix traffic on the paged layout, prefix cache on vs off,
    on :data:`GRANITE_CUT_LAYERS` granite-3-8b layers."""
    cfg = granite_cut()
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(PREFIX_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 32, cfg.vocab)
    check("outputs_match" in metrics, "the prefix phase ran one layout")
    reused = metrics["layouts"]["paged"]["prefix"]["tokens_reused"]
    emit("serve_prefix", args=" ".join(PREFIX_ARGS), seconds=wall,
         layers=cfg.n_layers, legs=legs,
         outputs_match=metrics["outputs_match"], tokens_reused=reused,
         invariants="checked by the launcher after each paged leg",
         launches=launches)
    check(reused > 0, "no prefix tokens reused on shared-prefix traffic")
    return launches


# ---------------------------------------------------------------------------
# the async front end: open-loop traffic, prefill quanta, dp replicas
# ---------------------------------------------------------------------------

#: the interleave point: 12 requests, chats of 16-64 tokens with 16 new
#: tokens and every 2nd request a 1024-token prompt with 2, at 8 req/s,
#: decode a token a dispatch, 128-token prefill quanta
ASYNC_ARGS = ["--arch", "granite-3-8b", "--async", "--requests", "12",
              "--slots", "8", "--prompt-len", "16", "--prompt-len-max", "64",
              "--new-tokens", "16", "--long-prompt-len", "1024",
              "--long-every", "2", "--long-new-tokens", "2",
              "--decode-chunk", "1", "--prefill-quantum", "128",
              "--arrival-rate", "8", "--max-len", "1280", "--no-warmup",
              "--json", ""]

#: the dp point: 16 prompts of 300-500 tokens opening with the same 256,
#: two paged replicas on the one card behind the prefix-affinity router
DP_ARGS = ["--arch", "granite-3-8b", "--async", "--dp", "2",
           "--requests", "16", "--slots", "8", "--prompt-len", "300",
           "--prompt-len-max", "500", "--shared-prefix-len", "256",
           "--new-tokens", "16", "--prefill-quantum", "128",
           "--arrival-rate", "4", "--dp-arrival-rate", "2",
           "--max-len", "640", "--no-warmup", "--json", ""]


def _check_async(serve, argv, metrics, cfg) -> dict:
    """Every leg of an ``--async`` launcher run (the async engine on each
    layout, the synchronous open-loop engine, the dp replicas): every
    request served to its budget, greedy streams equal to the synchronous
    engine's, finite logits, K1 launched once per layer and prefill
    dispatch, the leg's decode kernel once per layer and decode step (K2
    on the dense layout, K3 on the paged one) and no other decode kernel;
    on the interleaved legs at least one dispatch per prefill quantum of
    every prompt.  Returns the legs' latency, dispatches and launches."""
    args = serve._parser().parse_args(argv)
    prompts, budgets = serve._async_trace(args, cfg)
    q = args.prefill_quantum
    lens = [len(p) for p in prompts]
    legs = dict(metrics["async_legs"], sync=metrics["sync_open_loop"])
    if "dp" in metrics:
        legs["dp"] = dict(metrics["dp"]["latency"],
                          dispatches=metrics["dp"]["dispatches"],
                          kernel_launches=metrics["dp"]["kernel_launches"],
                          logits_finite=metrics["dp"]["logits_finite"],
                          preemptions=metrics["dp"]["preemptions"],
                          tokens_reused=metrics["dp"]["tokens_reused"])
    out = {}
    for name, m in legs.items():
        disp, timed = m["dispatches"], m["kernel_launches"]
        check(m["served"] == len(prompts) and m["shed"] == 0
              and m["tokens"] == sum(budgets),
              f"{name}: served {m['served']} of {len(prompts)}, "
              f"{m['tokens']} of {sum(budgets)} tokens")
        check(m["logits_finite"], f"{name}: non-finite logits")
        check(timed["fusemax_prefill"] == cfg.n_layers * disp["prefill"],
              f"{name}: K1 launched {timed['fusemax_prefill']} times, "
              f"expected {cfg.n_layers} x {disp['prefill']} dispatches")
        dk = "decode_partials" if name == "dense" else "paged_decode_partials"
        check(timed[dk] == cfg.n_layers * disp["decode_steps"],
              f"{name}: {dk} launched {timed[dk]} times, expected "
              f"{cfg.n_layers} x {disp['decode_steps']} decode steps")
        for other in set(DECODE_KERNELS) - {dk}:
            check(timed[other] == 0,
                  f"{name}: {other} launched {timed[other]} times")
        if m.get("interleave"):
            reused = m["tokens_reused"]
            need = sum(-(-n // q) for n in lens) if not reused \
                else -(-(sum(lens) - reused) // q)
            check(disp["prefill"] >= need,
                  f"{name}: {disp['prefill']} prefill dispatches, at least "
                  f"{need} quanta of {q} expected")
        out[name] = dict(tok_per_s=m["tok_per_s"], ttft_s=m["ttft_s"],
                         itl_s=m["itl_s"], span_s=m["span_s"],
                         dispatches=disp, kernel_launches=timed,
                         preemptions=m["preemptions"],
                         tokens_reused=m["tokens_reused"],
                         interleave=m.get("interleave"))
    for name, outs in metrics["_outputs_by_leg"].items():
        check([len(o) for o in outs] == budgets,
              f"{name}: streams of lengths {[len(o) for o in outs]}")
        check(outs == metrics["_outputs_by_leg"]["sync"],
              f"{name}: greedy streams differ from the synchronous engine's")
    check(metrics["outputs_match"] is True, "outputs_match is not true")
    return out


def phase_serve_async(torch, fm, dec, serve) -> dict:
    """Open-loop traffic on :data:`GRANITE_CUT_LAYERS` granite-3-8b layers
    (:data:`ASYNC_ARGS`): the launcher's async legs (dense, whole prompts
    at admission; paged_noprefix and paged, 1024-token prompts in eight
    128-token quanta between decode steps, so K1 runs one row at a
    history offset and K3 decodes beside parked rows) and the synchronous
    open-loop paged engine, with :func:`_check_async`'s gates and each
    leg's interleaving; TTFT / ITL p50, p95 and p99 and
    ``itl_p95_sync_over_async`` reported, not gated (same-code serve runs
    spread 49-52 % across calls).  ``--no-warmup``: the kernels are built
    and cuBLAS is up from the earlier phases."""
    cfg = granite_cut()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # this main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(ASYNC_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_async(serve, ASYNC_ARGS, metrics, cfg)
    for name in ("paged_noprefix", "paged"):
        check(legs[name]["interleave"], f"{name}: not interleaved")
    check(not legs["dense"]["interleave"], "dense leg interleaved")
    emit("serve_async", args=" ".join(ASYNC_ARGS), n_layers=cfg.n_layers,
         seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         itl_p95_sync_over_async=metrics["itl_p95_sync_over_async"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    for name in ("fusemax_prefill", "decode_partials",
                 "paged_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on the async path")
    launches["legs"] = {n: legs[n]["kernel_launches"] for n in legs}
    return launches


def phase_serve_dp(torch, fm, dec, serve) -> dict:
    """Two paged replicas of :data:`GRANITE_CUT_LAYERS` granite-3-8b
    layers sharing one model on the card behind the prefix-affinity
    router (:data:`DP_ARGS`):
    :func:`_check_async`'s gates on every leg, the dp streams equal to
    the synchronous engine's, at least one arrival routed by prefix and
    prefix tokens reused.  ``--no-warmup`` as :func:`phase_serve_async`."""
    cfg = granite_cut()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(DP_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_async(serve, DP_ARGS, metrics, cfg)
    dp = metrics["dp"]
    emit("serve_dp", args=" ".join(DP_ARGS), n_layers=cfg.n_layers,
         seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         dp={k: dp[k] for k in ("dp", "tp", "per_replica", "tokens_reused",
                                "prefix_hits", "routing", "arrival_rate")},
         itl_p95_sync_over_async=metrics["itl_p95_sync_over_async"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(dp["outputs_match"], "dp streams differ from the sync engine's")
    check(dp["routing"]["prefix_routed"] >= 1, "no arrival routed by prefix")
    check(dp["tokens_reused"] > 0, "dp replicas reused no prefix tokens")
    launches["legs"] = {n: legs[n]["kernel_launches"] for n in legs}
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# speculative decoding: verify chains through the P > 1 branches
# ---------------------------------------------------------------------------

#: granite's chain: k = 12 drafts, P = 13 positions x G = 4 = 52 rows of
#: K2 / K3 (of their 64); DeepSeek's: k = 4, P = 5 x 128 heads = 640 rows
GRANITE_SPEC_K, MLA_SPEC_K = 12, 4


def _clone_caches(caches: list) -> list:
    return [{"attn": {n: t.clone() for n, t in c["attn"].items()}}
            for c in caches]


def phase_model_spec(torch, fm, dec) -> dict:
    """granite-3-8b at full width cut to 4 layers: prompts of 512, 333, 128
    and 45 tokens, then ``verify_step`` on a P = 13 chain (k = 12, 52 K2 /
    K3 rows a fiber) against 13 sequential ``decode_step`` calls on the
    same prefilled cache, dense and paged, with ``attn_impl`` "cuda" and
    "torch".  Gates: argmax equal at every chain position, logits within
    1e-4 of their scale (verify vs stepwise, and cuda vs torch).
    Reported: the attention read's own distance, verify rows against the
    single-token calls on the cache the steps left (layer 0, random
    queries), which is 0.0 where the split geometry is the same."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.model import attention as attn
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens = [512, 333, 128, 45]
    b, p, ps, max_len = len(lens), GRANITE_SPEC_K + 1, 16, 1024
    w = max_len // ps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b, 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    chain = torch.randint(0, cfg.vocab, (b, p), generator=gen,
                          device="cuda", dtype=torch.int32)
    q_read = _rand(torch, gen, (b, cfg.n_heads, p, cfg.dh), torch.float32)
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kv0 = true_len + 1                  # counts chain position 0
    span = torch.full((b,), p, dtype=torch.int32, device="cuda")
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    tables = {"full": perm.to(torch.int32).reshape(b, w).contiguous()}
    rel_tol, res, verify_logits = 1e-4, {}, {}
    _zero_counts(fm, dec)
    for layout in ("dense", "paged"):
        bt = None if layout == "dense" else tables
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            if bt is None:
                caches = tf.init_cache(cfg, b, max_len, torch.float32,
                                       "cuda")
                kw = {}
            else:
                caches = tf.init_paged_cache(cfg, b, {"full": b * w}, ps,
                                             torch.float32, "cuda")
                kw = dict(block_tables=bt, slot_ids=torch.arange(
                    b, device="cuda"))
            _, caches = tf.prefill(cfg, model, {"inputs": toks}, caches, rt,
                                   true_len=true_len, **kw)
            lv, ver = tf.verify_step(cfg, model, chain, _clone_caches(caches),
                                     kv0, span, rt, block_tables=bt)
            steps = []
            for j in range(p):
                lg, caches = tf.decode_step(cfg, model, chain[:, j:j + 1],
                                            caches, kv0 + j, rt,
                                            block_tables=bt)
                steps.append(lg)
            ls = torch.stack(steps, dim=1)                 # [B, P, vocab]
            a = caches[0]["attn"]
            if bt is None:
                one = ops.fusemax_decode(q_read, a["k"], a["v"], kv0,
                                         impl=rt.attn_impl)
                each = [ops.fusemax_decode(q_read[:, :, j:j + 1], a["k"],
                                           a["v"], kv0 + j,
                                           impl=rt.attn_impl)
                        for j in range(p)]
            else:
                kp, vp = (attn.pool_pages(a[n]) for n in ("k_pages",
                                                          "v_pages"))
                one = ops.fusemax_decode_paged(q_read, kp, vp, bt["full"],
                                               kv0, impl=rt.attn_impl)
                each = [ops.fusemax_decode_paged(
                    q_read[:, :, j:j + 1], kp, vp, bt["full"], kv0 + j,
                    impl=rt.attn_impl) for j in range(p)]
            read = (one - torch.cat(each, dim=2)).abs().max().item()
            torch.cuda.synchronize()
            diff = (lv - ls).abs().max().item()
            scale = ls.abs().max().item()
            same = bool((lv.argmax(-1) == ls.argmax(-1)).all().item())
            res[f"{layout}/{name}"] = dict(
                verify_vs_stepwise_logits_max_abs_diff=diff,
                logits_max_abs=scale, argmax_equal=same,
                attention_read_max_abs_diff=read,
                finite=bool(torch.isfinite(lv).all().item()))
            verify_logits[(layout, name)] = lv
            check(res[f"{layout}/{name}"]["finite"],
                  f"model_spec {layout}/{name}: non-finite verify logits")
            check(same, f"model_spec {layout}/{name}: verify argmax differs "
                        f"from stepwise decode")
            check(diff <= rel_tol * scale,
                  f"model_spec {layout}/{name}: verify vs stepwise logits "
                  f"differ by {diff} > {rel_tol} x {scale}")
            del caches, ver
    impls = {}
    for layout in ("dense", "paged"):
        c, t = verify_logits[(layout, "cuda")], verify_logits[(layout,
                                                               "torch")]
        diff = (c - t).abs().max().item()
        scale = t.abs().max().item()
        same = bool((c.argmax(-1) == t.argmax(-1)).all().item())
        impls[layout] = dict(logits_max_abs_diff=diff, logits_max_abs=scale,
                             argmax_equal=same)
        check(same and diff <= rel_tol * scale,
              f"model_spec {layout}: cuda vs torch verify logits differ by "
              f"{diff} (scale {scale}), argmax equal {same}")
    launches = _counts(fm, dec)
    emit("model_spec", config="granite-3-8b n_layers=4 fp32", prompts=lens,
         chain_positions=p, rows_per_fiber=p * cfg.n_heads // cfg.n_kv_heads,
         rel_tol=rel_tol, runs=res, cuda_vs_torch=impls,
         cuda_launches_by_n_pos=launches["by_n_pos"])
    for k in ("decode_partials", "paged_decode_partials"):
        check(launches["by_n_pos"][k].get(p, 0) > 0,
              f"{k} never launched at n_pos = {p}")
    del model, verify_logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SPEC_ARGS = ["--arch", "granite-3-8b", "--cache-layout", "both",
             "--requests", "8", "--slots", "8", "--prompt-len", "128",
             "--prompt-len-max", "512", "--new-tokens", "64", "--max-len",
             "2048", "--page-size", "16", "--speculate",
             str(GRANITE_SPEC_K), "--duplicates", "8", "--repeats", "1",
             "--no-warmup", "--json", ""]


def _trace_prompts(serve, argv, vocab: int) -> list:
    """The prompts the launcher serves for ``argv`` (its seeded trace, the
    duplicates resending the first ones)."""
    import numpy as np

    args = serve._parser().parse_args(argv)
    lens = serve._trace_lens(args)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in lens]
    return prompts + [prompts[j % len(prompts)]
                      for j in range(args.duplicates)]


def _first_divergence(torch, serve, argv, cfg, outputs: dict,
                      base: str) -> dict:
    """Where a leg's greedy stream first leaves ``base``'s: the leg, the
    request, the position, both tokens, and the top-2 gap of the base
    leg's logits there (a fresh forward pass of the same seeded model on
    the prompt and the base stream before that position)."""
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    for leg, outs in outputs.items():
        for i, (a, o) in enumerate(zip(outputs[base], outs)):
            j = next((j for j, (x, y) in enumerate(zip(a, o)) if x != y),
                     None)
            if j is None:
                continue
            prompt = _trace_prompts(serve, argv, cfg.vocab)[i]
            rt = Runtime(activation_dtype=torch.float32,
                         param_dtype=torch.float32)
            gc.collect()
            torch.cuda.empty_cache()
            model = tf.init(cfg, 0, rt, device="cuda")
            ids = torch.tensor(list(prompt) + a[:j], dtype=torch.int32,
                               device="cuda")[None]
            top = tf.forward(cfg, model, {"inputs": ids}, rt)[0, -1] \
                .topk(2).values
            del model
            return dict(leg=leg, base=base, request=i, position=j,
                        base_token=a[j], leg_token=o[j],
                        base_top2_gap=(top[0] - top[1]).item())
    return {}


def _check_spec_legs(torch, serve, argv, cfg, metrics, p: int,
                     decode_kernel: dict, phase: str) -> dict:
    """The gates of a speculative serve: equal streams across the
    speculative legs and ``paged_nospec`` (or the first divergence and its
    top-2 gap, then a failure), drafts accepted, the pool drained of draft
    pages, and in each speculative leg's timed run the decode kernel
    launched at ``n_pos = p`` exactly once per layer and verify dispatch
    (and never at another n_pos > 1); the non-speculative leg never at
    n_pos > 1."""
    if metrics.get("outputs_match") is not True:
        where = _first_divergence(torch, serve, argv, cfg,
                                  metrics["_outputs_by_layout"],
                                  "paged_nospec")
        emit(phase + "_divergence", **where)
        check(False, f"{phase}: greedy streams differ: {where}")
    out = {}
    for lo, m in metrics["layouts"].items():
        k = decode_kernel[lo]
        by_n = m["kernel_launches_by_n_pos"][k]
        verify = {n: c for n, c in by_n.items() if n > 1}
        sp = m.get("speculation")
        out[lo] = dict(speculation=sp, launches_by_n_pos={
            str(n): c for n, c in sorted(by_n.items())},
            draft_pages=m["memory"].get("draft_pages"))
        if lo.endswith("_nospec"):
            check(not verify, f"{phase} {lo}: {k} launched at {verify}")
            continue
        check(sp["dispatches"] > 0 and sp["accepted"] > 0,
              f"{phase} {lo}: speculation {sp}")
        check(verify == {p: cfg.n_layers * sp["dispatches"]},
              f"{phase} {lo}: {k} launched {verify} at n_pos > 1, expected "
              f"{{{p}: {cfg.n_layers} x {sp['dispatches']} verify "
              f"dispatches}}")
        if lo != "dense":
            check(m["memory"]["draft_pages"] == {"full": 0},
                  f"{phase} {lo}: draft pages left {m['memory']}")
    return out


def phase_serve_spec(torch, fm, dec, serve) -> dict:
    """Speculative decoding on :data:`GRANITE_CUT_LAYERS` layers of
    granite-3-8b at full width: the launcher
    with ``--cache-layout both --speculate 12 --duplicates 8`` (8 prompts
    of 128-512 tokens, then their 8 resends, which FIFO admission sends
    after the originals complete: the cross-request drafting traffic of
    repeated or popular queries), 64 new tokens, 8 slots: the dense and
    paged legs speculative through K2 / K3 at n_pos = 13, ``paged_nospec``
    the same trace without; streams equal across the three."""
    cfg = granite_cut()
    torch.cuda.reset_peak_memory_stats()
    # a main path of this slice: counts set to 0 just before, read after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(SPEC_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    check(list(metrics["layouts"]) == ["dense", "paged", "paged_nospec"],
          f"serve_spec served {list(metrics['layouts'])}")
    spec = _check_spec_legs(torch, serve, SPEC_ARGS, cfg, metrics,
                            GRANITE_SPEC_K + 1, DECODE_KERNEL, "serve_spec")
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab)
    emit("serve_spec", args=" ".join(SPEC_ARGS), n_layers=cfg.n_layers,
         seconds=wall, legs=legs,
         speculation_by_leg=spec, speculation=metrics["speculation"],
         outputs_match=metrics["outputs_match"],
         invariants="checked by the launcher after each paged leg",
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: speculation lengths past K2/K3's old 64-row limit (fault F2): granite's
#: G = 4 folds k + 1 = 17 and 32 chain positions into 68 and 128 rows
ROWS_SPEC_KS = (16, 31)


def _rows_spec_args(k: int) -> list:
    """The serve_spec trace and legs at ``--speculate k``."""
    argv = list(SPEC_ARGS)
    argv[argv.index("--speculate") + 1] = str(k)
    return argv


def phase_serve_spec_rows(torch, fm, dec, serve) -> dict:
    """Speculation past 64 verify rows a fiber: granite-3-8b at full width
    cut to 4 layers, the serve_spec trace with ``--speculate 16`` (P = 17,
    68 rows) and then ``--speculate 31`` (P = 32, 128 rows), ``--cache-
    layout both``: streams equal across dense, paged and ``paged_nospec``,
    and K2 (dense) / K3 (paged) launched at n_pos = P 4 x verify
    dispatches.  Returns the launches by speculation length."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    out, by_k = {}, {}
    for k in ROWS_SPEC_KS:
        argv = _rows_spec_args(k)
        # a main path of this slice: counts set to 0 just before, read after
        _zero_counts(fm, dec)
        t0 = time.perf_counter()
        metrics = serve.main(argv, cfg=cfg)
        wall = time.perf_counter() - t0
        launches = _counts(fm, dec)
        check(list(metrics["layouts"]) == ["dense", "paged", "paged_nospec"],
              f"serve_spec_rows served {list(metrics['layouts'])}")
        spec = _check_spec_legs(torch, serve, argv, cfg, metrics, k + 1,
                                DECODE_KERNEL, "serve_spec_rows")
        legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab)
        by_k[k] = dict(args=" ".join(argv), seconds=wall,
                       rows_per_fiber=(k + 1) * 4, legs=legs,
                       speculation_by_leg=spec,
                       speculation=metrics["speculation"],
                       outputs_match=metrics["outputs_match"],
                       main_path_launches=launches)
        out[k + 1] = launches
    emit("serve_spec_rows", config="granite-3-8b n_layers=4 fp32",
         by_speculate=by_k)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# quantized pages and the host swap tier (granite-3-8b)
# ---------------------------------------------------------------------------

def phase_model_quant(torch, fm, dec) -> dict:
    """granite-3-8b at full width cut to 4 layers on quantized paged pools
    (each code dtype), ``attn_impl`` "cuda" and "torch" on the same
    weights: prompts of 512, 333, 128 and 45 prefilled in two 256-token
    chunks (the second reads the dequantized history), then 8 greedy
    decode steps through K3's quantized branch.  Equal tokens, logits
    within 1e-4 of their scale.  Returns the cuda runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens = [512, 333, 128, 45]
    b, chunk, ps, max_len = len(lens), 256, 16, 1024
    w = max_len // ps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    tables = {"full": perm.to(torch.int32).reshape(b, w).contiguous()}
    slot_ids = torch.arange(b, device="cuda")
    rel_tol, per_dtype = 1e-4, {}
    _zero_counts(fm, dec)
    for kv in QUANT_KV:
        streams, logits_all = {}, {}
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            caches = tf.init_paged_cache(cfg, b, {"full": b * w}, ps,
                                         torch.float32, "cuda", kv)
            lg = torch.zeros((b, cfg.vocab), device="cuda")
            for off in (0, chunk):
                part, caches = tf.prefill(
                    cfg, model, {"inputs": toks[:, off:off + chunk]}, caches,
                    rt, kv_offset=off, true_len=true_len,
                    block_tables=tables, slot_ids=slot_ids)
                sel = (true_len - 1 >= off) & (true_len - 1 < off + chunk)
                lg = torch.where(sel[:, None], part, lg)
            kvl = true_len.clone()
            out, lgs = [], [lg]
            for _ in range(8):
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(nxt)
                kvl = kvl + 1
                lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches,
                                            kvl, rt, block_tables=tables)
                lgs.append(lg)
            streams[name] = torch.stack(out).cpu()
            logits_all[name] = torch.stack(lgs)
            del caches
        torch.cuda.synchronize()
        diff = (logits_all["cuda"] - logits_all["torch"]).abs().max().item()
        scale = logits_all["torch"].abs().max().item()
        match = (streams["cuda"] == streams["torch"]).float().mean().item()
        finite = bool(torch.isfinite(logits_all["cuda"]).all().item())
        per_dtype[kv] = dict(logits_max_abs_diff=diff, logits_max_abs=scale,
                             token_match_rate=match, finite=finite)
        check(finite, f"{kv}: non-finite logits in the quantized model check")
        check(diff <= rel_tol * scale,
              f"{kv}: cuda vs torch logits differ by {diff} > {rel_tol} x "
              f"{scale}")
        check(match == 1.0, f"{kv}: greedy token match rate {match} < 1")
    launches = _counts(fm, dec)
    emit("model_quant", config="granite-3-8b n_layers=4 fp32 weights, "
         "quantized paged pools", prompts=lens,
         prefill_chunks=[[0, chunk], [chunk, 2 * chunk]], decode_steps=8,
         rel_tol=rel_tol, by_kv_dtype=per_dtype, cuda_launches=launches)
    by_code = launches["paged_decode_partials_by_kv_dtype"]
    check(by_code == {kv: cfg.n_layers * 8 for kv in QUANT_KV},
          f"K3's quantized branch launched {by_code}, expected "
          f"{cfg.n_layers} x 8 decode steps per code dtype")
    del model, logits_all
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _quant_args(kv_dtype: str, warmup: bool) -> list:
    """The serve cell's trace on the paged layout with a quantized leg."""
    args = ["--arch", "granite-3-8b", "--cache-layout", "paged",
            "--kv-dtype", kv_dtype, "--requests", "16", "--slots", "8",
            "--prompt-len", "128", "--prompt-len-max", "1024",
            "--new-tokens", "64", "--max-len", "2048", "--page-size", "16",
            "--repeats", "1", "--json", ""]
    return args if warmup else args + ["--no-warmup"]


#: granite-3-8b's depth in the serve_quant phase (its two runs took
#: 99-141 s at 20 layers, 52.8-56.6 s at 10); the resident-KV gate is a
#: ratio and the launch gates count per layer
QUANT_LAYERS = 5


def phase_serve_quant(torch, fm, dec, serve) -> dict:
    """granite-3-8b at full width (fp32 weights), its depth cut to
    ``QUANT_LAYERS`` of 40 to keep the script inside its time limit,
    serving the serve cell's trace on the paged layout and on quantized
    pages, fp8 e4m3 then int8 (the launcher's ``paged_quant`` leg): per
    leg tok/s, TTFT, peak resident KV bytes (the quantized leg's against
    the fp32 paged leg's: codes plus fp16 scales, 25.4 % at head dim 128),
    the launcher's ``quant_quality`` (reported, not a gate), and K3
    launched layers x decode steps, through its quantized branch in the
    quantized leg.  Returns the launches of each run, by code dtype."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              n_layers=QUANT_LAYERS)
    out, runs = {}, {}
    for kv, warmup in (("fp8_e4m3", True), ("int8", False)):
        args = _quant_args(kv, warmup)
        # this code dtype's main path: counts set to 0 just before it
        _zero_counts(fm, dec)
        t0 = time.perf_counter()
        metrics = serve.main(args, cfg=cfg)
        wall = time.perf_counter() - t0
        launches = _counts(fm, dec)
        legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab)
        quant = metrics["layouts"]["paged_quant"]
        peak = {lo: m["memory"]["peak_resident_cache_bytes"]
                for lo, m in metrics["layouts"].items()}
        ratio = peak["paged_quant"] / peak["paged"]
        steps = quant["dispatches"]["decode_steps"]
        by_code = quant["kernel_launches_by_kv_dtype"][
            "paged_decode_partials"]
        emit("serve_quant", args=" ".join(args), kv_dtype=kv, seconds=wall,
             legs=legs, peak_resident_cache_bytes=peak,
             quant_over_fp32_peak_resident=ratio,
             bytes_per_page={lo: m["memory"]["physical_cache_bytes"]
                             // max(1, m["memory"]["num_pages"]["full"])
                             for lo, m in metrics["layouts"].items()},
             quant_quality=metrics["quant_quality"],
             main_path_launches=launches)
        check(by_code == {kv: cfg.n_layers * steps},
              f"{kv}: K3's quantized branch launched {by_code} times in the "
              f"quantized leg, expected {cfg.n_layers} x {steps} decode "
              f"steps")
        check(ratio <= 0.27, f"{kv}: quantized peak resident KV is "
                             f"{ratio:.4f} of the fp32 leg's, above 0.27")
        out[kv] = dict(tok_per_s=quant["tok_per_s"], ttft_s=quant["ttft_s"],
                       ratio=ratio, quality=metrics["quant_quality"])
        runs[kv] = launches
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def _swap_waves(cfg):
    """The swap cell's traffic: wave 1, 8 prompts opening with the same 256
    tokens (tails of 144-240); wave 2, 8 unrelated prompts of 400-560
    tokens, which evict wave 1's chains from a 320-page pool; wave 3,
    wave 1 resent.  Seed 0, 32 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 256)
    wave1 = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)])
             .astype(np.int32) for n in rng.integers(144, 241, 8)]
    wave2 = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in rng.integers(400, 561, 8)]
    return [wave1, wave2, [p.copy() for p in wave1]]


SWAP_POOL_PAGES = 320
SWAP_HOST_BYTES = 8 << 30


def phase_serve_swap(torch, fm, dec) -> dict:
    """granite-3-8b at full width (:data:`GRANITE_CUT_LAYERS` layers, fp32
    weights) on the swap
    cell's three waves (:func:`_swap_waves`) through ``ServeEngine``: a
    320-page pool with an 8 GiB host swap tier against a pool that never
    evicts (1024 pages), unquantized and with fp8 e4m3 pages.  Wave 2
    must demote wave 1's chains (>= 16 pages) and wave 3 must promote them
    back (>= 16 pages, prefix hits), and every stream must equal the
    never-evicting pool's, bit for bit.  Reports the swap tier's host ms
    of demotion and promotion."""
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime
    from repro_torch.serving import Request, ServeEngine

    cfg = granite_cut()
    rt = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                 param_dtype=torch.float32)
    model = tf.init(cfg, 0, rt, device="cuda")
    waves = _swap_waves(cfg)
    result, runs = {}, {}
    _zero_counts(fm, dec)
    for kv in (None, "fp8_e4m3"):
        streams = {}
        for label, kw in (("never", {}),
                          ("swap", dict(num_pages=SWAP_POOL_PAGES,
                                        host_swap_bytes=SWAP_HOST_BYTES))):
            engine = ServeEngine(cfg, model, slots=8, max_len=2048, rt=rt,
                                 cache_layout="paged", page_size=16,
                                 kv_dtype=kv, device="cuda", **kw)
            out, wave_s = [], []
            for w, prompts in enumerate(waves):
                reqs = [Request(rid=100 * w + i, prompt=p,
                                max_new_tokens=32)
                        for i, p in enumerate(prompts)]
                t0 = time.perf_counter()
                for r in reqs:
                    engine.submit(r)
                engine.run()
                torch.cuda.synchronize()
                wave_s.append(time.perf_counter() - t0)
                check(all(r.done and len(r.generated) == 32 for r in reqs),
                      f"{kv} {label}: a request of wave {w + 1} did not "
                      f"finish")
                out.append([list(r.generated) for r in reqs])
            engine.kv.check_invariants()
            check(engine.logits_finite(), f"{kv} {label}: non-finite logits")
            streams[label] = out
            runs[(kv, label)] = dict(
                wave_s=wave_s, stats=dict(engine.stats),
                host_tier=engine.memory_stats()["host_tier"],
                host_swap_ms=dict(engine.kv.swap_ms),
                pool_pages=engine.kv.classes["full"].pool.num_pages,
                bytes_per_page=engine.kv.classes["full"].bytes_per_page)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        swap = runs[(kv, "swap")]
        name = kv or "fp32"
        result[name] = dict(
            streams_equal=streams["swap"] == streams["never"],
            demotions=swap["host_tier"]["demotions"],
            promotions=swap["host_tier"]["promotions"],
            prefix_hits=swap["stats"]["prefix_hits"],
            tokens_reused=swap["stats"]["tokens_reused"],
            demote_host_ms=swap["host_swap_ms"]["demote"],
            promote_host_ms=swap["host_swap_ms"]["promote"],
            never=runs[(kv, "never")], swap=swap)
    launches = _counts(fm, dec)
    emit("serve_swap",
         config=f"granite-3-8b n_layers={cfg.n_layers} fp32 weights",
         waves=[[len(p) for p in w] for w in waves], new_tokens=32,
         pool_pages=SWAP_POOL_PAGES, host_swap_bytes=SWAP_HOST_BYTES,
         by_kv_dtype=result, launches=launches)
    for name, r in result.items():
        check(r["streams_equal"], f"{name}: swap-tier streams differ from "
                                  f"the never-evicting pool's")
        check(r["demotions"] >= 16 and r["promotions"] >= 16,
              f"{name}: {r['demotions']} demotions, {r['promotions']} "
              f"promotions (need >= 16 each)")
        check(r["prefix_hits"] > 0, f"{name}: no prefix hit after the "
                                    f"promotions")
    check(launches["paged_decode_partials_by_kv_dtype"].get("fp8_e4m3", 0)
          > 0, "the fp8 swap run never launched K3's quantized branch")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# gemma2-9b: sliding-window rings, attention and final softcaps
# ---------------------------------------------------------------------------

def _gemma2_prefill_rows(torch, tf, cfg, model, rt, caches, toks, lens,
                         chunk, paged):
    """Prefill each prompt into its own slot: row 0 whole, every later row
    in ``chunk``-token pieces (the ring continuation reads its history
    band).  Dense: through a one-row cache scattered into the slot row;
    paged: straight into the pools through the slot's tables.  Returns the
    last-token logits [rows, vocab]."""
    out = []
    for i, n in enumerate(lens):
        pieces = [(0, n)] if i == 0 else \
            [(o, min(chunk, n - o)) for o in range(0, n, chunk)]
        slot = torch.tensor([i], device="cuda")
        true_len = torch.tensor([n], dtype=torch.int32, device="cuda")
        sub = caches if paged else tf.init_cache(cfg, 1, n, torch.float32,
                                                 "cuda")
        kw = dict(block_tables=paged, slot_ids=slot) if paged else {}
        for off, c in pieces:
            lg, sub = tf.prefill(cfg, model,
                                 {"inputs": toks[i:i + 1, off:off + c]}, sub,
                                 rt, kv_offset=off, true_len=true_len, **kw)
        if not paged:
            tf.scatter_cache_slots(cfg, caches, sub, slot)
        out.append(lg)
    return torch.cat(out)


def phase_model_gemma2(torch, fm, dec) -> dict:
    """4 full-width gemma2-9b layers (local, global, local, global), fp32:
    prompts of 4600 and 5000 tokens, one prefilled whole and one in
    2048-token chunks, then 8 greedy decode steps, on the dense and the
    paged layout, with ``attn_impl`` "cuda" and "torch" on the same
    weights: logits within 1e-4 of their scale, equal tokens, and dense =
    paged; then the dense leg's decode on the sequence-sharded cache
    (:func:`_gemma2_seq_sharded`, whose record it returns)."""
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=4)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens, chunk, ps, max_len = [4600, 5000], 2048, 16, 8192
    window = cfg.layer_specs()[0].window
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (len(lens), max(lens)), generator=gen,
                         device="cuda", dtype=torch.int32)
    b = len(lens)
    widths = {"full": max_len // ps, f"w{window}": -(-window // ps)}
    tables = {k: torch.randperm(b * w, generator=gen, device="cuda")
              .to(torch.int32).reshape(b, w).contiguous()
              for k, w in widths.items()}
    streams, logits_all, launches = {}, {}, {}
    for layout in ("dense", "paged"):
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            _zero_counts(fm, dec)
            paged = tables if layout == "paged" else None
            caches = tf.init_paged_cache(
                cfg, b, {k: b * w for k, w in widths.items()}, ps,
                torch.float32, "cuda") if paged else \
                tf.init_cache(cfg, b, max_len, torch.float32, "cuda")
            lg = _gemma2_prefill_rows(torch, tf, cfg, model, rt, caches,
                                      toks, lens, chunk, paged)
            if layout == "dense" and name == "cuda":
                prefilled = (_clone_caches(caches), lg.clone())
            kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out, lgs = [], [lg]
            for _ in range(8):
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(nxt)
                kv = kv + 1
                lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches,
                                            kv, rt, block_tables=paged)
                lgs.append(lg)
            streams[layout, name] = torch.stack(out).cpu()
            logits_all[layout, name] = torch.stack(lgs)
            launches[layout, name] = _counts(fm, dec)
            del caches
    torch.cuda.synchronize()
    rel_tol = 1e-4
    res = {}
    for layout in ("dense", "paged"):
        c, t = logits_all[layout, "cuda"], logits_all[layout, "torch"]
        res[layout] = dict(
            logits_max_abs_diff=(c - t).abs().max().item(),
            logits_max_abs=t.abs().max().item(),
            token_match_rate=(streams[layout, "cuda"]
                              == streams[layout, "torch"]).float().mean()
            .item(),
            finite=bool(torch.isfinite(c).all().item()),
            cuda_launches=launches[layout, "cuda"],
            torch_launches=launches[layout, "torch"])
    dense_paged = (logits_all["dense", "cuda"]
                   - logits_all["paged", "cuda"]).abs().max().item()
    streams_equal = bool(torch.equal(streams["dense", "cuda"],
                                     streams["paged", "cuda"]))
    emit("model_gemma2", config="gemma2-9b n_layers=4 (local, global, "
         "local, global) fp32", prompts=lens, window=window,
         prefill=["whole", f"{chunk}-token chunks"], decode_steps=8,
         rel_tol=rel_tol, layouts=res,
         dense_vs_paged_logits_max_abs_diff=dense_paged,
         dense_vs_paged_streams_equal=streams_equal)
    for layout, r in res.items():
        check(r["finite"], f"{layout}: non-finite logits in the gemma2 check")
        check(r["logits_max_abs_diff"] <= rel_tol * r["logits_max_abs"],
              f"gemma2 {layout}: cuda vs torch logits differ by "
              f"{r['logits_max_abs_diff']} > {rel_tol} x "
              f"{r['logits_max_abs']}")
        check(r["token_match_rate"] == 1.0,
              f"gemma2 {layout}: token match rate {r['token_match_rate']}")
        n_k1 = r["cuda_launches"]["fusemax_prefill_by_dims"].get("256x256",
                                                                 0)
        # row 0 whole, row 1 in ceil(5000 / 2048) = 3 chunks, every layer
        check(n_k1 == cfg.n_layers * (1 + 3),
              f"gemma2 {layout}: K1 at 256x256 launched {n_k1} times")
        dk = DECODE_KERNEL[layout]
        check(r["cuda_launches"][dk] == cfg.n_layers * 8,
              f"gemma2 {layout}: {dk} launched {r['cuda_launches'][dk]} "
              f"times in 8 steps of {cfg.n_layers} layers")
        check(all(n == 0 for n in r["torch_launches"].values()
                  if not isinstance(n, dict)),
              f"gemma2 {layout}: the torch path launched kernels")
    check(streams_equal, "gemma2: dense and paged greedy streams differ")
    check(dense_paged <= rel_tol * res["dense"]["logits_max_abs"],
          f"gemma2: dense vs paged logits differ by {dense_paged}")
    seq = _gemma2_seq_sharded(torch, fm, dec, cfg, model, rt_c, prefilled,
                              lens, logits_all["dense", "cuda"],
                              streams["dense", "cuda"], rel_tol)
    del model, logits_all, prefilled
    gc.collect()
    torch.cuda.empty_cache()
    return seq


#: the seq-sharded decode step's mesh: gemma2's 16-way model axis
SEQ_MESH = (1, 16)


def _gemma2_seq_sharded(torch, fm, dec, cfg, model, rt, prefilled, lens,
                        ref_logits, ref_stream, rel_tol) -> dict:
    """The dense leg's 8 decode steps again from its prefilled caches, with
    the parameters placed by the ``serve`` rules and the caches by
    ``cache_shardings`` on a (1, 16) mesh of cuda:0: 8 kv heads do not
    divide the 16-way model axis, so every cache (the global layers' 8192
    slots, the rings' 4096) splits on its slots into 16 strips and K2 runs
    on each strip (``SEQ_SPLITS`` splits, one a strip) — the main path of
    the strip: counts set to 0 just before, read just after.  Gates:
    tokens equal to the unsharded dense step's, logits within 1e-4 of
    their scale, K2 16 strips x 4 layers x 8 steps."""
    from repro_torch.distributed import sharded_decode as sdec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(SEQ_MESH, ("data", "model"),
                     ["cuda:0"] * math.prod(SEQ_MESH))
    rules = shd.make_rules(mesh, "serve")
    rt = dataclasses.replace(rt, decode_splits=SEQ_SPLITS)
    caches, lg = prefilled
    t0 = time.perf_counter()
    params = sdec.place_params(cfg, model, mesh, rules)
    caches = sdec.shard_caches(cfg, caches, mesh)
    specs = sorted({str(c["attn"]["k"].sharding.spec) for c in caches})
    _zero_counts(fm, dec)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lgs = [], [lg]
    for _ in range(8):
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        out.append(nxt)
        kv = kv + 1
        lg, caches = sdec.decode_step(cfg, model, params, nxt[:, None],
                                      caches, kv, rt, mesh)
        lgs.append(lg)
    torch.cuda.synchronize()
    launches = _counts(fm, dec)
    strips = launches["decode_partials_strips"]
    stream = torch.stack(out).cpu()
    diff = (torch.stack(lgs) - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    tp = SEQ_MESH[1]
    r = dict(mesh=dict(mesh.shape), rules="serve", cache_specs=specs,
             splits=SEQ_SPLITS, decode_steps=8,
             logits_max_abs_diff_vs_unsharded=diff, logits_max_abs=scale,
             rel_tol=rel_tol, tokens_equal=bool(torch.equal(stream,
                                                            ref_stream)),
             k2_strip_launches=strips, launches=launches,
             seconds=time.perf_counter() - t0)
    emit("model_gemma2_seq_sharded", **r)
    check(specs == ["('data', None, 'model', None)"],
          f"gemma2 caches placed {specs}, expected slot strips")
    check(r["tokens_equal"], "gemma2 seq-sharded decode: tokens differ from "
                             "the unsharded step's")
    check(diff <= rel_tol * scale, f"gemma2 seq-sharded logits differ by "
                                   f"{diff} > {rel_tol} x {scale}")
    check(strips == launches["decode_partials"] == tp * cfg.n_layers * 8,
          f"K2 launched {launches['decode_partials']} times, {strips} on "
          f"strips; expected {tp} x {cfg.n_layers} x 8")
    del params, caches
    return r


GEMMA2_SERVE_ARGS = ["--arch", "gemma2-9b", "--cache-layout", "both",
                     "--requests", "4", "--slots", "4", "--prompt-len",
                     "4200", "--prompt-len-max", "6000", "--new-tokens",
                     "32", "--max-len", "8192", "--repeats", "1",
                     "--json", ""]


def phase_serve_gemma2(torch, fm, dec, serve) -> dict:
    """The gemma2 main path: all 42 layers at full width (fp32), the
    launcher on the dense then the paged layout (one leg's model and cache
    resident at a time); every prompt is longer than the 4096 window, so
    every ring wraps; prefill unembeds only the last token."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-9b")
    lens = serve._trace_lens(serve._parser().parse_args(GEMMA2_SERVE_ARGS))
    window = cfg.layer_specs()[0].window
    check(min(lens) > window, f"prompts {lens} do not pass the window")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the gemma2 main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(GEMMA2_SERVE_ARGS)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    peak = torch.cuda.max_memory_allocated()
    legs = _check_legs(metrics, cfg.n_layers, 4, 32, cfg.vocab)
    check("outputs_match" in metrics, "the gemma2 phase ran one layout")
    weights = 4 * cfg.param_count()
    leg_cache = legs["dense"]["cache_bytes"]
    full_logits = 4 * 4 * 8192 * cfg.vocab        # [slots, bucket, vocab]
    emit("serve_gemma2", args=" ".join(GEMMA2_SERVE_ARGS), seconds=wall,
         prompt_lens=lens, window=window, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches, max_memory_allocated=peak,
         weights_bytes=weights, one_leg_cache_bytes=leg_cache,
         full_prefill_logits_bytes=full_logits)
    # the dense leg holds its slot caches and, while it prefills, the
    # group's own cache of the same size: a second leg's pool resident
    # beside them would take the peak past weights + 3 caches, and
    # unembedding every prefilled token past weights + 2 caches + logits
    check(peak < weights + 3 * leg_cache,
          f"peak {peak} B: more than one leg's cache was resident")
    check(peak < weights + 2 * leg_cache + full_logits,
          f"peak {peak} B: prefill unembedded more than the last token")
    for name in ("fusemax_prefill", "decode_partials",
                 "paged_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on gemma2's path")
    check(launches["fusemax_prefill_by_dims"].get("256x256", 0)
          == launches["fusemax_prefill"],
          f"K1 launches by dims {launches['fusemax_prefill_by_dims']}")
    check(0 < launches["fusemax_prefill_windowed"]
          < launches["fusemax_prefill"], "K1 never ran both layer kinds")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: the launcher as a user runs it, from the repo root: no flags (now
#: gemma2-9b-smoke on the card, dense: K1 at (32, 32), K2 at D = 32; the
#: serving example of :data:`EXAMPLE_RUNS` serves it on both layouts),
#: two other smoke configs, the hybrid and the SSM smoke configs
#: on both layouts (hymba: K1 / K2 / K3 at d32 beside Mamba; xlstm: no
#: attention kernel), and the MLA smoke config on the default (dense)
#: layout: K1 at (48, 32), K2's latent branch at (32, 16)
LAUNCHER_RUNS = [
    [],
    ["--arch", "granite-3-8b-smoke", "--cache-layout", "paged"],
    ["--arch", "gemma-7b-smoke"],
    ["--arch", "hymba-1.5b-smoke", "--cache-layout", "both"],
    ["--arch", "xlstm-125m-smoke", "--cache-layout", "both"],
    ["--arch", "deepseek-v3-671b-smoke"],
]
#: ... and an arch it must refuse, with the message that says why (a
#: patch front end takes embeddings, not token prompts)
LAUNCHER_REFUSED = [(["--arch", "pixtral-12b-smoke"], "token prompts")]


#: examples/torch_train_100m.py as the pool runs it: its default batch and
#: sequence, 8 layers of 10 / 2 heads of 64 (G 5), and the steps run.  K1
#: + LSE runs twice a layer a step (the forward and its remat), in fp32
EX100M_BATCH, EX100M_SEQ, EX100M_LAYERS, EX100M_STEPS = 8, 256, 8, 5

#: the examples that wrap the launchers, run in the same pool: the 100M
#: granite of examples/train_100m.py (K1 + LSE at (64, 64), G 5, and the
#: recompute backward), and the batched serving trace on both layouts
#: (gemma2-9b-smoke, the launcher's default arch: K1, K2 and K3), its
#: result written where the pool reads the launcher's
EXAMPLE_RUNS = [
    [os.path.join(ROOT, "examples", "torch_train_100m.py"), "--steps",
     str(EX100M_STEPS)],
    [os.path.join(ROOT, "examples", "torch_serve_batched.py"),
     "--json", "BENCH_torch_serving.json"],
]

#: launcher subprocesses run at once (each reaches the card in ~8 s of
#: start-up; one at a time they took ~100 s of the script's limit)
LAUNCHER_PARALLEL = 4


def _run_launchers(cmds: list) -> list:
    """``python <cmd>`` for each of ``cmds`` (a launcher's module and
    flags, or an example's path and flags), :data:`LAUNCHER_PARALLEL` at a
    time, each in a working directory of its own (the launcher writes
    ``BENCH_torch_serving.json`` into it).  Returns, in the order of
    ``cmds``, (cmd, exit code, stderr, wall seconds, the JSON it wrote or
    None, stdout)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = os.path.join(ROOT, "build", "launcher_runs")
    shutil.rmtree(base, ignore_errors=True)
    results = [None] * len(cmds)
    pending = list(enumerate(cmds))
    live = {}
    try:
        while pending or live:
            while pending and len(live) < LAUNCHER_PARALLEL:
                i, cmd = pending.pop(0)
                cwd = os.path.join(base, str(i))
                os.makedirs(cwd)
                with open(os.path.join(cwd, "stderr"), "w") as err, \
                        open(os.path.join(cwd, "stdout"), "w") as out:
                    proc = subprocess.Popen(
                        [sys.executable, *cmd], cwd=cwd, env=env,
                        stdout=out, stderr=err)
                live[i] = (proc, time.perf_counter(), cwd)
            time.sleep(0.2)
            for i, (proc, t0, cwd) in list(live.items()):
                wall = time.perf_counter() - t0
                if proc.poll() is None:
                    if wall < 600:
                        continue
                    proc.kill()
                    proc.wait()
                del live[i]
                with open(os.path.join(cwd, "stderr")) as fh:
                    err = fh.read()
                with open(os.path.join(cwd, "stdout")) as fh:
                    out = fh.read()
                out_json = os.path.join(cwd, "BENCH_torch_serving.json")
                m = None
                if os.path.exists(out_json):
                    with open(out_json) as fh:
                        m = json.load(fh)
                results[i] = (cmds[i], proc.returncode, err, wall, m, out)
    finally:
        for proc, _, _ in live.values():
            proc.kill()
            proc.wait()
    shutil.rmtree(base, ignore_errors=True)
    return results


def phase_launcher_defaults(torch) -> dict:
    """Each :data:`LAUNCHER_RUNS` command as a subprocess from the repo
    root: exit code 0, every layout's streams complete and, where the
    launcher compares layouts, ``outputs_match``; its kernels launched
    (an MLA arch's decode kernels: :data:`MLA_DECODE_KERNEL`; an arch
    without attention: none).  Each :data:`LAUNCHER_REFUSED` command
    exits non-zero with its message and writes no result."""
    from repro_torch.configs import get_config

    serve = ["-m", "repro_torch.launch.serve"]
    argvs = LAUNCHER_RUNS + [a for a, _ in LAUNCHER_REFUSED]
    pool = _run_launchers([serve + a for a in argvs] + EXAMPLE_RUNS)
    examples = _check_examples(torch, pool[len(argvs):])
    runs = []
    for cmd, rc, stderr, wall, m, _ in pool[:len(argvs)]:
        argv = cmd[len(serve):]
        run = dict(argv=" ".join(argv) or "(no flags)", rc=rc, seconds=wall)
        if rc == 0 and m is not None:
            run.update(arch=m["arch"],
                       mla=get_config(m["arch"]).mla is not None,
                       attention=any(sp.attn != "none" for sp in get_config(
                           m["arch"]).layer_specs()),
                       layouts=list(m["layouts"]),
                       tok_per_s=m["tok_per_s"],
                       kernel_launches={lo: v["kernel_launches"]
                                        for lo, v in m["layouts"].items()},
                       device=m["device"])
            if "outputs_match" in m:     # the launcher compared layouts
                run["outputs_match"] = m["outputs_match"]
        else:
            run["stderr_tail"] = stderr[-2000:]
        runs.append(run)
    refused, runs = runs[len(LAUNCHER_RUNS):], runs[:len(LAUNCHER_RUNS)]
    emit("launcher_defaults", runs=runs, refused=refused, examples=examples)
    for run, (_, msg) in zip(refused, LAUNCHER_REFUSED):
        check(run["rc"] != 0 and msg in run.get("stderr_tail", ""),
              f"launcher {run['argv']} was not refused: rc {run['rc']}, "
              f"{run.get('stderr_tail', '')[-400:]}")
    for run in runs:
        check(run["rc"] == 0, f"launcher {run['argv']} exited {run['rc']}: "
                              f"{run.get('stderr_tail', '')[-600:]}")
        check(run.get("outputs_match", True) is True,
              f"launcher {run['argv']}: streams differ across layouts")
        check(run["device"]["platform"] == "gpu",
              f"launcher {run['argv']} ran on {run['device']}")
        kmap = MLA_DECODE_KERNEL if run["mla"] else DECODE_KERNEL
        for lo, n in run["kernel_launches"].items():
            if not run["attention"]:
                check(not any(n.values()), f"launcher {run['argv']} {lo}: "
                                           f"kernels launched: {n}")
                continue
            check(n["fusemax_prefill"] > 0 and n[kmap[lo]] > 0,
                  f"launcher {run['argv']} {lo}: kernels not launched: {n}")
    check(runs[0]["arch"] == "gemma2-9b-smoke",
          f"the launcher's default arch is {runs[0]['arch']}")
    check(runs[-1]["mla"] and runs[-1]["layouts"] == ["dense"],
          f"the MLA smoke run served {runs[-1]['layouts']}, not the "
          f"default dense layout")
    for ex in examples:
        check(ex["rc"] == 0, f"{ex['example']} exited {ex['rc']}: "
                             f"{ex.get('stderr_tail', '')[-600:]}")
    train, serve = examples
    check(len(train["losses"]) == EX100M_STEPS
          and train["losses"][-1] < train["losses"][0],
          f"torch_train_100m: losses {train['losses']}")
    check(train["card_named"], "torch_train_100m: the card's name is not "
                               "in its output")
    want = 2 * EX100M_LAYERS * EX100M_STEPS
    check(train["k1_launches"] == want, f"torch_train_100m: K1 launched "
                                        f"{train['k1_launches']}, not {want}")
    check(serve.get("outputs_match") is True,
          "torch_serve_batched: streams differ across layouts")
    for lo, n in serve.get("kernel_launches", {}).items():
        check(n["fusemax_prefill"] > 0 and n[DECODE_KERNEL[lo]] > 0,
              f"torch_serve_batched {lo}: kernels not launched: {n}")
    check(sorted(serve.get("kernel_launches", {})) == ["dense", "paged"],
          f"torch_serve_batched served {serve.get('kernel_launches')}")
    return {"runs": runs, "examples": examples}


def _check_examples(torch, pool: list) -> list:
    """What the two :data:`EXAMPLE_RUNS` printed and wrote: the training
    example's losses, step seconds, tok/s and K1 launches (its own summary
    line), whether the card's name is in its output; the serving
    example's ``outputs_match``, tok/s and launches by layout."""
    import re

    out = []
    for cmd, rc, stderr, wall, m, stdout in pool:
        ex = dict(example=os.path.basename(cmd[0]) + " " + " ".join(cmd[1:]),
                  rc=rc, seconds=wall)
        if rc != 0:
            ex["stderr_tail"] = stderr[-2000:]
        elif "train" in cmd[0]:
            steps = re.findall(r"step +\d+ loss +([-\d.]+) .* ([\d.]+)s$",
                               stdout, re.M)
            done = re.search(r"([\d.]+) tok/s after the first step, K1 "
                             r"launches (\d+)", stdout)
            ex.update(losses=[float(a) for a, _ in steps],
                      step_seconds=[float(b) for _, b in steps],
                      tok_per_s=float(done.group(1)) if done else None,
                      k1_launches=int(done.group(2)) if done else 0,
                      card_named=torch.cuda.get_device_name(0) in stdout,
                      summary=stdout.strip().splitlines()[-1:])
        elif m is not None:
            ex.update(outputs_match=m.get("outputs_match"),
                      tok_per_s={lo: v["tok_per_s"]
                                 for lo, v in m["layouts"].items()},
                      kernel_launches={lo: v["kernel_launches"]
                                       for lo, v in m["layouts"].items()},
                      device=m["device"])
        out.append(ex)
    return out


# ---------------------------------------------------------------------------
# 7-10. DeepSeek-V3's MLA tower
# ---------------------------------------------------------------------------

def deepseek_tower():
    """DeepSeek-V3 at full width cut to its first three layers: exactly
    its dense prefix (MLA + a dense FFN of 18432), no expert layer; the
    MTP head is never built (serving does not run it)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=3)


def mla_smoke_tower():
    """The MLA smoke config (r 32, rd 16, nope 32, v 32, 4 heads) with its
    MoE cut to a dense FFN, as tests/test_torch_mla.py holds it to the
    reference: the phase holds the smoke kernels (the launcher serves the
    config with its experts in ``launcher_defaults``)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b-smoke"),
                               moe=None, family="dense")


def moe_tower():
    """DeepSeek-V3 at full width cut to 4 layers: its dense prefix (layers
    0-2) and its first MoE layer (layer 3: 256 routed experts of 7168 ->
    2048 -> 7168, top-8, one shared expert, a sigmoid router, capacity
    factor 1.25); 60.4 GB of fp32 weights.  The MTP head is never built."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)


class _RouteLog:
    """Every MoE call's expert picks (each token's top-k, sorted) and
    boundary margin (its k-th minus its (k+1)-th router score), kept on
    the device: ``repro_torch.model.moe.moe_ffn`` is wrapped on entry and
    restored on exit."""

    def __init__(self, torch):
        from repro_torch.model import moe

        self.torch, self.moe, self.calls = torch, moe, []

    def __enter__(self):
        torch, real = self.torch, self.moe.moe_ffn
        self.real = real

        def recorded(p, x, cfg):
            mo = cfg.moe
            logits = x.float() @ p.router
            scores = torch.sigmoid(logits) if mo.router == "sigmoid" \
                else torch.softmax(logits, dim=-1)
            top = torch.sort(scores, dim=-1, descending=True, stable=True)
            k = mo.top_k
            self.calls.append((top.indices[..., :k].sort(dim=-1).values,
                               top.values[..., k - 1] - top.values[..., k]))
            return real(p, x, cfg)

        self.moe.moe_ffn = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.real
        return False


def _router_flips(calls_a: list, calls_b: list, real: list) -> dict:
    """Two runs' expert picks compared call by call: a flip is a real
    token (``real[i]``: [B, S] bool) whose picked set differs.  Rows are
    independent (each is its own capacity group and attends only itself),
    so a flip touches its row alone; a row's first flipped call counts,
    and its later calls, which follow from that flip, are skipped.
    Returns the rows touched, the flips and their margins in run b."""
    check(len(calls_a) == len(calls_b) == len(real),
          f"MoE calls {len(calls_a)} / {len(calls_b)} / {len(real)}")
    touched, margins = set(), []
    for (pa, _), (pb, mb), live in zip(calls_a, calls_b, real):
        diff = ((pa != pb).any(-1) & live).cpu()
        mb = mb.cpu()
        newly = [r for r in range(diff.shape[0])
                 if r not in touched and bool(diff[r].any())]
        for r in newly:
            margins += mb[r][diff[r]].tolist()
        touched.update(newly)
    return dict(rows=sorted(touched), flips=len(margins),
                margins=sorted(margins))


def phase_model_mla(torch, fm, dec, cfg=None, phase="model_mla") -> dict:
    """The tower on the dense and on the paged layout, each with
    ``attn_impl`` "cuda" and "torch" on the same weights: two prefill
    chunks (the second at offset 256, the absorbed form through K1 at
    (r + rd, r)) and 8 greedy decode steps (dense: K2's E != F branch;
    paged: K4).  Logits within 1e-4 of their scale cuda vs torch, equal
    streams, and the dense streams equal to the paged ones.  On a tower
    with MoE layers the cuda vs torch check is flip-aware: the sigmoid
    router turns ulp-level differences into other expert picks where a
    token's k-th and (k+1)-th scores lie that close, so every real token
    whose picks differ is counted with its margin in the torch run; any
    margin >= 1e-5 fails, and the logits and tokens are held on the rows
    no flip touched.  Returns the cuda runs' launches by layout."""
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = deepseek_tower() if cfg is None else cfg
    n_moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens = [512, 333, 128, 45]
    b, chunk, ps, max_len = len(lens), 256, 16, 1024
    w = max_len // ps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    # every slot's table is a random permutation of the pool's pages
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    tables = {"full": perm.to(torch.int32).reshape(b, w).contiguous()}
    slot_ids = torch.arange(b, device="cuda")
    streams, logits_all, launches, routes = {}, {}, {}, {}
    for layout in ("dense", "paged"):
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            _zero_counts(fm, dec)
            with _RouteLog(torch) as log:
                if layout == "paged":
                    caches = tf.init_paged_cache(
                        cfg, b, {"full": b * w}, ps, torch.float32, "cuda")
                    pkw = dict(block_tables=tables, slot_ids=slot_ids)
                    dkw = dict(block_tables=tables)
                else:
                    caches = tf.init_cache(cfg, b, max_len, torch.float32,
                                           "cuda")
                    pkw, dkw = {}, {}
                lg = torch.zeros((b, cfg.vocab), device="cuda")
                for off in (0, chunk):
                    part, caches = tf.prefill(
                        cfg, model, {"inputs": toks[:, off:off + chunk]},
                        caches, rt, kv_offset=off, true_len=true_len, **pkw)
                    sel = (true_len - 1 >= off) \
                        & (true_len - 1 < off + chunk)
                    lg = torch.where(sel[:, None], part, lg)
                kv = true_len.clone()
                out, lgs = [], [lg]
                for _ in range(8):
                    nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                    out.append(nxt)
                    kv = kv + 1
                    lg, caches = tf.decode_step(cfg, model, nxt[:, None],
                                                caches, kv, rt, **dkw)
                    lgs.append(lg)
            routes[layout, name] = log.calls
            streams[layout, name] = torch.stack(out).cpu()
            logits_all[layout, name] = torch.stack(lgs)
            del caches
            if name == "cuda":
                launches[layout] = _counts(fm, dec)
    torch.cuda.synchronize()
    rel_tol = 1e-4
    m = cfg.mla
    expanded = f"{m.nope_dim + m.rope_dim}x{m.v_dim}"
    absorbed = f"{m.kv_lora_rank + m.rope_dim}x{m.kv_lora_rank}"
    n = cfg.n_layers
    want = {expanded: n, absorbed: n} if expanded != absorbed \
        else {expanded: 2 * n}
    # the real tokens of each MoE call: the two prefill chunks' positions
    # below each row's length, then every decode step's
    pos = torch.arange(chunk, device="cuda")
    real = [pos[None] + off < true_len[:, None] for off in (0, chunk)
            for _ in range(n_moe)] \
        + [torch.ones((b, 1), dtype=torch.bool, device="cuda")] * (8 * n_moe)
    by_layout = {}
    for layout, kernel in (("dense", "latent_decode_partials"),
                           ("paged", "mla_paged_decode_partials")):
        # a router flip between the impls touches its row alone: the
        # logits and tokens are held on the rows no flip touched
        flips = _router_flips(routes[layout, "cuda"],
                              routes[layout, "torch"], real) if n_moe \
            else dict(rows=[], flips=0, margins=[])
        live = [r for r in range(b) if r not in flips["rows"]]
        lc, lt = logits_all[layout, "cuda"], logits_all[layout, "torch"]
        by_layout[layout] = dict(
            logits_max_abs_diff=(lc[:, live] - lt[:, live]).abs().max()
            .item() if live else None,
            logits_max_abs=lt.abs().max().item(),
            token_match_rate=(streams[layout, "cuda"][:, live]
                              == streams[layout, "torch"][:, live]).float()
            .mean().item() if live else None,
            finite=bool(torch.isfinite(lc).all().item()),
            cuda_launches=launches[layout], decode_kernel=kernel)
        if n_moe:
            by_layout[layout].update(
                router_flips=flips["flips"], rows_touched=flips["rows"],
                largest_flip_margin=max(flips["margins"], default=None),
                flip_margins=flips["margins"][:16],
                smallest_margin_torch=min(c[1].min().item() for c in
                                          routes[layout, "torch"]),
                moe_calls=len(routes[layout, "torch"]))
    dense_eq_paged = bool((streams["dense", "cuda"]
                           == streams["paged", "cuda"]).all().item())
    ffn = f"{n_moe} MoE layer(s)" if n_moe else "dense FFN"
    emit(phase, config=f"{cfg.name} n_layers={cfg.n_layers} (MLA + {ffn}) "
         f"fp32, dense and paged", prompts=lens,
         prefill_chunks=[[0, chunk], [chunk, 2 * chunk]], decode_steps=8,
         rel_tol=rel_tol, layouts=by_layout,
         dense_streams_equal_paged=dense_eq_paged)
    for layout, r in by_layout.items():
        check(r["finite"], f"{layout}: non-finite logits in the MLA model "
                           f"cross-check")
        if n_moe:
            big = r["largest_flip_margin"]
            check(big is None or big < 1e-5,
                  f"{layout}: a router flip cuda vs torch at margin {big} "
                  f">= 1e-5")
            check(len(r["rows_touched"]) < b,
                  f"{layout}: router flips touch every row")
        check(r["logits_max_abs_diff"] <= rel_tol * r["logits_max_abs"],
              f"{layout}: MLA cuda vs torch logits differ by "
              f"{r['logits_max_abs_diff']} > {rel_tol} x "
              f"{r['logits_max_abs']}")
        check(r["token_match_rate"] == 1.0,
              f"{layout}: MLA greedy token match rate "
              f"{r['token_match_rate']} < 1")
        got = launches[layout]
        for kernel in ("latent_decode_partials", "mla_paged_decode_partials"):
            expect = n * 8 if kernel == r["decode_kernel"] else 0
            check(got[kernel] == expect,
                  f"{layout}: {kernel} launched {got[kernel]} times in 8 "
                  f"decode steps of {n} layers, expected {expect}")
        check(got["fusemax_prefill_by_dims"] == want,
              f"{layout}: K1 launches by dims "
              f"{got['fusemax_prefill_by_dims']}, expected {n} expanded + "
              f"{n} absorbed")
    check(dense_eq_paged, "MLA greedy streams differ between the dense and "
                          "the paged layout")
    del model, logits_all
    gc.collect()
    torch.cuda.empty_cache()
    return launches


MLA_SERVE_ARGS = ["--arch", "deepseek-v3-671b", "--cache-layout", "both",
                  "--requests", "16", "--slots", "8", "--prompt-len", "128",
                  "--prompt-len-max", "1024", "--new-tokens", "64",
                  "--max-len", "2048", "--page-size", "16", "--repeats", "1",
                  "--json", ""]

MLA_PREFIX_ARGS = ["--arch", "deepseek-v3-671b", "--cache-layout", "paged",
                   "--shared-prefix-len", "256", "--requests", "16",
                   "--slots", "8", "--prompt-len", "300", "--prompt-len-max",
                   "500", "--new-tokens", "32", "--max-len", "2048",
                   "--page-size", "16", "--repeats", "1", "--no-warmup",
                   "--json", ""]


def phase_serve_mla(torch, fm, dec, serve) -> dict:
    """The MLA main path: the launcher serving the tower on the dense and
    the paged layout (the serve cell's traffic): equal streams, and in
    each leg's timed run K1 3 x prefill dispatches and its decode kernel
    (dense: K2's E != F branch; paged: K4) 3 x decode steps."""
    cfg = deepseek_tower()
    torch.cuda.reset_peak_memory_stats()
    argv = MLA_SERVE_ARGS + SHARD_ARGS
    # the MLA main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(argv, cfg=cfg, devices=["cuda:0"] * SHARD_TP)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       MLA_DECODE_KERNEL,
                       per_shard={"paged_sharded": (1, SHARD_TP)})
    check(list(metrics["layouts"]) == ["dense", "paged", "paged_sharded"],
          f"serve_mla served {list(metrics['layouts'])}")
    sharded = _check_sharded(torch, metrics)
    emit("serve_mla", args=" ".join(argv),
         config="deepseek-v3-671b n_layers=3", seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         **sharded, main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(metrics["outputs_match"] is True,
          "MLA greedy streams differ between the dense, paged and sharded "
          "legs")
    launches["paged_sharded"] = \
        metrics["layouts"]["paged_sharded"]["kernel_launches"]
    for name in ("fusemax_prefill", "mla_paged_decode_partials",
                 "latent_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on the MLA path")
    for dims in ("192x128", "576x512"):
        check(launches["fusemax_prefill_by_dims"].get(dims, 0) > 0,
              f"K1 at (E, F) = {dims} never launched on the MLA path")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_mla_prefix(torch, fm, dec, serve) -> dict:
    """Shared-prefix traffic on the tower, prefix cache on vs off: every
    request after the first maps the 16 shared pages (15 x 256 tokens)
    and prefills its tail through the absorbed K1."""
    cfg = deepseek_tower()
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(MLA_PREFIX_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 32, cfg.vocab,
                       MLA_DECODE_KERNEL)
    check("outputs_match" in metrics, "the prefix phase ran one layout")
    reused = metrics["layouts"]["paged"]["prefix"]["tokens_reused"]
    emit("serve_mla_prefix", args=" ".join(MLA_PREFIX_ARGS),
         config="deepseek-v3-671b n_layers=3", seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"], tokens_reused=reused,
         invariants="checked by the launcher after each paged leg",
         launches=launches)
    check(reused == 3840, f"{reused} prefix tokens reused, expected 3840")
    check(launches["fusemax_prefill_by_dims"].get("576x512", 0) > 0,
          "no tail prefill ran the absorbed K1")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_mla_impls(torch, fm, dec) -> None:
    """A short trace on the tower served with ``attn_impl`` "cuda" and
    "torch": equal greedy streams, and the torch engine launched no
    kernel."""
    import numpy as np

    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime
    from repro_torch.serving import Request, ServeEngine

    cfg = deepseek_tower()
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    model = tf.init(cfg, 0, rt_c, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in rng.integers(128, 257, size=4)]
    streams, launches = {}, {}
    for impl in ("cuda", "torch"):
        _zero_counts(fm, dec)
        engine = ServeEngine(cfg, model, slots=4, max_len=512,
                             rt=dataclasses.replace(rt_c, attn_impl=impl),
                             cache_layout="paged", page_size=16,
                             device="cuda")
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=16)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
        streams[impl] = [list(r.generated) for r in reqs]
        launches[impl] = _counts(fm, dec)
        check(engine.logits_finite(), f"{impl}: non-finite logits")
        del engine
    emit("serve_mla_impls", config="deepseek-v3-671b n_layers=3",
         prompts=[len(pr) for pr in prompts], new_tokens=16,
         streams_equal=streams["cuda"] == streams["torch"],
         launches=launches)
    check(all(len(st) == 16 for st in streams["cuda"]),
          "a request did not get its 16 tokens")
    check(streams["cuda"] == streams["torch"],
          "cuda and torch attention give different greedy streams")
    check(launches["cuda"]["mla_paged_decode_partials"] > 0,
          "the cuda engine never launched K4")
    check(all(n == 0 for n in launches["torch"].values()
              if not isinstance(n, dict)),
          f"the torch engine launched kernels: {launches['torch']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


MLA_QUANT_ARGS = [("paged" if a == "both" else a) for a in MLA_SERVE_ARGS] \
    + ["--kv-dtype", "fp8_e4m3", "--no-warmup"]


MLA_SPEC_ARGS = ["--arch", "deepseek-v3-671b", "--cache-layout", "both",
                 "--requests", "8", "--slots", "8", "--prompt-len", "128",
                 "--prompt-len-max", "512", "--new-tokens", "64",
                 "--max-len", "2048", "--page-size", "16", "--speculate",
                 str(MLA_SPEC_K), "--duplicates", "8", "--repeats", "1",
                 "--no-warmup", "--json", ""]


def phase_serve_mla_spec(torch, fm, dec, serve) -> dict:
    """Speculative decoding on DeepSeek-V3's 3-layer tower (MoE cut): the
    launcher with ``--cache-layout both --speculate 4 --duplicates 8`` on
    the serve_spec trace; the dense leg verifies through K2's latent
    branch and the paged leg through K4, both at P = 5 (640 rows); streams
    equal to ``paged_nospec``'s."""
    cfg = deepseek_tower()
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(MLA_SPEC_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    check(list(metrics["layouts"]) == ["dense", "paged", "paged_nospec"],
          f"serve_mla_spec served {list(metrics['layouts'])}")
    spec = _check_spec_legs(torch, serve, MLA_SPEC_ARGS, cfg, metrics,
                            MLA_SPEC_K + 1, MLA_DECODE_KERNEL,
                            "serve_mla_spec")
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       MLA_DECODE_KERNEL)
    emit("serve_mla_spec", args=" ".join(MLA_SPEC_ARGS),
         config="deepseek-v3-671b n_layers=3", seconds=wall, legs=legs,
         speculation_by_leg=spec, speculation=metrics["speculation"],
         outputs_match=metrics["outputs_match"],
         invariants="checked by the launcher after each paged leg",
         main_path_launches=launches)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe(torch, fm, dec, serve) -> dict:
    """The MoE tower (:func:`moe_tower`, 4 layers, the fourth DeepSeek's
    first MoE layer) through the launcher on the serve_mla trace
    (``--cache-layout both``): dense = paged streams token for token (both
    run the same prefill, K2's latent branch equals K4 bit for bit, and an
    MoE layer routes each row alone), tok/s, TTFT, the peak allocated
    bytes, and in each leg's timed run K1 4 x prefill dispatches and its
    decode kernel 4 x decode steps."""
    cfg = moe_tower()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the MoE main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(MLA_SERVE_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       MLA_DECODE_KERNEL)
    check(list(metrics["layouts"]) == ["dense", "paged"],
          f"serve_moe served {list(metrics['layouts'])}")
    emit("serve_moe", args=" ".join(MLA_SERVE_ARGS),
         config="deepseek-v3-671b n_layers=4 (layers 0-2 dense FFN, layer 3 "
                "MoE: 256 experts top-8 + 1 shared, sigmoid router, cf 1.25)",
         seconds=wall, legs=legs, outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(metrics["outputs_match"] is True,
          "MoE tower greedy streams differ between the dense and paged legs")
    for name in ("fusemax_prefill", "mla_paged_decode_partials",
                 "latent_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on the MoE path")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_mla_quant(torch, fm, dec, serve) -> dict:
    """The tower with fp8 e4m3 latents: the launcher serving the serve
    cell's trace on the paged layout and its ``paged_quant`` leg (K4's
    quantized branch every decode step, 3 x decode steps; quant_quality
    reported), then a short trace with ``attn_impl`` "cuda" and "torch"
    on fp8 latents: equal greedy streams.  Returns the launcher run's
    launches."""
    import numpy as np

    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime
    from repro_torch.serving import Request, ServeEngine

    cfg = deepseek_tower()
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(MLA_QUANT_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       MLA_DECODE_KERNEL)
    quant = metrics["layouts"]["paged_quant"]
    steps = quant["dispatches"]["decode_steps"]
    by_code = quant["kernel_launches_by_kv_dtype"][
        "mla_paged_decode_partials"]
    peak = {lo: m["memory"]["peak_resident_cache_bytes"]
            for lo, m in metrics["layouts"].items()}
    gc.collect()
    torch.cuda.empty_cache()

    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    model = tf.init(cfg, 0, rt_c, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in rng.integers(128, 257, size=4)]
    streams = {}
    for impl in ("cuda", "torch"):
        engine = ServeEngine(cfg, model, slots=4, max_len=512,
                             rt=dataclasses.replace(rt_c, attn_impl=impl),
                             cache_layout="paged", page_size=16,
                             kv_dtype="fp8_e4m3", device="cuda")
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=16)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run()
        torch.cuda.synchronize()
        check(engine.logits_finite(), f"{impl}: non-finite logits")
        streams[impl] = [list(r.generated) for r in reqs]
        del engine
    emit("serve_mla_quant", args=" ".join(MLA_QUANT_ARGS),
         config="deepseek-v3-671b n_layers=3, fp8 e4m3 latents",
         seconds=wall, legs=legs, peak_resident_cache_bytes=peak,
         quant_over_fp32_peak_resident=peak["paged_quant"] / peak["paged"],
         quant_quality=metrics["quant_quality"],
         impls_streams_equal=streams["cuda"] == streams["torch"],
         main_path_launches=launches)
    check(by_code == {"fp8_e4m3": cfg.n_layers * steps},
          f"K4's quantized branch launched {by_code} times, expected "
          f"{cfg.n_layers} x {steps} decode steps")
    check(streams["cuda"] == streams["torch"],
          "fp8 latents: cuda and torch attention give different streams")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 15-19. hymba-1.5b (attention beside Mamba, G = 5), xlstm-125m (mLSTM /
# sLSTM, no attention) and the frame / patch front ends
# ---------------------------------------------------------------------------

def k1_hymba_cases(torch):
    """K1 at hymba-1.5b's (64, 64) with its group of 5 (25 q over 5 kv
    heads), fp32 and bf16: a windowed layer (window 1024) with a history
    offset and queries past the window, one whole past the window, and a
    global layer with an offset.  They draw from a generator of their
    own (``main``), so every earlier case keeps its inputs."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        out += [
            (f"{dn} hymba E64 G5 window=1024 q_offset=900 causal", 1, 5, 5,
             400, 1300, 64, 64, dtype,
             dict(causal=True, window=1024, q_offset=900)),
            (f"{dn} hymba E64 G5 window=1024 causal P=M=1300", 1, 5, 5,
             1300, 1300, 64, 64, dtype, dict(causal=True, window=1024)),
            (f"{dn} hymba E64 G5 global q_offset=512 causal", 2, 5, 5, 300,
             812, 64, 64, dtype, dict(causal=True, q_offset=512)),
        ]
    return out


def k2_hymba_cases(torch):
    """K2 at hymba's d64 with G = 5: a global layer's 2048-token cache
    (kv_len 0 and 1 among them) and a windowed layer's ring of 1024 read
    at eff_len = min(kv_len, 1024), fp32 and bf16 (as :func:`k2_cases`)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 hymba d64 G5 global kv_len 0,1 splits=4", 4, 5, 5, 1, 2048,
         64, f32, [0, 1, 1300, 2048], 4, 128, {}),
        ("bf16 hymba d64 G5 global splits=8", 2, 5, 5, 1, 2048, 64, bf16,
         [2047, 513], 8, 128, {}),
        ("fp32 hymba d64 G5 ring of 1024 at eff_len (kv_len past the "
         "window) splits=4", 4, 5, 5, 1, 1024, 64, f32, [1024, 1024, 700, 1],
         4, 128, {}),
        ("bf16 hymba d64 G5 ring of 1024 at eff_len splits=2", 2, 5, 5, 1,
         1024, 64, bf16, [1024, 37], 2, 128, {}),
    ]


def k3_hymba_cases(torch):
    """K3 at hymba's d64 with G = 5 on permuted pools: the "full" class
    (W 128 pages of 16) and the "w1024" ring class (W 64) read at eff_len
    (as :func:`k3_cases`)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 hymba ps16 d64 G5 global kv_len 0,1 splits=8", 4, 5, 5, 1,
         16, 128, 600, 64, f32, [0, 1, 1300, 2048], 8, 16, {}),
        ("bf16 hymba ps16 d64 G5 global splits=4", 2, 5, 5, 1, 16, 128, 300,
         64, bf16, [2047, 513], 4, 16, {}),
        ("fp32 hymba ring W=64 (window 1024) at eff_len ps16 splits=4", 4,
         5, 5, 1, 16, 64, 300, 64, f32, [1024, 1024, 700, 1], 4, 16, {}),
    ]


#: a hymba-1.5b decode step's kv_len (8 slots of the serve trace's
#: lengths) on a global layer, and the same slots' rings of 1024 at
#: eff_len
HYMBA_KVL = [2048, 1536, 1300, 1024, 700, 513, 1, 1900]


def time_hymba(torch, gen, fm, dec, ops, autotune) -> dict:
    """K1, K2 and K3 at hymba-1.5b's shapes, fp32, G = 5 (25 q over 5 kv
    heads), head dim 64: K1 at a 2048-bucket prefill dispatch of 4 rows
    on a windowed layer (window 1024) and a global one, with its device
    time; K2 and K3 at a decode step of 8 slots on a global layer's
    2048-token cache and on a windowed layer's ring of 1024 read at
    eff_len (K3 on pools of page_size 16, W 128 and 64)."""
    out = {}
    for where, window in (("hymba_local", 1024), ("hymba_global", None)):
        out[f"fusemax_prefill@{where}"] = _time_k1_shape(
            torch, gen, fm, autotune, b=4, hq=25, hkv=5, p=2048, m=2048,
            e=64, f=64, q_offset=0, window=window, with_device_ms=True,
            shape="B4 Hq25 Hkv5 P=M=2048 d64 fp32 causal"
                  + (f" window {window}" if window else ""))
        torch.cuda.empty_cache()
    ring = [min(n, 1024) for n in HYMBA_KVL]
    for where, m, kvl in (("hymba_global", 2048, HYMBA_KVL),
                          ("hymba_ring", 1024, ring)):
        out[f"decode_partials@{where}"] = time_k2(
            torch, gen, dec, autotune, b=8, hq=25, hkv=5, m=m, d=64,
            kvl=kvl)
        out[f"paged_decode_partials@{where}"] = time_k3(
            torch, gen, dec, ops, autotune,
            x=paged_data(torch, gen, 8, 25, 5, m, 64), kvl=kvl)
        torch.cuda.empty_cache()
    return out


def hymba_tower():
    """hymba-1.5b at full width (d 1600, 25 / 5 heads of 64, d_ff 5504,
    Mamba d_inner 3200, state 16, dt_rank 100, conv 4) cut to 4 layers:
    global, two windowed (1024), global."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("hymba-1.5b"), n_layers=4,
                               hybrid_global_layers=(0, 3))


def _ssm_prefill_literal_vs_hoisted(torch, tf, cfg, model) -> dict:
    """The hoisted SSM prefill against the literal one on the same rows
    of the tower's first layer (its Mamba at full width): a 1024-token
    chunk of 2 rows whose prompts (1300, 1800) run past it, then the
    continuation chunk at kv_offset 1024 from the handed-off state, where
    both prompts end and the bucket's padding follows (masked stepping).
    Outputs (padding included) and every state leaf, max abs distance
    over the outputs' scale."""
    from repro_torch.model import ssm as ssm_mod
    from repro_torch.model.layers import Runtime, apply_norm

    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    spec = cfg.layer_specs()[0]
    p = model.layers[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    x = torch.randn((2, 2048, cfg.d_model), generator=gen, device="cuda")
    h = apply_norm(p.ln1, x, cfg.norm)
    true_len = torch.tensor([1300, 1800], dtype=torch.int32, device="cuda")
    out = {}
    for form, prefill in (("literal", tf._prefill_ssm_literal),
                          ("hoisted", tf._prefill_ssm)):
        st = ssm_mod.INIT_STATE[spec.ssm](cfg, 2, torch.float32, "cuda")
        ys = []
        t0 = time.perf_counter()
        for off in (0, 1024):
            y, st = prefill(p.ssm, h[:, off:off + 1024], st, cfg, spec, rt,
                            true_len, off)
            ys.append(y)
        torch.cuda.synchronize()
        out[form] = (torch.cat(ys, dim=1), st, time.perf_counter() - t0)
    (ya, sa, ta), (yb, sb, tb) = out["literal"], out["hoisted"]
    scale = ya.abs().max().item()
    return dict(
        rows=2, chunks=[[0, 1024], [1024, 2048]], true_len=[1300, 1800],
        y_max_abs_diff=(ya - yb).abs().max().item(), y_max_abs=scale,
        state_max_abs_diff={k: (sa[k] - sb[k]).abs().max().item()
                            for k in sa},
        state_max_abs={k: sa[k].abs().max().item() for k in sa},
        literal_s=ta, hoisted_s=tb)


def phase_model_hybrid(torch, fm, dec) -> None:
    """hymba-1.5b at full width cut to 4 layers (:func:`hymba_tower`),
    fp32: prompts of 1300 and 1800 tokens (past the 1024 window), one
    prefilled whole and one in 512-token chunks, then 8 greedy decode
    steps, on the dense and the paged layout, with ``attn_impl`` "cuda"
    and "torch": equal tokens, logits within 1e-4 of their scale, dense =
    paged; K1 at (64, 64) G = 5, K2 / K3 at d64.  Then the hoisted SSM
    prefill against the literal one, within 1e-5 of scale."""
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = hymba_tower()
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens, chunk, ps, max_len = [1300, 1800], 512, 16, 2048
    window = cfg.layer_specs()[1].window
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (len(lens), max(lens)), generator=gen,
                         device="cuda", dtype=torch.int32)
    b = len(lens)
    widths = {"full": max_len // ps, f"w{window}": -(-window // ps)}
    tables = {k: torch.randperm(b * w, generator=gen, device="cuda")
              .to(torch.int32).reshape(b, w).contiguous()
              for k, w in widths.items()}
    streams, logits_all, launches = {}, {}, {}
    t0 = time.perf_counter()
    for layout in ("dense", "paged"):
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            _zero_counts(fm, dec)
            paged = tables if layout == "paged" else None
            caches = tf.init_paged_cache(
                cfg, b, {k: b * w for k, w in widths.items()}, ps,
                torch.float32, "cuda") if paged else \
                tf.init_cache(cfg, b, max_len, torch.float32, "cuda")
            lg = _gemma2_prefill_rows(torch, tf, cfg, model, rt, caches,
                                      toks, lens, chunk, paged)
            kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out, lgs = [], [lg]
            for _ in range(8):
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(nxt)
                kv = kv + 1
                lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches,
                                            kv, rt, block_tables=paged)
                lgs.append(lg)
            streams[layout, name] = torch.stack(out).cpu()
            logits_all[layout, name] = torch.stack(lgs)
            launches[layout, name] = _counts(fm, dec)
            del caches
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    rel_tol, ssm_tol = 1e-4, 1e-5
    res = {}
    for layout in ("dense", "paged"):
        c, t = logits_all[layout, "cuda"], logits_all[layout, "torch"]
        res[layout] = dict(
            logits_max_abs_diff=(c - t).abs().max().item(),
            logits_max_abs=t.abs().max().item(),
            token_match_rate=(streams[layout, "cuda"]
                              == streams[layout, "torch"]).float().mean()
            .item(),
            finite=bool(torch.isfinite(c).all().item()),
            cuda_launches=launches[layout, "cuda"],
            torch_launches=launches[layout, "torch"])
    dense_paged = (logits_all["dense", "cuda"]
                   - logits_all["paged", "cuda"]).abs().max().item()
    streams_equal = bool(torch.equal(streams["dense", "cuda"],
                                     streams["paged", "cuda"]))
    ssm = _ssm_prefill_literal_vs_hoisted(torch, tf, cfg, model)
    emit("model_hybrid", config="hymba-1.5b n_layers=4 (global, w1024, "
         "w1024, global) fp32", prompts=lens, window=window,
         prefill=["whole", f"{chunk}-token chunks"], decode_steps=8,
         rel_tol=rel_tol, layouts=res, seconds=model_s,
         dense_vs_paged_logits_max_abs_diff=dense_paged,
         dense_vs_paged_streams_equal=streams_equal,
         ssm_prefill_hoisted_vs_literal=dict(ssm, rel_tol=ssm_tol))
    for layout, r in res.items():
        check(r["finite"], f"{layout}: non-finite logits in the hymba check")
        check(r["logits_max_abs_diff"] <= rel_tol * r["logits_max_abs"],
              f"hymba {layout}: cuda vs torch logits differ by "
              f"{r['logits_max_abs_diff']} > {rel_tol} x "
              f"{r['logits_max_abs']}")
        check(r["token_match_rate"] == 1.0,
              f"hymba {layout}: token match rate {r['token_match_rate']}")
        n_k1 = r["cuda_launches"]["fusemax_prefill_by_dims"].get("64x64", 0)
        # row 0 whole, row 1 in ceil(1800 / 512) = 4 chunks, every layer
        check(n_k1 == cfg.n_layers * (1 + 4),
              f"hymba {layout}: K1 at 64x64 launched {n_k1} times")
        dk = DECODE_KERNEL[layout]
        check(r["cuda_launches"][dk] == cfg.n_layers * 8,
              f"hymba {layout}: {dk} launched {r['cuda_launches'][dk]} "
              f"times in 8 steps of {cfg.n_layers} layers")
        check(all(n == 0 for n in r["torch_launches"].values()
                  if not isinstance(n, dict)),
              f"hymba {layout}: the torch path launched kernels")
    check(streams_equal, "hymba: dense and paged greedy streams differ")
    check(dense_paged <= rel_tol * res["dense"]["logits_max_abs"],
          f"hymba: dense vs paged logits differ by {dense_paged}")
    check(ssm["y_max_abs_diff"] <= ssm_tol * ssm["y_max_abs"],
          f"hymba: hoisted vs literal SSM prefill outputs differ by "
          f"{ssm['y_max_abs_diff']} > {ssm_tol} x {ssm['y_max_abs']}")
    for k, d in ssm["state_max_abs_diff"].items():
        check(d <= ssm_tol * max(ssm["state_max_abs"][k], 1.0),
              f"hymba: hoisted vs literal SSM state '{k}' differs by {d}")
    del model, logits_all
    gc.collect()
    torch.cuda.empty_cache()


def _serve_trace_args(arch: str) -> list:
    """The hybrid serve cell: 16 requests with prompts uniform in [512,
    1536] (some past hymba's 1024 window), 32 new tokens, 8 slots,
    max_len 2048, both layouts."""
    return ["--arch", arch, "--cache-layout", "both", "--requests", "16",
            "--slots", "8", "--prompt-len", "512", "--prompt-len-max",
            "1536", "--new-tokens", "32", "--max-len", "2048", "--repeats",
            "1", "--json", ""]


HYMBA_SERVE_ARGS = _serve_trace_args("hymba-1.5b")
XLSTM_SERVE_ARGS = _serve_trace_args("xlstm-125m")


def _ssm_legs(metrics) -> dict:
    """Per leg: tok/s, TTFT, the SSM state bytes and resident KV."""
    return {lo: dict(tok_per_s=m["tok_per_s"], ttft_s=m["ttft_s"],
                     wall_s=m["wall_s"], warmup_s=m["warmup_s"],
                     dispatches=m["dispatches"],
                     ssm_state_bytes=m["memory"]["ssm_state_bytes"],
                     peak_resident_cache_bytes=m["memory"][
                         "peak_resident_cache_bytes"])
            for lo, m in metrics["layouts"].items()}


#: hymba-1.5b's depth in serve_hymba: 16 of its 32 layers, full attention
#: at the first, middle and last of them as in the full model (the phase
#: took 71.3 s at 32 layers on an 850 s run)
HYMBA_SERVE_LAYERS = 16
HYMBA_SERVE_GLOBAL = (0, 7, 15)


def phase_serve_hymba(torch, fm, dec, serve) -> dict:
    """The hybrid main path: hymba-1.5b at full width cut to
    :data:`HYMBA_SERVE_LAYERS` layers (fp32), the launcher on both
    layouts (:data:`HYMBA_SERVE_ARGS`): equal streams, every request its
    tokens, finite logits, and in each leg's timed run K1 launched once
    per layer and prefill dispatch and K2 (dense) / K3 (paged) once per
    layer and decode step; tok/s, TTFT, peak allocated and the SSM state
    bytes reported (layers x 8 slots x (3200·16 + 3·3200) x 4 B)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              n_layers=HYMBA_SERVE_LAYERS,
                              hybrid_global_layers=HYMBA_SERVE_GLOBAL)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the hybrid main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(HYMBA_SERVE_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 32, cfg.vocab)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    want_ssm = cfg.n_layers * 8 * (di * n + (cfg.ssm.conv_dim - 1) * di) * 4
    emit("serve_hymba", args=" ".join(HYMBA_SERVE_ARGS),
         n_layers=cfg.n_layers, seconds=wall,
         legs=legs, ssm=_ssm_legs(metrics),
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         ssm_state_bytes_expected=want_ssm)
    check("outputs_match" in metrics, "the hymba phase ran one layout")
    for lo, m in metrics["layouts"].items():
        check(m["memory"]["ssm_state_bytes"] == want_ssm,
              f"hymba {lo}: ssm_state_bytes {m['memory']['ssm_state_bytes']}"
              f" != {want_ssm}")
    for name in ("fusemax_prefill", "decode_partials",
                 "paged_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on hymba's path")
    check(launches["fusemax_prefill_by_dims"].get("64x64", 0)
          == launches["fusemax_prefill"],
          f"K1 launches by dims {launches['fusemax_prefill_by_dims']}")
    check(0 < launches["fusemax_prefill_windowed"]
          < launches["fusemax_prefill"], "K1 never ran both layer kinds")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: serve_xlstm's cut of xlstm-125m: 3 of its 12 layers, mLSTM, sLSTM,
#: mLSTM, so that both mixers serve (the phase took 95 s at 12 layers,
#: 43-47 s at 6, most of it stepping the recurrences token by token)
XLSTM_LAYERS = 3


def phase_serve_xlstm(torch, fm, dec, serve) -> dict:
    """xlstm-125m at full width (mLSTM d_inner 1536 with head dim 384; no
    attention) cut to :data:`XLSTM_LAYERS` layers, sLSTM at layer 1, the
    launcher on the hybrid serve trace, both layouts: equal streams, every
    request its tokens, no attention kernel launched, no resident KV."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              n_layers=XLSTM_LAYERS, slstm_layers=(1,))
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(XLSTM_SERVE_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    # no attention layer: every kernel count must stay 0
    legs = _check_legs(metrics, 0, 16, 32, cfg.vocab)
    emit("serve_xlstm", args=" ".join(XLSTM_SERVE_ARGS),
         config=f"xlstm-125m n_layers={XLSTM_LAYERS} slstm_layers=(1,)",
         seconds=wall, legs=legs, ssm=_ssm_legs(metrics),
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches)
    check("outputs_match" in metrics, "the xlstm phase ran one layout")
    check(all(launches[k] == 0 for k in ("fusemax_prefill",)
              + DECODE_KERNELS), f"xlstm launched attention kernels: "
                                 f"{launches}")
    for lo, m in metrics["layouts"].items():
        check(m["memory"]["peak_resident_cache_bytes"] == 0
              and m["memory"]["ssm_state_bytes"] > 0,
              f"xlstm {lo}: resident KV / SSM state {m['memory']}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_model_frontends(torch, fm, dec) -> None:
    """The frame and patch front ends at the model level, fp32:
    musicgen-large at full width cut to 4 layers (frames, layernorm,
    tanh-GeLU, MHA at head dim 64, G = 1) and pixtral-12b-smoke (patches,
    GQA at head dim 32): ``forward`` on 2 x 256 seeded embeddings, a
    prefill of their first 240 and 16 decode steps on the rest, with
    ``attn_impl`` "cuda" and "torch": logits within 1e-4 of their scale,
    prefill + decode within 2e-3 of ``forward`` (the reference's own
    check), K1 and K2 launched on the cuda runs only."""
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    rel_tol = 1e-4
    out = {}
    for cfg in (dataclasses.replace(get_config("musicgen-large"),
                                    n_layers=4),
                get_config("pixtral-12b-smoke")):
        model = tf.init(cfg, 0, rt_c, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        b, s, s_pref = 2, 256, 240
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
        res = {}
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            _zero_counts(fm, dec)
            full = tf.forward(cfg, model, {"inputs": x}, rt)
            caches = tf.init_cache(cfg, b, s, torch.float32, "cuda")
            lg, caches = tf.prefill(cfg, model, {"inputs": x[:, :s_pref]},
                                    caches, rt)
            steps = [lg]
            for t in range(s_pref, s):
                kv = torch.full((b,), t + 1, dtype=torch.int32,
                                device="cuda")
                lg, caches = tf.decode_step(cfg, model, x[:, t:t + 1],
                                            caches, kv, rt)
                steps.append(lg)
            res[name] = (full, torch.stack(steps, dim=1), _counts(fm, dec))
        (fc, sc, nc), (ft, st, nt) = res["cuda"], res["torch"]
        scale = ft.abs().max().item()
        out[cfg.name] = dict(
            frontend=cfg.frontend, n_layers=cfg.n_layers,
            forward_max_abs_diff=(fc - ft).abs().max().item(),
            serve_max_abs_diff=(sc - st).abs().max().item(),
            serve_vs_forward=(sc - fc[:, s_pref - 1:]).abs().max().item(),
            logits_max_abs=scale,
            finite=bool(torch.isfinite(fc).all() and torch.isfinite(sc)
                        .all()),
            cuda_launches={k: nc[k] for k in ("fusemax_prefill",
                                              "decode_partials")},
            torch_launches={k: nt[k] for k in ("fusemax_prefill",
                                               "decode_partials")})
        del model, res, caches
        gc.collect()
        torch.cuda.empty_cache()
    emit("model_frontends", rel_tol=rel_tol, prefill=240, decode_steps=16,
         models=out)
    for name, r in out.items():
        check(r["finite"], f"{name}: non-finite logits")
        for key in ("forward_max_abs_diff", "serve_max_abs_diff"):
            check(r[key] <= rel_tol * r["logits_max_abs"],
                  f"{name}: cuda vs torch {key} {r[key]} > {rel_tol} x "
                  f"{r['logits_max_abs']}")
        check(r["serve_vs_forward"] <= 2e-3 * r["logits_max_abs"],
              f"{name}: prefill + decode vs forward {r['serve_vs_forward']}")
        check(r["cuda_launches"]["fusemax_prefill"] > 0
              and r["cuda_launches"]["decode_partials"] > 0
              and not any(r["torch_launches"].values()),
              f"{name}: launches {r['cuda_launches']} / "
              f"{r['torch_launches']}")


# ---------------------------------------------------------------------------
# 19. train: K1 with a log-sum-exp output, the attention Function, and
#     stablelm-1.6b trained at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 4, 3e-4
#: the launcher leg: its default dtype (bf16 parameters and activations)
TRAIN_LAUNCHER_STEPS = 3
#: first step, attn_impl "cuda" against "torch": the loss (relative), the
#: global grad norm (relative), each grad leaf (against its largest
#: magnitude); the two differ in K1's 3xTF32 forward only
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_TOL = 1e-5, 1e-4, 1e-3
#: the launcher's first bf16 step, ``--attn-impl cuda`` against
#: ``torch`` from one seed: the loss and the global grad norm (relative).
#: Both attention forwards compute in fp32 and round their output to bf16
#: (unit roundoff 2^-8); K1's 3xTF32 scores move the last bit of a few of
#: those outputs, and the bf16 layers after them carry that on
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GNORM_RTOL = 2.0 ** -8, 2.0 ** -6
#: (dq, dk, dv) of the Function, CUDA forward against the plain one,
#: against their largest magnitude
FN_GRAD_TOL = 1e-4


def k1_lse_cases(torch):
    """K1 with its log-sum-exp output at every head dims training can
    reach, each with a window, a softcap and a ragged ``m_valid``, in
    bf16 at the launcher's training shape (stablelm-1.6b: B 4, 32/32
    heads, P = M = 1024, causal, d64), and in fp32 at the 100M example's
    (B 8, 10/2 heads, G 5, P = M = 256, causal, d64): (name, b, hkv,
    group, p, m, e, f, dtype, kwargs)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cw = dict(causal=True, window=100, softcap=30.0)
    return [
        (f"lse bf16 E64 F64 stablelm train B{TRAIN_BATCH} 32/32 heads "
         f"P=M={TRAIN_SEQ} causal", TRAIN_BATCH, 32, 1, TRAIN_SEQ,
         TRAIN_SEQ, 64, 64, bf16, dict(causal=True)),
        ("lse fp32 E64 F64 g1 window=100 softcap=30 m_valid=280", 2, 4, 1,
         300, 300, 64, 64, f32, dict(cw, m_valid=280)),
        ("lse bf16 E64 F64 g1 window=100 softcap=30 m_valid=280", 1, 4, 1,
         300, 300, 64, 64, bf16, dict(cw, m_valid=280)),
        ("lse fp32 E128 F128 g4 q_offset=60 window=100 softcap=30 "
         "m_valid=250", 1, 2, 4, 200, 260, 128, 128, f32,
         dict(cw, q_offset=60, m_valid=250)),
        ("lse fp32 E192 F128 g1 window=64 softcap=20 m_valid=190", 1, 4, 1,
         200, 200, 192, 128, f32,
         dict(causal=True, window=64, softcap=20.0, m_valid=190)),
        ("lse fp32 E256 F256 g2 window=100 softcap=50 m_valid=240", 1, 2, 2,
         260, 260, 256, 256, f32,
         dict(causal=True, window=100, softcap=50.0, m_valid=240)),
        ("lse fp32 E32 F32 g2 window=64 softcap=50 m_valid=140", 2, 2, 2,
         150, 150, 32, 32, f32,
         dict(causal=True, window=64, softcap=50.0, m_valid=140)),
        (f"lse fp32 E64 F64 g5 granite-100m train B{EX100M_BATCH} 10/2 "
         f"heads P=M={EX100M_SEQ} causal", EX100M_BATCH, 2, 5, EX100M_SEQ,
         EX100M_SEQ, 64, 64, f32, dict(causal=True)),
    ]


def run_k1_lse_cases(torch, gen, fm, autotune,
                     parent: Optional[ParentK1] = None) -> list:
    """Each LSE case: the output against the plain version's (the K1
    tolerance), the log-sum-exp within ``LSE_TOL`` of the plain
    version's, and the output with an LSE requested equal, bit for bit,
    to the output without one (``out_same_bits``); with ``parent``, at
    ``PARENT_K1_DIMS`` also the output's float64 distance against the
    parent body's (``_vs_parent``)."""
    rows = []
    for name, b, hkv, g, p, m, e, f, dtype, kw in k1_lse_cases(torch):
        tile = autotune.attention_params(p * g, m, e, f, impl="cuda")
        q = _rand(torch, gen, (b * hkv, p * g, e), dtype)
        k = _rand(torch, gen, (b * hkv, m, e), dtype)
        v = _rand(torch, gen, (b * hkv, m, f), dtype)
        args = dict(scale=e ** -0.5, group=g, block_q=tile.block_q,
                    block_k=tile.block_k, **kw)
        out, lse = fm.fusemax_attention_cuda(q, k, v, return_lse=True,
                                             **args)
        bare = fm.fusemax_attention_cuda(q, k, v, **args)
        ref, lse_ref = fm.fusemax_attention_torch(q, k, v, return_lse=True,
                                                  **args)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        lse_err = (lse - lse_ref).abs().max().item()
        same = bool(torch.equal(out, bare))
        rows.append(dict(kernel="fusemax_prefill", case=name, dtype=dn,
                         e=e, f=f, tile=[tile.block_q, tile.block_k],
                         max_abs_err=err, atol=atol, rtol=rtol,
                         lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
                         out_same_bits=same,
                         ok=ok and lse_err <= LSE_TOL and same))
        if parent is not None and (e, f) in PARENT_K1_DIMS:
            rows[-1].update(_vs_parent(torch, fm, parent, rows[-1], q, k, v,
                                       out, ref, args))
    return rows


def function_cases(torch, gen, ops) -> list:
    """``ops.fusemax_attention`` under autograd on the card: (dq, dk, dv)
    of K1's forward (with its LSE) and the recompute backward against the
    plain forward and the same backward, within ``FN_GRAD_TOL`` of their
    scale, and both against float64 autograd through ``mha_reference``
    (``impl="ref"``): the CUDA path no farther than the plain one plus
    ``F64_SLACK`` (``ok_vs_f64``)."""
    rows = []
    for name, b, hq, hkv, p, m, d, kw in (
            ("function stablelm MHA d64 P=M=1024 causal", 1, 32, 32, 1024,
             1024, 64, dict(causal=True)),
            ("function GQA g4 d128 P=M=512 window=256 softcap=50", 1, 16, 4,
             512, 512, 128, dict(causal=True, window=256, softcap=50.0))):
        q = _rand(torch, gen, (b, hq, p, d), torch.float32)
        k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
        v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
        dout = _rand(torch, gen, (b, hq, p, d), torch.float32)
        grads = {}
        for impl, dt in (("cuda", torch.float32), ("torch", torch.float32),
                         ("ref", torch.float64)):
            xs = [x.to(dt).requires_grad_(True) for x in (q, k, v)]
            out = ops.fusemax_attention(*xs, impl=impl, **kw)
            grads[impl] = torch.autograd.grad(out, xs, dout.to(dt))
        torch.cuda.synchronize()
        errs, scales, vs = {}, {}, {}
        for i, x in enumerate("qkv"):
            c, t, r = (grads[n][i] for n in ("cuda", "torch", "ref"))
            scales[x] = t.abs().max().item()
            errs[x] = (c - t).abs().max().item()
            vs[x] = {"kernel": (c.double() - r).abs().max().item(),
                     "plain": (t.double() - r).abs().max().item()}
        ok_plain = all(errs[x] <= FN_GRAD_TOL * scales[x] for x in "qkv")
        ok_f64 = all(vs[x]["kernel"] <= vs[x]["plain"] + F64_SLACK
                     for x in "qkv")
        rows.append(dict(kernel="fusemax_prefill", case=name, dtype="float32",
                         e=d, f=d, grad_max_abs_err=errs, grad_scale=scales,
                         grad_tol=FN_GRAD_TOL, vs_f64=vs,
                         f64_slack=F64_SLACK, ok_vs_plain=ok_plain,
                         ok_vs_f64=ok_f64, ok=ok_plain and ok_f64,
                         max_abs_err=max(errs.values())))
        del grads
    torch.cuda.empty_cache()
    return rows


def time_train(torch, gen, fm, autotune) -> dict:
    """K1 with its LSE at the training shape (B 4, 32/32 heads, P = M =
    1024, causal, (64, 64)): ``_time_k1_shape``'s row with the kernel's
    device time; and the recompute backward at that shape: its time, its
    bound (2 (3E + 2F) FLOPs a visible (query, key) pair, about 2.5 x the
    forward's, against the 3xTF32 and the FP32 rates; each input read and
    each output written once), SDPA's fp32 backward on the same inputs as
    the yardstick it never calls, and (dq, dk, dv) after K1's forward
    against those after the plain forward."""
    import torch.nn.functional as F

    b, h, p, d = TRAIN_BATCH, 32, TRAIN_SEQ, 64
    fwd = _time_k1_shape(torch, gen, fm, autotune, b=b, hq=h, hkv=h, p=p,
                         m=p, e=d, f=d, q_offset=0, return_lse=True,
                         with_device_ms=True,
                         shape=f"stablelm train: B{b} {h}/{h} heads P=M={p} "
                               f"causal d{d}, with the LSE")
    q, k, v, dout = (_rand(torch, gen, (b, h, p, d), torch.float32)
                     for _ in range(4))
    fold = lambda x: x.reshape(b * h, p, d)
    tile = autotune.attention_params(p, p, d, d, impl="cuda")
    args = dict(scale=d ** -0.5, causal=True, group=1)
    saved = {}
    for impl in ("cuda", "torch"):
        fwd_fn = fm.fusemax_attention_cuda if impl == "cuda" \
            else fm.fusemax_attention_torch
        out, lse = fwd_fn(fold(q), fold(k), fold(v), return_lse=True,
                          block_q=tile.block_q if impl == "cuda" else 128,
                          block_k=tile.block_k if impl == "cuda" else 128,
                          **args)
        saved[impl] = (out, lse)
    bwd = lambda impl: fm.fusemax_attention_bwd(
        fold(q), fold(k), fold(v), *saved[impl], fold(dout), **args)
    gc_, gt = bwd("cuda"), bwd("torch")
    errs = [(a - t).abs().max().item() / t.abs().max().item()
            for a, t in zip(gc_, gt)]
    del gc_, gt
    ms = time_ms(torch, lambda: bwd("cuda"), iters=5, warmup=1)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             scale=d ** -0.5)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), dout, retain_graph=True), iters=5, warmup=1)
    pairs = b * h * p * (p + 1) // 2
    flops = 2 * (3 * d + 2 * d) * pairs
    nbytes = 4 * (3 * q.numel() + 2 * dout.numel() + b * h * p
                  + 3 * q.numel())
    t_3x = 3 * flops / TF32_FLOPS * 1e3
    t_fp32 = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bwd_row = dict(
        shape=f"stablelm train backward: B{b} {h}/{h} heads P=M={p} causal "
              f"d{d}, blocks of {fm.BWD_BLOCK_K} keys",
        ms=ms, plain_ms=ms, plain_note="the backward is torch ops: it is its "
                                       "own plain version",
        library_ms=library_ms, library="SDPA fp32 backward (default "
                                       "backend), never called by the port",
        bound_ms=max(t_3x, t_bytes),
        bound_by="operations" if t_3x >= t_bytes else "bytes",
        bound_ms_3xtf32=max(t_3x, t_bytes), bound_ms_fp32=max(t_fp32, t_bytes),
        share_of_fp32_bound=max(t_fp32, t_bytes) / ms,
        flops=flops, bytes=nbytes, fwd_flops=fwd["flops"],
        grad_rel_err_cuda_vs_torch_fwd=errs,
        max_abs_err=max(errs), ok=max(errs) <= FN_GRAD_TOL)
    del saved, lib_out, qs, ks, vs
    torch.cuda.empty_cache()
    return {"fusemax_prefill@train_lse": fwd,
            "fusemax_attention_bwd@train": bwd_row}


def _train_batch(torch, cfg, seed: int = 0) -> dict:
    from repro_torch.data import DataConfig, SyntheticSource

    src = SyntheticSource(DataConfig(global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, vocab=cfg.vocab,
                                     seed=seed))
    return {k: v.to("cuda") for k, v in src.batch_at(0).items()}


def phase_train(torch, fm, dec) -> dict:
    """stablelm-1.6b at full width and depth, fp32, one seed, batch 4 x
    1024: the loss and every gradient of the first step with
    ``attn_impl="cuda"`` and ``"torch"`` on the same batch; then
    ``TRAIN_STEPS`` steps of the train step (AdamW, warmup-cosine, clip)
    through K1 on that batch, repeated — the main path: counts set to 0
    just before, read just after; K1 launches twice a layer a step (the
    forward and the remat recompute), each with its LSE."""
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    opt = make_optimizer("adamw")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, opt, rt_c, device="cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    batch = _train_batch(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the first step's loss and grads, K1 against its plain version
    params = list(state.params.values())
    first = {}
    for name, rt in (("cuda", rt_c), ("torch", rt_t)):
        k1 = fm.fusemax_attention_cuda.launches
        t0 = time.perf_counter()
        loss, _ = tf.loss_fn(cfg, state.model, batch, rt)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        first[name] = dict(loss=loss.item(), grads=grads,
                           seconds=time.perf_counter() - t0,
                           k1=fm.fusemax_attention_cuda.launches - k1)
        del loss
    gc_, gt = first["cuda"].pop("grads"), first["torch"].pop("grads")
    gnorm = {n: torch.sqrt(sum((g.double() ** 2).sum() for g in gs)).item()
             for n, gs in (("cuda", gc_), ("torch", gt))}
    leaf_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(gc_, gt))
    del gc_, gt
    torch.cuda.empty_cache()
    loss_rel = abs(first["cuda"]["loss"] - first["torch"]["loss"]) \
        / abs(first["torch"]["loss"])
    gnorm_rel = abs(gnorm["cuda"] - gnorm["torch"]) / gnorm["torch"]

    # the main path: the train step through K1
    step = make_train_step(cfg, opt, warmup_cosine(TRAIN_LR, 1, TRAIN_STEPS),
                           rt_c)
    _zero_counts(fm, dec)
    fm.fusemax_attention_cuda.launches_lse = 0
    fm.fusemax_attention_bwd.calls = 0
    losses, gnorms, lrs, secs, per_step = [], [], [], [], []
    for _ in range(TRAIN_STEPS):
        k1 = fm.fusemax_attention_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        gnorms.append(m["grad_norm"].item())
        lrs.append(m["lr"].item())
        per_step.append(fm.fusemax_attention_cuda.launches - k1)
    launches = _counts(fm, dec)
    launches["fusemax_prefill_lse"] = fm.fusemax_attention_cuda.launches_lse
    launches["backward_calls"] = fm.fusemax_attention_bwd.calls
    launches["step_losses"], launches["step_grad_norms"] = losses, gnorms
    launches["step_seconds"] = secs
    peak = torch.cuda.max_memory_allocated()
    steady = secs[1:]
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (sum(steady) / len(steady))
    emit("train", config=f"{TRAIN_ARCH} fp32, {cfg.n_layers} layers, d "
                         f"{cfg.d_model}", n_params=n_params,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s,
         first_step={n: first[n] for n in first}, loss_rel_diff=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, grad_norm=gnorm, grad_norm_rel_diff=
         gnorm_rel, grad_norm_rtol=TRAIN_GNORM_RTOL,
         grad_leaf_max_rel_diff=leaf_err, grad_leaf_tol=TRAIN_LEAF_TOL,
         losses=losses, grad_norms=gnorms, lrs=lrs, step_seconds=secs,
         tokens_per_s=tok_s, k1_launches_per_step=per_step,
         main_path_launches=launches, max_memory_allocated=peak)
    check(first["cuda"]["k1"] == 2 * cfg.n_layers
          and first["torch"]["k1"] == 0,
          f"first step: K1 launched {first['cuda']['k1']} / "
          f"{first['torch']['k1']} times (cuda / torch), expected "
          f"{2 * cfg.n_layers} / 0")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"first-step loss cuda vs torch "
                                       f"differs by {loss_rel} (relative)")
    check(gnorm_rel <= TRAIN_GNORM_RTOL,
          f"first-step grad norm cuda vs torch differs by {gnorm_rel}")
    check(leaf_err <= TRAIN_LEAF_TOL,
          f"a first-step grad leaf differs by {leaf_err} of its scale")
    check(all(x == x and abs(x) != float("inf") for x in losses + gnorms),
          f"non-finite loss or grad norm: {losses}, {gnorms}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(per_step == [2 * cfg.n_layers] * TRAIN_STEPS
          and launches["fusemax_prefill_lse"] == launches["fusemax_prefill"]
          and launches["backward_calls"] == cfg.n_layers * TRAIN_STEPS,
          f"K1 launches per step {per_step} (expected {2 * cfg.n_layers}: "
          f"forward + remat), {launches['fusemax_prefill_lse']} with an "
          f"LSE of {launches['fusemax_prefill']}, "
          f"{launches['backward_calls']} backward passes")
    for other in DECODE_KERNELS:
        check(launches[other] == 0, f"{other} launched while training")
    del state, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: the sharded phases' mesh: (data 2, model 2) positions, all cuda:0
SHARD_MESH = (2, 2)
#: the sharded step against the unsharded one (the reference's rtol), and
#: the first grad norm's
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL = 2e-4, 1e-5
#: train_elastic: stablelm-1.6b at full width cut to this many layers
ELASTIC_LAYERS = 2


def phase_train_sharded(torch, fm, dec, unsharded: dict) -> dict:
    """The train phase's run (stablelm-1.6b, full width and depth, fp32,
    its 4 x 1024 batch, seed and schedule) on a (data 2, model 2) mesh of
    cuda:0 under ``fsdp_tp``: the state held as its shards (each
    parameter, its AdamW moments split by the rules), each data shard's
    half of the batch through K1 + LSE per kv-head shard — the main path:
    counts set to 0 just before, read just after.  Gates: the losses equal
    the train phase's within the reference's rtol 2e-4, the first grad
    norm within 1e-5 relative, K1 + LSE 2 data x 2 kv-head shards x 24
    layers x 2 (forward + remat) launches a step, and each position's
    parameter and optimizer bytes (from the shard shapes) equal the bytes
    of the shard tensors it reads."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.model.layers import Runtime
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.training import (
        init_train_state, make_train_step, shard_train_state,
    )

    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh(SHARD_MESH, ("data", "model"),
                     ["cuda:0"] * math.prod(SHARD_MESH))
    rules = shd.make_rules(mesh, "fsdp_tp")
    rt = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                 param_dtype=torch.float32,
                 shard_activation=shd.act_sharder(mesh, rules))
    opt = make_optimizer("adamw")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = shard_train_state(init_train_state(cfg, 0, opt, rt,
                                               device="cuda"),
                              cfg, mesh, rules)
    batch = _train_batch(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    step = make_train_step(cfg, opt, warmup_cosine(TRAIN_LR, 1, TRAIN_STEPS),
                           rt, mesh=mesh, rules=rules)
    _zero_counts(fm, dec)
    fm.fusemax_attention_cuda.launches_lse = 0
    losses, gnorms, secs, per_step = [], [], [], []
    for _ in range(TRAIN_STEPS):
        k1 = fm.fusemax_attention_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        gnorms.append(m["grad_norm"].item())
        per_step.append(fm.fusemax_attention_cuda.launches - k1)
    launches = _counts(fm, dec)
    launches["fusemax_prefill_lse"] = fm.fusemax_attention_cuda.launches_lse
    peak = torch.cuda.max_memory_allocated()
    pos_bytes = state.position_bytes()
    planned = [a + b for a, b in zip(pos_bytes["params"],
                                     pos_bytes["opt_state"])]
    in_shards = state.held_position_bytes()
    ref_l, ref_g = unsharded["step_losses"], unsharded["step_grad_norms"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_l))
    gnorm_rel = abs(gnorms[0] - ref_g[0]) / ref_g[0]
    expect = math.prod(SHARD_MESH) * cfg.n_layers * 2
    steady = secs[1:]
    emit("train_sharded", config=f"{TRAIN_ARCH} fp32, {cfg.n_layers} "
         f"layers, d {cfg.d_model}", mesh=dict(mesh.shape),
         devices=[str(d) for d in mesh.devices], rules="fsdp_tp",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s, losses=losses,
         unsharded_losses=ref_l, loss_max_rel_diff=loss_rel,
         loss_rtol=SHARD_LOSS_RTOL, grad_norms=gnorms,
         unsharded_grad_norms=ref_g, first_grad_norm_rel_diff=gnorm_rel,
         grad_norm_rtol=SHARD_GNORM_RTOL, step_seconds=secs,
         unsharded_step_seconds=unsharded["step_seconds"],
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (sum(steady) / len(steady)),
         k1_launches_per_step=per_step, main_path_launches=launches,
         position_bytes=pos_bytes, shard_tensor_bytes=in_shards,
         state_bytes_held=held, max_memory_allocated=peak)
    check(loss_rel <= SHARD_LOSS_RTOL,
          f"sharded losses {losses} vs unsharded {ref_l}: {loss_rel}")
    check(gnorm_rel <= SHARD_GNORM_RTOL,
          f"sharded first grad norm {gnorms[0]} vs {ref_g[0]}: {gnorm_rel}")
    check(per_step == [expect] * TRAIN_STEPS
          and launches["fusemax_prefill_lse"] == launches["fusemax_prefill"],
          f"K1 launches per step {per_step}, expected {expect} (2 data x 2 "
          f"kv-head shards x {cfg.n_layers} layers x forward + remat), "
          f"{launches['fusemax_prefill_lse']} with an LSE")
    check(planned == in_shards and len(set(planned)) == 1,
          f"per-position bytes {planned} vs the shard tensors' {in_shards}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_elastic(torch, fm, dec) -> dict:
    """The elastic re-mesh: stablelm-1.6b at full width cut to
    ``ELASTIC_LAYERS`` layers, fp32, two steps on a (2, 2) mesh of cuda:0,
    a checkpoint (leaves written whole), two more steps (the uninterrupted
    run); then half the devices lost: ``ElasticMeshManager.plan`` picks
    (1, 2), a fresh state on it (another seed) restores the checkpoint
    onto that mesh and takes the same two steps.  Gate: its losses equal
    the uninterrupted run's within 2e-4."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.fault_tolerance import (
        ElasticMeshManager, RecoveryLog,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.model.layers import Runtime
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.training import (
        init_train_state, make_train_step, shard_train_state,
        state_shardings,
    )

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=ELASTIC_LAYERS)
    opt = make_optimizer("adamw")
    src = SyntheticSource(DataConfig(global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, vocab=cfg.vocab,
                                     seed=5))
    batches = [{k: v.to("cuda") for k, v in src.batch_at(i).items()}
               for i in range(4)]
    log = RecoveryLog()

    def build(shape, seed):
        mesh = make_mesh(shape, ("data", "model"),
                         ["cuda:0"] * math.prod(shape))
        rules = shd.make_rules(mesh, "fsdp_tp")
        rt = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                     param_dtype=torch.float32)
        whole = init_train_state(cfg, seed, opt, rt, device="cuda")
        sh = state_shardings(whole, shd.param_axes(cfg, whole.model), mesh,
                             rules)
        state = shard_train_state(whole, cfg, mesh, rules)
        step = make_train_step(cfg, opt, warmup_cosine(TRAIN_LR, 1, 8), rt,
                               mesh=mesh, rules=rules)
        return state, step, sh

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="elastic_")
    state, step, _ = build(SHARD_MESH, 0)
    for i in range(2):
        state, _ = step(state, batches[i])
    ckpt.save(tmp, 2, state.as_tree())
    log.record("checkpoint", step=2)
    ref = []
    for i in range(2, 4):
        state, m = step(state, batches[i])
        ref.append(m["loss"].item())
    del state
    gc.collect()
    plan = ElasticMeshManager(model_parallel=SHARD_MESH[1],
                              devices_per_pod=8).plan(2)
    state, step, sh = build(plan.shape, 1)
    state.load_tree(ckpt.restore(tmp, 2, state.as_tree(), sh))
    log.record("remesh", step=2, shape=list(plan.shape))
    got = []
    for i in range(2, 4):
        state, m = step(state, batches[i])
        got.append(m["loss"].item())
    shutil.rmtree(tmp, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    emit("train_elastic", config=f"{TRAIN_ARCH} fp32, {cfg.n_layers} "
         f"layers, d {cfg.d_model}", first_mesh=list(SHARD_MESH),
         plan=dict(shape=list(plan.shape), axes=list(plan.axes),
                   n_devices=plan.n_devices), uninterrupted_losses=ref,
         restored_losses=got, loss_max_rel_diff=rel,
         loss_rtol=SHARD_LOSS_RTOL, recovery_log=log.events,
         seconds=time.perf_counter() - t0)
    check(tuple(plan.shape) == (1, SHARD_MESH[1]),
          f"elastic plan {plan} for 2 surviving devices")
    check(rel <= SHARD_LOSS_RTOL,
          f"restored losses {got} vs uninterrupted {ref}: {rel}")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": got}


#: the measured share of the dry run's compute bound above which the
#: bound is a miscount (the step cannot beat its bound)
DRYRUN_SHARE_MAX = 1.05


def phase_dryrun(torch, unsharded: dict) -> dict:
    """``repro_torch.launch.dryrun`` on the card: the peaks read through
    ``torch.cuda.get_device_properties``; stablelm-1.6b at the train
    phase's shape (4 x 1024, fp32, a 1 x 1 mesh) beside that phase's
    measured step — its compute term (FlopCounterMode on meta tensors plus
    the attention formula, at the fp32 peak) over the steady step seconds
    must be at most ``DRYRUN_SHARE_MAX``; ``--list``; one production cell
    per mesh (gemma2-9b decode_32k on 16 x 16 and 2 x 16 x 16).  Nothing
    is allocated on the card."""
    import contextlib
    import io

    from repro_torch.analysis.roofline import card_peaks
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    peaks = card_peaks()
    cfg = get_config(TRAIN_ARCH)
    rec = dryrun.lower_cell(TRAIN_ARCH, "train_4k",
                            mesh=make_mesh((1, 1), ("data", "model"),
                                           ["meta"]),
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            dtype=torch.float32)
    steady = unsharded["step_seconds"][1:]
    measured = sum(steady) / len(steady)
    compute_s = rec["roofline"]["compute_s"]
    share = compute_s / measured
    tokens = TRAIN_BATCH * TRAIN_SEQ
    eight_nd = 8 * cfg.param_count() * tokens
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--list"])
    listed = out.getvalue().strip().splitlines()
    cells = {}
    for multi in (False, True):
        r = dryrun.lower_cell("gemma2-9b", "decode_32k", multi_pod=multi)
        cells[r["mesh"]] = {k: r[k] for k in ("chips", "mesh_shape",
                                              "model_axis_spans_hosts",
                                              "memory", "roofline")}
    after = torch.cuda.memory_allocated()
    emit("dryrun", peaks=dict(name=peaks.name, flops=peaks.flops,
                              hbm_bytes_per_s=peaks.hbm_bytes_per_s,
                              nvlink_bytes_per_s=peaks.nvlink_bytes_per_s,
                              network_bytes_per_s=peaks.network_bytes_per_s,
                              source=peaks.source),
         device_name=torch.cuda.get_device_properties(0).name,
         train_cell=dict(shape=f"{TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} "
                               "fp32 1 x 1", cost=rec["cost"],
                         memory=rec["memory"], roofline=rec["roofline"],
                         eight_n_d=eight_nd),
         measured_step_s=measured, compute_s=compute_s,
         measured_share_of_bound=share, share_max=DRYRUN_SHARE_MAX,
         list_last=listed[-1], production_cells=cells,
         allocated_before=before, allocated_after=after,
         seconds=time.perf_counter() - t0)
    check(share <= DRYRUN_SHARE_MAX,
          f"the dry run's compute term {compute_s} s is {share} of the "
          f"measured step {measured} s: a miscount")
    check(listed[-1] == "32 applicable cells", f"--list ended {listed[-1]}")
    check(before == after, f"the dry run allocated {after - before} bytes")
    check(all(c["model_axis_spans_hosts"] for c in cells.values()),
          "a 16-way model axis must span two hosts of 8")
    return rec


def phase_train_launcher(torch, fm) -> dict:
    """``launch/train.py``'s ``main`` on stablelm-1.6b at its default
    dtype (bf16 parameters and activations): ``TRAIN_LAUNCHER_STEPS``
    steps of the synthetic stream, K1 twice a layer a step, the loss
    finite; then one step from the same seed with ``--attn-impl torch``
    (the plain forward): the first step's loss and grad norm of the two
    within ``TRAIN_BF16_LOSS_RTOL`` / ``TRAIN_BF16_GNORM_RTOL``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_LAUNCHER_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    t0 = time.perf_counter()
    m = train.main(argv)
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    argv_t = argv[:2] + ["--steps", "1"] + argv[4:] + ["--attn-impl",
                                                       "torch"]
    mt = train.main(argv_t)
    loss_rel = abs(m["losses"][0] - mt["losses"][0]) / abs(mt["losses"][0])
    gnorm_rel = abs(m["grad_norms"][0] - mt["grad_norms"][0]) \
        / mt["grad_norms"][0]
    n_layers = get_config(TRAIN_ARCH).n_layers
    emit("train_launcher", args=" ".join(argv), seconds=wall,
         **{k: m[k] for k in ("losses", "grad_norms", "lrs", "step_seconds",
                              "tokens_per_s", "fusemax_prefill_launches",
                              "peak_memory_bytes", "device", "fp32")},
         first_step_vs_torch=dict(
             args=" ".join(argv_t), loss=mt["losses"][0],
             grad_norm=mt["grad_norms"][0],
             fusemax_prefill_launches=mt["fusemax_prefill_launches"],
             loss_rel_diff=loss_rel, loss_rtol=TRAIN_BF16_LOSS_RTOL,
             grad_norm_rel_diff=gnorm_rel,
             grad_norm_rtol=TRAIN_BF16_GNORM_RTOL))
    check(not m["fp32"] and m["device"]["platform"] == "gpu",
          f"launcher leg ran fp32={m['fp32']} on {m['device']}")
    check(all(x == x and abs(x) != float("inf") for x in m["losses"]),
          f"non-finite bf16 losses {m['losses']}")
    check(mt["fusemax_prefill_launches"] == 0,
          f"--attn-impl torch launched K1 {mt['fusemax_prefill_launches']} "
          f"times")
    check(loss_rel <= TRAIN_BF16_LOSS_RTOL,
          f"bf16 first-step loss cuda vs torch differs by {loss_rel} "
          f"(relative)")
    check(gnorm_rel <= TRAIN_BF16_GNORM_RTOL,
          f"bf16 first-step grad norm cuda vs torch differs by {gnorm_rel}")
    check(m["fusemax_prefill_launches"]
          == 2 * n_layers * TRAIN_LAUNCHER_STEPS,
          f"K1 launched {m['fusemax_prefill_launches']} times in "
          f"{TRAIN_LAUNCHER_STEPS} bf16 steps")
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher over a (2, 2) mesh of the card, at its defaults
    argv_m = ["--mesh", "2x2", "--rules", "fsdp_tp"]
    t0 = time.perf_counter()
    mm = train.main(argv_m)
    n_smoke = get_config(mm["arch"]).n_layers
    emit("train_launcher_mesh", args=" ".join(argv_m),
         seconds=time.perf_counter() - t0,
         **{k: mm[k] for k in ("arch", "losses", "step_seconds",
                               "fusemax_prefill_launches", "position_bytes",
                               "mesh", "rules", "device")})
    check(mm["device"]["platform"] == "gpu"
          and all(x == x and abs(x) != float("inf") for x in mm["losses"]),
          f"--mesh 2x2 trained {mm['losses']} on {mm['device']}")
    check(mm["fusemax_prefill_launches"] == 4 * 2 * n_smoke * mm["steps"],
          f"--mesh 2x2: K1 launched {mm['fusemax_prefill_launches']} times")
    check(len(mm["position_bytes"]["params"]) == 4,
          f"--mesh 2x2 position bytes {mm['position_bytes']}")
    gc.collect()
    torch.cuda.empty_cache()
    return m


# ---------------------------------------------------------------------------
# clocks beside every timed phase
# ---------------------------------------------------------------------------

#: what ``nvidia-smi`` reports beside each timed phase
CLOCK_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
                "clocks_throttle_reasons.active")


def emit_clocks(phase: str, seconds: float) -> None:
    """One ``clocks`` line right after ``phase``: its seconds and the
    card's SM and memory clocks, power draw, temperature and active
    throttle reasons; a query that fails or takes over 60 s fails the
    run."""
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(CLOCK_FIELDS)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"{phase}: nvidia-smi clock query failed: {smi.stderr.strip()}")
    vals = [v.strip() for v in smi.stdout.strip().splitlines()[0].split(",")]
    check(len(vals) == len(CLOCK_FIELDS),
          f"{phase}: nvidia-smi gave {vals} for {CLOCK_FIELDS}")
    emit("clocks", of=phase, seconds=round(seconds, 3),
         **dict(zip(CLOCK_FIELDS, vals)))


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, then its clocks line."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit_clocks(name, time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# the cascade analysis, the numeric cascades and the measured autotuner
# ---------------------------------------------------------------------------

def phase_analysis(torch) -> dict:
    """``repro_torch.analysis.report.check(impl="cuda")``: the declared
    cascades' analysis, and every structural probe on the kernels at the
    main paths' widths — K1 at granite's prefill (B4, 32/8 heads, P = M =
    1024 and 2048, causal, and with a window and a softcap), K2 / K3 at
    granite's decode data (B8, M 2048 and 4096, 16 splits; K3 on a
    permuted pool with sentinel pages, fp32 and fp8), K4 and K2's latent
    branch at DeepSeek's (B8, 128 heads, r 512, rd 64), the verify chains
    (P = 13, P = 5), and the plain torch ops: each live key counted once,
    the position sums exact, the shared memory a launch asks for the same
    at M and 2M; then the ``trace:*`` probes, which read each family's
    pass count off its plain version's torch calls on the CPU, listed with
    their passes (``traced_plain``)."""
    import io

    from repro_torch.analysis import report

    from repro_torch.analysis.lint import TRACE_PROBES

    buf, results = io.StringIO(), []
    t0 = time.perf_counter()
    failures = report.check(impl="cuda", out=buf, results=results)
    probes = [dict(entry=r["name"], probe=pr["probe"],
                   smem_bytes=pr.get("smem_bytes"),
                   page_list_bytes=pr.get("page_list_bytes"),
                   cases=pr["cases"])
              for r in results if r["ok"] for pr in r["probes"]
              if "traced" not in pr]
    traced = {pr["probe"]: dict(entry=r["name"], passes=pr["passes"],
                                multi_gen=pr["multi_gen"])
              for r in results if r["ok"] for pr in r["probes"]
              if "traced" in pr}
    emit("analysis", failures=failures, report=buf.getvalue().splitlines(),
         probes=probes, traced_plain=traced,
         seconds=time.perf_counter() - t0,
         errors=[r["error"] for r in results if not r["ok"]])
    check(failures == 0, f"cascade check: {failures} failure(s): "
          f"{buf.getvalue()}")
    check(set(traced) == set(TRACE_PROBES),
          f"trace probes run: {sorted(traced)}")
    return {"probes": len(probes), "traced": len(traced)}


#: tests/test_cascades_numeric.py's tolerance for every cascade (and K1)
#: against the oracle
CASCADE_TOL = dict(rtol=2e-4, atol=2e-5)


def phase_cascades_numeric(torch, ops) -> dict:
    """The torch cascades of ``repro_torch.core`` on the card at granite's
    prefill shape (B4, 32 heads of 128, P = M = 1024, causal; K/V repeated
    over the 4-head groups): ``attention_{3,2,1}pass`` (blocks of 128) and
    ``attention_decode_1pass`` (the last row, 16 splits), each against the
    3-pass oracle ``reference_attention`` evaluated in float64, with K1's
    output (``fusemax_attention``, GQA) on the same inputs beside them."""
    from repro_torch import core as cn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    b, hq, hkv, m, d = 4, 32, 8, 1024, 128
    q = _rand(torch, gen, (b, hq, m, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    k_e, v_e = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    spec = cn.AttnSpec(causal=True)
    ref = cn.reference_attention(q.double(), k_e.double(), v_e.double(), spec)
    dec_spec = cn.AttnSpec(causal=True, q_offset=m - 1)
    outs = {
        "attention_3pass": (cn.attention_3pass(q, k_e, v_e, spec), ref),
        "attention_2pass": (cn.attention_2pass(q, k_e, v_e, spec,
                                               block=128), ref),
        "attention_1pass": (cn.attention_1pass(q, k_e, v_e, spec,
                                               block=128), ref),
        "attention_decode_1pass": (cn.attention_decode_1pass(
            q[:, :, -1:].contiguous(), k_e, v_e, dec_spec, splits=16),
            ref[:, :, -1:]),
        "fusemax_attention (K1)": (ops.fusemax_attention(
            q, k, v, causal=True, impl="cuda"), ref),
    }
    torch.cuda.synchronize()
    rows = {}
    for name, (out, want) in outs.items():
        diff = (out.double() - want).abs()
        excess = (diff - (CASCADE_TOL["atol"] + CASCADE_TOL["rtol"]
                          * want.abs())).max().item()
        rows[name] = dict(max_abs_err_vs_f64=diff.max().item(),
                          ok=excess <= 0.0)
    emit("cascades_numeric", shape=f"B{b} {hq}/{hkv} heads P=M={m} d{d} "
         "causal", tolerance=CASCADE_TOL, results=rows)
    bad = [n for n, r in rows.items() if not r["ok"]]
    check(not bad, f"cascades off their float64 oracle: {bad}")
    return rows


AUTOTUNE_CACHE = os.path.join("build", "autotune_measured.json")


def phase_autotune_measured(torch, dec, ops, autotune) -> dict:
    """``autotune.measure_best`` over the decode candidates of K2 and K3 at
    granite's decode shape and of K4 at DeepSeek's, each writing its
    winner into the table and the disk cache ``build/
    autotune_measured.json``: the modeled and the measured choice with
    their ms; each kernel at the measured choice against its plain
    version (the kernel cases' fp32 gate); the verify read (P = 13 on
    K2 / K3, P = 5 on K4) through the public op against single-token reads
    under that split, bit for bit; and, after ``clear_table()``, the
    lookups read back from the disk to the same choices.  The table and
    the cache variable are cleared after, so later phases model."""
    path = os.path.join(ROOT, AUTOTUNE_CACHE)
    if os.path.exists(path):
        os.remove(path)
    os.environ[autotune.CACHE_ENV] = path
    autotune.clear_table()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    x = granite_paged_data(torch, gen)
    b, hkv, g, m, d, ps, w = (x[k] for k in ("b", "hkv", "g", "m", "d",
                                             "ps", "w"))
    kvl = list(TIMING_KVL)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    q_f = x["q"].reshape(b * hkv, g, d)
    k_f, v_f = x["k"].reshape(b * hkv, m, d), x["v"].reshape(b * hkv, m, d)
    table = with_sentinels(x["table"], kvl, ps, x["k_pages"].shape[0])
    kv_chain = torch.tensor([min(n, m - GRANITE_SPEC_K) for n in kvl],
                            dtype=torch.int32, device="cuda")
    table_chain = with_sentinels(x["table"], [n + GRANITE_SPEC_K for n in
                                              kv_chain.tolist()], ps,
                                 x["k_pages"].shape[0])
    y = deepseek_decode_data(torch, gen, kvl)
    q4, (ckv, kr), t4 = y["q"], y["pools"]["permuted"], \
        y["tables"]["permuted"]
    # the verify chain's data: tables backed to kv_len + P - 1
    kv_chain4 = [min(n, y["w"] * y["ps"] - MLA_SPEC_K) for n in kvl]
    y4 = deepseek_decode_data(torch, gen, [n + MLA_SPEC_K
                                           for n in kv_chain4])
    gq, hq4 = max(g, 8), y["h"]

    def k2(c, plain=False):
        fn = dec.decode_partials_torch if plain else dec.decode_partials_cuda
        return fn(q_f, k_f, v_f, kv_len, scale=d ** -0.5, hkv=hkv,
                  splits=c.splits, block_k=c.block_k)

    def k3(c, plain=False):
        fn = dec.paged_decode_partials_torch if plain \
            else dec.paged_decode_partials_cuda
        return fn(q_f, x["k_pages"], x["v_pages"], table, kv_len,
                  scale=d ** -0.5, hkv=hkv, splits=c.splits,
                  block_k=c.block_k)

    def k4(c, plain=False):
        fn = dec.mla_paged_decode_partials_torch if plain \
            else dec.mla_paged_decode_partials_cuda
        return fn(q4, ckv, kr, t4, y["kv_len"], scale=(MLA_R + MLA_RD)
                  ** -0.5, splits=c.splits, block_k=c.block_k)

    # the public ops: a P-position verify read against P single reads
    # (position j at kv_len + j), splits and block_k left to the table
    def verify_k2(p):
        qq = _rand(torch, gen, (b, hkv * g, p, d), torch.float32)
        chain = ops.fusemax_decode(qq, x["k"], x["v"], kv_chain, impl="cuda")
        single = torch.cat([ops.fusemax_decode(
            qq[:, :, j:j + 1], x["k"], x["v"], kv_chain + j, impl="cuda")
            for j in range(p)], dim=2)
        return chain, single

    def verify_k3(p):
        qq = _rand(torch, gen, (b, hkv * g, p, d), torch.float32)
        chain = ops.fusemax_decode_paged(qq, x["k_pages"], x["v_pages"],
                                         table_chain, kv_chain, impl="cuda")
        single = torch.cat([ops.fusemax_decode_paged(
            qq[:, :, j:j + 1], x["k_pages"], x["v_pages"], table_chain,
            kv_chain + j, impl="cuda") for j in range(p)], dim=2)
        return chain, single

    def verify_k4(p):
        qq = _rand(torch, gen, (y["b"], hq4, p, MLA_R + MLA_RD),
                   torch.float32)
        pools, tab = y4["pools"]["permuted"], y4["tables"]["permuted"]
        kl = torch.tensor(kv_chain4, dtype=torch.int32, device="cuda")
        chain = ops.fusemax_mla_decode_paged(qq, *pools, tab, kl,
                                             impl="cuda")
        single = torch.cat([ops.fusemax_mla_decode_paged(
            qq[:, :, j:j + 1], *pools, tab, kl + j, impl="cuda")
            for j in range(p)], dim=2)
        return chain, single

    kernels = {
        "decode_partials": (k2, autotune._decode_candidates(m),
                            autotune.decode_key(m, gq, d, d),
                            lambda: autotune.decode_params(m, gq, d, d),
                            verify_k2, GRANITE_SPEC_K + 1),
        "paged_decode_partials": (
            k3, autotune._paged_decode_candidates(w, ps),
            autotune.paged_decode_key(w, ps, gq, d, d),
            lambda: autotune.paged_decode_params(w, ps, gq, d, d),
            verify_k3, GRANITE_SPEC_K + 1),
        "mla_paged_decode_partials": (
            k4, autotune._paged_decode_candidates(y["w"], y["ps"]),
            autotune.mla_paged_decode_key(y["w"], y["ps"], hq4, MLA_R,
                                          MLA_RD),
            lambda: autotune.mla_paged_decode_params(y["w"], y["ps"], hq4,
                                                     MLA_R, MLA_RD),
            verify_k4, MLA_SPEC_K + 1),
    }
    out, bad = {}, []
    for name, (run, cands, key, lookup, verify, p) in kernels.items():
        modeled = lookup()
        best, secs = autotune.measure_best(lambda c: (lambda: run(c)),
                                           cands, key=key, iters=20,
                                           warmup=3)
        chosen = lookup()
        got = dec.combine_partials(*run(best), torch.float32)
        want = dec.combine_partials(*run(best, plain=True), torch.float32)
        chain, single = verify(p)
        torch.cuda.synchronize()
        err, ok, atol, rtol = _err(torch, got, want, "float32")
        vdiff = (chain - single).abs().max().item()
        row = dict(modeled=dataclasses.astuple(modeled),
                   modeled_ms=secs[modeled] * 1e3,
                   measured=dataclasses.astuple(best),
                   measured_ms=secs[best] * 1e3,
                   candidates_ms={f"{c.splits}x{c.block_k}": s * 1e3
                                  for c, s in secs.items()},
                   lookup=dataclasses.astuple(chosen), max_abs_err=err,
                   atol=atol, rtol=rtol, ok=ok and chosen == best,
                   verify_p=p, verify_vs_single_max_abs_diff=vdiff,
                   verify_ok=vdiff == 0.0)
        out[name] = row
        if not (row["ok"] and row["verify_ok"]):
            bad.append(name)
    autotune.clear_table()
    readback = {"decode_partials": kernels["decode_partials"][3](),
                "paged_decode_partials":
                    kernels["paged_decode_partials"][3](),
                "mla_paged_decode_partials":
                    kernels["mla_paged_decode_partials"][3]()}
    for name, hit in readback.items():
        out[name]["read_back"] = dataclasses.astuple(hit)
        if dataclasses.astuple(hit) != out[name]["measured"]:
            bad.append(f"{name} read back")
    del os.environ[autotune.CACHE_ENV]
    autotune.clear_table()
    emit("autotune_measured", cache=AUTOTUNE_CACHE, **out)
    check(not bad, f"measured autotune: {bad}")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build, autotune, ops
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import fusemax as fm
    from repro_torch.launch import serve
    from repro_torch.model.layers import strict_fp32

    strict_fp32()
    info = phase_device(torch, serve)

    # the parent's K1 body at PARENT_K1_DIMS compiles beside the shipped
    # libraries, all at once
    t_build = time.perf_counter()
    parent = ParentK1()
    secs = _build.timed_build()
    parent_ptxas = parent.finish()
    secs_all = time.perf_counter() - t_build
    ptxas = _build.ptxas_report()
    emit("build", seconds=secs_all, shipped_seconds=secs,
         build_dir=os.path.relpath(_build.build_dir(), ROOT), ptxas=ptxas,
         parent_k1_ptxas=parent_ptxas)
    emit_clocks("build", secs_all)
    t_kernels = time.perf_counter()
    # the latent body keeps its accumulators and query fragments in
    # registers: a spill would put them in local memory
    spills = [f"{inst}: {line}" for lib in ("mla_paged_decode_partials",
                                            "latent_decode_partials")
              for inst, line in ptxas[lib].items()
              if "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(len(ptxas["mla_paged_decode_partials"]) == 16
          and len(ptxas["latent_decode_partials"]) == 8 and not spills,
          f"latent decode instantiations missing or spilling: {spills}")
    # K1: every plan of every (E, F), fp32 and bf16, native and MACC exp
    k1_spills = [f"{inst}: {line}"
                 for inst, line in ptxas["fusemax_prefill"].items()
                 if "0 bytes spill stores, 0 bytes spill loads" not in line]
    n_plans = sum(len(kern.plans) for kern in autotune.CUDA_PREFILL.values())
    check(len(ptxas["fusemax_prefill"]) == 4 * n_plans and not k1_spills,
          f"K1: {len(ptxas['fusemax_prefill'])} instantiations for "
          f"{n_plans} plans x 4, spilling: {k1_spills}")
    parent_spills = [f"{inst}: {line}" for inst, line in parent_ptxas.items()
                     if "0 bytes spill stores, 0 bytes spill loads"
                     not in line]
    check(len(parent_ptxas) == 4 * len(PARENT_K1_DIMS) and not parent_spills,
          f"K1's parent body: {len(parent_ptxas)} instantiations, spilling: "
          f"{parent_spills}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the wgmma dims' stress cases draw from a generator of their own, so
    # that every case after them draws the inputs it drew before them
    gen_wg = torch.Generator(device="cuda")
    gen_wg.manual_seed(30)
    rows = run_k1_cases(torch, gen, fm, autotune, parent=parent) + \
        k1_quantum_vs_chunk_cases(torch, fm) + \
        run_k1_cases(torch, gen_wg, fm, autotune, cases=[],
                     split_cases=k1_wgmma_split_cases(torch),
                     parent=parent) + \
        run_k2_cases(torch, gen, dec, autotune) + \
        run_k3_cases(torch, gen, dec, autotune) + \
        misaligned_cases(torch, gen, dec) + \
        unbuilt_dims_cases(torch, gen, fm, dec) + \
        run_k4_cases(torch, gen, dec) + \
        run_latent_cases(torch, gen, dec) + \
        run_latent_split_cases(torch, gen, dec)
    for r in rows:
        emit("kernel_case", **r)
    same = k3_vs_k2(torch, gen, dec, autotune)
    emit("kernel_case", **same)
    same4 = k4_perm_vs_identity(torch, gen, dec, autotune)
    emit("kernel_case", **same4)
    same2l = k2latent_vs_k4(torch, gen, dec, autotune)
    emit("kernel_case", **same2l)
    k3q, same3q = run_k3q_cases(torch, gen, dec, autotune)
    k4q, same4q = run_k4q_cases(torch, gen, dec)
    refused = quant_refusal_cases(torch, gen, dec)
    for r in k3q + k4q + refused + [same3q, same4q]:
        emit("kernel_case", **r)
    rows += k3q + k4q + refused
    t1 = time_k1(torch, gen, fm, autotune)
    emit("kernel_time", kernel="fusemax_prefill", **t1)
    t2 = time_k2(torch, gen, dec, autotune)
    emit("kernel_time", kernel="decode_partials", **t2)
    t3 = time_k3(torch, gen, dec, ops, autotune)
    emit("kernel_time", kernel="paged_decode_partials", **t3)
    t4 = time_k4(torch, gen, dec, ops, autotune)
    emit("kernel_time", kernel="mla_paged_decode_partials", **t4)
    # K4 at a long context: 8 slots of 16384 tokens (302 MB of fp32
    # latents), where the latent body's work grows and the projections'
    # does not
    t4long = time_k4(torch, gen, dec, ops, autotune, kvl=[16384] * 8,
                     fold_heads=True, w=1024)
    emit("kernel_time", kernel="mla_paged_decode_partials@long_16k",
         **t4long)
    torch.cuda.empty_cache()
    t2l = time_latent(torch, gen, dec, autotune)
    emit("kernel_time", kernel="decode_partials@latent_576x512", **t2l)
    t1m = time_k1_mla(torch, gen, fm, autotune, parent)
    for where, t in t1m.items():
        emit("kernel_time", kernel=f"fusemax_prefill@{where}", **t)
    tg = time_gemma2(torch, gen, fm, dec, ops, autotune, parent)
    same256 = tg.pop("k3_vs_k2_d256")
    emit("kernel_case", **same256)
    ts = time_smoke(torch, gen, fm, dec, ops, autotune)
    tq = {f"paged_decode_partials@{short}": time_k3_quant(
        torch, gen, dec, ops, autotune, kv) for kv, short in QUANT_KV.items()}
    # K4 on both code dtypes (int8 latents serve on no main path: timed,
    # not in the kernels line)
    for kv, short in QUANT_KV.items():
        tq[f"mla_paged_decode_partials@{short}"] = time_k4_quant(
            torch, gen, dec, ops, autotune, kv)
    for name, t in list(tg.items()) + list(ts.items()) + list(tq.items()):
        emit("kernel_time", kernel=name, **t)
    # the verify shapes of the speculative paths — granite's chain of 13
    # (52 rows a fiber) on K2 and K3, DeepSeek's chain of 5 (640 rows) on
    # K4 and K2's latent branch: their cases (K3 and K4 also on code
    # pools) and timing rows, from a generator of their own, so every
    # row above keeps its inputs
    gen_spec = torch.Generator(device="cuda")
    gen_spec.manual_seed(20)
    ck = autotune.DECODE_CHUNK
    spec_rows = run_k2_cases(torch, gen_spec, dec, autotune,
                             k2_spec_cases(torch, ck)) + \
        run_k3_cases(torch, gen_spec, dec, autotune,
                     k3_spec_cases(torch, ck)) + \
        run_k4_cases(torch, gen_spec, dec, k4_spec_cases(torch)) + \
        run_latent_cases(torch, gen_spec, dec, latent_spec_cases(torch))
    k3qv, same3qv = run_k3q_cases(torch, gen_spec, dec, autotune,
                                  k3_spec_cases(torch, ck))
    k4qv, same4qv = run_k4q_cases(torch, gen_spec, dec, k4_spec_cases(torch))
    same3qv["case"] += " (verify shapes)"
    same4qv["case"] += " (verify shapes)"
    spec_rows += k3qv + k4qv
    for r in spec_rows + [same3qv, same4qv]:
        emit("kernel_case", **r)
    rows += spec_rows
    gp, mp = GRANITE_SPEC_K + 1, MLA_SPEC_K + 1
    tv = {f"decode_partials@verify_p{gp}": time_k2(
              torch, gen_spec, dec, autotune, p=gp),
          f"paged_decode_partials@verify_p{gp}": time_k3(
              torch, gen_spec, dec, ops, autotune, p=gp),
          f"mla_paged_decode_partials@verify_p{mp}": time_k4(
              torch, gen_spec, dec, ops, autotune, p=mp),
          f"decode_partials@latent_verify_p{mp}": time_latent(
              torch, gen_spec, dec, autotune, p=mp)}
    for name, t in tv.items():
        emit("kernel_time", kernel=name, **t)
    # K2 and K3 past 64 rows a fiber (fault F2 closed): granite's chains of
    # 17 and 32 (68 and 128 rows), their cases, the verify read against
    # single-token reads and timing rows, from a generator of their own
    gen_rows = torch.Generator(device="cuda")
    gen_rows.manual_seed(21)
    rows_rows = run_k2_cases(torch, gen_rows, dec, autotune,
                             k2_rows_cases(torch, ck)) + \
        run_k3_cases(torch, gen_rows, dec, autotune,
                     k3_rows_cases(torch, ck))
    rows_same = [r for k in ROWS_SPEC_KS
                 for r in verify_vs_single(torch, gen_rows, dec, k + 1)]
    for r in rows_rows + rows_same:
        emit("kernel_case", **r)
    rows += rows_rows
    for k in ROWS_SPEC_KS:
        tv[f"decode_partials@verify_p{k + 1}"] = time_k2(
            torch, gen_rows, dec, autotune, p=k + 1)
        tv[f"paged_decode_partials@verify_p{k + 1}"] = time_k3(
            torch, gen_rows, dec, ops, autotune, p=k + 1)
        for kern in ("decode_partials", "paged_decode_partials"):
            name = f"{kern}@verify_p{k + 1}"
            emit("kernel_time", kernel=name, **tv[name])
    # hymba-1.5b's shapes (G = 5, head dim 64, window 1024): K1, K2 and K3
    # cases and timing rows, from a generator of their own
    gen_h = torch.Generator(device="cuda")
    gen_h.manual_seed(22)
    rows_h = run_k1_cases(torch, gen_h, fm, autotune,
                          k1_hymba_cases(torch)) + \
        run_k2_cases(torch, gen_h, dec, autotune, k2_hymba_cases(torch)) + \
        run_k3_cases(torch, gen_h, dec, autotune, k3_hymba_cases(torch))
    for r in rows_h:
        emit("kernel_case", **r)
    rows += rows_h
    th = time_hymba(torch, gen_h, fm, dec, ops, autotune)
    for name, t in th.items():
        emit("kernel_time", kernel=name, **t)
    # serve_async's shapes: K1 at a prefill quantum, K3 beside parked rows
    gen_a = torch.Generator(device="cuda")
    gen_a.manual_seed(23)
    ta = time_async(torch, gen_a, fm, dec, ops, autotune)
    for name, t in ta.items():
        emit("kernel_time", kernel=name, **t)
    # the device-sharded pool's kernel branches: K1 and K3 on head shards,
    # the latent body's page strips — cases and timing rows, from a
    # generator of their own
    gen_sh = torch.Generator(device="cuda")
    gen_sh.manual_seed(24)
    rows_sh = k1_head_shard_cases(torch, gen_sh, ops) + \
        k3_head_shard_cases(torch, gen_sh, ops) + \
        latent_strip_cases(torch, gen_sh, dec)
    for r in rows_sh:
        emit("kernel_case", **r)
    rows += rows_sh
    tsh = time_head_shards(torch, gen_sh, dec, ops, autotune)
    tsh.update(time_strips(torch, gen_sh, dec, ops, autotune))
    for name, t in tsh.items():
        emit("kernel_time", kernel=name, **t)
    # the sequence-sharded dense cache: K2 on slot strips, cases and one
    # strip's timing row, from a generator of their own
    gen_sq = torch.Generator(device="cuda")
    gen_sq.manual_seed(26)
    rows_sq = k2_strip_cases(torch, gen_sq, dec)
    for r in rows_sq:
        emit("kernel_case", **r)
    rows += rows_sq
    tsq = time_seq_strip(torch, gen_sq, dec, autotune)
    emit("kernel_time", kernel="decode_partials@seq_strip", **tsq)
    # training: K1 with its log-sum-exp at every head dims, the attention
    # Function's grads on the card, and the training shape's timing rows
    # (K1 + LSE, the recompute backward), from a generator of their own
    gen_tr = torch.Generator(device="cuda")
    gen_tr.manual_seed(25)
    rows_tr = run_k1_lse_cases(torch, gen_tr, fm, autotune, parent) + \
        function_cases(torch, gen_tr, ops)
    for r in rows_tr:
        emit("kernel_case", **r)
    rows += rows_tr
    ttr = time_train(torch, gen_tr, fm, autotune)
    for name, t in ttr.items():
        emit("kernel_time", kernel=name, **t)
    bad = [r["case"] for r in rows + rows_same + [
        same, same4, same2l, same256, same3q, same4q, same3qv, same4qv]
           if not r["ok"]]
    bad += [n for n, t in (("K1 timing shape", t1), ("K2 timing shape", t2),
                           ("K3 timing shape", t3), ("K4 timing shape", t4),
                           ("K4 long-context timing shape", t4long),
                           ("K2 latent timing shape", t2l),
                           ("K1 mla_forward timing shape",
                            t1m["mla_forward"]),
                           ("K1 absorbed timing shape",
                            t1m["mla_absorbed"])) if not t["ok"]]
    bad += [f"{n} timing shape" for n, t in list(tg.items())
            + list(ts.items()) + list(tq.items()) + list(tv.items())
            + list(th.items()) + list(ta.items()) + list(tsh.items())
            + list(ttr.items()) + [("K2 seq strip", tsq)] if not t["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    emit_clocks("kernels", time.perf_counter() - t_kernels)
    torch.cuda.empty_cache()
    # the paper's cascade analysis on the kernels, the torch cascades
    # against float64, and the autotuner's measured mode (which leaves the
    # table empty: every later phase takes the modeled choice)
    timed("analysis", phase_analysis, torch)
    timed("cascades_numeric", phase_cascades_numeric, torch, ops)
    timed("autotune_measured", phase_autotune_measured, torch, dec, ops,
          autotune)
    gc.collect()
    torch.cuda.empty_cache()

    timed("model", phase_model, torch)
    launches = timed("serve", phase_serve, torch, fm, dec, serve)
    timed("serve_prefix", phase_serve_prefix, torch, fm, dec, serve)
    async_launches = timed("serve_async", phase_serve_async, torch, fm, dec,
                           serve)
    dp_launches = timed("serve_dp", phase_serve_dp, torch, fm, dec, serve)
    gc.collect()
    torch.cuda.empty_cache()
    timed("model_spec", phase_model_spec, torch, fm, dec)
    spec_launches = timed("serve_spec", phase_serve_spec, torch, fm, dec,
                          serve)
    rows_launches = timed("serve_spec_rows", phase_serve_spec_rows, torch,
                          fm, dec, serve)
    timed("model_quant", phase_model_quant, torch, fm, dec)
    quant_launches = timed("serve_quant", phase_serve_quant, torch, fm, dec,
                           serve)
    timed("serve_swap", phase_serve_swap, torch, fm, dec)
    # each later model gets the card to itself: the granite phases have
    # released theirs
    gc.collect()
    torch.cuda.empty_cache()
    seq_sharded = timed("model_gemma2", phase_model_gemma2, torch, fm, dec)
    g2_launches = timed("serve_gemma2", phase_serve_gemma2, torch, fm, dec,
                        serve)
    defaults = timed("launcher_defaults", phase_launcher_defaults, torch)
    # the hybrid, SSM and front-end models: each gets the card to itself
    timed("model_hybrid", phase_model_hybrid, torch, fm, dec)
    hymba_launches = timed("serve_hymba", phase_serve_hymba, torch, fm, dec,
                           serve)
    timed("serve_xlstm", phase_serve_xlstm, torch, fm, dec, serve)
    timed("model_frontends", phase_model_frontends, torch, fm, dec)
    timed("model_mla", phase_model_mla, torch, fm, dec)
    mla_launches = timed("serve_mla", phase_serve_mla, torch, fm, dec, serve)
    timed("serve_mla_prefix", phase_serve_mla_prefix, torch, fm, dec, serve)
    timed("serve_mla_impls", phase_serve_mla_impls, torch, fm, dec)
    mla_quant_launches = timed("serve_mla_quant", phase_serve_mla_quant,
                               torch, fm, dec, serve)
    mla_spec_launches = timed("serve_mla_spec", phase_serve_mla_spec, torch,
                              fm, dec, serve)
    # the MoE tower holds 56 GiB of weights: every earlier model is gone
    gc.collect()
    torch.cuda.empty_cache()
    timed("model_moe", phase_model_mla, torch, fm, dec, cfg=moe_tower(),
          phase="model_moe")
    timed("serve_moe", phase_serve_moe, torch, fm, dec, serve)
    smoke_mla = timed("model_mla_smoke", phase_model_mla, torch, fm, dec,
                      cfg=mla_smoke_tower(), phase="model_mla_smoke")
    # training gets the card to itself
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = timed("train", phase_train, torch, fm, dec)
    sharded_launches = timed("train_sharded", phase_train_sharded, torch, fm,
                             dec, train_launches)
    timed("train_elastic", phase_train_elastic, torch, fm, dec)
    timed("train_launcher", phase_train_launcher, torch, fm)
    timed("dryrun", phase_dryrun, torch, train_launches)

    def entry(name, route, source, replaces, t, n_launches, kernel=None):
        cases = [r["ok"] for r in rows + [same, same4, same2l, same256]
                 if r["kernel"] == (kernel or name)]
        check(n_launches > 0, f"{name} never launched on its main path")
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "cases_passed": f"{sum(cases)}/{len(cases)}",
                "ok": all(cases) and t["ok"]}

    def k1_entry(name, t, n_launches, **dims):
        extra = {key: val for key, val in t.items()
                 if key.startswith(("bound_ms_", "share_", "library_",
                                    "parent_"))
                 and key != "library_ms"}
        # the wgmma body's dims name it as their source
        src = k1_wg_src \
            if autotune.CUDA_PREFILL[(t["e"], t["f"])].body == "wgmma" \
            else k1_src
        return dict(entry(name, "cuda", src, k1_tpu, t, n_launches,
                          kernel="fusemax_prefill"), **dims, **extra,
                    tile=t["tile"], plan=t["plan"])

    def by_n_pos(kernel, step_run, verify_run):
        """A decode kernel's launches split by draft positions: decode steps
        (n_pos == 1) on its main decode path, verify chains (n_pos > 1) on
        its speculative path."""
        return {"launches_n_pos_1": step_run["by_n_pos"][kernel].get(1, 0),
                "launches_n_pos_gt_1": {
                    str(n): c for n, c in
                    verify_run["by_n_pos"][kernel].items() if n > 1}}

    def decode_entry(name, src, tpu, t, n_launches, ring=None,
                     cases_of=None, **extra):
        e = dict(entry(name, "cuda", src, tpu, t, n_launches,
                       kernel=cases_of or name.split("@")[0]),
                 device_ms=t["device_ms"], **extra,
                 **{key: t[key] for key in ("bound_ms_fp32",
                                            "bound_ms_3xtf32", "bytes_ms")
                    if key in t})
        if ring is not None:     # the same kernel on a local layer's ring
            e.update(ring_ms=ring["ms"], ring_device_ms=ring["device_ms"],
                     ring_plain_ms=ring["plain_ms"],
                     ring_bound_ms=ring["bound_ms"],
                     ring_library_ms=ring["library_ms"],
                     ring_max_abs_err=ring["max_abs_err"],
                     ring_shape=ring["shape"])
        return e

    k1_src = "src/repro_torch/kernels/csrc/fusemax_prefill.cu"
    k1_wg_src = "src/repro_torch/kernels/csrc/fusemax_prefill_wgmma.cuh"
    k1_tpu = "src/repro/kernels/fusemax.py:102"
    k2_src = "src/repro_torch/kernels/csrc/decode_partials.cu"
    k2_tpu = "src/repro/kernels/decode.py:60"
    k3_src = "src/repro_torch/kernels/csrc/paged_decode_partials.cu"
    k3_tpu = "src/repro/kernels/decode.py:248"
    k4_src = "src/repro_torch/kernels/csrc/mla_paged_decode_partials.cu"
    k4_tpu = "src/repro/kernels/decode.py:608"
    k2l_src = "src/repro_torch/kernels/csrc/latent_decode_partials.cu"
    by_dims = mla_launches["fusemax_prefill_by_dims"]
    g2_k1 = g2_launches["fusemax_prefill_by_dims"].get("256x256", 0)
    g2_local = g2_launches["fusemax_prefill_windowed"]
    # the smoke GQA configs' launches over the launcher's GQA runs (all at
    # head dim 32); the MLA smoke config's over its launcher run and the
    # MLA smoke tower's cuda runs (both layouts)
    smoke = {k: sum(n[k] for run in defaults["runs"] if not run["mla"]
                    for n in run["kernel_launches"].values())
             for k in ("fusemax_prefill", "decode_partials",
                       "paged_decode_partials")}
    smoke_latent = sum(n["latent_decode_partials"]
                       for run in defaults["runs"] if run["mla"]
                       for n in run["kernel_launches"].values()) \
        + smoke_mla["dense"]["latent_decode_partials"]
    smoke_dims = {k: sum(smoke_mla[lo]["fusemax_prefill_by_dims"].get(k, 0)
                         for lo in smoke_mla) for k in ("48x32",)}
    latent_dense = mla_launches["latent_decode_partials"] \
        - mla_launches["latent_decode_partials_strips"]

    def shard_row(t):
        """A shard count's timing row, in brief."""
        return {key: t[key] for key in ("shape", "ms", "device_ms",
                                        "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "max_abs_err")}

    def async_counts(kernel):
        """A kernel's launches in the async phases' main-path runs."""
        return {"serve_async": async_launches[kernel],
                "serve_dp": dp_launches[kernel]}

    # the interleaved legs' launches: K1 at prefill quanta, K3 beside
    # parked rows
    interleaved = ("paged_noprefix", "paged")
    quanta_k1 = sum(async_launches["legs"][n]["fusemax_prefill"]
                    for n in interleaved)
    parked_k3 = sum(async_launches["legs"][n]["paged_decode_partials"]
                    for n in interleaved)
    print(json.dumps({"kernels": [
        dict(k1_entry("fusemax_prefill", t1, launches["fusemax_prefill"],
                      e=128, f=128),
             async_launches=async_counts("fusemax_prefill")),
        dict(entry("decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/decode_partials.cu",
                   "src/repro/kernels/decode.py:60", t2,
                   launches["decode_partials"]),
             device_ms=t2["device_ms"],
             async_launches=async_counts("decode_partials"),
             **by_n_pos("decode_partials", launches, spec_launches)),
        dict(entry("paged_decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/paged_decode_partials.cu",
                   "src/repro/kernels/decode.py:248", t3,
                   launches["paged_decode_partials"]),
             device_ms=t3["device_ms"],
             async_launches=async_counts("paged_decode_partials"),
             **by_n_pos("paged_decode_partials", launches, spec_launches),
             k2_ms_same_data=t3["k2_ms_same_data"],
             k2_device_ms_same_data=t3["k2_device_ms_same_data"],
             k3_vs_k2_max_abs_diff=same["max_abs_diff_live"]),
        dict(entry("mla_paged_decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/"
                   "mla_paged_decode_partials.cu",
                   "src/repro/kernels/decode.py:608", t4,
                   mla_launches["mla_paged_decode_partials"]),
             device_ms=t4["device_ms"], bound_ms_fp32=t4["bound_ms_fp32"],
             bytes_ms=t4["bytes_ms"],
             **by_n_pos("mla_paged_decode_partials", mla_launches,
                        mla_spec_launches),
             ms_splits4_same_data=t4["ms_splits4_same_data"],
             k4_perm_vs_identity_max_abs_diff=same4["max_abs_diff_live"],
             long_context={key: t4long[key] for key in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "bound_ms_fp32", "device_share_of_bound",
                 "library_ms", "library", "max_abs_err")}),
        k1_entry("fusemax_prefill@mla_forward", t1m["mla_forward"],
                 by_dims.get("192x128", 0), e=192, f=128),
        k1_entry("fusemax_prefill@mla_absorbed", t1m["mla_absorbed"],
                 by_dims.get("576x512", 0), e=576, f=512),
        dict(k1_entry("fusemax_prefill@gemma2_local",
                      tg["fusemax_prefill@gemma2_local"], g2_local, e=256,
                      f=256), window=4096, softcap=50.0),
        dict(k1_entry("fusemax_prefill@gemma2_global",
                      tg["fusemax_prefill@gemma2_global"], g2_k1 - g2_local,
                      e=256, f=256), softcap=50.0),
        decode_entry("decode_partials@gemma2", k2_src, k2_tpu,
                     tg["decode_partials@gemma2_global"],
                     g2_launches["decode_partials"],
                     ring=tg["decode_partials@gemma2_ring"]),
        decode_entry("paged_decode_partials@gemma2", k3_src, k3_tpu,
                     tg["paged_decode_partials@gemma2_global"],
                     g2_launches["paged_decode_partials"],
                     ring=tg["paged_decode_partials@gemma2_ring"],
                     k3_vs_k2_max_abs_diff=same256["max_abs_diff_live"]),
        # hymba-1.5b: G = 5, head dim 64, window 1024 on 29 of 32 layers
        # (launches: serve_hymba's cut, 13 of 16)
        dict(k1_entry("fusemax_prefill@hymba_local",
                      th["fusemax_prefill@hymba_local"],
                      hymba_launches["fusemax_prefill_windowed"], e=64,
                      f=64), window=1024, group=5,
             device_ms=th["fusemax_prefill@hymba_local"]["device_ms"]),
        dict(k1_entry("fusemax_prefill@hymba_global",
                      th["fusemax_prefill@hymba_global"],
                      hymba_launches["fusemax_prefill"]
                      - hymba_launches["fusemax_prefill_windowed"], e=64,
                      f=64), group=5,
             device_ms=th["fusemax_prefill@hymba_global"]["device_ms"]),
        decode_entry("decode_partials@hymba", k2_src, k2_tpu,
                     th["decode_partials@hymba_global"],
                     hymba_launches["decode_partials"], group=5,
                     ring=th["decode_partials@hymba_ring"]),
        decode_entry("paged_decode_partials@hymba", k3_src, k3_tpu,
                     th["paged_decode_partials@hymba_global"],
                     hymba_launches["paged_decode_partials"], group=5,
                     ring=th["paged_decode_partials@hymba_ring"]),
        # serve_async: K1 at a prefill quantum (launches: the interleaved
        # legs'), K3 at a decode step beside parked rows (the same legs')
        dict(k1_entry("fusemax_prefill@async_quantum",
                      ta["fusemax_prefill@async_quantum"], quanta_k1, e=128,
                      f=128), q_offset=896,
             device_ms=ta["fusemax_prefill@async_quantum"]["device_ms"]),
        decode_entry("paged_decode_partials@async_parked", k3_src, k3_tpu,
                     ta["paged_decode_partials@async_parked"], parked_k3,
                     host_ms=ta["paged_decode_partials@async_parked"][
                         "host_ms"]),
        # the device-sharded pool (the serve phases' paged_sharded legs on
        # two shards of the card; launches: each leg's timed run): K3 on
        # one of 2 kv-head shards (2 a layer and step), and the latent
        # kernel on one of 2 page strips of K4's 16 splits (2 a layer and
        # step); the other shard counts' rows beside
        decode_entry("paged_decode_partials@head_shards", k3_src, k3_tpu,
                     tsh["paged_decode_partials@head_shard_tp2"],
                     launches["paged_sharded"]["paged_decode_partials"],
                     cases_of="paged_decode_partials@head_shards",
                     tp=SHARD_TP, host_ms=tsh[
                         "paged_decode_partials@head_shard_tp2"]["host_ms"],
                     whole_pool_ms=t3["ms"],
                     whole_pool_device_ms=t3["device_ms"],
                     other_tp={str(tp): shard_row(
                         tsh[f"paged_decode_partials@head_shard_tp{tp}"])
                         for tp in K3_SHARD_TPS if tp != SHARD_TP}),
        decode_entry("latent_decode_partials@strip", k2l_src, k4_tpu,
                     tsh["latent_decode_partials@strip_tp2"],
                     mla_launches["paged_sharded"]["latent_decode_partials"],
                     cases_of="latent_decode_partials@strip", tp=SHARD_TP, ms_by_strip=tsh[
                         "latent_decode_partials@strip_tp2"]["ms_by_strip"],
                     whole_table_device_ms=t4["device_ms"],
                     other_tp={str(tp): shard_row(
                         tsh[f"latent_decode_partials@strip_tp{tp}"])
                         for tp in STRIP_TPS if tp != SHARD_TP}),
        # the sequence-sharded dense cache: K2 on one of 16 slot strips of
        # gemma2's decode step (launches: model_gemma2's seq-sharded leg,
        # 16 strips x 4 layers x 8 steps)
        decode_entry("decode_partials@seq_strip", k2_src, k2_tpu, tsq,
                     seq_sharded["k2_strip_launches"],
                     cases_of="decode_partials@seq_strip", tp=tsq["tp"],
                     splits=SEQ_SPLITS),
        # training: K1 with its LSE at stablelm-1.6b's shape (launches:
        # phase_train's steps, the forward and the remat recompute), and
        # the recompute backward beside it (torch ops, not a kernel)
        dict(k1_entry("fusemax_prefill@train_lse",
                      ttr["fusemax_prefill@train_lse"],
                      train_launches["fusemax_prefill_lse"], e=64, f=64),
             device_ms=ttr["fusemax_prefill@train_lse"]["device_ms"],
             lse_max_abs_err=ttr["fusemax_prefill@train_lse"][
                 "lse_max_abs_err"],
             ms_no_lse=ttr["fusemax_prefill@train_lse"]["ms_no_lse"],
             backward={key: ttr["fusemax_attention_bwd@train"][key]
                       for key in ("shape", "ms", "bound_ms", "bound_by",
                                   "bound_ms_fp32", "library_ms", "library",
                                   "max_abs_err")},
             backward_calls=train_launches["backward_calls"],
             sharded_launches=sharded_launches["fusemax_prefill_lse"]),
        k1_entry("fusemax_prefill@smoke_32x32",
                 ts["fusemax_prefill@smoke_32x32"], smoke["fusemax_prefill"],
                 e=32, f=32),
        k1_entry("fusemax_prefill@smoke_48x32",
                 ts["fusemax_prefill@smoke_48x32"],
                 smoke_dims.get("48x32", 0), e=48, f=32),
        decode_entry("decode_partials@smoke_d32", k2_src, k2_tpu,
                     ts["decode_partials@smoke_d32"],
                     smoke["decode_partials"]),
        decode_entry("paged_decode_partials@smoke_d32", k3_src, k3_tpu,
                     ts["paged_decode_partials@smoke_d32"],
                     smoke["paged_decode_partials"]),
        decode_entry("mla_paged_decode_partials@smoke_32x16", k4_src, k4_tpu,
                     ts["mla_paged_decode_partials@smoke_32x16"],
                     smoke_mla["paged"]["mla_paged_decode_partials"]),
        # K2's E != F branch: MLA decode on the dense latent cache (its
        # launches on serve_mla's page strips are the strip entry's)
        dict(decode_entry("decode_partials@latent_576x512", k2l_src, k2_tpu,
                          t2l, latent_dense, cases_of="latent_decode_partials",
                          k2latent_vs_k4_max_abs_diff=same2l[
                              "max_abs_diff_live"],
                          **by_n_pos("latent_decode_partials", mla_launches,
                                     mla_spec_launches)),
             launches_n_pos_1=latent_dense),
        # the verify chains of the speculative paths (launches: that
        # path's at n_pos = P)
        decode_entry(f"decode_partials@verify_p{gp}", k2_src, k2_tpu,
                     tv[f"decode_partials@verify_p{gp}"],
                     spec_launches["by_n_pos"]["decode_partials"].get(gp, 0),
                     n_pos=gp, host_ms=tv[
                         f"decode_partials@verify_p{gp}"]["host_ms"]),
        decode_entry(f"paged_decode_partials@verify_p{gp}", k3_src, k3_tpu,
                     tv[f"paged_decode_partials@verify_p{gp}"],
                     spec_launches["by_n_pos"]["paged_decode_partials"].get(
                         gp, 0), n_pos=gp, host_ms=tv[
                         f"paged_decode_partials@verify_p{gp}"]["host_ms"]),
        # past 64 rows a fiber (launches: serve_spec_rows' at n_pos = P)
        *(decode_entry(f"{kern}@verify_p{k + 1}", src, tpu,
                       tv[f"{kern}@verify_p{k + 1}"],
                       rows_launches[k + 1]["by_n_pos"][kern].get(k + 1, 0),
                       n_pos=k + 1, rows_per_fiber=4 * (k + 1),
                       host_ms=tv[f"{kern}@verify_p{k + 1}"]["host_ms"])
          for k in ROWS_SPEC_KS
          for kern, src, tpu in (("decode_partials", k2_src, k2_tpu),
                                 ("paged_decode_partials", k3_src, k3_tpu))),
        decode_entry(f"mla_paged_decode_partials@verify_p{mp}", k4_src,
                     k4_tpu, tv[f"mla_paged_decode_partials@verify_p{mp}"],
                     mla_spec_launches["by_n_pos"][
                         "mla_paged_decode_partials"].get(mp, 0), n_pos=mp),
        decode_entry(f"decode_partials@latent_verify_p{mp}", k2l_src, k2_tpu,
                     tv[f"decode_partials@latent_verify_p{mp}"],
                     mla_spec_launches["by_n_pos"][
                         "latent_decode_partials"].get(mp, 0), n_pos=mp,
                     cases_of="latent_decode_partials"),
        decode_entry("decode_partials@latent_smoke_32x16", k2l_src, k2_tpu,
                     ts["decode_partials@latent_smoke_32x16"], smoke_latent,
                     cases_of="latent_decode_partials"),
        # K3's and K4's quantized branches: launches from the serve_quant
        # run of each code dtype and from serve_mla_quant
        *(decode_entry(f"paged_decode_partials@{short}", k3_src, k3_tpu,
                       tq[f"paged_decode_partials@{short}"],
                       quant_launches[kv][
                           "paged_decode_partials_by_kv_dtype"].get(kv, 0),
                       cases_of=f"paged_decode_partials@{short}",
                       kv_dtype=kv, host_ms=tq[
                           f"paged_decode_partials@{short}"]["host_ms"],
                       quant_vs_dequant_max_abs_diff=same3q[
                           "max_abs_diff_by_kv_dtype"][kv])
          for kv, short in QUANT_KV.items()),
        decode_entry("mla_paged_decode_partials@fp8", k4_src, k4_tpu,
                     tq["mla_paged_decode_partials@fp8"],
                     mla_quant_launches[
                         "mla_paged_decode_partials_by_kv_dtype"].get(
                             "fp8_e4m3", 0),
                     cases_of="mla_paged_decode_partials@fp8",
                     kv_dtype="fp8_e4m3",
                     quant_vs_dequant_max_abs_diff=same4q[
                         "max_abs_diff_by_kv_dtype"]["fp8_e4m3"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
