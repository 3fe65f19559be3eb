"""Quickstart of the PyTorch port: the paper's contribution in five minutes.

1. Pass analysis over Einsum cascades (§III): derive Table I.
2. Numeric equivalence of the 3/2/1-pass attention cascades (§IV).
3. The FuseMax prefill kernel (K1, CUDA on the card; its plain torch
   version with ``--device cpu``) vs. the fp32 oracle (§V).
4. A few training steps of a small model with the FuseMax attention path.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    AttnSpec, all_attention_cascades, analyze, attention_1pass,
    attention_2pass, attention_3pass, division_counts,
)
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.kernels import fusemax_attention, mha_reference
from repro_torch.model.layers import Runtime, resolve_device
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.training.train_step import init_train_state, make_train_step


def section(title):
    print(f"\n=== {title} ===")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain torch versions)")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    section("1. Pass analysis (paper §III / Table I)")
    for name, cascade in all_attention_cascades().items():
        a = analyze(cascade, "M")
        live = sorted(a.full_fiber_tensors())
        print(f"{name:16s} → {a.passes}-pass over M; O(M)-live tensors: "
              f"{live}")
    print("division counts @ M=1M, P=512, F=64:",
          division_counts(1 << 20, 512, 64))

    section(f"2. Cascade equivalence (§IV) on {dev}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
               ((1, 2, 64, 32), (1, 2, 256, 32), (1, 2, 256, 32)))
    spec = AttnSpec(causal=True)
    r3 = attention_3pass(q, k, v, spec)
    r2 = attention_2pass(q, k, v, spec, block=64)
    r1 = attention_1pass(q, k, v, spec, block=64)
    print("3p vs 2p max err:", float((r3 - r2).abs().max()))
    print("3p vs 1p max err:", float((r3 - r1).abs().max()))

    kernel = "the CUDA kernel" if dev.type == "cuda" else "its plain version"
    section(f"3. FuseMax prefill, {kernel}, vs oracle (§V)")
    ref = mha_reference(q, k, v, causal=True)
    out = fusemax_attention(q, k, v, causal=True)
    print("kernel max err:", float((out - ref).abs().max()))
    out_m = fusemax_attention(q, k, v, causal=True, exp_impl="maccs")
    print("kernel (exp=6 MACCs) max err:", float((out_m - ref).abs().max()))

    section("4. Train a tiny model with the FuseMax attention path")
    cfg = get_config("granite-3-8b-smoke")
    rt = Runtime(param_dtype=torch.float32, activation_dtype=torch.float32)
    opt = make_optimizer("adamw")
    state = init_train_state(cfg, 0, opt, rt, device=dev)
    step = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 20), rt)
    src = SyntheticSource(DataConfig(global_batch=4, seq_len=64,
                                     vocab=cfg.vocab))
    for i in range(args.steps):
        batch = {key: t.to(dev) for key, t in src.batch_at(i).items()}
        state, m = step(state, batch)
        print(f"step {i}: loss={float(m['loss']):.4f}")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
