#!/usr/bin/env python3
"""Card check of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line (``"phase": ...``):

1. device  — ``nvidia-smi`` name and power limit (also printed raw on a
             line of its own), torch and CUDA versions;
2. build   — seconds to build the three kernels from ``kernels/csrc``
             (nvcc, in parallel) and the ptxas register / shared-memory
             report;
3. kernels — every case of the prefill (K1), dense split-K decode (K2)
             and paged split-K decode (K3) kernels against its plain torch
             version on the same inputs, with its tolerance; K3 against K2
             on a permuted pool holding a dense cache's rows (``k3_vs_k2``:
             equal bits on every row with kv_len >= 1); then each kernel's
             time at the shapes the granite-3-8b main path gives it, beside
             its plain version's, a library call's (``library_ms``: a
             yardstick the port never calls) and the least time the card
             could take (``bound_ms``);
4. model   — granite-3-8b at full width cut to 4 layers, fp32: prefill 4
             mixed-length prompts and decode 8 greedy steps with
             ``attn_impl="cuda"`` and ``"torch"`` on the same weights;
             logits difference and token match rate;
5. serve   — ``repro_torch.launch.serve.main --cache-layout both`` on the
             full 40-layer granite-3-8b (fp32): greedy streams equal on
             the dense and the paged layout, every request gets its
             tokens, logits stay finite, and in each leg's timed run K1
             launched 40 x prefill dispatches and K2 (dense) or K3 (paged)
             40 x decode steps;
6. serve_prefix — the launcher on the paged layout with a 256-token
             shared prefix against its prefix-cache-off leg: equal
             streams, tokens reused, the pool's invariants audited;
7. the ``kernels`` line (launches on the main path, errors, times,
   bounds) and, last, ``{"ok": true, "device": {...}}``.

Any failed phase raises: the script then exits non-zero and prints no
result line.  It also exits non-zero when no CUDA card is visible or when
the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and fp32
#: non-tensor FLOP/s — the serving path is fp32, so no tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: tolerances: fp32 differs only in summation order; bf16 outputs may
#: differ by one rounding of the output (2 ulps at unit scale)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}


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


def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def k1_cases(torch):
    """(name, b, hkv, group, p, m, d, dtype, kwargs) for the prefill
    kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 causal g4 d128", 2, 2, 4, 128, 128, 128, f32,
         dict(causal=True)),
        ("bf16 causal g4 d128", 2, 2, 4, 128, 128, 128, bf16,
         dict(causal=True)),
        ("fp32 causal q_offset=64 g4", 1, 2, 4, 100, 164, 128, f32,
         dict(causal=True, q_offset=64)),
        ("fp32 m_valid=200 of 256 g1 d64", 2, 2, 1, 96, 256, 64, f32,
         dict(m_valid=200)),
        ("fp32 window=48 causal g8 d64", 1, 2, 8, 96, 96, 64, f32,
         dict(causal=True, window=48)),
        ("fp32 softcap=30 causal g4", 1, 2, 4, 128, 128, 128, f32,
         dict(causal=True, softcap=30.0)),
        ("fp32 exp=maccs causal g4", 1, 2, 4, 128, 128, 128, f32,
         dict(causal=True, exp_impl="maccs")),
        ("bf16 causal g1 d128 unaligned", 1, 4, 1, 200, 200, 128, bf16,
         dict(causal=True)),
        ("bf16 window=100 causal g8 d64", 1, 1, 8, 150, 150, 64, bf16,
         dict(causal=True, window=100)),
    ]


def run_k1_cases(torch, gen, fm, tile) -> list:
    rows = []
    for name, b, hkv, g, p, m, d, dtype, kw in k1_cases(torch):
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k = _rand(torch, gen, (b * hkv, m, d), dtype)
        v = _rand(torch, gen, (b * hkv, m, d), dtype)
        args = dict(scale=d ** -0.5, group=g, block_q=tile[0],
                    block_k=tile[1], **kw)
        out = fm.fusemax_attention_cuda(q, k, v, **args)
        ref = fm.fusemax_attention_torch(q, k, v, **args)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        rows.append(dict(kernel="fusemax_prefill", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def run_k2_cases(torch, gen, dec) -> list:
    rows = []
    f32, bf16 = torch.float32, torch.bfloat16
    # name, b, hkv, group, P, M, d, dtype, kv_len, splits, block_k, kwargs
    cases = [
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
    ]
    for (name, b, hkv, g, p, m, d, dtype, kvl, splits, bk, kw) in cases:
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
        rows.append(dict(kernel="decode_partials", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def _paged_inputs(torch, gen, b, hkv, ps, w, n_pages, d, dtype, kvl, n_pos):
    """Random pools and a permuted block table per row whose entries past
    the pages ``kv_len + n_pos - 1`` keys need hold the sentinel."""
    k = _rand(torch, gen, (n_pages, ps, hkv, d), dtype)
    v = _rand(torch, gen, (n_pages, ps, hkv, d), dtype)
    table = torch.full((b, w), n_pages, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda").to(
        torch.int32)
    used = 0
    for i, n in enumerate(kvl):
        need = -(-(n + n_pos - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return k, v, table


def k3_cases(torch):
    """(name, b, hkv, group, P, page_size, W, pool pages, d, dtype, kv_len,
    splits, block_k, kwargs) for the paged decode kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
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
    ]


def run_k3_cases(torch, gen, dec) -> list:
    rows = []
    for (name, b, hkv, g, p, ps, w, n_pages, d, dtype, kvl, splits, bk,
         kw) in k3_cases(torch):
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


def granite_paged_data(torch, gen):
    """A granite-3-8b decode step's data on both layouts: 8 slots, 32 q
    over 8 kv heads, head dim 128, fp32, a 2048-token dense cache, and the
    same rows scattered into a 1024-page pool (page_size 16, W 128) in a
    random page order, table entries past each slot's kv_len holding the
    sentinel."""
    b, hq, hkv, m, d, ps = 8, 32, 8, 2048, 128, 16
    w = m // ps
    g = hq // hkv
    q = _rand(torch, gen, (b, hq, 1, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    k_pages = torch.empty((b * w, ps, hkv, d), device="cuda")
    v_pages = torch.empty_like(k_pages)
    k_pages[perm] = k.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * w, ps, hkv, d)
    v_pages[perm] = v.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * w, ps, hkv, d)
    table = perm.to(torch.int32).reshape(b, w).contiguous()
    return dict(b=b, hq=hq, hkv=hkv, g=g, m=m, d=d, ps=ps, w=w, q=q, k=k,
                v=v, k_pages=k_pages, v_pages=v_pages, table=table)


def with_sentinels(table, kvl, ps, n_pages):
    """``table`` with the entries past each row's kv_len set to the
    sentinel ``n_pages``."""
    t = table.clone()
    for i, n in enumerate(kvl):
        t[i, -(-n // ps):] = n_pages
    return t


def k3_vs_k2(torch, gen, dec, autotune) -> dict:
    """K3 on the permuted pool against K2 on the dense cache, both at 16
    splits (K2's block_k 128, K3's 16): equal bits on every kv_len >= 1
    row."""
    x = granite_paged_data(torch, gen)
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 0]
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
    row = dict(kernel="paged_decode_partials", case="k3_vs_k2",
               kv_len=kvl, splits=dense.splits, block_k_k2=dense.block_k,
               block_k_k3=paged.block_k,
               max_abs_diff_live=diff[live].max().item(),
               max_abs_diff_all=diff.max().item())
    row["ok"] = row["max_abs_diff_live"] == 0.0
    return row


def time_k3(torch, gen, dec, ops, autotune) -> dict:
    """K3 at a granite-3-8b decode step: the data of :func:`k3_vs_k2`,
    mixed kv_len, 16 splits; beside it K2 on the same rows in the dense
    layout, and as the library yardstick ``gather_pages`` + SDPA on the
    gathered view."""
    import torch.nn.functional as F

    x = granite_paged_data(torch, gen)
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n_pages = x["k_pages"].shape[0]
    table = with_sentinels(x["table"], kvl, x["ps"], n_pages)
    b, hq, hkv, g, m, d, ps, w = (x[k] for k in
                                  ("b", "hq", "hkv", "g", "m", "d", "ps", "w"))
    tuned = autotune.paged_decode_params(w, ps, max(g, 8), d, d)
    dense = autotune.decode_params(m, max(g, 8), d, d)
    q_f = x["q"].reshape(b * hkv, g, d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=tuned.block_k)
    kp, vp = x["k_pages"], x["v_pages"]
    out = dec.combine_partials(*dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.paged_decode_partials_torch(
        q_f, kp, vp, table, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.paged_decode_partials_cuda(
        q_f, kp, vp, table, kv_len, **args))
    plain_ms = time_ms(torch, lambda: dec.paged_decode_partials_torch(
        q_f, kp, vp, table, kv_len, **args), iters=5, warmup=1)
    k_f, v_f = x["k"].reshape(b * hkv, m, d), x["v"].reshape(b * hkv, m, d)
    k2_ms = time_ms(torch, lambda: dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, scale=d ** -0.5, hkv=hkv,
        splits=dense.splits, block_k=dense.block_k))
    mask = (torch.arange(m, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]

    def library():
        kg = ops.gather_pages(kp, table).transpose(1, 2)
        vg = ops.gather_pages(vp, table).transpose(1, 2)
        try:
            return F.scaled_dot_product_attention(
                x["q"], kg, vg, attn_mask=mask, enable_gqa=True)
        except TypeError:
            rep = hq // hkv
            return F.scaled_dot_product_attention(
                x["q"], kg.repeat_interleave(rep, dim=1),
                vg.repeat_interleave(rep, dim=1), attn_mask=mask)

    library_ms = time_ms(torch, library)
    live = sum(kvl)
    # each valid key is read once (K and V rows of every kv head), the
    # table and queries once, the fp32 partials written once
    nbytes = (4 * 2 * live * hkv * d + 4 * table.numel() + 4 * q_f.numel()
              + 4 * b + 4 * b * hkv * tuned.splits * g * (d + 2))
    flops = 4 * d * live * hq
    row = _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                      shape=f"B{b} Hq{hq} Hkv{hkv} page_size {ps} W {w} pool "
                            f"{n_pages} pages d{d} fp32 kv_len {kvl} splits "
                            f"{tuned.splits} block_k {tuned.block_k}")
    row["k2_ms_same_data"] = k2_ms
    return row


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


def time_k1(torch, gen, fm, tile) -> dict:
    """K1 at a granite-3-8b prefill dispatch: 4 prompts of 1024, causal,
    32 q heads over 8 kv heads, head dim 128, fp32."""
    b, hq, hkv, p, d = 4, 32, 8, 1024, 128
    g = hq // hkv
    q = _rand(torch, gen, (b, hq, p, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, p, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, p, d), torch.float32)
    q_f = (q.reshape(b, hkv, g, p, d).transpose(2, 3)
           .reshape(b * hkv, p * g, d).contiguous())
    k_f, v_f = k.reshape(b * hkv, p, d), v.reshape(b * hkv, p, d)
    args = dict(scale=d ** -0.5, causal=True, group=g, block_q=tile[0],
                block_k=tile[1])
    out = fm.fusemax_attention_cuda(q_f, k_f, v_f, **args)
    ref = fm.fusemax_attention_torch(q_f, k_f, v_f, **args)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: fm.fusemax_attention_cuda(q_f, k_f, v_f,
                                                          **args))
    plain_ms = time_ms(torch, lambda: fm.fusemax_attention_torch(
        q_f, k_f, v_f, **args), iters=5, warmup=1)
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, is_causal=True))
    # the causal bound needs p(p+1)/2 (q, k) pairs per head; each costs
    # d MACs for Q·K and d for P·V
    pairs = p * (p + 1) // 2
    flops = 4 * d * pairs * hq * b
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    return _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                       shape=f"B{b} Hq{hq} Hkv{hkv} P=M={p} d{d} fp32 causal")


def time_k2(torch, gen, dec, autotune) -> dict:
    """K2 at a granite-3-8b decode step: 8 slots, 2048-slot cache, mixed
    kv_len, 32 q heads over 8 kv heads, head dim 128, fp32."""
    b, hq, hkv, m, d = 8, 32, 8, 2048, 128
    g = hq // hkv
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]
    q = _rand(torch, gen, (b, hq, 1, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    tuned = autotune.decode_params(m, max(g, 8), d, d)
    q_f = q.reshape(b * hkv, g, d)
    k_f, v_f = k.reshape(b * hkv, m, d), v.reshape(b * hkv, m, d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=tuned.block_k)
    out = dec.combine_partials(*dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.decode_partials_cuda(q_f, k_f, v_f,
                                                         kv_len, **args))
    plain_ms = time_ms(torch, lambda: dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), iters=5, warmup=1)
    mask = (torch.arange(m, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, attn_mask=mask))
    live = sum(kvl)
    # each valid key is read once (K and V rows of every kv head), the
    # queries once, the fp32 partials written once
    nbytes = (4 * 2 * live * hkv * d + 4 * q.numel() + 4 * b
              + 4 * b * hkv * tuned.splits * g * (d + 2))
    flops = 4 * d * live * hq
    return _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                       shape=f"B{b} Hq{hq} Hkv{hkv} M{m} d{d} fp32 kv_len "
                             f"{kvl} splits {tuned.splits} block_k "
                             f"{tuned.block_k}")


def _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok, shape):
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, max_abs_err=err, ok=ok)


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

#: the decode kernel each layout's decode steps launch
DECODE_KERNEL = {"dense": "decode_partials", "paged": "paged_decode_partials",
                 "paged_noprefix": "paged_decode_partials"}


def _counts(fm, dec) -> dict:
    return {"fusemax_prefill": fm.fusemax_attention_cuda.launches,
            "decode_partials": dec.decode_partials_cuda.launches,
            "paged_decode_partials": dec.paged_decode_partials_cuda.launches}


def _zero_counts(fm, dec) -> None:
    fm.fusemax_attention_cuda.launches = 0
    dec.decode_partials_cuda.launches = 0
    dec.paged_decode_partials_cuda.launches = 0


def _check_legs(metrics, n_layers: int, n_req: int, new_tokens: int,
                vocab: int) -> dict:
    """Per layout: every stream complete and in the vocabulary, logits
    finite, and each kernel launched once per layer per dispatch (K1) or
    decode step (K2 on the dense layout, K3 on the paged one)."""
    legs = {}
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
        check(timed["fusemax_prefill"] == n_layers * disp["prefill"],
              f"{lo}: K1 launched {timed['fusemax_prefill']} times, "
              f"expected {n_layers} x {disp['prefill']} prefill dispatches")
        dk = DECODE_KERNEL[lo]
        other = ({"decode_partials", "paged_decode_partials"} - {dk}).pop()
        check(timed[dk] == n_layers * disp["decode_steps"],
              f"{lo}: {dk} launched {timed[dk]} times, expected "
              f"{n_layers} x {disp['decode_steps']} decode steps")
        check(timed[other] == 0, f"{lo}: {other} launched {timed[other]} "
                                 f"times on this layout")
    for lo, outs in metrics["_outputs_by_layout"].items():
        check(len(outs) == n_req and all(len(o) == new_tokens
                                         for o in outs),
              f"{lo}: streams of lengths {[len(o) for o in outs]}, "
              f"expected {n_req} x {new_tokens}")
        check(all(0 <= t < vocab for o in outs for t in o),
              f"{lo}: token outside the vocabulary")
    check(metrics.get("outputs_match") is True,
          f"greedy streams differ across {list(metrics['layouts'])}")
    return legs


def phase_serve(torch, fm, dec, serve) -> dict:
    """The main path: dense then paged layout on the same trace."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-3-8b")
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab)
    emit("serve", args=" ".join(SERVE_ARGS), seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    return launches


def phase_serve_prefix(torch, fm, dec, serve) -> dict:
    """Shared-prefix traffic on the paged layout, prefix cache on vs off."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-3-8b")
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(PREFIX_ARGS)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 32, cfg.vocab)
    reused = metrics["layouts"]["paged"]["prefix"]["tokens_reused"]
    emit("serve_prefix", args=" ".join(PREFIX_ARGS), seconds=wall,
         layers=cfg.n_layers, legs=legs,
         outputs_match=metrics["outputs_match"], tokens_reused=reused,
         invariants="checked by the launcher after each paged leg",
         launches=launches)
    check(reused > 0, "no prefix tokens reused on shared-prefix traffic")
    return launches


# ---------------------------------------------------------------------------

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

    secs = _build.timed_build()
    emit("build", seconds=secs, build_dir=os.path.relpath(
        _build.build_dir(), ROOT), ptxas=_build.ptxas_report())

    tile = autotune.attention_params(4096, 1024, 128, 128, impl="cuda")
    tile = (tile.block_q, tile.block_k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = run_k1_cases(torch, gen, fm, tile) + \
        run_k2_cases(torch, gen, dec) + run_k3_cases(torch, gen, dec)
    for r in rows:
        emit("kernel_case", **r)
    same = k3_vs_k2(torch, gen, dec, autotune)
    emit("kernel_case", **same)
    t1 = time_k1(torch, gen, fm, tile)
    emit("kernel_time", kernel="fusemax_prefill", **t1)
    t2 = time_k2(torch, gen, dec, autotune)
    emit("kernel_time", kernel="decode_partials", **t2)
    t3 = time_k3(torch, gen, dec, ops, autotune)
    emit("kernel_time", kernel="paged_decode_partials", **t3)
    bad = [r["case"] for r in rows + [same] if not r["ok"]]
    bad += [n for n, t in (("K1 timing shape", t1), ("K2 timing shape", t2),
                           ("K3 timing shape", t3)) if not t["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    torch.cuda.empty_cache()

    phase_model(torch)
    launches = phase_serve(torch, fm, dec, serve)
    phase_serve_prefix(torch, fm, dec, serve)

    def entry(name, route, source, replaces, t):
        cases = [r["ok"] for r in rows + [same] if r["kernel"] == name]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "cases_passed": f"{sum(cases)}/{len(cases)}",
                "ok": all(cases) and t["ok"]}

    print(json.dumps({"kernels": [
        entry("fusemax_prefill", "cuda",
              "src/repro_torch/kernels/csrc/fusemax_prefill.cu",
              "src/repro/kernels/fusemax.py:102", t1),
        entry("decode_partials", "cuda",
              "src/repro_torch/kernels/csrc/decode_partials.cu",
              "src/repro/kernels/decode.py:60", t2),
        dict(entry("paged_decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/paged_decode_partials.cu",
                   "src/repro/kernels/decode.py:248", t3),
             k2_ms_same_data=t3["k2_ms_same_data"],
             k3_vs_k2_max_abs_diff=same["max_abs_diff_live"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
