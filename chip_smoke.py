#!/usr/bin/env python3
"""Card check of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line (``"phase": ...``):

1. device  — ``nvidia-smi`` name and power limit (also printed raw on a
             line of its own), torch and CUDA versions;
2. build   — seconds to build the five kernel libraries from
             ``kernels/csrc``
             (nvcc, in parallel) and the ptxas register / shared-memory
             report; every instantiation of the latent decode body (K4 and
             K2's E != F branch) must be there without a spill;
3. kernels — every case of the prefill (K1, at the GQA head dims and at
             DeepSeek's MLA (E, F) = (192, 128) and (576, 512), at the
             smoke configs' (32, 32) and (48, 32) and gemma's (256, 256)
             with causal masks, history offsets, windows, softcap 50 and a
             ragged m_valid, and cases that stress its 3xTF32 split:
             scores in the hundreds, low mantissa bits that matter, P = M
             = 1024), dense split-K decode (K2), paged split-K decode (K3),
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
             bits on every row with kv_len >= 1; then each kernel's time at
             the shapes the granite-3-8b, DeepSeek-V3 and gemma2-9b main
             paths give it and at a smoke serving shape (``ms``: CUDA
             events around 20 back-to-back wrapper calls; K2-K4 also
             ``device_ms``: the kernel's own duration from
             ``torch.profiler`` over 20 more calls, without the wrapper's
             host time; K2 and K3 also ``host_ms``, the wrapper's host
             time per call), beside its plain version's, a library call's
             (``library_ms``: a yardstick the port never calls; for K1
             also SDPA under each fp32 backend and the one the default
             call ran; SDPA has no softcap, so at gemma2's shapes it runs
             the same masks without one) and the least time the card
             could take (``bound_ms``, over the keys the causal and window
             masks leave; K1, K4 and K2's latent branch against the tensor
             cores' 3xTF32 rate, with the FP32 units' beside it); K4 also
             at a long context (8 slots of 16384 tokens, its library call
             SDPA with the 128 heads on the query axis of the one latent
             kv head); and the verify shapes of the speculative paths: K2
             and K3 at granite's chain of P = 13 (52 rows a fiber), K4 and
             K2's latent branch at DeepSeek's P = 5 (640 rows), each also
             among the kernel cases (K3 and K4 on fp8 and int8 pools too);
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
6a. model_spec — granite-3-8b at full width cut to 4 layers: ``verify_step``
             on a P = 13 chain (k = 12, 52 K2 / K3 rows) against 13
             sequential ``decode_step`` calls, dense and paged, ``attn_impl``
             "cuda" and "torch": argmax equal at every chain position,
             logits within 1e-4 of their scale; the attention read's own
             verify-vs-stepwise distance reported;
6b. serve_spec — speculative decoding on all 40 layers: the launcher with
             ``--cache-layout both --speculate 12 --duplicates 8`` (8
             prompts of 128-512 tokens and their 8 resends, 64 new
             tokens): streams equal across ``dense``, ``paged`` and
             ``paged_nospec`` (else the first divergent position and the
             non-speculative logits' top-2 gap there, then a failure),
             drafts accepted, no draft page left, and in each speculative
             leg's timed run K2 (dense) / K3 (paged) launched at n_pos = 13
             40 x verify dispatches; accept rate, committed tokens a
             dispatch and the spec / non-spec tok/s reported;
6c. model_quant — the model check on fp8 e4m3 and int8 paged pools (two
             prefill chunks, the second reading the dequantized history,
             8 decode steps through K3's quantized branch);
6d. serve_quant — the launcher on the serve cell's trace with
             ``--cache-layout paged --kv-dtype fp8_e4m3`` and then ``int8``:
             the quantized leg's peak resident KV against the fp32 leg's
             (at most 27 %), ``quant_quality`` reported, K3's quantized
             branch 40 x decode steps;
6e. serve_swap — 40-layer granite-3-8b through ``ServeEngine`` on three
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
             1e-4 of their scale, dense = paged;
8. serve_gemma2 — the launcher (``--cache-layout both``) on all 42 layers
             at full width (fp32, ~37 GB): 4 prompts of 4200-6000 tokens,
             all past the window, 32 new tokens; the serve phase's checks,
             K1 launched 42 x prefill dispatches, K2 / K3 42 x decode
             steps;
9. launcher_defaults — ``python -m repro_torch.launch.serve`` as
             subprocesses from the repo root: with no flags (gemma2-9b-
             smoke on the card), ``--cache-layout both``, granite-3-8b-
             smoke paged, gemma-7b-smoke and deepseek-v3-671b-smoke on
             the default dense layout: exit code 0, kernels launched,
             ``outputs_match`` where it compares layouts;
10. model_mla — DeepSeek-V3's first three layers (MLA + dense FFN) at full
             width, fp32, on the dense and the paged layout: two prefill
             chunks (the second at an offset, the absorbed form) and 8
             decode steps with ``attn_impl="cuda"`` and ``"torch"``; dense
             streams equal to paged;
11. serve_mla — the launcher (``--cache-layout both``) serving that tower:
             ``outputs_match``, and in each leg's timed run K1 3 x prefill
             dispatches and the leg's decode kernel (dense: K2's latent
             branch; paged: K4) 3 x decode steps;
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
14. model_mla_smoke — the model_mla check on the MLA smoke config (MoE
             cut, as the launcher serves it): K1 at (48, 32), K4 and K2's
             latent branch at (32, 16);
15. the ``kernels`` line (launches on the main paths, K2 / K3 / K4 / K2's
   latent branch split by n_pos == 1 (decode steps) and n_pos > 1 (verify
   chains), errors, times, bounds) and, last, ``{"ok": true, "device":
   {...}}``.

Any failed phase raises: the script then exits non-zero and prints no
result line.  It also exits non-zero when no CUDA card is visible or when
the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

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


def run_k1_cases(torch, gen, fm, autotune) -> list:
    """Every K1 case against its plain version; the split cases also
    report the kernel's and the plain version's distance to a float64
    reference (``vs_f64``, not gated)."""
    rows = []
    cases = [c + (None, False) for c in k1_cases(torch)] + \
        [c + (None, False) for c in k1_dims_cases(torch)] + \
        [c + (True,) for c in k1_split_cases(torch)]
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
        if split:
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


def paged_data(torch, gen, b, hq, hkv, m, d, ps=16):
    """A decode step's data on both layouts, fp32: a dense cache of m slots
    and the same rows scattered into a pool of b * m / ps pages in a random
    page order (tables [b, m / ps])."""
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


def granite_paged_data(torch, gen):
    """A granite-3-8b decode step: 8 slots, 32 q over 8 kv heads, head dim
    128, a 2048-token cache, a 1024-page pool (page_size 16, W 128)."""
    return paged_data(torch, gen, 8, 32, 8, 2048, 128)


def gemma2_paged_data(torch, gen, m=8192):
    """A gemma2-9b decode step: 4 slots, 16 q over 8 kv heads, head dim
    256, a global layer's 8192-token cache (or a local layer's ring of
    4096) and its pool (page_size 16)."""
    return paged_data(torch, gen, 4, 16, 8, m, 256)


def with_sentinels(table, kvl, ps, n_pages):
    """``table`` with the entries past each row's kv_len set to the
    sentinel ``n_pages``."""
    t = table.clone()
    for i, n in enumerate(kvl):
        t[i, -(-n // ps):] = n_pages
    return t


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


def run_latent_split_cases(torch, gen, dec) -> list:
    """Every :func:`latent_split_cases` case against its plain version,
    with the kernel's and the plain version's distance to a float64
    reference (``vs_f64``, not gated)."""
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
        rows.append(dict(kernel=kernel, case=name, dtype="float32",
                         rows=p * h, max_abs_err=err, atol=atol, rtol=rtol,
                         ok=ok, vs_f64={
                             "kernel": (out.double() - r64).abs().max().item(),
                             "plain": (ref.double() - r64).abs().max().item()}))
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


def _quantized(torch, pools, kv_dtype):
    """Per pool: (codes, fp16 scales, the fp32 pool they decode to),
    through the port's ``quantize_kv`` (one scale per trailing vector)."""
    from repro_torch.model.attention import (
        dequantize_kv, kv_quant_dtype, quantize_kv,
    )

    qdt = kv_quant_dtype(kv_dtype)
    out = []
    for x in pools:
        codes, scales = quantize_kv(x, qdt)
        out.append((codes, scales, dequantize_kv(codes, scales)))
    return out


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
                   q_offset, shape, window=None, softcap=None) -> dict:
    """K1 at one prefill shape, causal with a history offset (and a window
    and a softcap where given), fp32: the kernel, its plain version, SDPA
    on the same inputs (by default and under each fp32 backend; the window
    as a boolean mask, and never a softcap, which SDPA has not: there it
    is a yardstick of a neighbouring function), and both bounds: the FP32
    units' and the tensor cores' in 3xTF32, which is the one K1 runs
    against, over the (query, key) pairs the causal and window masks
    leave."""
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
    out = fm.fusemax_attention_cuda(q_f, k_f, v_f, **args)
    ref = fm.fusemax_attention_torch(q_f, k_f, v_f, **args)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    del out, ref
    ms = time_ms(torch, lambda: fm.fusemax_attention_cuda(q_f, k_f, v_f,
                                                          **args))
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
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + b * hq * p * f)
    t_fp32 = flops / FP32_FLOPS * 1e3
    t_3xtf32 = 3 * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_3xtf32, t_bytes),
               bound_by="operations" if t_3xtf32 >= t_bytes else "bytes",
               bound_ms_fp32=max(t_fp32, t_bytes),
               bound_ms_3xtf32=max(t_3xtf32, t_bytes),
               share_of_3xtf32_bound=max(t_3xtf32, t_bytes) / ms,
               flops=flops, bytes=nbytes, max_abs_err=err, ok=ok,
               tile=[tile.block_q, tile.block_k], **backends)
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


def time_k1_mla(torch, gen, fm, autotune) -> dict:
    """K1 at DeepSeek-V3's two MLA prefill shapes: ``mla_forward`` (4
    prompts of 1024, 128 heads, (E, F) = (192, 128), causal) and the
    absorbed tail (4 rows of a 256-token tail after a 768-token cached
    prefix, the 128 heads in one fiber's group, (576, 512))."""
    fwd = _time_k1_shape(
        torch, gen, fm, autotune, b=4, hq=128, hkv=128, p=1024, m=1024,
        e=192, f=128, q_offset=0,
        shape="B4 H128 (one fiber each) P=M=1024 E192 F128 fp32 causal")
    torch.cuda.empty_cache()
    tail = _time_k1_shape(
        torch, gen, fm, autotune, b=4, hq=128, hkv=1, p=256, m=1024, e=576,
        f=512, q_offset=768,
        shape="B4 H128 in one group (Hkv 1) P=256 after 768 cached, M=1024 "
              "E576 F512 fp32 causal")
    torch.cuda.empty_cache()
    return {"mla_forward": fwd, "mla_absorbed": tail}


def time_gemma2(torch, gen, fm, dec, ops, autotune) -> dict:
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
            shape=f"B2 Hq16 Hkv8 P=M=8192 d256 fp32 causal softcap 50"
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
            f=32, q_offset=0, window=64, softcap=50.0,
            shape="B4 Hq4 Hkv2 P=M=256 d32 fp32 causal window 64 softcap 50"),
        "fusemax_prefill@smoke_48x32": _time_k1_shape(
            torch, gen, fm, autotune, b=4, hq=4, hkv=4, p=256, m=256, e=48,
            f=32, q_offset=0,
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
              warmup: int = 3) -> float:
    """Mean device time per launch of ``fn``'s kernel (the CUDA kernel
    records whose name holds ``kernel``), from ``torch.profiler`` over
    ``iters`` calls after ``warmup``: what the card spends, without the
    wrapper's host time between launches that :func:`time_ms` sees.  The
    mean is over the launches the profiler recorded, which may miss one of
    the ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [ev.device_time_total if hasattr(ev, "device_time_total")
          else ev.cuda_time_total for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and kernel in ev.name]
    check(0 < len(us) <= iters, f"profiler saw {len(us)} launches of "
                                f"{kernel} in {iters} calls")
    return sum(us) / 1e3 / len(us)


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
                device_share_of_bound=row["bound_ms"] / dev_ms)


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

#: the decode kernel each layout's decode steps launch (GQA models)
DECODE_KERNEL = {"dense": "decode_partials", "paged": "paged_decode_partials",
                 "paged_noprefix": "paged_decode_partials",
                 "paged_nospec": "paged_decode_partials",
                 "paged_swap": "paged_decode_partials",
                 "paged_quant": "paged_decode_partials"}
#: ... and on an MLA model (dense: K2's E != F branch; paged: K4)
MLA_DECODE_KERNEL = {"dense": "latent_decode_partials",
                     "paged": "mla_paged_decode_partials",
                     "paged_noprefix": "mla_paged_decode_partials",
                     "paged_nospec": "mla_paged_decode_partials",
                     "paged_quant": "mla_paged_decode_partials"}
DECODE_KERNELS = ("decode_partials", "paged_decode_partials",
                  "mla_paged_decode_partials", "latent_decode_partials")


def _counts(fm, dec) -> dict:
    return {"fusemax_prefill": fm.fusemax_attention_cuda.launches,
            "decode_partials": dec.decode_partials_cuda.launches,
            "paged_decode_partials": dec.paged_decode_partials_cuda.launches,
            "mla_paged_decode_partials":
                dec.mla_paged_decode_partials_cuda.launches,
            "latent_decode_partials": dec.latent_decode_partials_cuda.launches,
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
    dec.paged_decode_partials_cuda.launches_by_code.clear()
    dec.mla_paged_decode_partials_cuda.launches_by_code.clear()
    for k in DECODE_KERNELS:
        getattr(dec, k + "_cuda").launches_by_n_pos.clear()


def _check_legs(metrics, n_layers: int, n_req: int, new_tokens: int,
                vocab: int, decode_kernel: dict = DECODE_KERNEL) -> dict:
    """Per layout: every stream complete and in the vocabulary, logits
    finite, and each kernel launched once per layer per dispatch (K1) or
    decode step (``decode_kernel[layout]``: K2 on the dense layout, K3 on
    the paged one; on an MLA model K2's dense latent branch and K4), the
    other decode kernels never."""
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
        dk = decode_kernel[lo]
        check(timed[dk] == n_layers * disp["decode_steps"],
              f"{lo}: {dk} launched {timed[dk]} times, expected "
              f"{n_layers} x {disp['decode_steps']} decode steps")
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
    check("outputs_match" in metrics, "the serve phase ran one layout")
    emit("serve", args=" ".join(SERVE_ARGS), seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    for name in ("fusemax_prefill", "decode_partials",
                 "paged_decode_partials"):
        check(launches[name] > 0, f"{name} never launched on the main path")
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
    """Speculative decoding on all 40 layers of granite-3-8b: the launcher
    with ``--cache-layout both --speculate 12 --duplicates 8`` (8 prompts
    of 128-512 tokens, then their 8 resends, which FIFO admission sends
    after the originals complete: the cross-request drafting traffic of
    repeated or popular queries), 64 new tokens, 8 slots: the dense and
    paged legs speculative through K2 / K3 at n_pos = 13, ``paged_nospec``
    the same trace without; streams equal across the three."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-3-8b")
    torch.cuda.reset_peak_memory_stats()
    # a main path of this slice: counts set to 0 just before, read after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(SPEC_ARGS)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    check(list(metrics["layouts"]) == ["dense", "paged", "paged_nospec"],
          f"serve_spec served {list(metrics['layouts'])}")
    spec = _check_spec_legs(torch, serve, SPEC_ARGS, cfg, metrics,
                            GRANITE_SPEC_K + 1, DECODE_KERNEL, "serve_spec")
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab)
    emit("serve_spec", args=" ".join(SPEC_ARGS), seconds=wall, legs=legs,
         speculation_by_leg=spec, speculation=metrics["speculation"],
         outputs_match=metrics["outputs_match"],
         invariants="checked by the launcher after each paged leg",
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def phase_serve_quant(torch, fm, dec, serve) -> dict:
    """granite-3-8b at full width (40 layers, fp32 weights) serving the
    serve cell's trace on the paged layout and on quantized pages, fp8
    e4m3 then int8 (the launcher's ``paged_quant`` leg): per leg tok/s,
    TTFT, peak resident KV bytes (the quantized leg's against the fp32
    paged leg's: codes plus fp16 scales, 25.4 % at head dim 128), the
    launcher's ``quant_quality`` (reported, not a gate), and K3 launched
    40 x decode steps, through its quantized branch in the quantized leg.
    Returns the launches of each run, by code dtype."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-3-8b")
    out, runs = {}, {}
    for kv, warmup in (("fp8_e4m3", True), ("int8", False)):
        args = _quant_args(kv, warmup)
        # this code dtype's main path: counts set to 0 just before it
        _zero_counts(fm, dec)
        t0 = time.perf_counter()
        metrics = serve.main(args)
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
    """granite-3-8b at full width (40 layers, fp32 weights) on the swap
    cell's three waves (:func:`_swap_waves`) through ``ServeEngine``: a
    320-page pool with an 8 GiB host swap tier against a pool that never
    evicts (1024 pages), unquantized and with fp8 e4m3 pages.  Wave 2
    must demote wave 1's chains (>= 16 pages) and wave 3 must promote them
    back (>= 16 pages, prefix hits), and every stream must equal the
    never-evicting pool's, bit for bit.  Reports the swap tier's host ms
    of demotion and promotion."""
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("granite-3-8b")
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
    emit("serve_swap", config="granite-3-8b n_layers=40 fp32 weights",
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


def phase_model_gemma2(torch, fm, dec) -> None:
    """4 full-width gemma2-9b layers (local, global, local, global), fp32:
    prompts of 4600 and 5000 tokens, one prefilled whole and one in
    2048-token chunks, then 8 greedy decode steps, on the dense and the
    paged layout, with ``attn_impl`` "cuda" and "torch" on the same
    weights: logits within 1e-4 of their scale, equal tokens, and dense =
    paged."""
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
    del model, logits_all
    gc.collect()
    torch.cuda.empty_cache()


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
#: gemma2-9b-smoke on the card, dense: K1 at (32, 32), K2 at D = 32), both
#: layouts, two other smoke configs, and the MLA smoke config on the
#: default (dense) layout: K1 at (48, 32), K2's latent branch at (32, 16)
LAUNCHER_RUNS = [
    [],
    ["--cache-layout", "both"],
    ["--arch", "granite-3-8b-smoke", "--cache-layout", "paged"],
    ["--arch", "gemma-7b-smoke"],
    ["--arch", "deepseek-v3-671b-smoke"],
]


def phase_launcher_defaults(torch) -> dict:
    """Each :data:`LAUNCHER_RUNS` command as a subprocess from the repo
    root: exit code 0, every layout's streams complete and, where the
    launcher compares layouts, ``outputs_match``; its kernels launched
    (an MLA arch's decode kernels: :data:`MLA_DECODE_KERNEL`)."""
    from repro_torch.configs import get_config

    runs = []
    out_json = os.path.join(ROOT, "BENCH_torch_serving.json")
    for argv in LAUNCHER_RUNS:
        if os.path.exists(out_json):
            os.unlink(out_json)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        run = dict(argv=" ".join(argv) or "(no flags)", rc=proc.returncode,
                   seconds=wall)
        if proc.returncode == 0 and os.path.exists(out_json):
            with open(out_json) as fh:
                m = json.load(fh)
            run.update(arch=m["arch"],
                       mla=get_config(m["arch"]).mla is not None,
                       layouts=list(m["layouts"]),
                       tok_per_s=m["tok_per_s"],
                       kernel_launches={lo: v["kernel_launches"]
                                        for lo, v in m["layouts"].items()},
                       device=m["device"])
            if "outputs_match" in m:     # the launcher compared layouts
                run["outputs_match"] = m["outputs_match"]
        else:
            run["stderr_tail"] = proc.stderr[-2000:]
        runs.append(run)
    if os.path.exists(out_json):
        os.unlink(out_json)
    emit("launcher_defaults", runs=runs)
    for run in runs:
        check(run["rc"] == 0, f"launcher {run['argv']} exited {run['rc']}: "
                              f"{run.get('stderr_tail', '')[-600:]}")
        check(run.get("outputs_match", True) is True,
              f"launcher {run['argv']}: streams differ across layouts")
        check(run["device"]["platform"] == "gpu",
              f"launcher {run['argv']} ran on {run['device']}")
        kmap = MLA_DECODE_KERNEL if run["mla"] else DECODE_KERNEL
        for lo, n in run["kernel_launches"].items():
            check(n["fusemax_prefill"] > 0 and n[kmap[lo]] > 0,
                  f"launcher {run['argv']} {lo}: kernels not launched: {n}")
    check(runs[0]["arch"] == "gemma2-9b-smoke",
          f"the launcher's default arch is {runs[0]['arch']}")
    check(runs[-1]["mla"] and runs[-1]["layouts"] == ["dense"],
          f"the MLA smoke run served {runs[-1]['layouts']}, not the "
          f"default dense layout")
    return {"runs": runs}


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
    MoE cut to a dense FFN, as the launcher serves it and
    tests/test_torch_mla.py holds it to the reference."""
    from repro_torch.launch.serve import serve_config

    return serve_config("deepseek-v3-671b-smoke")


def phase_model_mla(torch, fm, dec, cfg=None, phase="model_mla") -> dict:
    """The tower on the dense and on the paged layout, each with
    ``attn_impl`` "cuda" and "torch" on the same weights: two prefill
    chunks (the second at offset 256, the absorbed form through K1 at
    (r + rd, r)) and 8 greedy decode steps (dense: K2's E != F branch;
    paged: K4).  Logits within 1e-4 of their scale cuda vs torch, equal
    streams, and the dense streams equal to the paged ones.  Returns the
    cuda runs' launches by layout."""
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = deepseek_tower() if cfg is None else cfg
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
    streams, logits_all, launches = {}, {}, {}
    for layout in ("dense", "paged"):
        for name, rt in (("cuda", rt_c), ("torch", rt_t)):
            _zero_counts(fm, dec)
            if layout == "paged":
                caches = tf.init_paged_cache(cfg, b, {"full": b * w}, ps,
                                             torch.float32, "cuda")
                pkw = dict(block_tables=tables, slot_ids=slot_ids)
                dkw = dict(block_tables=tables)
            else:
                caches = tf.init_cache(cfg, b, max_len, torch.float32,
                                       "cuda")
                pkw, dkw = {}, {}
            lg = torch.zeros((b, cfg.vocab), device="cuda")
            for off in (0, chunk):
                part, caches = tf.prefill(
                    cfg, model, {"inputs": toks[:, off:off + chunk]}, caches,
                    rt, kv_offset=off, true_len=true_len, **pkw)
                sel = (true_len - 1 >= off) & (true_len - 1 < off + chunk)
                lg = torch.where(sel[:, None], part, lg)
            kv = true_len.clone()
            out, lgs = [], [lg]
            for _ in range(8):
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(nxt)
                kv = kv + 1
                lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches,
                                            kv, rt, **dkw)
                lgs.append(lg)
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
    by_layout = {}
    for layout, kernel in (("dense", "latent_decode_partials"),
                           ("paged", "mla_paged_decode_partials")):
        lc, lt = logits_all[layout, "cuda"], logits_all[layout, "torch"]
        by_layout[layout] = dict(
            logits_max_abs_diff=(lc - lt).abs().max().item(),
            logits_max_abs=lt.abs().max().item(),
            token_match_rate=(streams[layout, "cuda"]
                              == streams[layout, "torch"]).float().mean()
            .item(),
            finite=bool(torch.isfinite(lc).all().item()),
            cuda_launches=launches[layout], decode_kernel=kernel)
    dense_eq_paged = bool((streams["dense", "cuda"]
                           == streams["paged", "cuda"]).all().item())
    emit(phase, config=f"{cfg.name} n_layers={cfg.n_layers} (MLA + dense "
         f"FFN) fp32, dense and paged", prompts=lens,
         prefill_chunks=[[0, chunk], [chunk, 2 * chunk]], decode_steps=8,
         rel_tol=rel_tol, layouts=by_layout,
         dense_streams_equal_paged=dense_eq_paged)
    for layout, r in by_layout.items():
        check(r["finite"], f"{layout}: non-finite logits in the MLA model "
                           f"cross-check")
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
    # the MLA main path: counts set to 0 just before it, read just after
    _zero_counts(fm, dec)
    t0 = time.perf_counter()
    metrics = serve.main(MLA_SERVE_ARGS, cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _counts(fm, dec)
    legs = _check_legs(metrics, cfg.n_layers, 16, 64, cfg.vocab,
                       MLA_DECODE_KERNEL)
    check(list(metrics["layouts"]) == ["dense", "paged"],
          f"serve_mla served {list(metrics['layouts'])}")
    emit("serve_mla", args=" ".join(MLA_SERVE_ARGS),
         config="deepseek-v3-671b n_layers=3", seconds=wall, legs=legs,
         outputs_match=metrics["outputs_match"],
         paged_vs_dense_tok_per_s=metrics["paged_vs_dense_tok_per_s"],
         main_path_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(metrics["outputs_match"] is True,
          "MLA greedy streams differ between the dense and paged legs")
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
    ptxas = _build.ptxas_report()
    emit("build", seconds=secs, build_dir=os.path.relpath(
        _build.build_dir(), ROOT), ptxas=ptxas)
    # the latent body keeps its accumulators and query fragments in
    # registers: a spill would put them in local memory
    spills = [f"{inst}: {line}" for lib in ("mla_paged_decode_partials",
                                            "latent_decode_partials")
              for inst, line in ptxas[lib].items()
              if "0 bytes spill stores, 0 bytes spill loads" not in line]
    check(len(ptxas["mla_paged_decode_partials"]) == 16
          and len(ptxas["latent_decode_partials"]) == 8 and not spills,
          f"latent decode instantiations missing or spilling: {spills}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = run_k1_cases(torch, gen, fm, autotune) + \
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
    t1m = time_k1_mla(torch, gen, fm, autotune)
    for where, t in t1m.items():
        emit("kernel_time", kernel=f"fusemax_prefill@{where}", **t)
    tg = time_gemma2(torch, gen, fm, dec, ops, autotune)
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
    bad = [r["case"] for r in rows + [same, same4, same2l, same256, same3q,
                                      same4q, same3qv, same4qv]
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
            if not t["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    torch.cuda.empty_cache()

    phase_model(torch)
    launches = phase_serve(torch, fm, dec, serve)
    phase_serve_prefix(torch, fm, dec, serve)
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_spec(torch, fm, dec)
    spec_launches = phase_serve_spec(torch, fm, dec, serve)
    phase_model_quant(torch, fm, dec)
    quant_launches = phase_serve_quant(torch, fm, dec, serve)
    phase_serve_swap(torch, fm, dec)
    # each later model gets the card to itself: the granite phases have
    # released theirs
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_gemma2(torch, fm, dec)
    g2_launches = phase_serve_gemma2(torch, fm, dec, serve)
    defaults = phase_launcher_defaults(torch)
    phase_model_mla(torch, fm, dec)
    mla_launches = phase_serve_mla(torch, fm, dec, serve)
    phase_serve_mla_prefix(torch, fm, dec, serve)
    phase_serve_mla_impls(torch, fm, dec)
    mla_quant_launches = phase_serve_mla_quant(torch, fm, dec, serve)
    mla_spec_launches = phase_serve_mla_spec(torch, fm, dec, serve)
    smoke_mla = phase_model_mla(torch, fm, dec, cfg=mla_smoke_tower(),
                                phase="model_mla_smoke")

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
                 if key.startswith(("bound_ms_", "share_", "library_"))
                 and key != "library_ms"}
        return dict(entry(name, "cuda", k1_src, k1_tpu, t, n_launches,
                          kernel="fusemax_prefill"), **dims, **extra,
                    tile=t["tile"])

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
    print(json.dumps({"kernels": [
        k1_entry("fusemax_prefill", t1, launches["fusemax_prefill"],
                 e=128, f=128),
        dict(entry("decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/decode_partials.cu",
                   "src/repro/kernels/decode.py:60", t2,
                   launches["decode_partials"]),
             device_ms=t2["device_ms"],
             **by_n_pos("decode_partials", launches, spec_launches)),
        dict(entry("paged_decode_partials", "cuda",
                   "src/repro_torch/kernels/csrc/paged_decode_partials.cu",
                   "src/repro/kernels/decode.py:248", t3,
                   launches["paged_decode_partials"]),
             device_ms=t3["device_ms"],
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
        # K2's E != F branch: MLA decode on the dense latent cache
        decode_entry("decode_partials@latent_576x512", k2l_src, k2_tpu, t2l,
                     mla_launches["latent_decode_partials"],
                     cases_of="latent_decode_partials",
                     k2latent_vs_k4_max_abs_diff=same2l[
                         "max_abs_diff_live"],
                     **by_n_pos("latent_decode_partials", mla_launches,
                                mla_spec_launches)),
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
