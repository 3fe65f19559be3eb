"""The port's kernel ops (repro_torch.kernels) against the JAX reference.

Runs on the CPU, where the port's ops take their kernels' plain torch
versions (impl="torch") — the code the CUDA kernels are held to on the
card.  Inputs come from numpy with a seed and go to both packages; the
reference runs its Pallas kernels in interpret mode (impl="pallas") as
tests/test_kernels.py does, its jnp executors and its 3-pass oracle.

Tolerances: fp32 paths differ only in summation order, so outputs
(unit-scale attention averages) agree to rtol = atol = 1e-5; bf16 inputs
are accumulated in fp32 by both and the output is rounded once, so they
agree to one bf16 ulp (rtol 2**-7, atol 1e-2).
"""
import dataclasses
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.core.passes import analyze as jax_analyze
from repro.kernels import autotune as jax_autotune
from repro.kernels import ops as jax_ops
from repro.kernels.fusemax import exp_maccs as jax_exp_maccs
from repro_torch.core.passes import analyze as port_analyze
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fusemax import exp_maccs

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)


def mk(seed, b, hq, hkv, p, m, e, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, p, e)).astype(np.float32),
            rng.standard_normal((b, hkv, m, e)).astype(np.float32),
            rng.standard_normal((b, hkv, m, f)).astype(np.float32))


def jax_call(fn, *arrays, **kw):
    return np.asarray(fn(*map(jnp.asarray, arrays), **kw), np.float32)


def torch_call(fn, *arrays, **kw):
    return fn(*map(torch.from_numpy, arrays), **kw).float().numpy()


# the shape sweep of tests/test_kernels.py
SHAPE_SWEEP = [
    # b, hq, hkv, p,   m,   e,  f
    (1, 4, 4, 128, 256, 64, 64),       # MHA, aligned
    (2, 8, 2, 64, 384, 32, 32),        # GQA group 4
    (1, 4, 1, 100, 200, 48, 48),       # MQA, unaligned → padding
    (1, 16, 16, 8, 512, 128, 128),     # few rows, long M
    (1, 25, 5, 33, 192, 64, 64),       # hymba-like odd head count
]


def _mask_kw(mask, m):
    return {"none": {}, "causal": dict(causal=True),
            "window": dict(causal=True, window=max(16, m // 3)),
            "softcap": dict(softcap=30.0)}[mask]


@pytest.mark.parametrize("shape", SHAPE_SWEEP)
@pytest.mark.parametrize("mask", ["none", "causal", "window", "softcap"])
def test_fusemax_attention_matches_reference(shape, mask):
    kw = _mask_kw(mask, shape[4])
    q, k, v = mk(sum(shape), *shape)
    tiles = dict(block_q=64, block_k=128)
    ours = torch_call(ops.fusemax_attention, q, k, v, impl="torch",
                      **tiles, **kw)
    # the jnp executor once per shape (causal), the Pallas kernel always
    for impl in ("pallas", "jnp") if mask == "causal" else ("pallas",):
        ref = jax_call(jax_ops.fusemax_attention, q, k, v, impl=impl,
                       **tiles, **kw)
        np.testing.assert_allclose(ours, ref, **F32_TOL, err_msg=impl)
    oracle = jax_call(jax_ops.fusemax_attention, q, k, v, impl="ref", **kw)
    np.testing.assert_allclose(ours, oracle, **F32_TOL)
    ours_ref = torch_call(ops.fusemax_attention, q, k, v, impl="ref", **kw)
    np.testing.assert_allclose(ours_ref, oracle, **F32_TOL)


@pytest.mark.parametrize("q_offset,p,m", [(7, 64, 71), (100, 28, 128),
                                          (224, 32, 256)])
def test_fusemax_attention_q_offset(q_offset, p, m):
    """Chunked-prefill continuation: queries at [q_offset, q_offset + P)
    against M = q_offset + P cached keys (G 4; the last case is a serving
    quantum's geometry scaled down: a short P after a long offset)."""
    q, k, v = mk(3, 2, 8, 2, p, m, 32, 32)
    kw = dict(causal=True, q_offset=q_offset)
    ours = torch_call(ops.fusemax_attention, q, k, v, impl="torch", **kw)
    for impl in ("pallas", "jnp", "ref"):
        ref = jax_call(jax_ops.fusemax_attention, q, k, v, impl=impl, **kw)
        np.testing.assert_allclose(ours, ref, **F32_TOL, err_msg=impl)


def test_fusemax_attention_bf16():
    q, k, v = mk(1, 1, 8, 2, 64, 256, 64, 64)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = ops.fusemax_attention(qb, kb, vb, impl="torch", causal=True)
    assert ours.dtype == torch.bfloat16
    # the same bf16-rounded inputs go to the reference
    qj, kj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (qb, kb, vb))
    ref = jax_ops.fusemax_attention(qj, kj, vj, impl="pallas", causal=True)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


@pytest.mark.parametrize("m_valid,kw", [
    (200, dict()),
    (150, dict(causal=True, q_offset=40)),
    (90, dict(causal=True, window=24, softcap=20.0)),
])
def test_kernel_layout_plain_version_matches_pallas_kernel(m_valid, kw):
    """At the folded layout the CUDA kernel takes (GQA group 4 in the
    query rows, keys padded past ``m_valid``), the plain version equals
    the Pallas kernel run on the same arrays."""
    from repro.kernels.fusemax import fusemax_attention_pallas
    from repro_torch.kernels.fusemax import fusemax_attention_torch

    rng = np.random.default_rng(m_valid)
    q = rng.standard_normal((4, 64 * 4, 32)).astype(np.float32)
    k = rng.standard_normal((4, 256, 32)).astype(np.float32)
    v = rng.standard_normal((4, 256, 32)).astype(np.float32)
    args = dict(scale=32 ** -0.5, group=4, block_q=64, block_k=128,
                m_valid=m_valid, **kw)
    ref = jax_call(fusemax_attention_pallas, q, k, v, interpret=True,
                   **args)
    ours = torch_call(fusemax_attention_torch, q, k, v, **args)
    np.testing.assert_allclose(ours, ref, **F32_TOL)


#: K1 at the redesigned wgmma dims, at the kernel's own key tile:
#: (E, F, B, Hq, Hkv, P, M, m_valid, kwargs) — gemma's (256, 256) under
#: every mask it serves (causal, a window, softcap 50, a history offset)
#: and a ragged ``m_valid``, DeepSeek's MLA prefill (192, 128) causal, the
#: MLA smoke config's (48, 32) (causal, a ragged ``m_valid``) and the GQA
#: smoke configs' (32, 32) (a window and softcap, as gemma2-9b-smoke's
#: local layers)
NEW_TILE_CASES = [
    (256, 256, 1, 4, 2, 64, 64, None, dict(causal=True)),
    (256, 256, 1, 4, 2, 64, 80, None,
     dict(causal=True, q_offset=16, window=24, softcap=50.0)),
    (256, 256, 2, 2, 2, 64, 96, 70, dict(softcap=50.0)),
    (192, 128, 1, 2, 2, 64, 96, None, dict(causal=True)),
    (48, 32, 2, 4, 4, 64, 64, None, dict(causal=True)),
    (48, 32, 1, 4, 4, 64, 96, 75, dict()),
    (32, 32, 1, 4, 2, 64, 64, None,
     dict(causal=True, window=40, softcap=50.0)),
]


@pytest.mark.parametrize("case", NEW_TILE_CASES,
                         ids=["d256-causal", "d256-off-window-cap",
                              "d256-mvalid-cap", "mla-fwd-causal",
                              "smoke-mla-causal", "smoke-mla-mvalid",
                              "smoke-gqa-window-cap"])
def test_plain_version_at_the_new_key_tiles_matches_reference(case):
    """The plain version at the wgmma body's 64-row block and its key tile
    at (256, 256) (16 keys), (192, 128), (48, 32) and (32, 32) (32 keys)
    equals the reference's Pallas kernel (interpret) at the same tile, on
    the folded layout the kernel takes, and the reference's jnp executor
    on the unfolded heads (on the first ``m_valid`` keys, which is the
    same function), within 1e-5; every plan of those dims has that
    tile."""
    from repro.kernels.fusemax import fusemax_attention_pallas
    from repro_torch.kernels.fusemax import fusemax_attention_torch

    e, f, b, hq, hkv, p, m, m_valid, kw = case
    kern = autotune.CUDA_PREFILL[(e, f)]
    assert kern.body == "wgmma"
    assert {autotune.prefill_plan(fib, rows, e, f).block_k
            for fib in (1, 16, 512) for rows in (1, 128, 16384)} \
        == {kern.block_k}
    assert all(bq == 64 for bq, _ in kern.plans)
    bq, bk = autotune.CUDA_PREFILL_TILES[(e, f)]
    assert (bq, bk) == (64, kern.block_k)
    g = hq // hkv
    q, k, v = mk(e + m, b, hq, hkv, p, m, e, f)
    q_f = ops._fold_decode_q(torch.from_numpy(q), b, hkv, g, e)
    k_f, v_f = (torch.from_numpy(x).reshape(b * hkv, m, x.shape[-1])
                for x in (k, v))
    args = dict(scale=e ** -0.5, group=g, block_q=bq, block_k=bk,
                m_valid=m_valid, **kw)
    ours = fusemax_attention_torch(q_f, k_f, v_f, **args)
    tol = dict(rtol=0.0, atol=1e-5)
    pallas = jax_call(fusemax_attention_pallas, q_f.numpy(), k_f.numpy(),
                      v_f.numpy(), interpret=True, **args)
    np.testing.assert_allclose(ours.numpy(), pallas, err_msg="pallas",
                               **tol)
    mv = m if m_valid is None else m_valid
    jnp_ref = jax_call(jax_ops.fusemax_attention, q, k[:, :, :mv],
                       v[:, :, :mv], impl="jnp", scale=e ** -0.5, **kw)
    unfolded = ops._unfold_decode_out(ours, b, hkv, g, f, p=p).numpy()
    np.testing.assert_allclose(unfolded, jnp_ref, err_msg="jnp", **tol)


def test_exp_maccs_elementwise():
    x = np.linspace(-60.0, 0.0, 50001, dtype=np.float32)
    ours = exp_maccs(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_exp_maccs(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=2e-7, atol=0)
    rel = np.abs(ours - np.exp(x)) / np.maximum(np.exp(x), 1e-30)
    assert rel.max() < 2e-5


def test_fusemax_attention_exp_maccs():
    q, k, v = mk(2, 1, 4, 4, 64, 256, 32, 32)
    kw = dict(causal=True, exp_impl="maccs")
    ours = torch_call(ops.fusemax_attention, q, k, v, impl="torch", **kw)
    ref = jax_call(jax_ops.fusemax_attention, q, k, v, impl="pallas", **kw)
    np.testing.assert_allclose(ours, ref, **F32_TOL)


def _decode_inputs(seed, b, hq, hkv, p, m, e, kv_len):
    q, k, v = mk(seed, b, hq, hkv, p, m, e, e)
    return q, k, v, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (16, 1)])
def test_fusemax_decode_ragged(splits, hq, hkv):
    """kv_len 0 rows follow the Pallas kernel (no tile runs → output 0);
    the reference's jnp executor and oracle differ there, so they are
    compared on the kv_len ≥ 1 rows only."""
    kv_len = [0, 1, 150, 256]
    q, k, v, kvl = _decode_inputs(5, 4, hq, hkv, 1, 256, 64, kv_len)
    kw = dict(splits=splits, block_k=128)
    ours = torch_call(ops.fusemax_decode, q, k, v, kvl, impl="torch", **kw)
    pallas = jax_call(jax_ops.fusemax_decode, q, k, v, kvl, impl="pallas",
                      **kw)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    assert np.all(ours[0] == 0.0)
    live = kvl >= 1
    for impl in ("jnp", "ref"):
        ref = jax_call(jax_ops.fusemax_decode, q, k, v, kvl, impl=impl, **kw)
        np.testing.assert_allclose(ours[live], ref[live], **F32_TOL,
                                   err_msg=impl)


def test_fusemax_decode_window_softcap():
    q, k, v, kvl = _decode_inputs(6, 3, 4, 4, 1, 256, 32, [17, 200, 256])
    for kw in (dict(window=64), dict(softcap=20.0)):
        kw.update(splits=4, block_k=64)
        ours = torch_call(ops.fusemax_decode, q, k, v, kvl, impl="torch",
                          **kw)
        for impl in ("pallas", "jnp", "ref"):
            ref = jax_call(jax_ops.fusemax_decode, q, k, v, kvl, impl=impl,
                           **kw)
            np.testing.assert_allclose(ours, ref, **F32_TOL,
                                       err_msg=f"{impl} {kw}")


def test_fusemax_decode_verify_rows():
    """P = 2 verify rows: query j attends keys < kv_len + j.  With
    kv_len = 0, row j = 0 has no valid key but its splits still run
    tiles; the port keeps the Pallas kernel's result there too."""
    q, k, v, kvl = _decode_inputs(7, 3, 8, 2, 2, 256, 32, [0, 5, 250])
    kw = dict(splits=4, block_k=64)
    ours = torch_call(ops.fusemax_decode, q, k, v, kvl, impl="torch", **kw)
    pallas = jax_call(jax_ops.fusemax_decode, q, k, v, kvl, impl="pallas",
                      **kw)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    for impl in ("jnp", "ref"):
        ref = jax_call(jax_ops.fusemax_decode, q, k, v, kvl, impl=impl, **kw)
        np.testing.assert_allclose(ours[1:], ref[1:], **F32_TOL,
                                   err_msg=impl)


def test_autotune_matches_reference_model():
    for p, m, e in [(128, 256, 64), (33 * 5, 192, 64), (4096, 1024, 128),
                    (8, 512, 128)]:
        pb, mb = jax_autotune._bucket(p), jax_autotune._bucket(m)
        want = min(jax_autotune._attention_candidates(pb, mb),
                   key=lambda c: jax_autotune._attention_cost(c, pb, mb, e,
                                                              e))
        got = autotune.attention_params(p, m, e, e, impl="torch")
        assert (got.block_q, got.block_k) == (want.block_q, want.block_k)
    for m in (64, 256, 512, 1000, 2048, 4096):
        want = min(jax_autotune._decode_candidates(m),
                   key=lambda c: jax_autotune._decode_cost(c, m, 8, 128, 128))
        got = autotune.decode_params(m, 8, 128, 128)
        assert (got.splits, got.block_k) == (want.splits, want.block_k)
    assert autotune.next_pow2(1000) == jax_autotune.next_pow2(1000) == 1024


@pytest.mark.parametrize("w,ps,e", [(128, 16, 128), (4, 16, 32),
                                    (64, 8, 64), (8, 64, 128), (3, 16, 32),
                                    (16, 32, 256)])
def test_paged_autotune_matches_reference_model(w, ps, e):
    """Page-aligned split-K geometry: the reference's cost model over its
    candidates (granite's serve shape first: 16 splits of 16-key tiles,
    where the dense model picks 128-key tiles at the same splits)."""
    want = min(jax_autotune._paged_decode_candidates(w, ps),
               key=lambda c: jax_autotune._decode_cost(c, w * ps, 8, e, e))
    got = autotune.paged_decode_params(w, ps, 8, e, e)
    assert (got.splits, got.block_k) == (want.splits, want.block_k)
    ref = jax_autotune.paged_decode_params(w, ps, 8, e, e)
    assert (got.splits, got.block_k) == (ref.splits, ref.block_k)
    if (w, ps, e) == (128, 16, 128):
        assert (got.splits, got.block_k) == (16, 16)
        dense = autotune.decode_params(w * ps, 8, e, e)
        assert (dense.splits, dense.block_k) == (16, 128)


def _wg_bytes(bq, bk, e, f, nbuf, fs=1, elem_bytes=4):
    """``WgLayout::BYTES`` of ``fusemax_prefill_wgmma.cuh`` at a key tile
    and a count of K / Vᵀ split buffers: BK raw K and V rows, the fp32
    splits of Q, NBUF K tiles and NBUF Vᵀ tiles, hi and, unless bf16, lo,
    and 10 mbarriers."""
    nb = 1 if elem_bytes == 2 else 2
    return (elem_bytes * bk * (e + f)
            + 4 * nb * (bq * e + nbuf * bk * e + nbuf * (f // fs) * bk) + 80)


def test_cuda_tile_fits_shared_memory():
    """Each (E, F) pair the CUDA prefill kernel is compiled for has its own
    body, tile and plans, and every plan fits one block's shared memory:
    granite's (128, 128) runs the wgmma body on 64 x 32 (229,456 B fp32,
    the kernel's ``WgLayout::BYTES``: the raw tiles, Q's split and two K
    and Vᵀ splits), at a serving quantum in two column blocks (196,688 B);
    the mma.sync body's (128, 128) tile was 128 x 64 with two warps per
    32-row group (157,696 B); gemma's (256, 256) runs the wgmma body on
    64 x 16 with one K and one Vᵀ split (229,456 B; two would fit only at
    8 keys, 213,072 B) and DeepSeek's MLA prefill (192, 128) on 64 x 32
    with one of each (221,264 B; two at 16 keys, 200,784 B); the smoke
    dims (48, 32) and (32, 32) on 64 x 32 with two split buffers (75,856
    and 57,424 B; on the mma.sync body 128 x 64, 66,560 and 46,080 B).
    DeepSeek's absorbed (576, 512) stays on the mma.sync body at 64 x 64
    with four warps a row group (220,160 B; 128 rows would take 388,096
    B; the wgmma body's Q split alone would take 294,912 B).  A pair the
    kernel is not compiled for raises."""
    tile = autotune.attention_params(4096, 1024, 128, 128, impl="cuda")
    assert (tile.block_q, tile.block_k) == (64, 32)
    assert autotune.prefill_plan(8, 512, 128, 128).f_split == 2
    assert autotune.prefill_smem_bytes(64, 32, 128, 128, 1) == 229_456
    assert autotune.prefill_smem_bytes(64, 32, 128, 128, 1,
                                       f_split=2) == 196_688
    for (e, f), (bq, bk) in autotune.CUDA_PREFILL_TILES.items():
        kern = autotune.CUDA_PREFILL[(e, f)]
        got = autotune.attention_params(4096, 1024, e, f, impl="cuda")
        assert (got.block_q, got.block_k) == (bq, bk) == \
            (kern.plans[0][0], kern.block_k)
        assert kern.plans[0] == (bq, 1)
        for pbq, fs in kern.plans:
            assert pbq == bq                 # one tile for every plan
            for eb in (4, 2):
                assert autotune.prefill_smem_bytes(
                    pbq, bk, e, f, kern.warp_split, eb, f_split=fs) \
                    <= autotune.SMEM_BUDGET
    assert autotune.CUDA_PREFILL_TILES[(576, 512)] == (64, 64)
    assert autotune.prefill_smem_bytes(128, 64, 576, 512, 4) \
        > autotune.SMEM_BUDGET
    assert 4 * 64 * 576 * 2 == 294_912 > autotune.SMEM_BUDGET
    assert autotune.CUDA_PREFILL_TILES[(48, 32)] == (64, 32)
    assert autotune.CUDA_PREFILL_TILES[(32, 32)] == (64, 32)
    assert autotune.prefill_smem_bytes(64, 32, 48, 32, 1) == 75_856
    assert autotune.prefill_smem_bytes(64, 32, 32, 32, 1) == 57_424
    assert autotune.CUDA_PREFILL_TILES[(256, 256)] == (64, 16)
    assert autotune.CUDA_PREFILL_TILES[(192, 128)] == (64, 32)
    assert autotune.prefill_smem_bytes(64, 16, 256, 256, 1) == 229_456
    assert _wg_bytes(64, 8, 256, 256, 2) == 213_072
    assert autotune.prefill_smem_bytes(64, 32, 192, 128, 1) == 221_264
    assert _wg_bytes(64, 16, 192, 128, 2) == 200_784
    assert autotune.prefill_smem_bytes(64, 64, 576, 512, 4) == 220_160
    with pytest.raises(ValueError, match="compiled for head dims"):
        autotune.attention_params(64, 64, 512, 512, impl="cuda")
    with pytest.raises(ValueError, match="no column blocks"):
        autotune.prefill_smem_bytes(64, 64, 576, 512, 4, f_split=2)


def _eligible(fibers, rows, e, f):
    """The plans :func:`autotune.prefill_plan` chooses among: the default,
    and a plan with column blocks while it launches at most one block an
    SM."""
    kern = autotune.CUDA_PREFILL[(e, f)]
    plans = [autotune.PrefillPlan(bq, kern.block_k, fs,
                                  -(-rows // bq) * fibers * fs)
             for bq, fs in kern.plans]
    return [p for p in plans if p.f_split == 1 or p.blocks <= 132]


@pytest.mark.parametrize("what,fibers,rows,e,f,want", [
    # serve_async's quantum on granite: B1, 8 kv heads x G 4, P = 128:
    # 64 blocks by default, two column blocks give 128
    ("granite quantum", 8, 4 * 128, 128, 128, (2, 128)),
    # stablelm-1.6b training: B4 x 32 heads, G 1, P = 1024
    ("stablelm train", 128, 1024, 64, 64, (1, 2048)),
    # granite's whole-prompt chunk: B4 x 8 kv heads, G 4, P = 1024
    ("granite chunk", 32, 4 * 1024, 128, 128, (1, 2048)),
    # hymba's quantum: B1, 5 kv heads x G 5, P = 128: 50 blocks by default
    ("hymba quantum", 5, 5 * 128, 64, 64, (2, 100)),
    # granite, P = 208: 104 blocks by default; two column blocks would be
    # 208, more than the SMs, so the default runs
    ("granite short chunk", 8, 4 * 208, 128, 128, (1, 104)),
    # hymba, P = 256: 100 blocks by default; 200 in two column blocks,
    # though two fit an SM's shared memory, ran slower on the card
    ("hymba short chunk", 5, 5 * 256, 64, 64, (1, 100)),
    # DeepSeek's absorbed tail: B4, the 128 heads in one group, P = 256:
    # 512 row blocks a fiber on the mma.sync body
    ("absorbed tail", 4, 128 * 256, 576, 512, (1, 2048)),
    # the MLA smoke config's prefill: B4 x 4 heads, P = 256
    ("mla smoke", 16, 256, 48, 32, (1, 64)),
])
def test_prefill_plan_fills_the_card(what, fibers, rows, e, f, want):
    """The plan launches at least the card's 132 SMs of blocks at the
    training shape and a whole-prompt chunk, which the default plan
    already fills.  A shorter call takes two column blocks where they
    launch at most one block an SM, else the default plan: granite's
    quantum launches 128 (4 SMs short of 132; four column blocks, 256,
    ran slower on the card and are not compiled), hymba's 100, twice the
    default's.  The absorbed tail launches 2048 blocks, the MLA smoke
    prefill 64 (its one plan)."""
    plan = autotune.prefill_plan(fibers, rows, e, f)
    assert (plan.f_split, plan.blocks) == want, what
    assert plan.blocks == -(-rows // plan.block_q) * fibers * plan.f_split
    assert (plan.block_q, plan.f_split) in autotune.CUDA_PREFILL[(e, f)].plans
    assert plan.blocks >= autotune.H100_SMS == 132 or plan.blocks == max(
        p.blocks for p in _eligible(fibers, rows, e, f))
    if plan.f_split > 1:
        assert plan.blocks <= 132


@pytest.mark.parametrize("e,f", sorted(autotune.CUDA_PREFILL))
def test_prefill_plan_key_tile_is_independent_of_p(e, f):
    """BK, the K chunk (whose k-steps make the score partials: the
    mma.sync body's ``PREFILL_K_CHUNK``, the wgmma body's all of E) and
    the warps that split a tile's keys are one per (E, F): every plan, at
    any P, fibers or M, runs the same key tile, so a row's fp32 result
    never depends on how the prompt was chunked.  A shape too small to
    fill the card takes the plan that launches the most blocks, at most
    one an SM."""
    kern = autotune.CUDA_PREFILL[(e, f)]
    bk = kern.block_k
    kc = autotune.PREFILL_K_CHUNK if kern.body == "mma_sync" else e
    assert e % kc == 0 and kc % 8 == 0
    for fibers in (1, 2, 5, 8, 32, 128):
        for p in (1, 3, 17, 128, 512, 1024, 4096):
            plan = autotune.prefill_plan(fibers, p, e, f)
            assert plan.block_k == bk
            if plan.blocks < autotune.H100_SMS:
                assert plan.blocks == max(
                    q.blocks for q in _eligible(fibers, p, e, f))


@pytest.mark.parametrize("e,f", sorted(autotune.CUDA_PREFILL))
def test_prefill_plan_column_blocks_tile_f(e, f):
    """The F-split column blocks of every plan tile F exactly: each output
    column belongs to one block, and each block's columns split evenly
    over the warps of a row group in 8-column n-blocks and 16-byte
    vectors.  Only the wgmma body has column blocks."""
    kern = autotune.CUDA_PREFILL[(e, f)]
    for bq, fs in kern.plans:
        fc = f // fs
        assert fc * fs == f and fc % (8 * kern.warp_split) == 0 \
            and fc % 4 == 0
        if kern.body == "wgmma":             # a wgmma's N
            assert bq == 64 and fc in (32, 64, 128, 256)
        else:
            assert fs == 1
        cols = np.concatenate([np.arange(cb * fc, (cb + 1) * fc)
                               for cb in range(fs)])
        np.testing.assert_array_equal(np.sort(cols), np.arange(f))
        assert len(set(cols.tolist())) == f


def _source_plans():
    """(E, F) -> (body, BK, WF, NBUF, [(BQ, FS), ...]) as
    ``csrc/fusemax_prefill.cu`` compiles them: ``REPRO_WGMMA_PLANS`` on
    the wgmma body (one warpgroup a row group; the key tile and split
    buffers of its ``WgTile``: 32 keys and two buffers unless the (E, F)
    has a specialization), in order, and ``REPRO_DIMS`` on the mma.sync
    body under the one plan of their ``PrefillTile``."""
    import re
    from repro_torch.kernels import _build

    src = (_build.CSRC / "fusemax_prefill.cu").read_text()
    wg = (_build.CSRC / "fusemax_prefill_wgmma.cuh").read_text()

    def macro(name):
        block = src[src.index(f"#define {name}(X)"):]
        end = block.index("\n")
        while block[end - 1] == "\\":
            end = block.index("\n", end + 1)
        return block[:end]

    tile_re = r"static constexpr int BK = (\d+), NBUF = (\d+);"
    default = tuple(map(int, re.search(
        r"struct WgTile {\s*" + tile_re, wg).groups()))
    wg_tiles = {(int(e), int(f)): (int(bk), int(nbuf))
                for e, f, bk, nbuf in re.findall(
                    r"struct WgTile<(\d+), (\d+)> {\s*" + tile_re, wg)}
    plans = {}
    for e, f, bq, fs in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)",
                                   macro("REPRO_WGMMA_PLANS")):
        dims = (int(e), int(f))
        bk, nbuf = wg_tiles.get(dims, default)
        plans.setdefault(dims, ("wgmma", bk, 1, nbuf, []))[4] \
            .append((int(bq), int(fs)))
    for e, f in re.findall(r"X\((\d+), (\d+)\)", macro("REPRO_DIMS")):
        tile = re.search(
            rf"struct PrefillTile<{e}, {f}> {{\s*static constexpr int "
            r"BQ = (\d+), BK = (\d+), WF = (\d+)", src)
        bq, bk, wf = map(int, tile.groups())
        plans[(int(e), int(f))] = ("mma_sync", bk, wf, 2, [(bq, 1)])
    return plans


def _layout_bytes(bq, e, f, fs, elem_bytes):
    """``Layout<T, E, F>::BYTES`` of ``fusemax_prefill.cu`` (VK, the slot
    and the fp32 P tile), or at the wgmma body's dims ``WgLayout<T, E, F,
    FS>::BYTES`` (:func:`_wg_bytes` at the BK and NBUF the source's
    ``WgTile`` sets), written out from the structs."""
    kern = autotune.CUDA_PREFILL[(e, f)]
    if kern.body == "wgmma":
        assert bq == 64
        _, bk, _, nbuf, _ = _source_plans()[(e, f)]
        return _wg_bytes(bq, bk, e, f, nbuf, fs, elem_bytes)
    assert fs == 1
    bk, wf = kern.block_k, kern.warp_split
    kc = autotune.PREFILL_K_CHUNK
    pad = 16 // elem_bytes
    vk = bk
    while vk > 8 and vk * (f + pad) > bk * (kc + pad):
        vk //= 2
    slot = max(bk * (kc + pad), vk * (f + pad))
    assert bq % 32 == 0
    probs = 4 * (bq * (bk + 8) + bq * wf) if wf > 1 else 0
    return elem_bytes * (bq * (e + pad) + 3 * slot) + probs


def test_prefill_plans_and_smem_model_match_the_source():
    """``CUDA_PREFILL`` is what the source compiles — each (E, F)'s body,
    key tile, warp split and plans, in order — and ``prefill_smem_bytes``
    at every plan equals the source's layout formula in fp32 and bf16,
    within one block's 232,448 B: on the wgmma body at (64, 64) 114,768 B
    (two blocks share an SM) and 98,384 B in two column blocks; at
    (128, 128) 229,456 and 196,688 B in one and two; at (256, 256)
    229,456 B and at (192, 128) 221,264 B, one split buffer each; at
    (48, 32) and (32, 32) 75,856 and 57,424 B (three blocks an SM, by
    shared memory)."""
    assert {dims: (k.body, k.block_k, k.warp_split, k.split_buffers,
                   list(k.plans))
            for dims, k in autotune.CUDA_PREFILL.items()} == _source_plans()
    for (e, f), kern in autotune.CUDA_PREFILL.items():
        for bq, fs in kern.plans:
            for eb in (4, 2):
                got = autotune.prefill_smem_bytes(
                    bq, kern.block_k, e, f, kern.warp_split, eb, f_split=fs)
                assert got == _layout_bytes(bq, e, f, fs, eb), (e, f, bq, fs)
                assert got <= autotune.SMEM_BUDGET
    smem = lambda e, fs: autotune.prefill_smem_bytes(64, 32, e, e, 1,
                                                     f_split=fs)
    assert (smem(64, 1), smem(64, 2)) == (114_768, 98_384)
    assert (smem(128, 1), smem(128, 2)) == (229_456, 196_688)
    assert 2 * (smem(64, 1) + 1024) <= 233_472   # two blocks an SM
    assert autotune.prefill_smem_bytes(64, 16, 256, 256, 1) == 229_456
    assert autotune.prefill_smem_bytes(64, 32, 192, 128, 1) == 221_264
    assert autotune.prefill_smem_bytes(64, 32, 48, 32, 1) == 75_856
    assert autotune.prefill_smem_bytes(64, 32, 32, 32, 1) == 57_424
    assert 3 * (75_856 + 1024) <= 233_472 < 4 * (57_424 + 1024)


def test_kernel_cascades_name_the_reference_builders():
    """Each port op names its reference op's cascade builder; a port-only
    op (the dense latent decode) resolves through the reference op it
    implements."""
    assert set(ops.REFERENCE_CASCADES) == set(ops.KERNEL_CASCADES)
    for name, dotted in ops.REFERENCE_CASCADES.items():
        builder = jax_ops.KERNEL_CASCADES[ops.REFERENCE_OP.get(name, name)]
        assert dotted == f"{builder.__module__}.{builder.__qualname__}", name


def _cascade_fields(c):
    return (c.name, [dataclasses.astuple(e) for e in c.einsums],
            dict(c.partitions), dict(c.aliases))


@pytest.mark.parametrize("name", sorted(ops.KERNEL_CASCADES))
def test_port_cascade_builders_equal_the_reference_builders(name):
    """The port's builder of each op builds the reference builder's
    cascade, Einsum by Einsum, and both analyze to the same passes and
    live footprint over M."""
    port = ops.KERNEL_CASCADES[name]()
    ref = jax_ops.KERNEL_CASCADES[ops.REFERENCE_OP.get(name, name)]()
    assert _cascade_fields(port) == _cascade_fields(ref)
    pa, ra = port_analyze(port, "M"), jax_analyze(ref, "M")
    assert (pa.passes, pa.full_fiber_tensors()) \
        == (ra.passes, ra.full_fiber_tensors())
    assert pa.traversal_gens == ra.traversal_gens


def test_cuda_impl_on_cpu_tensor_raises():
    q, k, v = (torch.from_numpy(a) for a in mk(0, 1, 4, 2, 8, 16, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_decode(q[:, :, :1], k, v, torch.tensor([3]), impl="cuda")
    # "auto" on a CPU tensor is the plain version, never the kernel
    assert ops.resolve_impl("auto", q) == "torch"


def test_import_without_jax_or_triton():
    """``import repro_torch`` and its kernel ops work with jax and triton
    unimportable (blocked in sys.modules)."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "triton", "repro"):
            sys.modules[name] = None
        import repro_torch
        import repro_torch.kernels.ops
        import repro_torch.kernels.decode
        import repro_torch.model.attention
        import repro_torch.serving.engine
        import repro_torch.serving.kv_cache
        import repro_torch.launch.serve
        import repro_torch.bridge
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# K2 on the slot strips of a sequence-sharded dense cache
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, P, M, E, kv_len, window, strip counts, splits)
K2_STRIPS = [
    (4, 8, 2, 1, 256, 64, [0, 1, 150, 256], None, (2, 4, 16), 16),
    (3, 4, 4, 1, 256, 32, [17, 200, 256], 64, (2, 4), 8),
    (2, 8, 2, 13, 512, 32, [300, 499], None, (4,), 8),
]


@pytest.mark.parametrize("case", K2_STRIPS, ids=["ragged", "window",
                                                 "chain_p13"])
def test_k2_strips_concatenate_to_the_whole_sweep(case):
    """Each strip's plain partials on a K/V that hold only its slots
    (``strip_kv``), concatenated in strip order, equal the whole sweep's
    partials bit for bit; so does the seq-sharded decode's output the
    whole decode's at the same geometry."""
    b, hq, hkv, p, m, e, kv_len, window, tps, splits = case
    q, k, v, kvl = (torch.from_numpy(np.asarray(a)) for a in
                    _decode_inputs(11, b, hq, hkv, p, m, e, kv_len))
    g = hq // hkv
    for tp in tps:
        sp, bk, n = ops.seq_strips(m, g, e, e, tp, p=p, splits=splits)
        assert sp == splits and n * tp == sp
        kw = dict(splits=sp, block_k=bk, window=window, impl="torch")
        whole = ops.fusemax_decode_strip(q, k, v, kvl, split_first=0,
                                         n_splits=sp, **kw)
        ms = m // tp
        parts = [ops.fusemax_decode_strip(
            q, k[:, :, j * ms:(j + 1) * ms], v[:, :, j * ms:(j + 1) * ms],
            kvl, split_first=j * n, n_splits=n, **kw) for j in range(tp)]
        for i in range(3):
            cat = torch.cat([part[i] for part in parts], dim=1)
            assert torch.equal(cat, whole[i]), (tp, i)
        if p == 1:
            out = ops.fusemax_decode_seq_sharded(
                q, list(k.chunk(tp, 2)), list(v.chunk(tp, 2)), kvl,
                window=window, impl="torch", splits=sp)
            ref = ops.fusemax_decode(q, k, v, kvl, window=window,
                                     impl="torch", splits=sp, block_k=bk)
            assert torch.equal(out, ref), tp


def test_k2_strip_count_must_divide_the_splits():
    q, k, v, kvl = (torch.from_numpy(np.asarray(a)) for a in
                    _decode_inputs(12, 2, 4, 2, 1, 96, 32, [96, 50]))
    with pytest.raises(ValueError, match=r"tp=3 does not divide 4"):
        ops.fusemax_decode_seq_sharded(q, list(k.chunk(3, 2)),
                                       list(v.chunk(3, 2)), kvl,
                                       impl="torch", splits=4)
    with pytest.raises(ValueError, match="splits=8"):
        ops.seq_strips(256, 4, 32, 32, 16, splits=8)
