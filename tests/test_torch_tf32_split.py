"""The 3xTF32 split of K1 and of the MLA latent decode body, emulated on
the CPU.

K1 (``csrc/fusemax_prefill.cu``) and the latent decode body that K4 and
K2's E ≠ F branch share (``csrc/mla_decode_partials.cuh``) run both of
their fp32 products on the tensor cores: each operand x is split into hi
= cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), and lo·hi +
hi·lo + hi·hi is accumulated in fp32.  This file emulates that in plain
torch — the rounding on the 13 mantissa bits TF32 drops (to nearest, ties
away from zero) and the three products — and puts it in place of
``torch.einsum`` under the plain versions (``fusemax_attention_torch``,
whose two einsums are exactly Q·Kᵀ and P·V; the latent sweep of
``mla_paged_decode_partials_torch`` and ``latent_decode_partials_torch``,
whose two are Q·[ckv | krope]ᵀ and P·ckv), so the emulation stays out of
the package.

Tolerances: the split is held to the plain fp32 version within
chip_smoke's fp32 tolerance (atol 1e-4); single-pass TF32 (hi·hi alone)
must land at least 10x farther from a float64 reference than the split,
so the comparison can fail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode as dec
from repro_torch.kernels import fusemax as fm

_EINSUM = torch.einsum
K1_PRODUCTS = ("bre,bke->brk", "brk,bkf->brf")
#: the latent sweep's two products (``decode._sweep_partials``): scores
#: of every split's key tile, and P times its value tile
LATENT_PRODUCTS = ("bre,bske->bsrk", "bsrk,bskf->bsrf")
FP32_ATOL = 1e-4


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round a float32 to TF32's 10 mantissa bits, to
    nearest with ties away from zero (sign-magnitude bits: adding half of
    the dropped range rounds the magnitude), returned as a float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3_einsum(eq, a, b):
    """One K1 or latent product in 3xTF32: lo·hi + hi·lo + hi·hi, small
    terms first (each product of two TF32 values is exact in fp32)."""
    assert eq in K1_PRODUCTS + LATENT_PRODUCTS, eq
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return _EINSUM(eq, al, bh) + _EINSUM(eq, ah, bl) + _EINSUM(eq, ah, bh)


def tf32_einsum(eq, a, b):
    """One product in single-pass TF32 (what the kernels must not do)."""
    assert eq in K1_PRODUCTS + LATENT_PRODUCTS, eq
    return _EINSUM(eq, rna_tf32(a), rna_tf32(b))


#: (E, F), kv heads, GQA group: granite's heads, DeepSeek's mla_forward
#: and its absorbed latent attention
DIMS = [((128, 128), 2, 4), ((192, 128), 4, 1), ((576, 512), 1, 16)]


def make(seed, dims, hkv, group, p=40, inputs="unit"):
    e, f = dims
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((hkv, p * group, e)).astype(np.float32)
    k = rng.standard_normal((hkv, p, e)).astype(np.float32)
    v = rng.standard_normal((hkv, p, f)).astype(np.float32)
    if inputs == "low_bits":      # bits below TF32's mantissa matter
        q, k, v = (x + x * np.float32(2.0 ** -12) for x in (q, k, v))
    return tuple(map(torch.from_numpy, (q, k, v)))


def k1(q, k, v, group):
    """The plain K1, causal, at the CUDA kernel's tile."""
    e, f = q.shape[2], v.shape[2]
    bq, bk = fm.CUDA_PREFILL_TILES[(e, f)]
    return fm.fusemax_attention_torch(q, k, v, scale=e ** -0.5, causal=True,
                                      group=group, block_q=bq, block_k=bk)


def causal_ref64(q, k, v, group):
    s = torch.einsum("bre,bke->brk", q.double(), k.double()) \
        * q.shape[2] ** -0.5
    qpos = torch.arange(q.shape[1]) // group
    s = s.masked_fill(torch.arange(k.shape[1])[None, :] > qpos[:, None],
                      float("-inf"))
    return torch.einsum("brk,bkf->brf", torch.softmax(s, -1), v.double())


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                     # TF32's ulp at 1
    x = torch.tensor([1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -23,
                      -(1 + one_ulp / 2), 1 + 3 * one_ulp / 2, 3.0, 0.0,
                      -2.0 ** -130], dtype=torch.float32)
    want = [1 + one_ulp, 1.0, -(1 + one_ulp), 1 + 2 * one_ulp, 3.0, 0.0,
            -2.0 ** -130]
    assert rna_tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = rna_tf32(y)
    lo = rna_tf32(y - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((y - hi - lo).abs() <= y.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("inputs", ["unit", "low_bits"])
@pytest.mark.parametrize("dims,hkv,group", DIMS)
def test_split_k1_matches_fp32_plain(monkeypatch, dims, hkv, group,
                                     inputs):
    q, k, v = make(1, dims, hkv, group, inputs=inputs)
    want = k1(q, k, v, group)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    got = k1(q, k, v, group)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("dims,hkv,group", DIMS)
def test_single_pass_tf32_is_10x_farther_than_the_split(monkeypatch, dims,
                                                        hkv, group):
    q, k, v = make(2, dims, hkv, group, inputs="low_bits")
    ref = causal_ref64(q, k, v, group)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    err_split = (k1(q, k, v, group).double() - ref).abs().max().item()
    monkeypatch.setattr(torch, "einsum", tf32_einsum)
    err_tf32 = (k1(q, k, v, group).double() - ref).abs().max().item()
    assert err_split < FP32_ATOL
    assert err_tf32 >= 10 * err_split, (err_tf32, err_split)


# ---------------------------------------------------------------------------
# the MLA latent decode body: K4 (paged) and K2's E != F branch (dense)
# ---------------------------------------------------------------------------

#: DeepSeek-V3's latent and heads; a 16-token page, 4 splits
MLA_R, MLA_RD, MLA_G, PS = 512, 64, 128, 16


def latent_inputs(seed, n_pos, kv_len, inputs, m=128):
    """Folded absorbed queries [B, n_pos·128, 576], a dense latent cache
    [B, m, 512] / [B, m, 64], and the same rows in a page pool behind a
    permuted block table."""
    rng = np.random.default_rng(seed)
    b = len(kv_len)
    q = rng.standard_normal((b, n_pos * MLA_G, MLA_R + MLA_RD))
    ckv = rng.standard_normal((b, m, MLA_R))
    kr = rng.standard_normal((b, m, MLA_RD))
    q, ckv, kr = (x.astype(np.float32) for x in (q, ckv, kr))
    if inputs == "low_bits":      # bits below TF32's mantissa matter
        q, ckv, kr = (x + x * np.float32(2.0 ** -12) for x in (q, ckv, kr))
    w = m // PS
    perm = rng.permutation(b * w)
    ckv_p = np.empty((b * w, PS, MLA_R), np.float32)
    kr_p = np.empty((b * w, PS, MLA_RD), np.float32)
    ckv_p[perm] = ckv.reshape(b * w, PS, MLA_R)
    kr_p[perm] = kr.reshape(b * w, PS, MLA_RD)
    table = perm.reshape(b, w).astype(np.int32)
    return tuple(map(torch.from_numpy, (q, ckv, kr, ckv_p, kr_p, table))) \
        + (torch.tensor(kv_len, dtype=torch.int32),)


def latent_decode(layout, x, n_pos, block_k):
    """The plain partials of one layout, combined: K4's sweep on the pool
    (``paged``) or the dense branch's on the cache (``dense``)."""
    q, ckv, kr, ckv_p, kr_p, table, kv_len = x
    args = dict(scale=(MLA_R + MLA_RD) ** -0.5, splits=4, block_k=block_k,
                n_pos=n_pos, rows_per_pos=MLA_G)
    if layout == "paged":
        parts = dec.mla_paged_decode_partials_torch(q, ckv_p, kr_p, table,
                                                    kv_len, **args)
    else:
        parts = dec.latent_decode_partials_torch(q, ckv, kr, kv_len, **args)
    return dec.combine_partials(*parts, torch.float32)


def latent_ref64(x, n_pos):
    """Softmax attention in float64 on the latents: row r of position
    r // 128 sees the keys below kv_len + that position."""
    q, ckv, kr, _, _, _, kv_len = x
    k = torch.cat([ckv, kr], dim=-1).double()
    s = torch.einsum("bre,bke->brk", q.double(), k) \
        * (MLA_R + MLA_RD) ** -0.5
    lim = kv_len[:, None].long() \
        + torch.arange(q.shape[1])[None, :] // MLA_G * (n_pos > 1)
    s = s.masked_fill(torch.arange(k.shape[1])[None, None, :]
                      >= lim[:, :, None], float("-inf"))
    return torch.einsum("brk,bkf->brf", torch.softmax(s, -1), ckv.double())


#: (n_pos, kv_len per slot, block_k): a decode step at 128 rows with
#: kv_len off the 16-key chunk, and P = 3 verify (384 rows)
LATENT_CASES = [(1, [128, 77, 16], 16), (3, [100, 37], 16)]


@pytest.mark.parametrize("inputs", ["unit", "low_bits"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("n_pos,kv_len,block_k", LATENT_CASES)
def test_split_latent_matches_fp32_plain(monkeypatch, n_pos, kv_len,
                                         block_k, layout, inputs):
    x = latent_inputs(3, n_pos, kv_len, inputs)
    want = latent_decode(layout, x, n_pos, block_k)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    got = latent_decode(layout, x, n_pos, block_k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=FP32_ATOL)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("n_pos,kv_len,block_k", LATENT_CASES)
def test_single_pass_tf32_latent_is_10x_farther_than_the_split(
        monkeypatch, n_pos, kv_len, block_k, layout):
    x = latent_inputs(4, n_pos, kv_len, "low_bits")
    ref = latent_ref64(x, n_pos)
    monkeypatch.setattr(torch, "einsum", split3_einsum)
    err_split = (latent_decode(layout, x, n_pos, block_k).double()
                 - ref).abs().max().item()
    monkeypatch.setattr(torch, "einsum", tf32_einsum)
    err_tf32 = (latent_decode(layout, x, n_pos, block_k).double()
                - ref).abs().max().item()
    assert err_split < FP32_ATOL
    assert err_tf32 >= 10 * err_split, (err_tf32, err_split)
