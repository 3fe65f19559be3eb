"""The 3xTF32 split of K1, emulated on the CPU.

K1 (``csrc/fusemax_prefill.cu``) runs both of its fp32 products on the
tensor cores: each operand x is split into hi = cvt.rna.tf32.f32(x) and
lo = cvt.rna.tf32.f32(x - hi), and lo·hi + hi·lo + hi·hi is accumulated
in fp32.  This file emulates that in plain torch — the rounding on the
13 mantissa bits TF32 drops (to nearest, ties away from zero) and the
three products — and puts it in place of ``torch.einsum`` under the
plain K1 (``fusemax_attention_torch``, whose two einsums are exactly
Q·Kᵀ and P·V), so the emulation stays out of the package.

Tolerances: the split is held to the plain fp32 version within
chip_smoke's fp32 tolerance (atol 1e-4); single-pass TF32 (hi·hi alone)
must land at least 10x farther from a float64 reference than the split,
so the comparison can fail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fusemax as fm

_EINSUM = torch.einsum
K1_PRODUCTS = ("bre,bke->brk", "brk,bkf->brf")
FP32_ATOL = 1e-4


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round a float32 to TF32's 10 mantissa bits, to
    nearest with ties away from zero (sign-magnitude bits: adding half of
    the dropped range rounds the magnitude), returned as a float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3_einsum(eq, a, b):
    """One K1 product in 3xTF32: lo·hi + hi·lo + hi·hi, small terms first
    (each product of two TF32 values is exact in fp32)."""
    assert eq in K1_PRODUCTS, eq
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return _EINSUM(eq, al, bh) + _EINSUM(eq, ah, bl) + _EINSUM(eq, ah, bh)


def tf32_einsum(eq, a, b):
    """One K1 product in single-pass TF32 (what K1 must not do)."""
    assert eq in K1_PRODUCTS, eq
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
