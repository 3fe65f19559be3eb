"""FuseMax split-K decode ("flash-decoding" over Cascade 5): the CUDA
partials kernel's wrapper, its plain torch version, and the combine.

Port of the dense half of ``repro.kernels.decode``.  Decode offers one
query token per sequence, so the 1-pass cascade runs twice:

1. each of S disjoint splits of the cache sweeps its key tiles with the
   running (m, l, acc) state and emits per-split partials —
   :func:`decode_partials_torch` (plain) or :func:`decode_partials_cuda`
   (``csrc/decode_partials.cu``, launches counted in
   ``decode_partials_cuda.launches``);
2. :func:`combine_partials` merges them with the associative running-max
   algebra of Eqs. 48-52, in plain torch ops as the reference keeps it in
   jnp outside its ``pallas_call``.

Both partial paths follow the TPU kernel's semantics exactly: a tile runs
only if ``k_lo < kv_len + P - 1`` (and, with a window, ``k_hi > kv_len - 1
- window``), so a slot with ``kv_len = 0`` runs no tile and decodes to 0
(the jnp executor of the reference returns a mean of V there instead).

Layout: q ``[B·Hkv, R, E]`` with R = P·G folded query rows (row r is
draft position ``r // rows_per_pos``), k/v ``[B·Hkv, M, E/F]``, kv_len
``[B]`` int32 → partials m, l ``[B·Hkv, S, R]`` and acc ``[B·Hkv, S, R,
F]`` in fp32, without the TPU's 128-lane padding.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.fusemax import (
    CUDA_DTYPES, NEG_INF, _exp, _ptr, _stream, check_cuda_operands,
)


def _split_geometry(m: int, splits: int, block_k: int) -> tuple[int, int]:
    """(split_len, block_k) as ``fusemax_decode_pallas`` derives them."""
    if m % splits:
        raise ValueError(f"M={m} not divisible by splits={splits}")
    split_len = m // splits
    block_k = min(block_k, split_len)
    if split_len % block_k:
        raise ValueError(f"split_len={split_len} % block_k={block_k}")
    return split_len, block_k


def decode_partials_torch(
    q: torch.Tensor,        # [BHkv, R, E]
    k: torch.Tensor,        # [BHkv, M, E]
    v: torch.Tensor,        # [BHkv, M, F]
    kv_len: torch.Tensor,   # [B] int
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
):
    """Plain split-K partials, mirroring ``_decode_partials_kernel``: all
    splits sweep their key tiles in lockstep, each (fiber, split) updating
    its running state only on the tiles the TPU kernel runs."""
    bh, r, e = q.shape
    m, f = v.shape[1], v.shape[2]
    split_len, block_k = _split_geometry(m, splits, block_k)
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    dev = q.device
    kvl = kv_len.to(device=dev, dtype=torch.int64).repeat_interleave(hkv)
    q_pos = kvl - 1                                          # [BH]
    qf = q.float()
    k4 = k.reshape(bh, splits, split_len, e)
    v4 = v.reshape(bh, splits, split_len, f)
    split0 = torch.arange(splits, device=dev) * split_len    # [S]
    pos = torch.arange(r, device=dev) // rows_per_pos        # [R]

    rm = torch.full((bh, splits, r), NEG_INF, dtype=torch.float32,
                    device=dev)
    rd = torch.zeros((bh, splits, r), dtype=torch.float32, device=dev)
    rnv = torch.zeros((bh, splits, r, f), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for t in range(split_len // block_k):
        k_lo = split0 + t * block_k                          # [S]
        run = k_lo[None, :] < (kvl + (n_pos - 1))[:, None]   # [BH, S]
        if window is not None:
            run &= (k_lo + block_k - 1)[None, :] > (q_pos - window)[:, None]
        kt = k4[:, :, t * block_k:(t + 1) * block_k].float()
        vt = v4[:, :, t * block_k:(t + 1) * block_k].float()
        sc = torch.einsum("bre,bske->bsrk", qf, kt) * scale  # [BH,S,R,bk]
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        kpos = k_lo[:, None] + torch.arange(block_k, device=dev)  # [S, bk]
        lim = kvl[:, None] + (pos if n_pos > 1 else 0 * pos)[None, :]
        ok = kpos[None, :, None, :] < lim[:, None, :, None]  # [BH,S,R,bk]
        if window is not None:
            ok = ok & (kpos[None, :, None, :]
                       > (q_pos - window)[:, None, None, None])
        sc = torch.where(ok, sc, neg)

        lm = sc.amax(dim=-1)
        m_new = torch.maximum(rm, lm)
        p = _exp(sc - m_new[..., None], exp_impl)
        sld = p.sum(dim=-1)
        prm = _exp(rm - m_new, exp_impl)
        slnv = torch.einsum("bsrk,bskf->bsrf", p, vt)
        run3 = run[..., None]
        rd = torch.where(run3, rd * prm + sld, rd)
        rnv = torch.where(run3[..., None], rnv * prm[..., None] + slnv, rnv)
        rm = torch.where(run3, m_new, rm)
    return rm, rd, rnv


def combine_partials(pm: torch.Tensor, pl: torch.Tensor, pnv: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Combine split-K partials (associative running-max algebra,
    Eqs. 48-52): [BH, S, R], [BH, S, R], [BH, S, R, F] → [BH, R, F]."""
    gm = pm.amax(dim=1, keepdim=True)
    cf = torch.exp(pm - gm)                  # per-split correction factor
    rd = (pl * cf).sum(dim=1)                # [BH, R]
    rnv = (pnv * cf[..., None]).sum(dim=1)   # [BH, R, F]
    rd = torch.where(rd == 0.0, torch.ones_like(rd), rd)
    return (rnv / rd[..., None]).to(dtype)


@functools.lru_cache(maxsize=None)
def _partials_lib():
    """(kernel entry point, most query rows it takes) — builds at first
    use."""
    from repro_torch.kernels import _build

    lib = _build.load("decode_partials")
    fn = lib.decode_partials
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    max_rows = lib.decode_partials_max_rows
    max_rows.restype = ctypes.c_int
    max_rows.argtypes = []
    return fn, max_rows()


def decode_partials_cuda(
    q: torch.Tensor,        # [BHkv, R, E]
    k: torch.Tensor,        # [BHkv, M, E]
    v: torch.Tensor,        # [BHkv, M, F]
    kv_len: torch.Tensor,   # [B] int32 on the same device
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
):
    """Launch the CUDA split-K partials kernel on the current stream (no
    sync).  Same contract as :func:`decode_partials_torch`."""
    check_cuda_operands("decode_partials_cuda", q, k, v)
    bh, r, e = q.shape
    m = k.shape[1]
    if k.shape[0] != bh or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"decode_partials_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.device != q.device \
            or not kv_len.is_contiguous() or kv_len.shape != (bh // hkv,) \
            or bh % hkv:
        raise ValueError(f"kv_len must be a contiguous int32 [B·Hkv/Hkv] "
                         f"tensor on {q.device}; got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    split_len, block_k = _split_geometry(m, splits, block_k)
    fn, max_rows = _partials_lib()
    if not 1 <= r <= max_rows:
        raise ValueError(f"{r} query rows per fiber; the kernel takes "
                         f"1..{max_rows}")
    if bh > 65535 or splits > 2**31 - 1:
        raise ValueError(f"grid ({splits}, {bh}) too large")
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((bh, splits, r), **f32)
    pl = torch.empty((bh, splits, r), **f32)
    pnv = torch.empty((bh, splits, r, v.shape[2]), **f32)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(kv_len), _ptr(pm), _ptr(pl),
             _ptr(pnv), CUDA_DTYPES[q.dtype], e, bh, hkv, r, m, splits,
             split_len, block_k, n_pos, rows_per_pos, float(scale),
             0 if window is None else int(window),
             0.0 if softcap is None else float(softcap),
             int(exp_impl == "maccs"), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"decode_partials launch failed: CUDA error {err}")
    decode_partials_cuda.launches += 1
    return pm, pl, pnv


decode_partials_cuda.launches = 0
