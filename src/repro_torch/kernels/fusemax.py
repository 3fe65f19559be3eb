"""FuseMax 1-pass prefill attention: the CUDA kernel's wrapper and its
plain torch version (paper §V, Cascade 5 / Mapping 1).

Port of ``repro.kernels.fusemax``.  Both functions take the folded layout
the kernel sees — q ``[B·Hkv, P·G, E]`` (GQA group folded into query rows:
row r is query position ``r // group + q_offset``), k ``[B·Hkv, M, E]``,
v ``[B·Hkv, M, F]`` — and return ``[B·Hkv, P·G, F]`` in q's dtype.  E may
differ from F (DeepSeek's MLA: (192, 128) expanded, (576, 512) absorbed):

* :func:`fusemax_attention_torch` is the plain version: a loop over key
  tiles carrying the running max / denominator / numerator·V (RM, RD, RNV,
  Eqs. 39-41) in fp32, with the TPU kernel's per-(query tile, key tile)
  skip and its masks, and one deferred division at the end (Eq. 53).
* :func:`fusemax_attention_cuda` launches ``csrc/fusemax_prefill.cu``
  (both products on the tensor cores in error-compensated 3xTF32) and
  counts its launches in ``fusemax_attention_cuda.launches`` (and by
  head dims in ``.launches_by_dims``, those with a sliding window in
  ``.launches_windowed``).

``NEG_INF`` is finite on purpose: a row fully masked inside a tile that
runs accumulates ``exp(0) = 1`` terms, and the next valid tile's
correction ``exp(-1e30 - m) = 0`` erases them; ``-inf`` would give NaN.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.autotune import CUDA_PREFILL_TILES

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# Taylor coefficients of 2^f = exp(f·ln2) on f ∈ [0, 1): ln2^k / k!.
# Six multiply-accumulates via Horner — the paper's exp-on-the-MACC-array
# trick ([36]); max rel. error ≈ 1.4e-5 on [0,1).
_EXP2_COEFFS = (
    1.0,
    0.6931471805599453,
    0.24022650695910072,
    0.05550410866482158,
    0.009618129107628477,
    0.0013333558146428443,
    0.00015403530393381608,
)

#: dtypes the CUDA kernels take, by their code in the C interface
CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def exp_maccs(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x ≤ 0 with 6 MACCs: exp(x) = 2^n · 2^f, t = x·log2e = n+f.

    2^n is built in the float's exponent field, 2^f by a 6-step Horner
    chain (fp32 in, fp32 out)."""
    t = torch.clamp_min(x * LOG2E, -126.0)
    n = torch.floor(t)
    f = t - n
    p = torch.full_like(f, _EXP2_COEFFS[6])
    for c in _EXP2_COEFFS[5::-1]:
        p = p * f + c                                    # 6 MACCs total
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * two_n.to(x.dtype)


def _exp(x: torch.Tensor, impl: str) -> torch.Tensor:
    return exp_maccs(x) if impl == "maccs" else torch.exp(x)


def _tile_runs(pg: int, block_q: int, block_k: int, n_kt: int, *,
               causal: bool, window: Optional[int], q_offset: int,
               group: int, m_valid: int) -> np.ndarray:
    """[n_q_tiles, n_k_tiles] bool: which (query tile, key tile) pairs the
    TPU kernel runs (``fusemax.py:_fusemax_kernel`` block-level skip),
    with the query tile's range taken over its real rows — the CUDA
    kernel's loop bounds are the same rule."""
    n_qt = -(-pg // block_q)
    r0 = np.arange(n_qt) * block_q
    q_lo = r0 // group + q_offset
    q_hi = (np.minimum(r0 + block_q, pg) - 1) // group + q_offset
    k_lo = np.arange(n_kt) * block_k
    run = np.broadcast_to(k_lo[None, :] < m_valid, (n_qt, n_kt)).copy()
    if causal:
        run &= k_lo[None, :] <= q_hi[:, None]
    if window is not None:
        run &= (k_lo[None, :] + block_k - 1) > (q_lo[:, None] - window)
    return run


def fusemax_attention_torch(
    q: torch.Tensor,   # [BHkv, PG, E]
    k: torch.Tensor,   # [BHkv, M, E]
    v: torch.Tensor,   # [BHkv, M, F]
    *,
    scale: float,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    group: int = 1,
    block_q: int = 128,
    block_k: int = 128,
    m_valid: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """Plain 1-pass FuseMax forward, mirroring ``_fusemax_kernel``: every
    query tile sweeps the key tiles the TPU kernel runs for it, carrying
    (RM, RD, RNV) in fp32; division is deferred to the end."""
    bh, pg, e = q.shape
    m, f = v.shape[1], v.shape[2]
    m_valid = m if m_valid is None else m_valid
    dev = q.device
    n_kt = -(-m // block_k)
    run_t = _tile_runs(pg, block_q, block_k, n_kt, causal=causal,
                       window=window, q_offset=q_offset, group=group,
                       m_valid=m_valid)
    # per-row run flags [n_kt, PG] (a row runs what its query tile runs)
    run_rows = torch.from_numpy(
        np.repeat(run_t, block_q, axis=0)[:pg].T.copy()).to(dev)

    qf = q.float()
    qpos = torch.arange(pg, device=dev) // group + q_offset      # [PG]
    rm = torch.full((bh, pg), NEG_INF, dtype=torch.float32, device=dev)
    rd = torch.zeros((bh, pg), dtype=torch.float32, device=dev)
    rnv = torch.zeros((bh, pg, f), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for kt in range(n_kt):
        if not run_t[:, kt].any():
            continue
        k_lo = kt * block_k
        k_t = k[:, k_lo:k_lo + block_k].float()
        v_t = v[:, k_lo:k_lo + block_k].float()
        s = torch.einsum("bre,bke->brk", qf, k_t) * scale     # BQK (Eq. 42)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = k_lo + torch.arange(k_t.shape[1], device=dev)
        ok = (kpos < m_valid)[None, :].expand(pg, -1)
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(ok, s, neg)

        lm = s.amax(dim=-1)                                   # Eq. 43
        m_new = torch.maximum(rm, lm)                         # Eq. 44
        p = _exp(s - m_new[..., None], exp_impl)              # Eq. 45
        sld = p.sum(dim=-1)                                   # Eq. 46
        prm = _exp(rm - m_new, exp_impl)                      # Eq. 48
        slnv = torch.einsum("brk,bkf->brf", p, v_t)           # Eq. 47
        run = run_rows[kt][None, :]
        rd = torch.where(run, rd * prm + sld, rd)             # Eqs. 49-50
        rnv = torch.where(run[..., None],
                          rnv * prm[..., None] + slnv, rnv)   # Eqs. 51-52
        rm = torch.where(run, m_new, rm)
    rd = torch.where(rd == 0.0, torch.ones_like(rd), rd)      # l = 0 guard
    return (rnv / rd[..., None]).to(q.dtype)                  # Eq. 53


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one dtype
    the kernels take (each wrapper checks its head dims itself)."""
    dt = tensors[0].dtype
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, not CUDA")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: mixed dtypes {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous operand {tuple(t.shape)}")
    if dt not in CUDA_DTYPES:
        raise ValueError(f"{name}: dtype {dt} not in {list(CUDA_DTYPES)}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _prefill_lib():
    """(kernel entry point, tile query) — builds at first use."""
    from repro_torch.kernels import _build

    lib = _build.load("fusemax_prefill")
    fn = lib.fusemax_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    tile_fn = lib.fusemax_prefill_tile
    tile_fn.restype = ctypes.c_int
    tile_fn.argtypes = [ctypes.c_int, ctypes.c_int] \
        + [ctypes.POINTER(ctypes.c_int)] * 2
    return fn, tile_fn


@functools.lru_cache(maxsize=None)
def cuda_prefill_tile(e: int, f: int) -> tuple[int, int]:
    """The (BQ, BK) tile the library compiled for head dims (E, F), as
    ``fusemax_prefill_tile`` reports it; raises for a pair it does not
    hold."""
    _, tile_fn = _prefill_lib()
    bq, bk = ctypes.c_int(), ctypes.c_int()
    if tile_fn(e, f, ctypes.byref(bq), ctypes.byref(bk)) != 0:
        raise ValueError(f"fusemax_prefill has no instantiation for head "
                         f"dims (E, F) = ({e}, {f})")
    return bq.value, bk.value


def fusemax_attention_cuda(
    q: torch.Tensor,   # [BHkv, PG, E]
    k: torch.Tensor,   # [BHkv, M, E]
    v: torch.Tensor,   # [BHkv, M, F]
    *,
    scale: float,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    group: int = 1,
    block_q: int = 64,
    block_k: int = 64,
    m_valid: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """Launch the CUDA prefill kernel on the current stream (no sync).
    ``block_q``/``block_k`` must be the tile the kernel is compiled for at
    these head dims (``autotune.attention_params(..., impl="cuda")``; the
    library's own report is checked here)."""
    check_cuda_operands("fusemax_attention_cuda", q, k, v)
    bh, pg, e = q.shape
    f = v.shape[2]
    if k.shape[:2] != v.shape[:2] or k.shape[0] != bh or k.shape[2] != e:
        raise ValueError(f"fusemax_attention_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (e, f) not in CUDA_PREFILL_TILES:
        raise ValueError(f"fusemax_attention_cuda: head dims (E, F) = "
                         f"({e}, {f}); the kernel is built for "
                         f"{sorted(CUDA_PREFILL_TILES)}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    m = k.shape[1]
    m_valid = m if m_valid is None else m_valid
    if not 0 <= m_valid <= m:
        raise ValueError(f"m_valid={m_valid} outside [0, {m}]")
    if bh > 65535:
        raise ValueError(f"B·Hkv={bh} exceeds the grid's 65535 fibers")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("fusemax_attention_cuda: operands must be "
                             "16-byte aligned (the kernel copies 16-byte "
                             "vectors)")
    fn, _ = _prefill_lib()
    tile = cuda_prefill_tile(e, f)
    if (block_q, block_k) != tile:
        raise ValueError(f"tile ({block_q}, {block_k}) but the kernel is "
                         f"compiled for {tile} at (E, F) = ({e}, {f})")
    out = torch.empty((bh, pg, f), dtype=q.dtype, device=q.device)
    if pg == 0 or bh == 0:
        return out
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), CUDA_DTYPES[q.dtype], e,
             f, bh, pg, m, float(scale), int(causal),
             0 if window is None else int(window),
             0.0 if softcap is None else float(softcap), int(q_offset),
             int(group), int(m_valid), int(exp_impl == "maccs"),
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"fusemax_prefill launch failed: CUDA error {err}")
    fusemax_attention_cuda.launches += 1
    by_dims = fusemax_attention_cuda.launches_by_dims
    by_dims[(e, f)] = by_dims.get((e, f), 0) + 1
    if window is not None:
        fusemax_attention_cuda.launches_windowed += 1
    return out


fusemax_attention_cuda.launches = 0
#: the same launches split by head dims (E, F): which instantiation ran
fusemax_attention_cuda.launches_by_dims = {}
#: the launches with a sliding window (local layers)
fusemax_attention_cuda.launches_windowed = 0
