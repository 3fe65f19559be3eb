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
  ``.launches_windowed``, those that write a log-sum-exp in
  ``.launches_lse``); ``.last_plan`` is the plan its last launch ran
  (:func:`~repro_torch.kernels.autotune.prefill_plan`).

With ``return_lse=True`` both also return each row's log-sum-exp
``rm + log(rd_safe)`` as fp32 ``[B·Hkv, P·G]`` — what the reference's
custom-VJP forward saves for its recompute backward
(``repro.kernels.ops._make_flash_jnp``); ``-1e30`` for a row no key tile
reached.

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

from repro_torch.core.einsum import Cascade
from repro_torch.core.taxonomy import attention_1pass
from repro_torch.kernels import autotune
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

def prefill_cascade() -> Cascade:
    """Declared cascade of this kernel family (checked by the analyzer).

    Both functions below are Mapping 1 of Cascade 5: M1 is the key-tile
    loop (the cascade's iterative rank), the per-row (RM, RD, RNV) the
    running state of Eqs. 39-41 (registers in the CUDA kernel), and each
    K/V tile is visited once a query tile —
    :mod:`repro_torch.analysis.lint` checks the visits on the kernel's own
    outputs and its shared memory at two sequence lengths.
    """
    return attention_1pass()


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


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or fp64 for fp64 inputs
    (which only a gradient check passes; the kernels take fp32 / bf16)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


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
    return_lse: bool = False,
):
    """Plain 1-pass FuseMax forward, mirroring ``_fusemax_kernel``: every
    query tile sweeps the key tiles the TPU kernel runs for it, carrying
    (RM, RD, RNV) in fp32; division is deferred to the end.  Returns the
    output, or (output, log-sum-exp) with ``return_lse``."""
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

    acc = acc_dtype(q)
    qf = q.to(acc)
    qpos = torch.arange(pg, device=dev) // group + q_offset      # [PG]
    rm = torch.full((bh, pg), NEG_INF, dtype=acc, device=dev)
    rd = torch.zeros((bh, pg), dtype=acc, device=dev)
    rnv = torch.zeros((bh, pg, f), dtype=acc, device=dev)
    neg = torch.tensor(NEG_INF, dtype=acc, device=dev)
    for kt in range(n_kt):
        if not run_t[:, kt].any():
            continue
        k_lo = kt * block_k
        k_t = k[:, k_lo:k_lo + block_k].to(acc)
        v_t = v[:, k_lo:k_lo + block_k].to(acc)
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
    out = (rnv / rd[..., None]).to(q.dtype)                   # Eq. 53
    return (out, (rm + torch.log(rd)).to(acc)) if return_lse else out


#: keys a block of the recompute backward (:func:`fusemax_attention_bwd`)
BWD_BLOCK_K = 128


def fusemax_attention_bwd(
    q: torch.Tensor,     # [BHkv, PG, E]
    k: torch.Tensor,     # [BHkv, M, E]
    v: torch.Tensor,     # [BHkv, M, F]
    out: torch.Tensor,   # [BHkv, PG, F]
    lse: torch.Tensor,   # [BHkv, PG] fp32
    dout: torch.Tensor,  # [BHkv, PG, F]
    *,
    scale: float,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    group: int = 1,
    m_valid: Optional[int] = None,
    block_k: int = BWD_BLOCK_K,
):
    """(dq, dk, dv) of the 1-pass forward: the FlashAttention-2 recompute
    backward of the reference's custom VJP (``ops.py:_make_flash_jnp``'s
    ``bwd_vjp``), in torch ops on the folded layout.

    One pass over key blocks recomputes the probabilities from (q, k, lse)
    — P = exp(S − lse) — so nothing of size [PG, M] is kept: ``delta =
    Σ dO∘O``, dV += Pᵀ dO, dP = dO Vᵀ, dS = P (dP − delta) (times the
    softcap's 1 − tanh²), dQ += dS K · scale, dK = dSᵀ Q · scale, all in
    fp32 (fp64 for fp64 inputs).  A key block touches only the query rows its causal / window
    masks leave (rows are ordered by position, so they are one slice);
    the rows outside it have P = 0 exactly in the reference, as here.
    The reference has no Pallas backward, so neither is this a kernel."""
    bh, pg, e = q.shape
    m, f = v.shape[1], v.shape[2]
    m_valid = m if m_valid is None else m_valid
    dev = q.device
    acc = acc_dtype(q)
    qf = q.to(acc)
    do = dout.to(acc)
    delta = (do * out.to(acc)).sum(dim=-1)                    # [BH, PG]
    qpos = torch.arange(pg, device=dev) // group + q_offset
    dq = torch.zeros_like(qf)
    dk = torch.zeros((bh, m, e), dtype=acc, device=dev)
    dv = torch.zeros((bh, m, f), dtype=acc, device=dev)
    neg = torch.tensor(NEG_INF, dtype=acc, device=dev)
    for k_lo in range(0, min(m, m_valid), block_k):
        k_hi = min(k_lo + block_k, m)
        # the rows that see a key of [k_lo, k_hi): qpos >= k_lo (causal)
        # and qpos < k_hi - 1 + window; qpos rises with the row
        r_lo = max(0, (k_lo - q_offset) * group) if causal else 0
        r_hi = pg
        if window is not None:
            r_hi = min(pg, max(0, (k_hi - 1 + window - q_offset) * group))
        if r_lo >= r_hi:
            continue
        q_b, do_b = qf[:, r_lo:r_hi], do[:, r_lo:r_hi]
        k_b, v_b = k[:, k_lo:k_hi].to(acc), v[:, k_lo:k_hi].to(acc)
        s = torch.einsum("bre,bke->brk", q_b, k_b) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        kpos = torch.arange(k_lo, k_hi, device=dev)
        qp = qpos[r_lo:r_hi, None]
        ok = (kpos < m_valid)[None, :].expand(r_hi - r_lo, -1)
        if causal:
            ok = ok & (kpos[None, :] <= qp)
        if window is not None:
            ok = ok & (kpos[None, :] > qp - window)
        s = torch.where(ok, s, neg)
        p = torch.exp(s - lse[:, r_lo:r_hi, None].to(acc))    # = A
        dv[:, k_lo:k_hi] = torch.einsum("brk,brf->bkf", p, do_b)
        dp = torch.einsum("brf,bkf->brk", do_b, v_b)
        ds = p * (dp - delta[:, r_lo:r_hi, None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)                           # d softcap
        dq[:, r_lo:r_hi] += torch.einsum("brk,bke->bre", ds, k_b) * scale
        dk[:, k_lo:k_hi] = torch.einsum("brk,bre->bke", ds, q_b) * scale
    fusemax_attention_bwd.calls += 1
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: backward passes run (torch ops on any device; not a kernel launch)
fusemax_attention_bwd.calls = 0


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


#: the ctypes argument types of ``fusemax_prefill``
PREFILL_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float] + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _prefill_lib():
    """(kernel entry point, plan query) — builds at first use."""
    from repro_torch.kernels import _build

    lib = _build.load("fusemax_prefill")
    fn = lib.fusemax_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = PREFILL_ARGTYPES
    plan_fn = lib.fusemax_prefill_plan
    plan_fn.restype = ctypes.c_int
    plan_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    return fn, plan_fn


@functools.lru_cache(maxsize=None)
def cuda_prefill_plan(dtype: torch.dtype, e: int, f: int, block_q: int,
                      f_split: int) -> tuple[int, int]:
    """(BK, shared-memory bytes of one block) of the plan (block_q,
    f_split) the library compiled for head dims (E, F) and ``dtype``, as
    ``fusemax_prefill_plan`` reports it; raises for a plan it does not
    hold."""
    _, plan_fn = _prefill_lib()
    bk, smem = ctypes.c_int(), ctypes.c_int()
    if plan_fn(CUDA_DTYPES[dtype], e, f, block_q, f_split, ctypes.byref(bk),
               ctypes.byref(smem)) != 0:
        raise ValueError(f"fusemax_prefill has no plan ({block_q} rows, "
                         f"{f_split} column blocks) at head dims (E, F) = "
                         f"({e}, {f})")
    return bk.value, smem.value


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
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    m_valid: Optional[int] = None,
    exp_impl: str = "native",
    return_lse: bool = False,
):
    """Launch the CUDA prefill kernel on the current stream (no sync).
    The call runs the plan :func:`autotune.prefill_plan` gives for its
    fibers and rows (recorded in ``fusemax_attention_cuda.last_plan``);
    ``block_q``/``block_k``, where given, must be the tile the kernel is
    compiled for at these head dims (``autotune.attention_params(...,
    impl="cuda")``), and the library's own report of the plan (key tile,
    shared memory) is checked against the autotuner's model here.  With ``return_lse`` the
    kernel also writes each row's log-sum-exp (fp32 ``[B·Hkv, P·G]``) and
    (output, lse) is returned; without it the kernel gets a null pointer
    and writes none."""
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
    plan = autotune.prefill_plan(bh, pg, e, f)
    tile = (plan.block_q, plan.block_k)
    if (block_q if block_q is not None else tile[0],
            block_k if block_k is not None else tile[1]) != tile:
        raise ValueError(f"tile ({block_q}, {block_k}) but the kernel's "
                         f"plan at (E, F) = ({e}, {f}) for {bh} x {pg} rows "
                         f"is {tile}")
    smem = autotune.prefill_smem_bytes(
        plan.block_q, plan.block_k, e, f,
        autotune.CUDA_PREFILL[(e, f)].warp_split, q.element_size(),
        f_split=plan.f_split)
    lib_plan = cuda_prefill_plan(q.dtype, e, f, plan.block_q, plan.f_split)
    if lib_plan != (plan.block_k, smem):
        raise RuntimeError(f"fusemax_prefill reports (BK, smem) = {lib_plan} "
                           f"for {plan}; the autotuner models "
                           f"{(plan.block_k, smem)}")
    out = torch.empty((bh, pg, f), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, pg), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if pg == 0 or bh == 0:
        return (out, lse) if return_lse else out
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
             None if lse is None else _ptr(lse), CUDA_DTYPES[q.dtype], e,
             f, bh, pg, m, float(scale), int(causal),
             0 if window is None else int(window),
             0.0 if softcap is None else float(softcap), int(q_offset),
             int(group), int(m_valid), int(exp_impl == "maccs"),
             plan.block_q, plan.f_split, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"fusemax_prefill launch failed: CUDA error {err}")
    fusemax_attention_cuda.launches += 1
    fusemax_attention_cuda.last_plan = plan
    by_dims = fusemax_attention_cuda.launches_by_dims
    by_dims[(e, f)] = by_dims.get((e, f), 0) + 1
    if window is not None:
        fusemax_attention_cuda.launches_windowed += 1
    if return_lse:
        fusemax_attention_cuda.launches_lse += 1
        return out, lse
    return out


fusemax_attention_cuda.launches = 0
#: the same launches split by head dims (E, F): which instantiation ran
fusemax_attention_cuda.launches_by_dims = {}
#: the launches with a sliding window (local layers)
fusemax_attention_cuda.launches_windowed = 0
#: the launches that wrote a log-sum-exp (the training forward)
fusemax_attention_cuda.launches_lse = 0
#: the plan of the last launch (``autotune.PrefillPlan``), None before one
fusemax_attention_cuda.last_plan = None
