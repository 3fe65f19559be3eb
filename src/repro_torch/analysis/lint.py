"""Structural check: declared cascades vs. the port's kernels.

The symbolic analysis (:mod:`repro_torch.analysis.passes`) proves what a
*declared* cascade costs; this module checks that the shipped code
implements it.  Port of ``repro.analysis.lint``, whose Pallas half reads
each ``pl.pallas_call``'s grid and index maps and counts the K/V tiles
every output fiber visits.  A CUDA kernel has no index map to read, so
each probe here reads the kernel's own outputs instead:

Visits, on the outputs
    The probe sets the queries to 0.  Every logit is then exactly 0 — a
    softcap gives ``tanh(0) = 0``, the 3xTF32 split of 0 is 0 — so every
    live key weighs ``exp(0 − 0) = 1`` and every masked one 0.  V's first
    three columns (for the latent kernels, the latent ``ckv``'s) hold 1,
    ``pos mod 1024`` and ``pos // 1024`` of the key's logical position,
    integers that TF32 holds exactly and whose sums stay below 2^24, so
    the fp32 sums are exact.  A split-K decode's partials then give, per
    (fiber, split, row), the number of live keys the split visited,
    counted with multiplicity (``l`` and ``acc[0]``), and the exact sums
    of their positions (``acc[1]``, ``acc[2]``); its running max is 0
    where a key was live and stays at ``NEG_INF`` where none was.  The
    probe holds each to the closed form of the row's live range (kv_len,
    the verify chain's causal limit, the window, the split's range): a
    re-read shows as a count over, a gap as a count under, a wrong page
    behind a permuted block table as a wrong sum.  K1 returns rows, not
    partials: ``exp(lse)`` is the count of keys a row visited and the
    output's position columns are their means.  The plain torch ops (the
    3-pass oracles, the 2-pass cascade) return normalised rows, held to
    the means.  On fp8 pools only the count is checked: V's codes hold 1
    and 0 (a position is not exact in e4m3).

Footprint, on the launch's shared memory
    Each probe runs at two cache lengths, M and 2M, and asserts that the
    shared memory each kernel launch asks for — ``prefill_smem_bytes``,
    ``decode_smem_bytes`` and ``mla_decode_smem_bytes`` of
    :mod:`repro_torch.kernels.autotune`, at the arguments the wrappers
    check them with (the wrappers hold those to the libraries' own
    ``*_smem_bytes`` when they load) — is the same at both: the
    counterpart of the reference's ``assert_s_independent``.  K3's launch
    also holds its split's page list, 4 bytes a page of the split (the
    slice of the block table the reference's kernel keeps whole in SMEM as
    a scalar prefetch); that part grows with M / S, is reported as
    ``page_list``, and is index data, not running state.

Exactness: with ``exp_impl="native"`` every count and sum is compared for
equality.  ``exp_maccs`` (:func:`repro_torch.kernels.fusemax.exp_maccs`)
gives exactly 1 at 0, but ``2^-126`` rather than 0 for a masked key, so
under ``exp_impl="maccs"`` counts and sums are held within 0.5.

Probes take ``impl="torch"`` (the plain versions, on the CPU) or
``impl="cuda"`` (the kernels, on the card), at ``size="small"`` or at the
main paths' full widths (``size="full"``, the card's default).

Passes, traced off the torch code
    The ``trace:*`` probes are the counterparts of the reference's
    ``jnp:*`` probes: :func:`~repro_torch.analysis.trace.trace_m_passes`
    reads the pass count and the live footprint off the plain versions'
    torch calls at the reference's probe sizes (M = 144 in blocks of 48),
    whatever ``impl`` is — a CUDA kernel is one opaque call whose output
    would appear to read nothing, so the kernels' structure stays with the
    visit-count probes above, and their agreement with these plain
    versions with ``chip_smoke.py``'s kernel cases.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.cascade import CascadeEntry, REGISTRY
from repro_torch.analysis.trace import (
    LintError, TorchTrace, assert_torch_path, trace_m_passes,
)
from repro_torch.core import cascades_numeric as cn
from repro_torch.kernels import autotune
from repro_torch.kernels import decode as dec
from repro_torch.kernels import fusemax as fm
from repro_torch.kernels import ref as kref

#: positions are encoded as (pos mod POS_BASE, pos // POS_BASE)
POS_BASE = 1024
#: a partial whose running max is at most this saw no live key
EMPTY_MAX = -1e29
#: normalised rows: relative error of a mean against its closed form
MEAN_RTOL = 1e-5


# ---------------------------------------------------------------------------
# Encodings and closed forms
# ---------------------------------------------------------------------------

def position_values(pos: torch.Tensor, width: int) -> torch.Tensor:
    """[..., width] fp32 rows: 1, ``pos mod POS_BASE``, ``pos // POS_BASE``,
    then zeros."""
    out = torch.zeros((*pos.shape, width), dtype=torch.float32,
                      device=pos.device)
    out[..., 0] = 1.0
    out[..., 1] = (pos % POS_BASE).float()
    out[..., 2] = (pos // POS_BASE).float()
    return out


def _prefix(n: np.ndarray):
    """(Σ k mod B, Σ k // B) over k in [0, n), B = POS_BASE."""
    q, r = n // POS_BASE, n % POS_BASE
    s1 = q * (POS_BASE * (POS_BASE - 1) // 2) + r * (r - 1) // 2
    s2 = POS_BASE * (q * (q - 1) // 2) + q * r
    return s1, s2


def range_sums(lo, hi):
    """(count, Σ pos mod B, Σ pos // B) of the keys in [lo, hi), elementwise
    (empty where hi ≤ lo)."""
    lo = np.asarray(lo, np.int64)
    hi = np.maximum(np.asarray(hi, np.int64), lo)
    (a1, a2), (b1, b2) = _prefix(lo), _prefix(hi)
    return hi - lo, b1 - a1, b2 - a2


def _where(mask: np.ndarray) -> tuple:
    return tuple(int(i) for i in np.argwhere(mask)[0])


def check_partials(what: str, pm, pl, pnv, lo, hi, *, sums: bool = True,
                   exact: bool = True) -> dict:
    """Hold split-K partials ``pm``/``pl`` [F, S, R] and ``pnv`` [F, S, R,
    ≥ 3] to the live ranges [lo, hi) [F, S, R]: a live partial has max 0,
    count ``l`` = ``acc[0]`` = hi − lo and (with ``sums``) the positions'
    exact sums; an empty one keeps max ``NEG_INF``."""
    pm, pl, pnv = (t.detach().float().cpu().numpy() for t in (pm, pl, pnv))
    count, s1, s2 = range_sums(lo, hi)
    live = count > 0
    tol = 0.0 if exact else 0.5
    if np.any(~live & (pm > EMPTY_MAX)):
        raise LintError(f"{what}: a split with no live key has a running max "
                        f"at (fiber, split, row) {_where(~live & (pm > EMPTY_MAX))}")
    if np.any(live & (pm <= EMPTY_MAX)):
        raise LintError(f"{what}: a split with live keys kept its running "
                        f"max at NEG_INF at (fiber, split, row) "
                        f"{_where(live & (pm <= EMPTY_MAX))} — a gap (no "
                        f"live key visited)")
    if np.any(live & (pm != 0.0)):
        raise LintError(f"{what}: running max not 0 with q = 0 at "
                        f"{_where(live & (pm != 0.0))}")
    got = {"count": pl, "count_acc": pnv[..., 0]}
    want = {"count": count, "count_acc": count}
    if sums:
        got.update(pos_mod=pnv[..., 1], pos_div=pnv[..., 2])
        want.update(pos_mod=s1, pos_div=s2)
    errs = {}
    for key in got:
        d = np.where(live, np.abs(got[key] - want[key]), 0.0)
        errs[key] = float(d.max())
        if errs[key] > tol:
            at = _where(d > tol)
            g, w = float(got[key][at]), float(want[key][at])
            kind = ("a re-read (keys visited twice)" if key == "count"
                    and g > w else "a gap (live keys not visited)"
                    if key == "count" else "the wrong keys")
            raise LintError(f"{what}: {key} {g} != {w} at (fiber, split, "
                            f"row) {at} — {kind}")
    return {"partials": int(live.sum()), "empty": int((~live).sum()),
            "max_count_err": max(errs["count"], errs["count_acc"]),
            "max_sum_err": max(errs.get("pos_mod", 0.0),
                               errs.get("pos_div", 0.0))}


def check_rows(what: str, out, lo, hi, lse=None, exact: bool = True) -> dict:
    """Hold normalised rows ``out`` [..., ≥ 3] to the live ranges [lo, hi)
    [...]: column 0 is 1, columns 1–2 the positions' means; with ``lse``
    (K1), ``exp(lse)`` is the count within 0.5."""
    o = out.detach().float().cpu().numpy()
    count, s1, s2 = range_sums(lo, hi)
    if np.any(count == 0):
        raise LintError(f"{what}: probe data gave a row with no live key")
    res = {"rows": int(count.size)}
    if lse is not None:
        n = np.exp(lse.detach().double().cpu().numpy())
        err = np.abs(n - count)
        res["max_count_err"] = float(err.max())
        if err.max() >= 0.5:
            at = _where(err >= 0.5)
            kind = "a re-read" if n[at] > count[at] else "a gap"
            raise LintError(f"{what}: exp(lse) = {float(n[at]):.3f} keys, "
                            f"{int(count[at])} live, at row {at} — {kind}")
    rtol = MEAN_RTOL if exact else 0.5 / count
    worst = 0.0
    for col, want in ((0, np.ones_like(s1, dtype=np.float64)),
                      (1, s1 / count), (2, s2 / count)):
        err = np.abs(o[..., col] - want) / np.maximum(np.abs(want), 1.0)
        worst = max(worst, float(err.max()))
        bad = err > rtol
        if np.any(bad):
            at = _where(bad)
            raise LintError(f"{what}: column {col} mean {float(o[..., col][at])}"
                            f" != {float(want[at])} at row {at} — the wrong "
                            f"keys, or keys visited twice")
    res["max_mean_rel_err"] = worst
    return res


def assert_s_independent(sigs: Sequence, name: str) -> None:
    """What a launch asks for, probed at different sequence lengths, must be
    identical — shared memory scaling with S is an O(S) footprint."""
    if len({repr(s) for s in sigs}) != 1:
        raise LintError(f"{name}: shared memory changes with sequence length "
                        f"({list(sigs)}) — live footprint is not O(1)")


# ---------------------------------------------------------------------------
# Probe shapes: small (the CPU) and the main paths' full widths (the card)
# ---------------------------------------------------------------------------

#: kv_len of each sequence as a fraction of M: granite's decode data
#: (2048, 1500, 1024, 700, 300, 64, 1, 1900 of 2048) at full width
_KVL_FULL = (1.0, 1500 / 2048, 0.5, 700 / 2048, 300 / 2048, 64 / 2048, 0.0,
             1900 / 2048)
_KVL_SMALL = (1.0, 0.4, 0.0)

SHAPES = {
    "small": {
        "prefill": dict(b=1, hq=4, hkv=2, e=32, f=32, ms=(64, 128),
                        window=40, softcap=50.0),
        "decode": dict(b=3, hq=4, hkv=2, d=32, ms=(128, 256), splits=4,
                       block_k=16, kvl=_KVL_SMALL, window=48),
        "latent": dict(b=3, h=4, rank=32, rope=16, ms=(128, 256), splits=4,
                       block_k=16, kvl=_KVL_SMALL),
        "paged": dict(b=3, hq=4, hkv=2, d=32, ps=16, ws=(8, 16), splits=4,
                      kvl=_KVL_SMALL),
        "mla": dict(b=3, h=4, rank=32, rope=16, ps=16, ws=(8, 16), splits=4,
                    kvl=_KVL_SMALL),
        "verify_p": 3, "mla_verify_p": 3,
        "torch_ops": dict(b=1, hq=4, hkv=2, e=16, ms=(48, 96), block=16),
    },
    "full": {
        # granite-3-8b's prefill (B4, 32 / 8 heads of 128, P = M)
        "prefill": dict(b=4, hq=32, hkv=8, e=128, f=128, ms=(1024, 2048),
                        window=256, softcap=50.0),
        # granite-3-8b's decode data, 16 splits
        "decode": dict(b=8, hq=32, hkv=8, d=128, ms=(2048, 4096), splits=16,
                       block_k=128, kvl=_KVL_FULL, window=512),
        # DeepSeek-V3's latent decode (128 heads, r 512, rd 64)
        "latent": dict(b=8, h=128, rank=512, rope=64, ms=(2048, 4096),
                       splits=16, block_k=128, kvl=_KVL_FULL),
        "paged": dict(b=8, hq=32, hkv=8, d=128, ps=16, ws=(128, 256),
                      splits=16, kvl=_KVL_FULL),
        "mla": dict(b=8, h=128, rank=512, rope=64, ps=16, ws=(128, 256),
                    splits=16, kvl=_KVL_FULL),
        # granite's verify chain of 13, DeepSeek's of 5
        "verify_p": 13, "mla_verify_p": 5,
        "torch_ops": dict(b=2, hq=8, hkv=2, e=64, ms=(512, 1024), block=128),
    },
}


def _setup(impl: str, size: Optional[str]):
    if impl not in ("torch", "cuda"):
        raise ValueError(f"impl must be 'torch' or 'cuda', not {impl!r}")
    dev = torch.device("cuda" if impl == "cuda" else "cpu")
    return dev, SHAPES[size or ("full" if impl == "cuda" else "small")]


def _gen(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _kv_lens(fracs, m: int, n_pos: int) -> list[int]:
    """kv_len per sequence: a fraction of M, at least 1, leaving room for
    the verify chain's n_pos − 1 later positions."""
    return [min(max(1, int(x * m)), m - (n_pos - 1)) for x in fracs]


def _ranges(kvl, fiber_batch, split_len: int, splits: int, rows: int,
            n_pos: int, window: Optional[int] = None):
    """[F, S, R] live ranges of split-K partials: fiber f reads sequence
    ``fiber_batch[f]``; row r sits at chain position ``r // (rows / n_pos)``
    and sees keys below ``kv_len + position`` (decode: below kv_len), and
    with a window from ``kv_len − window``."""
    kvl = np.asarray(kvl, np.int64)[np.asarray(fiber_batch)][:, None, None]
    pos = (np.arange(rows) // (rows // n_pos))[None, None, :] \
        if n_pos > 1 else np.zeros((1, 1, rows), np.int64)
    s0 = (np.arange(splits) * split_len)[None, :, None]
    hi = np.minimum(s0 + split_len, kvl + pos)
    lo = np.maximum(s0, kvl - window) if window is not None \
        else np.broadcast_to(s0, hi.shape)
    return np.broadcast_to(lo, hi.shape), hi


def _probe(name: str, cases: list, smem: list, *, impl: str, size: str,
           page_list: Optional[list] = None) -> dict:
    assert_s_independent(smem, name)
    out = {"probe": name, "impl": impl, "size": size, "cases": cases,
           "smem_bytes": smem[0]}
    if page_list is not None:
        out["page_list_bytes"] = page_list
    return out


# ---------------------------------------------------------------------------
# K1: prefill
# ---------------------------------------------------------------------------

def probe_prefill(entry: CascadeEntry, impl: str = "torch",
                  size: Optional[str] = None, fn: Optional[Callable] = None,
                  exp_impl: str = "native") -> dict:
    """K1 (or its plain version), causal, and causal with a window and a
    softcap, at P = M and P = 2M: each row's count from its log-sum-exp,
    its positions' means from its output."""
    dev, shapes = _setup(impl, size)
    s = shapes["prefill"]
    fn = fn or (fm.fusemax_attention_cuda if impl == "cuda"
                else fm.fusemax_attention_torch)
    e, f, group = s["e"], s["f"], s["hq"] // s["hkv"]
    gen = _gen(dev, 0)
    cases, smem = [], []
    for m in s["ms"]:
        bh, pg = s["b"] * s["hkv"], m * group
        # the kernel's plan for this call: its tile and column blocks
        plan = autotune.prefill_plan(bh, pg, e, f)
        bq, bk = plan.block_q, plan.block_k
        q = torch.zeros((bh, pg, e), device=dev)
        k = torch.randn((bh, m, e), generator=gen, device=dev)
        v = position_values(torch.arange(m, device=dev), f).expand(
            bh, m, f).contiguous()
        qpos = np.arange(pg) // group
        for window, softcap in ((None, None), (s["window"], s["softcap"])):
            out, lse = fn(q, k, v, scale=e ** -0.5, causal=True,
                          window=window, softcap=softcap, group=group,
                          block_q=bq, block_k=bk, exp_impl=exp_impl,
                          return_lse=True)
            lo = np.zeros_like(qpos) if window is None \
                else np.maximum(0, qpos - window + 1)
            what = f"prefill[M={m}, window={window}, softcap={softcap}]"
            cases.append(dict(case=what, **check_rows(
                what, out, np.broadcast_to(lo, (bh, pg)),
                np.broadcast_to(qpos + 1, (bh, pg)), lse=lse,
                exact=exp_impl == "native")))
        smem.append(autotune.prefill_smem_bytes(
            bq, bk, e, f, autotune.CUDA_PREFILL[(e, f)].warp_split,
            q.element_size(), f_split=plan.f_split))
    return _probe("prefill", cases, smem, impl=impl, size=size)


# ---------------------------------------------------------------------------
# K2: split-K decode on the dense cache, and its E ≠ F (latent) branch
# ---------------------------------------------------------------------------

def probe_decode(entry: CascadeEntry, impl: str = "torch",
                 size: Optional[str] = None, fn: Optional[Callable] = None,
                 n_pos: int = 1, exp_impl: str = "native") -> dict:
    """K2's partials (or ``fn``, with ``decode_partials_torch``'s
    signature) on granite's decode data at M and 2M: decode steps (P = 1,
    global and windowed with a softcap) or a verify chain of ``n_pos``."""
    dev, shapes = _setup(impl, size)
    s = shapes["decode"]
    fn = fn or (dec.decode_partials_cuda if impl == "cuda"
                else dec.decode_partials_torch)
    d, hkv, group = s["d"], s["hkv"], s["hq"] // s["hkv"]
    rows, splits = n_pos * group, s["splits"]
    gen = _gen(dev, 1)
    cases, smem = [], []
    windows = ((None, None), (s["window"], 50.0)) if n_pos == 1 \
        else ((None, None),)
    for m in s["ms"]:
        kvl = _kv_lens(s["kvl"], m, n_pos)
        bh = s["b"] * hkv
        q = torch.zeros((bh, rows, d), device=dev)
        k = torch.randn((bh, m, d), generator=gen, device=dev)
        v = position_values(torch.arange(m, device=dev), d).expand(
            bh, m, d).contiguous()
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev)
        for window, softcap in windows:
            pm, pl, pnv = fn(q, k, v, kv_len, scale=d ** -0.5,
                             softcap=softcap, window=window, hkv=hkv,
                             splits=splits, block_k=s["block_k"],
                             exp_impl=exp_impl, n_pos=n_pos,
                             rows_per_pos=group)
            lo, hi = _ranges(kvl, np.arange(bh) // hkv, m // splits, splits,
                             rows, n_pos, window)
            what = f"decode[M={m}, n_pos={n_pos}, window={window}]"
            cases.append(dict(case=what, **check_partials(
                what, pm, pl, pnv, lo, hi, exact=exp_impl == "native")))
        smem.append(autotune.decode_smem_bytes(rows, d, q.element_size()))
    name = "decode" if n_pos == 1 else "verify"
    return _probe(name, cases, smem, impl=impl, size=size)


def probe_decode_latent(entry: CascadeEntry, impl: str = "torch",
                        size: Optional[str] = None,
                        fn: Optional[Callable] = None, n_pos: int = 1,
                        exp_impl: str = "native") -> dict:
    """K2's E ≠ F branch (MLA decode on the dense latent cache) at
    DeepSeek's widths: the latent ``ckv`` carries the positions and is
    the value; ``krope`` is random."""
    dev, shapes = _setup(impl, size)
    s = shapes["latent"]
    fn = fn or (dec.latent_decode_partials_cuda if impl == "cuda"
                else dec.latent_decode_partials_torch)
    rank, rope, b = s["rank"], s["rope"], s["b"]
    rows, splits = n_pos * s["h"], s["splits"]
    gen = _gen(dev, 2)
    cases, smem = [], []
    for m in s["ms"]:
        kvl = _kv_lens(s["kvl"], m, n_pos)
        q = torch.zeros((b, rows, rank + rope), device=dev)
        ckv = position_values(torch.arange(m, device=dev), rank).expand(
            b, m, rank).contiguous()
        krope = torch.randn((b, m, rope), generator=gen, device=dev)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev)
        pm, pl, pnv = fn(q, ckv, krope, kv_len, scale=(rank + rope) ** -0.5,
                         splits=splits, block_k=s["block_k"],
                         exp_impl=exp_impl, n_pos=n_pos,
                         rows_per_pos=s["h"])
        lo, hi = _ranges(kvl, np.arange(b), m // splits, splits, rows, n_pos)
        what = f"decode_latent[M={m}, n_pos={n_pos}]"
        cases.append(dict(case=what, **check_partials(
            what, pm, pl, pnv, lo, hi, exact=exp_impl == "native")))
        smem.append(autotune.mla_decode_smem_bytes(rank, rope,
                                                   q.element_size()))
    name = "decode_latent" if n_pos == 1 else "verify_latent"
    return _probe(name, cases, smem, impl=impl, size=size)


# ---------------------------------------------------------------------------
# K3 and K4: paged split-K decode behind a permuted block table
# ---------------------------------------------------------------------------

#: what a physical page no table entry names holds: a read of it shows in
#: the position sums
POISON = 777.0


def paged_layout(kvl, ps: int, w: int, n_pos: int, seed: int):
    """(block table [B, W] int32, n_pages, pos [n_pages, ps] int64): each
    sequence's pages up to ``kv_len + n_pos − 1`` tokens at physical pages
    of a seeded permutation, the rest of its row the sentinel ``n_pages``;
    ``pos`` is the logical position a physical slot holds (−1: unused)."""
    b = len(kvl)
    n_pages = b * w
    used = [-(-(n + n_pos - 1) // ps) for n in kvl]
    perm = np.random.default_rng(seed).permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    pos = np.full((n_pages, ps), -1, np.int64)
    nxt = 0
    for i, u in enumerate(used):
        for j in range(u):
            phys = int(perm[nxt])
            nxt += 1
            table[i, j] = phys
            pos[phys] = j * ps + np.arange(ps)
    return torch.from_numpy(table), n_pages, torch.from_numpy(pos)


def _paged_values(pos: torch.Tensor, width: int) -> torch.Tensor:
    """[n_pages, ps, width] rows of :func:`position_values`, unused slots
    ``POISON``."""
    vals = position_values(pos.clamp(min=0), width)
    vals[pos < 0] = POISON
    return vals


def probe_decode_paged(entry: CascadeEntry, impl: str = "torch",
                       size: Optional[str] = None,
                       fn: Optional[Callable] = None, n_pos: int = 1,
                       code: Optional[torch.dtype] = None,
                       exp_impl: str = "native") -> dict:
    """K3's partials on granite's decode data in a pool behind a permuted
    table with sentinel pages, at W and 2W pages a row: fp32 pages, or
    ``code`` (fp8 e4m3) pages with fp16 scales (counts only)."""
    dev, shapes = _setup(impl, size)
    s = shapes["paged"]
    fn = fn or (dec.paged_decode_partials_cuda if impl == "cuda"
                else dec.paged_decode_partials_torch)
    d, hkv, group, ps = s["d"], s["hkv"], s["hq"] // s["hkv"], s["ps"]
    rows, splits = n_pos * group, s["splits"]
    gen = _gen(dev, 3)
    cases, smem, page_list = [], [], []
    for w in s["ws"]:
        m = w * ps
        kvl = _kv_lens(s["kvl"], m, n_pos)
        table, n_pages, pos = paged_layout(kvl, ps, w, n_pos, seed=w)
        bh = s["b"] * hkv
        q = torch.zeros((bh, rows, d), device=dev)
        k_pages = torch.randn((n_pages, ps, hkv, d), generator=gen,
                              device=dev)
        vals = _paged_values(pos.to(dev), d)
        if code is not None:
            vals[..., 1:] = 0.0         # e4m3 holds 1 and 0 exactly
        v_pages = vals[:, :, None, :].expand(n_pages, ps, hkv, d).contiguous()
        scales = {}
        if code is not None:
            k_pages, v_pages = k_pages.to(code), v_pages.to(code)
            scales = dict(
                k_scale=torch.rand((n_pages, ps, hkv), generator=gen,
                                   device=dev).add(0.5).half(),
                v_scale=torch.ones((n_pages, ps, hkv), device=dev).half())
        pm, pl, pnv = fn(q, k_pages, v_pages, table.to(dev),
                         torch.tensor(kvl, dtype=torch.int32, device=dev),
                         scale=d ** -0.5, hkv=hkv, splits=splits,
                         block_k=ps, exp_impl=exp_impl, n_pos=n_pos,
                         rows_per_pos=group, **scales)
        lo, hi = _ranges(kvl, np.arange(bh) // hkv, m // splits, splits,
                         rows, n_pos)
        what = (f"decode_paged[W={w}, n_pos={n_pos}, "
                f"{'fp32' if code is None else str(code).split('.')[-1]}]")
        cases.append(dict(case=what, **check_partials(
            what, pm, pl, pnv, lo, hi, sums=code is None,
            exact=exp_impl == "native")))
        eb, scaled = k_pages.element_size(), code is not None
        smem.append(autotune.decode_smem_bytes(rows, d, eb, scaled=scaled))
        page_list.append(autotune.decode_smem_bytes(
            rows, d, eb, pages=w // splits, scaled=scaled) - smem[-1])
    name = ("decode_paged" if n_pos == 1 else "verify_paged") \
        + ("" if code is None else "_fp8")
    return _probe(name, cases, smem, impl=impl, size=size,
                  page_list=page_list)


def probe_mla_decode_paged(entry: CascadeEntry, impl: str = "torch",
                           size: Optional[str] = None,
                           fn: Optional[Callable] = None, n_pos: int = 1,
                           exp_impl: str = "native") -> dict:
    """K4's partials at DeepSeek-V3's widths in a latent pool behind a
    permuted table with sentinel pages: the latent ``ckv`` pages carry
    the positions and are the value, ``krope`` pages are random."""
    dev, shapes = _setup(impl, size)
    s = shapes["mla"]
    fn = fn or (dec.mla_paged_decode_partials_cuda if impl == "cuda"
                else dec.mla_paged_decode_partials_torch)
    rank, rope, ps, b = s["rank"], s["rope"], s["ps"], s["b"]
    rows, splits = n_pos * s["h"], s["splits"]
    gen = _gen(dev, 4)
    cases, smem = [], []
    for w in s["ws"]:
        m = w * ps
        kvl = _kv_lens(s["kvl"], m, n_pos)
        table, n_pages, pos = paged_layout(kvl, ps, w, n_pos, seed=w + 1)
        q = torch.zeros((b, rows, rank + rope), device=dev)
        ckv = _paged_values(pos.to(dev), rank).contiguous()
        krope = torch.randn((n_pages, ps, rope), generator=gen, device=dev)
        pm, pl, pnv = fn(q, ckv, krope, table.to(dev),
                         torch.tensor(kvl, dtype=torch.int32, device=dev),
                         scale=(rank + rope) ** -0.5, splits=splits,
                         block_k=ps, exp_impl=exp_impl, n_pos=n_pos,
                         rows_per_pos=s["h"])
        lo, hi = _ranges(kvl, np.arange(b), m // splits, splits, rows, n_pos)
        what = f"mla_decode_paged[W={w}, n_pos={n_pos}]"
        cases.append(dict(case=what, **check_partials(
            what, pm, pl, pnv, lo, hi, exact=exp_impl == "native")))
        smem.append(autotune.mla_decode_smem_bytes(rank, rope,
                                                   ckv.element_size()))
    name = "mla_decode_paged" if n_pos == 1 else "mla_verify_paged"
    return _probe(name, cases, smem, impl=impl, size=size)


# ---------------------------------------------------------------------------
# The plain torch ops: the 3-pass oracles and the 2-pass cascade
# ---------------------------------------------------------------------------

def _ops_inputs(s: dict, m: int, dev, seed: int):
    gen = _gen(dev, seed)
    q = torch.zeros((s["b"], s["hq"], m, s["e"]), device=dev)
    k = torch.randn((s["b"], s["hkv"], m, s["e"]), generator=gen, device=dev)
    v = position_values(torch.arange(m, device=dev), s["e"]).expand(
        s["b"], s["hkv"], m, s["e"]).contiguous()
    return q, k, v


def probe_torch_mha_reference(entry: CascadeEntry, impl: str = "torch",
                              size: Optional[str] = None) -> dict:
    """:func:`repro_torch.kernels.ref.mha_reference`, causal with a
    window, at M and 2M: each row the mean of its live keys."""
    dev, shapes = _setup(impl, size)
    s = shapes["torch_ops"]
    cases = []
    for m in s["ms"]:
        q, k, v = _ops_inputs(s, m, dev, 5)
        window = m // 3
        out = kref.mha_reference(q, k, v, causal=True, window=window)
        qpos = np.arange(m)
        what = f"mha_reference[M={m}]"
        cases.append(dict(case=what, **check_rows(
            what, out, np.broadcast_to(np.maximum(0, qpos - window + 1),
                                       out.shape[:-1]),
            np.broadcast_to(qpos + 1, out.shape[:-1]))))
    return {"probe": "torch:mha_reference", "impl": impl, "cases": cases}


def probe_torch_decode_reference(entry: CascadeEntry, impl: str = "torch",
                                 size: Optional[str] = None) -> dict:
    """:func:`repro_torch.kernels.ref.decode_reference` on ragged kv_len."""
    dev, shapes = _setup(impl, size)
    s = shapes["torch_ops"]
    cases = []
    for m in s["ms"]:
        q, k, v = _ops_inputs(s, m, dev, 6)
        kvl = [m, m // 3 + 1][:s["b"]]
        out = kref.decode_reference(q[:, :, :1], k, v, torch.tensor(
            kvl, device=dev))[:, :, 0]
        what = f"decode_reference[M={m}]"
        hi = np.broadcast_to(np.asarray(kvl)[:, None], out.shape[:-1])
        cases.append(dict(case=what, **check_rows(what, out,
                                                  np.zeros_like(hi), hi)))
    return {"probe": "torch:decode_reference", "impl": impl, "cases": cases}


def probe_torch_attention_2pass(entry: CascadeEntry, impl: str = "torch",
                                size: Optional[str] = None) -> dict:
    """:func:`repro_torch.core.cascades_numeric.attention_2pass`, causal."""
    dev, shapes = _setup(impl, size)
    s = shapes["torch_ops"]
    cases = []
    for m in s["ms"]:
        q, k, v = _ops_inputs(dict(s, hq=s["hkv"]), m, dev, 7)
        out = cn.attention_2pass(q, k, v, cn.AttnSpec(causal=True),
                                 block=s["block"])
        qpos = np.arange(m)
        what = f"attention_2pass[M={m}]"
        cases.append(dict(case=what, **check_rows(
            what, out, np.zeros(out.shape[:-1], np.int64),
            np.broadcast_to(qpos + 1, out.shape[:-1]))))
    return {"probe": "torch:attention_2pass", "impl": impl, "cases": cases}


def _with_chain(probe: Callable, key: str) -> Callable:
    """``probe`` at the size's verify chain length (``key`` of SHAPES)."""
    def run(entry, impl="torch", size=None, fn=None, exp_impl="native"):
        _, shapes = _setup(impl, size)
        return probe(entry, impl, size, fn=fn, n_pos=shapes[key],
                     exp_impl=exp_impl)
    return run


# ---------------------------------------------------------------------------
# Traced pass counts of the plain versions (the reference's jnp:* probes)
# ---------------------------------------------------------------------------

_M = 144                    # probe sequence extent (3 blocks of 48)
_PAIRS = ((3, 48),)


def _traced(key: str, fn: Callable, args: Callable, pairs) -> Callable:
    """A probe that traces ``fn(*args())`` under the registry entry that
    binds ``key`` (or the entry it is given) and reports its passes."""
    def run(entry=None, impl="torch", size=None):
        _setup(impl, size)
        entry = entry or next(e for e in REGISTRY if key in e.lint)
        a = args()
        tr = assert_torch_path(fn, a, entry, m_total=_M, m_pairs=pairs,
                               label=key.split(":", 1)[1])
        case = dict(case=f"{key}[{', '.join(str(tuple(t.shape)) for t in a)}]",
                    passes=tr.passes, multi_gen=tr.multi_gen)
        return {"probe": key, "traced": "plain", "passes": tr.passes,
                "multi_gen": tr.multi_gen, "cases": [case]}
    return run


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _kv_len():
    return torch.tensor([100, 40], dtype=torch.int32)


def _splitk(n_pos: int) -> Callable:
    """``decode_partials_torch`` (3 splits of 48 keys, tiles of 16) and
    ``combine_partials`` at ``n_pos`` draft positions."""
    def fn(q, k, v, kv_len):
        pm, pl, pnv = dec.decode_partials_torch(
            q, k, v, kv_len, scale=0.25, hkv=2, splits=3, block_k=16,
            n_pos=n_pos)
        return dec.combine_partials(pm, pl, pnv, torch.float32)
    return fn


def _mla_paged(n_pos: int) -> Callable:
    """``mla_paged_decode_partials_torch`` (3 splits of one 48-token page)
    and ``combine_partials`` at ``n_pos`` draft positions."""
    def fn(q, ckv_pages, krope_pages, table, kv_len):
        pm, pl, pnv = dec.mla_paged_decode_partials_torch(
            q, ckv_pages, krope_pages, table, kv_len, scale=0.25, splits=3,
            block_k=48, n_pos=n_pos)
        return dec.combine_partials(pm, pl, pnv, torch.float32)
    return fn


def _mla_args(n_pos: int):
    """q [2, 4·n_pos, 16 + 8] against a pool of 7 pages of 48 tokens (only
    the gathered view carries both factors) on an identity block table."""
    return (_z(2, 4 * n_pos, 24), _z(7, 48, 16), _z(7, 48, 8),
            torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32),
            _kv_len())


#: each trace probe's function, its arguments (made anew each call) and
#: the (n_blocks, block) pairs of its blocked layouts
_TRACED = {
    "trace:mha_reference": (
        kref.mha_reference,
        lambda: (_z(2, 4, 5, 8), _z(2, 2, _M, 8), _z(2, 2, _M, 8)), ()),
    "trace:decode_reference": (
        kref.decode_reference,
        lambda: (_z(2, 4, 1, 8), _z(2, 2, _M, 8), _z(2, 2, _M, 8),
                 _kv_len()), ()),
    "trace:attention_2pass": (
        lambda q, k, v: cn.attention_2pass(q, k, v, block=48),
        lambda: (_z(2, 4, 5, 8), _z(2, 4, _M, 8), _z(2, 4, _M, 8)), _PAIRS),
    "trace:prefill": (
        lambda q, k, v: fm.fusemax_attention_torch(
            q, k, v, scale=0.125, group=2, block_k=48),
        lambda: (_z(4, 10, 8), _z(4, _M, 8), _z(4, _M, 8)), _PAIRS),
    "trace:decode": (
        _splitk(1),
        lambda: (_z(4, 2, 8), _z(4, _M, 8), _z(4, _M, 8), _kv_len()), _PAIRS),
    "trace:verify": (
        _splitk(2),
        lambda: (_z(4, 4, 8), _z(4, _M, 8), _z(4, _M, 8), _kv_len()), _PAIRS),
    "trace:mla_decode": (_mla_paged(1), lambda: _mla_args(1), _PAIRS),
    "trace:mla_verify": (_mla_paged(2), lambda: _mla_args(2), _PAIRS),
}
TRACE_PROBES: dict[str, Callable[..., dict]] = {
    key: _traced(key, *spec) for key, spec in _TRACED.items()}


PROBES: dict[str, Callable[..., dict]] = {
    "prefill": probe_prefill,
    "decode": probe_decode,
    "decode_latent": probe_decode_latent,
    "decode_paged": probe_decode_paged,
    "decode_paged_fp8": functools.partial(probe_decode_paged,
                                          code=torch.float8_e4m3fn),
    "mla_decode_paged": probe_mla_decode_paged,
    "verify": _with_chain(probe_decode, "verify_p"),
    "verify_paged": _with_chain(probe_decode_paged, "verify_p"),
    "verify_latent": _with_chain(probe_decode_latent, "mla_verify_p"),
    "mla_verify_paged": _with_chain(probe_mla_decode_paged, "mla_verify_p"),
    "torch:mha_reference": probe_torch_mha_reference,
    "torch:decode_reference": probe_torch_decode_reference,
    "torch:attention_2pass": probe_torch_attention_2pass,
    **TRACE_PROBES,
}


def lint_entry(entry: CascadeEntry, impl: str = "torch",
               size: Optional[str] = None) -> list[dict]:
    """Run every structural probe bound to a registry entry.  Raises
    :class:`LintError` on the first declaration/implementation mismatch."""
    results = []
    for key in entry.lint:
        probe = PROBES.get(key)
        if probe is None:
            raise LintError(
                f"{entry.name}: lint probe '{key}' is not implemented — "
                f"declare the probe in repro_torch.analysis.lint.PROBES")
        results.append(probe(entry, impl, size))
    return results


def lint_all(entries: Optional[Iterable[CascadeEntry]] = None,
             impl: str = "torch", size: Optional[str] = None) -> list[dict]:
    """Lint every registry entry; returns per-entry result dicts with
    ``ok``/``error`` fields instead of raising (report use)."""
    out = []
    for e in (REGISTRY if entries is None else entries):
        try:
            out.append({"name": e.name, "ok": True,
                        "probes": lint_entry(e, impl, size)})
        except LintError as err:
            out.append({"name": e.name, "ok": False, "error": str(err)})
    return out


__all__ = [
    "LintError",
    "PROBES",
    "SHAPES",
    "TRACE_PROBES",
    "TorchTrace",
    "assert_s_independent",
    "assert_torch_path",
    "check_partials",
    "check_rows",
    "lint_all",
    "lint_entry",
    "paged_layout",
    "position_values",
    "range_sums",
    "trace_m_passes",
]
