"""The walk of K2 and K3, emulated on the CPU.

K2 and K3 (``csrc/decode_partials.cuh``) walk each split of the cache in
chunks of ``CK`` keys; ``WK`` warps split every chunk's keys, each keeping
its own running (m, l, acc) per query row, and the warps' states are
merged once per split (M = max m_w, each state scaled by exp(m_w - M) and
summed in warp order).  Inside a warp a score is a per-lane partial dot
over D / 32 contiguous features summed by a tree over the 32 lanes.  With
P = 1 and no window the walk stops at kv_len; otherwise it covers the
whole tile-run range of the TPU kernel.  This file emulates that order of
work in plain torch (:func:`walk`) and holds it

1. to the plain versions (``decode_partials_torch``,
   ``paged_decode_partials_torch``) and, after the combine, to the
   reference's Pallas kernels in interpret mode, on ``chip_smoke.py``'s K2
   and K3 case lists (68 and 128 verify rows a fiber among them, and
   hymba-1.5b's G = 5 at d64 on a 2048-token cache and a ring of 1024
   read at eff_len) at small
   sizes (kv heads cut to 2; bf16 cases take
   bf16-valued fp32 inputs, the values the kernels widen to fp32):
   the partials m and l within rtol = atol = 1e-5 (l within rtol 3e-5
   with exp_impl="maccs": its exp is within 9.2e-6 of exp, relative, and
   the merge scales l and acc by one more such factor, which acc / l
   divides out), each split's output acc / l and the combined outputs
   within 1e-5 absolute on unit-normal inputs (chip_smoke's fp32 gate is
   1e-4);
2. dense walk at block_k 128 against paged walk at block_k 16 on a pool
   holding the same rows in permuted pages: equal bits on every fiber
   with kv_len >= 1, with the skip and without it;
3. with the skip against without it: equal bits on P = 1 cases;
4. on a P = 2 case whose split starts at kv_len, the skip applied anyway
   changes the result — so the condition on the skip can fail.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.kernels import ops as jax_ops
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import decode as dec
from repro_torch.kernels.fusemax import NEG_INF, _exp

ROOT = Path(__file__).resolve().parents[1]
CK = autotune.DECODE_CHUNK
WK = autotune.DECODE_KEY_WARPS
TOL = dict(rtol=1e-5, atol=1e-5)
MACCS_RTOL = 3e-5
OUT_ATOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
K2_CASES = CS.k2_cases(torch, CK) + CS.k2_spec_cases(torch, CK) \
    + CS.k2_rows_cases(torch, CK) + CS.k2_hymba_cases(torch)
K3_CASES = CS.k3_cases(torch, CK) + CS.k3_spec_cases(torch, CK) \
    + CS.k3_rows_cases(torch, CK) + CS.k3_hymba_cases(torch)


def walk(q, kv_rows, kv_len, *, hkv, splits, split_len, block_k, scale,
         softcap=None, window=None, exp_impl="native", n_pos=1,
         rows_per_pos=None, skip="exact"):
    """Partials (m, l, acc) in the new kernels' order of work.

    ``kv_rows(kpos)`` returns the K and V rows ``[BH, S, CK, D]`` of key
    positions ``[BH, S, CK]``.  ``skip``: "exact" stops the walk at kv_len
    where the kernels do (P = 1, no window), "never" walks the whole
    tile-run range, "always" stops at kv_len whatever P is."""
    bh, r, d = q.shape
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    kvl = kv_len.to(torch.int64).repeat_interleave(hkv)[:, None]  # [BH, 1]
    split0 = (torch.arange(splits) * split_len)[None, :]           # [1, S]
    n_tiles = split_len // block_k
    lim = kvl + n_pos - 1 - split0
    t1 = torch.where(lim <= 0, 0,
                     torch.clamp((lim + block_k - 1) // block_k, max=n_tiles))
    t0 = torch.zeros_like(t1)
    if window is not None:
        need = kvl - window - split0
        t0 = torch.where(need <= 0, 0, need // block_k)
    kbeg = split0 + t0 * block_k
    kfin = split0 + torch.maximum(t0, t1) * block_k
    stop = {"exact": n_pos == 1 and window is None, "never": False,
            "always": True}[skip]
    kend = torch.minimum(kfin, kvl) if stop else kfin

    kw, fpl = CK // WK, d // 32
    shape = (bh, splits, r, WK)
    m = torch.full(shape, NEG_INF)
    l = torch.zeros(shape)
    acc = torch.zeros((*shape, d))
    lim_row = kvl + (torch.arange(r) // rows_per_pos if n_pos > 1
                     else torch.zeros(r, dtype=torch.int64))[None, :]
    q_lanes = q.float().reshape(bh, 1, r, 1, 32, fpl)
    neg = torch.tensor(NEG_INF)
    for c in range(-(-split_len // CK)):
        c0 = kbeg + c * CK                                 # [BH, S]
        runs = (c0 < kend)[..., None, None]
        nk = torch.clamp(kend - c0, 0, CK)
        kpos = c0[..., None] + torch.arange(CK)            # [BH, S, CK]
        incl = (torch.arange(CK) < nk[..., None])[:, :, None, :]
        kt, vt = kv_rows(torch.minimum(kpos, split0[..., None]
                                       + split_len - 1))
        kt, vt = kt.float(), vt.float()
        # per-lane partial dots (D / 32 features each, in order), then the
        # tree over the lanes: lane l with lane l ^ 16 first
        k_lanes = kt.reshape(bh, splits, 1, CK, 32, fpl)
        part = q_lanes[..., 0] * k_lanes[..., 0]
        for j in range(1, fpl):
            part = part + q_lanes[..., j] * k_lanes[..., j]
        while part.shape[-1] > 1:
            h = part.shape[-1] // 2
            part = part[..., :h] + part[..., h:]
        s = part[..., 0] * scale                           # [BH, S, R, CK]
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = kpos[:, :, None, :] < lim_row[:, None, :, None]
        if window is not None:
            ok = ok & (kpos[:, :, None, :]
                       > (kvl - 1 - window)[:, :, None, None])
        x = torch.where(ok, s, neg)
        # the WK warps' shares of the chunk: KW consecutive keys each
        xw = x.reshape(bh, splits, r, WK, kw)
        iw = incl.expand(bh, splits, r, CK).reshape(bh, splits, r, WK, kw)
        m_new = torch.maximum(m, torch.where(iw, xw, neg).amax(-1))
        p = torch.where(iw, _exp(xw - m_new[..., None], exp_impl), 0.0)
        prm = _exp(m - m_new, exp_impl)
        l_new = l * prm + p.sum(-1)
        acc_new = acc * prm[..., None]
        vw = vt.reshape(bh, splits, 1, WK, kw, d)
        for key in range(kw):
            acc_new = acc_new + p[..., key, None] * vw[..., key, :]
        m = torch.where(runs, m_new, m)
        l = torch.where(runs, l_new, l)
        acc = torch.where(runs[..., None], acc_new, acc)
    # the cross-warp merge, in warp order
    mx = m.amax(-1)
    f = _exp(m - mx[..., None], exp_impl)
    pl = torch.zeros_like(mx)
    pnv = torch.zeros((bh, splits, r, d))
    for w in range(WK):
        pl = pl + f[..., w] * l[..., w]
        pnv = pnv + f[..., w, None] * acc[..., w, :]
    return mx, pl, pnv


def dense_rows(k, v):
    idx = torch.arange(k.shape[0])[:, None, None]
    return lambda kpos: (k[idx, kpos], v[idx, kpos])


def paged_rows(k_pages, v_pages, table, hkv):
    n_pages, ps = k_pages.shape[:2]
    bt = torch.clamp(table.to(torch.int64), max=n_pages - 1)
    bh = table.shape[0] * hkv
    b_idx = (torch.arange(bh) // hkv)[:, None, None]
    h_idx = (torch.arange(bh) % hkv)[:, None, None]

    def rows(kpos):
        page = bt[b_idx, kpos // ps]
        return (k_pages[page, kpos % ps, h_idx],
                v_pages[page, kpos % ps, h_idx])
    return rows


def _as_kernel_input(a: np.ndarray, dtype) -> np.ndarray:
    """bf16 cases: the bf16 values, held in fp32."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return a


def _k2_inputs(case, seed):
    name, b, hkv, g, p, m, d, dtype, kvl, splits, bk, kw = case
    hkv = min(hkv, 2)
    rng = np.random.default_rng(seed)
    q = _as_kernel_input(rng.standard_normal((b, hkv * g, p, d))
                         .astype(np.float32), dtype)
    k = _as_kernel_input(rng.standard_normal((b, hkv, m, d))
                         .astype(np.float32), dtype)
    v = _as_kernel_input(rng.standard_normal((b, hkv, m, d))
                         .astype(np.float32), dtype)
    return q, k, v, np.asarray(kvl, np.int32), hkv


def _k3_inputs(case, seed):
    name, b, hkv, g, p, ps, w, n_pages, d, dtype, kvl, splits, bk, kw = case
    hkv = min(hkv, 2)
    rng = np.random.default_rng(seed)
    q = _as_kernel_input(rng.standard_normal((b, hkv * g, p, d))
                         .astype(np.float32), dtype)
    kp = _as_kernel_input(rng.standard_normal((n_pages, ps, hkv, d))
                          .astype(np.float32), dtype)
    vp = _as_kernel_input(rng.standard_normal((n_pages, ps, hkv, d))
                          .astype(np.float32), dtype)
    perm = rng.permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    used = 0
    for i, n in enumerate(kvl):
        need = -(-(n + p - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(kvl, np.int32), hkv


def _close(got, want, what, exp_impl):
    """m and l within rtol = atol = 1e-5 (l within rtol 3e-5 under
    exp_impl="maccs"), and each split's own output acc / l within 1e-5
    absolute (acc itself where no tile ran, l = 0)."""
    rtol_l = MACCS_RTOL if exp_impl == "maccs" else 1e-5
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"{what}: partial m: {m}")
    torch.testing.assert_close(got[1], want[1], rtol=rtol_l, atol=1e-5,
                               msg=lambda m: f"{what}: partial l: {m}")

    def per_split(parts):
        return parts[2] / torch.where(parts[1] > 0, parts[1], 1.0)[..., None]

    torch.testing.assert_close(per_split(got), per_split(want), rtol=0,
                               atol=OUT_ATOL,
                               msg=lambda m: f"{what}: acc / l: {m}")


def _combined(parts, b, hkv, g, d, p):
    out = dec.combine_partials(*parts, torch.float32)
    return ops._unfold_decode_out(out, b, hkv, g, d, p=p).numpy()


# ---------------------------------------------------------------------------
# 1. the walk against the plain versions and the reference's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_dense_walk_matches_plain_and_pallas(case):
    name, b, _, g, p, m, d, dtype, kvl, splits, bk, kw = case
    q, k, v, kv_len, hkv = _k2_inputs(case, 11)
    q_f = ops._fold_decode_q(torch.from_numpy(q), b, hkv, g, d)
    k_f = torch.from_numpy(k).reshape(b * hkv, m, d)
    v_f = torch.from_numpy(v).reshape(b * hkv, m, d)
    split_len, block_k = dec._split_geometry(m, splits, bk)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=block_k,
                n_pos=p, rows_per_pos=g, softcap=kw.get("softcap"),
                window=kw.get("window"),
                exp_impl=kw.get("exp_impl", "native"))
    ours = walk(q_f, dense_rows(k_f, v_f), torch.from_numpy(kv_len),
                split_len=split_len, **args)
    plain = dec.decode_partials_torch(q_f, k_f, v_f,
                                      torch.from_numpy(kv_len), **args)
    _close(ours, plain, name, args["exp_impl"])
    out = _combined(ours, b, hkv, g, d, p)
    np.testing.assert_allclose(out, _combined(plain, b, hkv, g, d, p),
                               rtol=0, atol=OUT_ATOL)
    pallas = np.asarray(jax_ops.fusemax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        impl="pallas", splits=splits, block_k=bk, **kw), np.float32)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_paged_walk_matches_plain_and_pallas(case):
    name, b, _, g, p, ps, w, n_pages, d, dtype, kvl, splits, bk, kw = case
    q, kp, vp, table, kv_len, hkv = _k3_inputs(case, 12)
    q_f = ops._fold_decode_q(torch.from_numpy(q), b, hkv, g, d)
    kp_t, vp_t, bt = map(torch.from_numpy, (kp, vp, table))
    split_pages, block_k = dec._paged_geometry(w, ps, splits, bk)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=block_k,
                n_pos=p, rows_per_pos=g, softcap=kw.get("softcap"),
                exp_impl=kw.get("exp_impl", "native"))
    ours = walk(q_f, paged_rows(kp_t, vp_t, bt, hkv),
                torch.from_numpy(kv_len), split_len=split_pages * ps, **args)
    plain = dec.paged_decode_partials_torch(q_f, kp_t, vp_t, bt,
                                            torch.from_numpy(kv_len), **args)
    _close(ours, plain, name, args["exp_impl"])
    out = _combined(ours, b, hkv, g, d, p)
    np.testing.assert_allclose(out, _combined(plain, b, hkv, g, d, p),
                               rtol=0, atol=OUT_ATOL)
    pallas = np.asarray(jax_ops.fusemax_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), impl="pallas", splits=splits, block_k=bk, **kw),
        np.float32)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=OUT_ATOL)


# ---------------------------------------------------------------------------
# 2.-4. bit-level properties of the walk
# ---------------------------------------------------------------------------

def _same_rows_both_layouts(seed, b=4, hkv=2, g=4, m=512, d=128, ps=16):
    """q, a dense cache and the same rows in a permuted page pool."""
    rng = np.random.default_rng(seed)
    w = m // ps
    q = torch.from_numpy(rng.standard_normal((b * hkv, g, d))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, m, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, m, d))
                         .astype(np.float32))
    perm = torch.from_numpy(rng.permutation(b * w))
    pages = [torch.empty((b * w, ps, hkv, d)) for _ in range(2)]
    for dst, src in zip(pages, (k, v)):
        dst[perm] = src.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
            .reshape(b * w, ps, hkv, d)
    table = perm.reshape(b, w).to(torch.int32)
    return q, k.reshape(b * hkv, m, d), v.reshape(b * hkv, m, d), pages, \
        table


@pytest.mark.parametrize("skip", ["exact", "never"])
def test_dense_and_paged_walks_give_the_same_bits(skip):
    """K2's walk at 128-key tiles and K3's at 16-key tiles, same splits, on
    a pool holding the dense rows: equal bits on every live fiber."""
    q, k, v, (kp, vp), table = _same_rows_both_layouts(21)
    hkv, m, ps, splits = 2, k.shape[1], kp.shape[1], 4
    kvl = torch.tensor([512, 300, 1, 0], dtype=torch.int32)
    common = dict(scale=128 ** -0.5, hkv=hkv, splits=splits,
                  split_len=m // splits, skip=skip)
    dense = walk(q, dense_rows(k, v), kvl, block_k=128, **common)
    paged = walk(q, paged_rows(kp, vp, table, hkv), kvl, block_k=ps,
                 **common)
    live = kvl.repeat_interleave(hkv) >= 1
    for a, c in zip(dense, paged):
        assert torch.equal(a[live], c[live])
    out_d = dec.combine_partials(*dense, torch.float32)
    out_p = dec.combine_partials(*paged, torch.float32)
    assert torch.equal(out_d[live], out_p[live])


P1_CASES = [c for c in K2_CASES if c[4] == 1]


@pytest.mark.parametrize("case", P1_CASES, ids=[c[0] for c in P1_CASES])
def test_skip_gives_the_same_bits_at_one_position(case):
    """With P = 1 every tile that runs starts below kv_len, so stopping the
    walk at kv_len drops only chunks that add exact zeros."""
    name, b, _, g, p, m, d, dtype, kvl, splits, bk, kw = case
    q, k, v, kv_len, hkv = _k2_inputs(case, 13)
    q_f = ops._fold_decode_q(torch.from_numpy(q), b, hkv, g, d)
    rows = dense_rows(torch.from_numpy(k).reshape(b * hkv, m, d),
                      torch.from_numpy(v).reshape(b * hkv, m, d))
    split_len, block_k = dec._split_geometry(m, splits, bk)
    kw = dict(scale=d ** -0.5, hkv=hkv, splits=splits, split_len=split_len,
              block_k=block_k, softcap=kw.get("softcap"),
              window=kw.get("window"), exp_impl=kw.get("exp_impl", "native"))
    always = walk(q_f, rows, torch.from_numpy(kv_len), skip="always", **kw)
    never = walk(q_f, rows, torch.from_numpy(kv_len), skip="never", **kw)
    for a, c in zip(always, never):
        assert torch.equal(a, c)


def test_skip_would_change_a_verify_row_whose_split_starts_at_kv_len():
    """P = 2 with kv_len = 64 and 32-key splits: split 2 starts at kv_len,
    so its one tile runs; position 1 sees key 64 there, position 0 no key.
    Stopping the walk at kv_len would drop that key, and the kernels do
    not: at P > 1 they walk the whole tile-run range."""
    rng = np.random.default_rng(31)
    g, p, m, d, splits = 4, 2, 128, 64, 4
    q = torch.from_numpy(rng.standard_normal((1, p * g, d))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32))
    kvl = torch.tensor([64], dtype=torch.int32)
    kw = dict(scale=d ** -0.5, hkv=1, splits=splits, split_len=m // splits,
              block_k=m // splits, n_pos=p, rows_per_pos=g)
    rows = dense_rows(k, v)
    exact = walk(q, rows, kvl, skip="exact", **kw)
    never = walk(q, rows, kvl, skip="never", **kw)
    always = walk(q, rows, kvl, skip="always", **kw)
    for a, c in zip(exact, never):
        assert torch.equal(a, c)
    assert not torch.equal(always[2], never[2])
    assert always[0][0, 2, g:].max() == NEG_INF       # key 64 dropped
    assert (never[0][0, 2, g:] > NEG_INF).all()       # key 64 seen
    out_always = dec.combine_partials(*always, torch.float32)
    out_never = dec.combine_partials(*never, torch.float32)
    plain = dec.combine_partials(*dec.decode_partials_torch(
        q, k, v, kvl, scale=d ** -0.5, hkv=1, splits=splits,
        block_k=m // splits, n_pos=p, rows_per_pos=g), torch.float32)
    torch.testing.assert_close(out_never, plain, **TOL)
    assert (out_always[0, g:] - plain[0, g:]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the kernels' shared-memory layout and vector loads
# ---------------------------------------------------------------------------

def test_walk_constants_are_the_kernels():
    src = (ROOT / "src/repro_torch/kernels/csrc/decode_partials.cuh") \
        .read_text()
    consts = dict(re.findall(r"constexpr int (CK|STAGES|WK) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "CK": autotune.DECODE_CHUNK, "STAGES": autotune.DECODE_STAGES,
        "WK": autotune.DECODE_KEY_WARPS}


def test_decode_smem_mirror_pins_the_kernel_layout():
    """``decode_smem_bytes`` is the kernels' ``smem_bytes``: a ring of 2
    chunks of 16 K and 16 V rows (32,768 B at fp32 d128) which the merge
    of 4 key warps reuses, each warp's probabilities of a chunk and
    rescale factors of its rows (80 B a row of the block), plus the page
    list.  Granite's K3 launch (4 rows, 8 pages a split) takes 33,120 B,
    64 rows 33,440 B (the merge of 8 rows, 16,640 B, fits the ring); at
    bf16 d64 with 64 rows the merge (8,448 B) is larger than the ring
    (8,192 B).  Every instantiation fits one block, with page lists of up
    to 2048 ids."""
    assert autotune.decode_smem_bytes(4, 128, 4, pages=8) == 32_800 + 320
    assert autotune.decode_smem_bytes(64, 128, 4, pages=8) == 32_800 + 640
    assert autotune.decode_smem_bytes(64, 64, 2) == 8_448 + 640
    assert autotune.decode_smem_bytes(4, 64, 2) == 8_192 + 320
    assert autotune.decode_row_block(4) == 4
    assert autotune.decode_row_block(5) == autotune.decode_row_block(64) == 8
    for eb in (4, 2):
        for d in dec.CUDA_HEAD_DIMS:
            for rows in (1, 4, 5, 8, 64):
                assert autotune.decode_smem_bytes(
                    rows, d, eb, pages=2048) <= autotune.SMEM_BUDGET
    dec._check_smem("t", 4, 128, 4, 2048)
    with pytest.raises(ValueError, match="shared memory"):
        dec._check_smem("t", 4, 128, 4, 60_000)


def test_quad_layout_constants_are_the_kernels():
    """The header's block (128 threads), its row limit (``INT_MAX - 7``,
    ``CUDA_MAX_ROWS``) and its grid (the blocks of rows on grid.x, then
    the splits and the fibers) are those ``autotune.decode_grid`` and
    ``decode.CUDA_MAX_ROWS`` mirror."""
    src = (ROOT / "src/repro_torch/kernels/csrc/decode_partials.cuh") \
        .read_text()
    assert re.findall(r"constexpr int NT = (\d+);", src) == ["128"]
    assert "constexpr int max_rows() { return INT_MAX - 7; }" in src
    assert dec.CUDA_MAX_ROWS == 2**31 - 1 - 7
    assert "const dim3 grid(a.R / RB + (a.R % RB != 0), a.splits, bh);" \
        in src
    assert autotune.decode_grid(9, 16, 64) == (2, 16, 64)


@pytest.mark.parametrize("code_bytes", [4, 2, 1])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("rows", [4, 8, 52, 65, 68, 128, 640])
def test_quad_layout_mirror(rows, d, code_bytes):
    """``autotune``'s mirror of the K2/K3 layout at a fiber's row count:
    blocks of 4 rows up to 4, else of 8, that cover the fiber once and lie
    on grid.x; the merge of 4 key warps over the block's rows reuses the
    ring (fp32 m, l and acc), quantized pools (1-byte codes) add their
    scale slots, and each warp its chunk's probabilities and its rows'
    rescale factors."""
    rb = 4 if rows <= 4 else 8
    assert autotune.decode_row_block(rows) == rb
    nb = -(-rows // rb)
    assert (nb - 1) * rb < rows <= nb * rb
    assert autotune.decode_grid(rows, 16, 64) == (nb, 16, 64)
    scaled = code_bytes == 1
    ring = 2 * CK * 2 * d * code_bytes
    merge = 4 * WK * rb * (d + 2)
    pbuf = 4 * WK * rb * (CK // WK + 1)
    want = -(-max(ring, merge) // 16) * 16 + (4 * 2 * 2 * CK if scaled
                                              else 0) + pbuf + 4 * 8
    assert autotune.decode_smem_bytes(rows, d, code_bytes, pages=8,
                                      scaled=scaled) == want
    assert want <= autotune.SMEM_BUDGET
    # every row count up to the kernels' limit has a grid within CUDA's;
    # past 65535 splits or fibers the wrappers refuse it
    dec._check_grid("t", rows, 16, 64)
    dec._check_grid("t", dec.CUDA_MAX_ROWS, 2**16 - 1, 2**16 - 1)
    with pytest.raises(ValueError, match="grid"):
        dec._check_grid("t", rows, 2**16, 64)
    with pytest.raises(ValueError, match="grid"):
        dec._check_grid("t", rows, 16, 2**16)


def test_vector_check_refuses_a_misaligned_view():
    t = torch.randn(4, 16, 128)
    dec._check_vectors("t", k=t)
    buf = torch.empty(t.numel() + 1)
    view = buf[1:].view(t.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        dec._check_vectors("t", k=view)
