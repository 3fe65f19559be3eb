"""The port's paged KV pool, prefix cache and paged decode against the JAX
reference.

On the CPU the port's paged decode takes K3's plain torch version
(``paged_decode_partials_torch``, the code the CUDA kernel is held to on
the card).  It is compared with the reference's Pallas kernel in
interpret mode (``impl="pallas"``) and its jnp executor, as
tests/test_kv_cache.py runs them; inputs come from numpy with a seed.
Tolerances as in tests/test_torch_kernels.py: fp32 paths differ only in
summation order (rtol = atol = 1e-5 on unit-scale averages); bf16 inputs
are accumulated in fp32 and the output rounded once (one bf16 ulp).
Rows with kv_len = 0 follow the Pallas kernel (output 0), so they are
compared with Pallas only.

The host side (page pool, block tables, prefix index, COW, preemption)
is held to the reference's ``PagedKVCache`` and ``ServeEngine`` on the
same sequences: equal tables, refcounts, greedy streams and counters,
with the reference's own tests (test_kv_cache.py, test_prefix_cache.py)
as the checklist.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.model import attention as jattn
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import KVShard
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.model import attention as attn
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.kv_cache import PagePool, PagedKVCache

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
NAME = "granite-3-8b-smoke"
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "peak_live_tokens",
             "prefix_hits", "tokens_reused", "cow_copies",
             "tokens_prefilled")


@pytest.fixture(scope="module")
def models():
    params, _ = jtf.init(jax_get_config(NAME), jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(get_config(NAME), jax.device_get(params),
                                  RT, device="cpu")
    return params, model


def _pool_inputs(seed, b, hq, hkv, p, e, ps, w, n_pages, kv_len):
    """q, pools and a table of distinct random pages per row, entries past
    the pages ``kv_len + p - 1`` keys need holding the sentinel."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, p, e)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, e)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, e)).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    used = 0
    for i, n in enumerate(kv_len):
        need = -(-(n + p - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(kv_len, np.int32)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*map(jnp.asarray, arrays), **kw), np.float32)


def _torch(fn, *arrays, **kw):
    return fn(*map(torch.from_numpy, arrays), **kw).float().numpy()


# ---------------------------------------------------------------------------
# K3's plain version against the Pallas kernel and the jnp executor
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # b, hq, hkv, P, e, ps, w, pages, kv_len, splits, block_k, softcap
    (4, 8, 2, 1, 32, 8, 4, 20, [0, 1, 13, 32], None, None, None),
    (3, 8, 4, 1, 32, 16, 8, 30, [77, 128, 5], 4, 8, None),
    (2, 16, 2, 1, 64, 16, 16, 40, [256, 100], 16, 16, 30.0),
    (2, 4, 4, 1, 16, 32, 4, 9, [0, 128], 2, 32, None),
    (3, 8, 2, 2, 32, 8, 8, 30, [0, 5, 63], 4, 4, None),
    (2, 8, 2, 4, 32, 16, 8, 20, [1, 120], 2, 16, 20.0),
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"case{i}" for i in range(len(PAGED_CASES))])
def test_paged_decode_matches_pallas_and_jnp(case):
    b, hq, hkv, p, e, ps, w, n_pages, kvl, splits, bk, cap = case
    q, kp, vp, bt, kv_len = _pool_inputs(sum(kvl) + p, b, hq, hkv, p, e, ps,
                                         w, n_pages, kvl)
    kw = dict(splits=splits, block_k=bk, softcap=cap)
    ours = _torch(ops.fusemax_decode_paged, q, kp, vp, bt, kv_len,
                  impl="torch", **kw)
    pallas = _jax(jax_ops.fusemax_decode_paged, q, kp, vp, bt, kv_len,
                  impl="pallas", **kw)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    if p == 1:
        assert np.all(ours[kv_len == 0] == 0.0)
    live = kv_len >= 1
    jnp_out = _jax(jax_ops.fusemax_decode_paged, q, kp, vp, bt, kv_len,
                   impl="jnp", **kw)
    np.testing.assert_allclose(ours[live], jnp_out[live], **F32_TOL)
    ref = _torch(ops.fusemax_decode_paged, q, kp, vp, bt, kv_len,
                 impl="ref", softcap=cap)
    np.testing.assert_allclose(ref[live], jnp_out[live], **F32_TOL)


def test_paged_decode_bf16():
    q, kp, vp, bt, kv_len = _pool_inputs(9, 2, 8, 2, 1, 64, 16, 8, 24,
                                         [100, 7])
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kp, vp))
    ours = ops.fusemax_decode_paged(qb, kb, vb, torch.from_numpy(bt),
                                    torch.from_numpy(kv_len), impl="torch")
    assert ours.dtype == torch.bfloat16
    qj, kj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (qb, kb, vb))
    ref = jax_ops.fusemax_decode_paged(qj, kj, vj, jnp.asarray(bt),
                                       jnp.asarray(kv_len), impl="pallas")
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


def test_paged_partials_equal_dense_partials_on_the_same_rows():
    """On a pool holding a dense cache's rows in permuted pages, K3's plain
    version at the dense split geometry (block_k = page_size = the dense
    tile) gives the dense plain version's partials bit for bit."""
    from repro_torch.kernels.decode import (
        decode_partials_torch, paged_decode_partials_torch,
    )

    rng = np.random.default_rng(4)
    b, hkv, g, ps, w, e = 2, 2, 4, 16, 8, 32
    q = torch.from_numpy(rng.standard_normal((b * hkv, g, e))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, w * ps, e))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, w * ps, e))
                         .astype(np.float32))
    perm = torch.from_numpy(rng.permutation(b * w))
    pages = [torch.empty((b * w, ps, hkv, e)) for _ in range(2)]
    for dst, src in zip(pages, (k, v)):
        dst[perm] = src.reshape(b, hkv, w, ps, e).permute(0, 2, 3, 1, 4) \
            .reshape(b * w, ps, hkv, e)
    table = perm.reshape(b, w).to(torch.int32)
    kv_len = torch.tensor([100, 3], dtype=torch.int32)
    kw = dict(scale=e ** -0.5, hkv=hkv, splits=4, block_k=ps)
    dense = decode_partials_torch(q, k.reshape(b * hkv, -1, e),
                                  v.reshape(b * hkv, -1, e), kv_len, **kw)
    paged = paged_decode_partials_torch(q, *pages, table, kv_len, **kw)
    for a, c in zip(dense, paged):
        assert torch.equal(a, c)


def test_gather_pages_clamps_the_sentinel():
    _, kp, _, bt, _ = _pool_inputs(1, 2, 4, 2, 1, 16, 8, 4, 10, [20, 0])
    ours = ops.gather_pages(torch.from_numpy(kp), torch.from_numpy(bt))
    ref = _jax(jax_ops.gather_pages, kp, bt)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_cuda_paged_decode_on_cpu_tensor_raises():
    q, kp, vp, bt, kv_len = (torch.from_numpy(a) for a in _pool_inputs(
        0, 1, 4, 2, 1, 64, 16, 2, 4, [5]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_decode_paged(q, kp, vp, bt, kv_len, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.decode import paged_decode_partials_cuda
        paged_decode_partials_cuda(q[:, :, 0].reshape(2, 2, 64), kp, vp,
                                   bt, kv_len, scale=0.1, hkv=2, splits=1,
                                   block_k=16)


# ---------------------------------------------------------------------------
# page writes and the paged attention layer
# ---------------------------------------------------------------------------

def _with_sink(a: np.ndarray) -> torch.Tensor:
    """A port pool (pages + one sink page) holding ``a``'s pages."""
    t = torch.zeros((a.shape[0] + 1, *a.shape[1:]))
    t[:-1] = torch.from_numpy(a)
    return t


def test_write_pages_drops_what_the_reference_drops():
    rng = np.random.default_rng(2)
    n_pages, ps, hkv, e = 6, 4, 2, 8
    pages = rng.standard_normal((n_pages, ps, hkv, e)).astype(np.float32)
    # row 1 is unbacked past its first page (sentinel), row 2 is released
    bt = np.array([[3, 0, 5], [1, n_pages, n_pages],
                   [n_pages, n_pages, n_pages]], np.int32)
    positions = np.array([[0, 5, 11], [2, 3, 7], [0, 1, 2]], np.int32)
    valid = np.array([[True, True, False], [True, True, True],
                      [False, False, False]])
    values = rng.standard_normal((3, 3, hkv, e)).astype(np.float32)
    ref = np.asarray(jattn.write_pages(
        jnp.asarray(pages), jnp.asarray(bt), jnp.asarray(positions),
        jnp.asarray(values), 3 * ps, jnp.asarray(valid)))
    ours = attn.write_pages(_with_sink(pages), torch.from_numpy(bt),
                            torch.from_numpy(positions),
                            torch.from_numpy(values), 3 * ps,
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(ours[:-1].numpy(), ref)


def _layer_pair(models):
    params, model = models
    cfg, jcfg = get_config(NAME), jax_get_config(NAME)
    jp = jax.tree.map(lambda a: a[0], params["runs"][0][0]["attn"])
    return cfg, jcfg, jp, model.layers[0].attn, cfg.layer_specs()[0], \
        jcfg.layer_specs()[0]


@pytest.mark.parametrize("off", [0, 24])
def test_gqa_prefill_paged_matches_reference(models, off):
    """A prefill chunk into the pool (off = 0) and a prefix-hit
    continuation (off = 24, history gathered from the pages, writes below
    ``cached_len`` dropped): outputs within tolerance, pools equal page
    for page."""
    cfg, jcfg, jp, tp, spec, jspec = _layer_pair(models)
    rng = np.random.default_rng(off)
    b, s, ps, w = 2, 16, 8, 8
    n_pages = 20
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, cfg.n_kv_heads, cfg.dh)) \
        .astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    bt = np.array([[4, 9, 2, 17, 11, 0, n_pages, n_pages],
                   [7, 1, 13, 5, 3, 19, n_pages, n_pages]], np.int32)
    true_len = np.array([off + 16, off + 9], np.int32)
    cached_len = np.array([off, off + 3], np.int32)
    jc = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}
    jy, jc = jattn.gqa_prefill_paged(
        jp, jnp.asarray(x), jc, jnp.asarray(bt), off, jcfg, jspec, JRT,
        jnp.asarray(true_len), jnp.asarray(cached_len))
    tc = {"k_pages": _with_sink(kp), "v_pages": _with_sink(vp)}
    ty, tc = attn.gqa_prefill_paged(
        tp, torch.from_numpy(x), tc, torch.from_numpy(bt), off, cfg, spec,
        RT, torch.from_numpy(true_len), torch.from_numpy(cached_len))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=2e-5)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name][:-1].numpy(),
                                   np.asarray(jc[name]), rtol=1e-5,
                                   atol=1e-5)
        # pages no row maps are untouched, bit for bit
        mapped = set(bt.ravel()) - {n_pages}
        for pg in set(range(n_pages)) - mapped:
            np.testing.assert_array_equal(
                tc[name][pg].numpy(), (kp if name == "k_pages" else vp)[pg])


def test_gqa_decode_paged_matches_reference(models):
    """One decode step with an inactive slot (kv_len = 0, released table
    row): live outputs within tolerance, pools equal page for page (the
    inactive slot's write is dropped)."""
    cfg, jcfg, jp, tp, spec, jspec = _layer_pair(models)
    rng = np.random.default_rng(5)
    b, ps, n_pages = 3, 8, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, cfg.n_kv_heads, cfg.dh)) \
        .astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    bt = np.array([[3, 8, n_pages, n_pages], [n_pages] * 4,
                   [12, 0, 6, 15]], np.int32)
    kv_len = np.array([11, 0, 32], np.int32)
    jc = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}
    jy, jc = jattn.gqa_decode_paged(jp, jnp.asarray(x), jc, jnp.asarray(bt),
                                    jnp.asarray(kv_len), jcfg, jspec, JRT)
    tc = {"k_pages": _with_sink(kp), "v_pages": _with_sink(vp)}
    ty, tc = attn.gqa_decode_paged(tp, torch.from_numpy(x), tc,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(kv_len), cfg, spec, RT)
    live = kv_len > 0
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               rtol=1e-5, atol=2e-5)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name][:-1].numpy(),
                                   np.asarray(jc[name]), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# host bookkeeping (test_kv_cache.py / test_prefix_cache.py checklist)
# ---------------------------------------------------------------------------

def _kv(**kw):
    return PagedKVCache(get_config(NAME), dtype=torch.float32, device="cpu",
                        **kw)


def test_page_pool_alloc_free_reuse():
    pool = PagePool(4)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.pages_in_use == 3
    assert pool.alloc(2) is None          # insufficient → no change
    assert pool.pages_in_use == 3
    b = pool.alloc(1)
    assert pool.free_pages == 0
    pool.free(a)
    c = pool.alloc(2)                     # freed pages are reusable
    assert set(c) <= set(a)
    assert pool.peak_in_use == 4
    pool.free(b + c)
    assert pool.pages_in_use == 0


def test_page_pool_refcounts_and_double_free():
    pool = PagePool(4)
    (a, b) = pool.alloc(2)
    pool.ref(a)
    assert pool.refcount(a) == 2
    with pytest.raises(RuntimeError):
        pool.free([a])                    # freeing a shared page
    assert not pool.unref(a)
    assert pool.unref(a)
    with pytest.raises(RuntimeError):
        pool.free([a])                    # double free
    with pytest.raises(RuntimeError):
        pool.unref(a)                     # refcount never negative
    pool.free([b])
    assert pool.pages_in_use == 0 and pool.free_pages == 4
    with pytest.raises(RuntimeError):
        pool.ref(3)                       # ref of unallocated page


def test_paged_kv_cache_grow_release():
    kv = _kv(slots=2, max_len=64, page_size=16, num_pages=6)
    assert kv.classes["full"].table_width == 4
    assert kv.grow(0, 20) and kv.pages_in_use["full"] == 2
    assert kv.grow(0, 20) and kv.pages_in_use["full"] == 2
    assert kv.grow(1, 60) and kv.pages_in_use["full"] == 6
    assert not kv.grow(0, 40)             # all-or-nothing
    assert kv.pages_in_use["full"] == 6
    kv.check_invariants()
    tbl = kv.tables()["full"]
    assert tbl.shape == (2, 4) and tbl.dtype == torch.int32
    used = list(tbl[0, :2].tolist()) + list(tbl[1].tolist())
    assert len(set(used)) == 6
    kv.release(1)
    assert kv.pages_in_use["full"] == 2
    assert kv.grow(0, 40)
    kv.check_invariants()
    tiny = _kv(slots=2, max_len=64, page_size=16, num_pages=3)
    with pytest.raises(ValueError):
        tiny.validate_request(64)
    # the device pools hold the P pages plus the sink page
    assert kv.caches[0]["attn"]["k_pages"].shape[0] == 7
    assert kv.memory_stats()["num_pages"] == {"full": 6}


def test_sentinel_rows_never_live():
    kv = _kv(slots=2, max_len=64, page_size=16, num_pages=6)
    sentinel = kv.classes["full"].pool.num_pages
    assert (kv.classes["full"].table == sentinel).all()
    assert kv.grow(0, 20)
    tbl = kv.classes["full"].table
    assert (tbl[0, :2] < sentinel).all()
    assert (tbl[0, 2:] == sentinel).all() and (tbl[1] == sentinel).all()
    kv.tables()
    kv.classes["full"].table[0, 0] = sentinel     # a table slip
    with pytest.raises(AssertionError):
        kv.tables()
    kv.classes["full"].table[0, 0] = kv.classes["full"].owned[0][0]
    kv.release(0)
    assert (kv.classes["full"].table == sentinel).all()


def test_admit_never_evicts_its_own_match():
    kv = _kv(slots=2, max_len=64, page_size=16, num_pages=6)
    rng = np.random.default_rng(13)
    a = rng.integers(0, 512, 40).astype(np.int32)
    b = rng.integers(0, 512, 40).astype(np.int32)
    info = kv.admit(0, a, 41)
    assert info is not None and info["cached_len"] == 0
    kv.release(0, tokens=a)
    assert kv.match_prefix(a) == 2
    assert kv.admit(1, b, 41) is not None
    c = np.concatenate([a, rng.integers(0, 512, 13).astype(np.int32)])
    pool = kv.classes["full"].pool
    entries, free = len(kv._prefix), pool.free_pages
    assert kv.admit(0, c, len(c) + 1) is None
    assert kv.match_prefix(a) == 2
    assert len(kv._prefix) == entries and pool.free_pages == free
    assert kv.classes["full"].owned[0] == []
    kv.check_invariants()


def _host_state(kv):
    c = kv.classes["full"]
    return (c.table.tolist(), [list(o) for o in c.owned],
            dict(c.pool._refcount), list(c.pool._free),
            {h: (e.page, e.parent, e.last_used)
             for h, e in kv._prefix.items()},
            kv.stats["prefix_evictions"], c.pool.peak_in_use,
            c.peak_live_pages)


def test_host_bookkeeping_equals_the_reference_step_for_step():
    """The same admit / grow / release / COW sequence on the port's and
    the reference's PagedKVCache: equal tables, owned rows, refcounts,
    free lists, prefix index and counters after every step."""
    kw = dict(slots=3, max_len=64, page_size=8, num_pages=14)
    ours = _kv(**kw)
    ref = JaxPagedKVCache(jax_get_config(NAME), dtype=jnp.float32, **kw)
    rng = np.random.default_rng(21)
    shared = rng.integers(0, 512, 16)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n)])
               .astype(np.int32) for n in (5, 0, 12, 3)]
    prompts.append(rng.integers(0, 512, 30).astype(np.int32))
    stream0 = np.concatenate([prompts[0], rng.integers(0, 512, 9)])
    results = []
    for kv in (ours, ref):
        out = []

        def step(what, value):
            out.append((what, value, _host_state(kv)))

        step("admit0", kv.admit(0, prompts[0], len(prompts[0]) + 1))
        step("admit1", kv.admit(1, prompts[1], len(prompts[1]) + 1))
        pairs = out[-1][1]["cow_pairs"]
        if kv is ours:
            kv.apply_cow(kv.caches, pairs)
        else:
            kv.caches = kv.apply_cow(kv.caches, pairs)
        step("cow", None)
        step("grow0", kv.grow(0, len(prompts[0]) + 9))
        step("admit2", kv.admit(2, prompts[2], len(prompts[2]) + 1))
        step("release0", kv.release(0, tokens=stream0))
        step("admit0b", kv.admit(0, prompts[4], len(prompts[4]) + 1))
        step("grow2", kv.grow(2, 60))
        step("release1", kv.release(1, tokens=prompts[1]))
        step("admit1b", kv.admit(1, prompts[3], len(prompts[3]) + 1))
        step("release_all", [kv.release(s) for s in range(3)])
        kv.check_invariants()
        step("clear", kv.clear_prefix())
        results.append(out)
    for a, b in zip(*results):
        assert a[0] == b[0]
        assert a[1] == b[1], a[0]
        assert a[2] == b[2], a[0]
    assert ours.memory_stats() == ref.memory_stats()


# ---------------------------------------------------------------------------
# the engine: against the reference, and the layouts against each other
# ---------------------------------------------------------------------------

def _serve(engine_cls, req_cls, cfg, model, prompts, budgets, rt, audit,
           **kw):
    eng = engine_cls(cfg, model, rt=rt, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        steps += 1
        assert steps < 500
        if audit and eng.kv is not None:
            eng.kv.check_invariants()      # every step ends quiescent
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng


def _ours(models, prompts, budgets, **kw):
    return _serve(ServeEngine, Request, get_config(NAME), models[1], prompts,
                  budgets, RT, True, device="cpu", **kw)


def _theirs(models, prompts, budgets, **kw):
    return _serve(JaxServeEngine, JaxRequest, jax_get_config(NAME),
                  models[0], prompts, budgets, JRT, False, **kw)


def _mixed_trace(seed=1):
    rng = np.random.default_rng(seed)
    lens = [5, 17, 9, 30, 3, 12]
    return ([rng.integers(0, 512, n).astype(np.int32) for n in lens],
            [7, 3, 10, 5, 1, 6])


def _shared_trace(seed=0, page=16):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, 2 * page)
    prompts = [np.concatenate([shared, rng.integers(0, 512, t)])
               .astype(np.int32) for t in (8, 5, 11, 8, 3, 9)]
    prompts.append(prompts[0][:2 * page].copy())     # page-aligned: COW
    return prompts, [5, 4, 6, 5, 3, 5, 4]


@pytest.mark.parametrize("trace,engine_kw", [
    ("mixed", dict(slots=4, max_len=64, decode_chunk=4)),
    ("mixed", dict(slots=2, max_len=48, decode_chunk=8, prefill_chunk=8,
                   page_size=8)),
    ("shared", dict(slots=2, max_len=64, decode_chunk=4)),
    ("shared", dict(slots=3, max_len=64, decode_chunk=4, page_size=8,
                    num_pages=14)),
], ids=["mixed", "mixed-chunked", "shared-prefix", "shared-prefix-small"])
def test_paged_engine_matches_reference(models, trace, engine_kw):
    prompts, budgets = _mixed_trace() if trace == "mixed" else \
        _shared_trace(page=engine_kw.get("page_size", 16))
    kw = dict(cache_layout="paged", **engine_kw)
    ours, teng = _ours(models, prompts, budgets, **kw)
    theirs, jeng = _theirs(models, prompts, budgets, **kw)
    assert ours == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.memory_stats() == jeng.memory_stats()
    if trace == "shared":
        assert teng.stats["tokens_reused"] > 0
        assert teng.stats["cow_copies"] > 0
    assert teng.logits_finite()


def test_dense_and_paged_streams_equal(models):
    prompts, budgets = _mixed_trace(3)
    kw = dict(slots=3, max_len=64, decode_chunk=4)
    dense, _ = _ours(models, prompts, budgets, **kw)
    paged, pe = _ours(models, prompts, budgets, cache_layout="paged", **kw)
    assert dense == paged
    m = pe.memory_stats()
    assert m["resident_cache_bytes"] == 0
    assert 0 < m["peak_resident_cache_bytes"] < m["physical_cache_bytes"]


def test_preemption_on_pool_exhaustion_gives_the_dense_streams(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (11, 16, 6, 14)]
    budgets = [6] * 4
    kw = dict(slots=2, max_len=64, decode_chunk=4)
    dense, _ = _ours(models, prompts, budgets, **kw)
    paged, pe = _ours(models, prompts, budgets, cache_layout="paged",
                      page_size=8, num_pages=5, **kw)
    theirs, je = _theirs(models, prompts, budgets, cache_layout="paged",
                         page_size=8, num_pages=5, **kw)
    assert dense == paged == theirs
    assert pe.stats["preemptions"] > 0
    assert pe.stats["preemptions"] == je.stats["preemptions"]
    pe.clear_prefix_cache()
    assert all(v == 0 for v in pe.kv.pages_in_use.values())
    pe.kv.check_invariants()


def test_prefix_cache_on_and_off_give_the_same_streams(models):
    prompts, budgets = _shared_trace(5)
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout="paged")
    warm, we = _ours(models, prompts, budgets, **kw)
    cold, ce = _ours(models, prompts, budgets, prefix_caching=False, **kw)
    dense, _ = _ours(models, prompts, budgets, slots=2, max_len=64,
                     decode_chunk=4)
    assert warm == cold == dense
    assert we.stats["tokens_reused"] > 0 and ce.stats["tokens_reused"] == 0
    total = sum(len(p) for p in prompts)
    assert we.stats["tokens_prefilled"] == total - we.stats["tokens_reused"]


def test_cow_isolation_on_divergence(models):
    """A prompt exactly covering its hit re-prefills its last token into a
    COW copy; the index-held pages stay bitwise untouched."""
    rng = np.random.default_rng(3)
    p32 = rng.integers(0, 512, 32).astype(np.int32)
    pdiv = p32.copy()
    pdiv[20] = (pdiv[20] + 1) % 512
    eng = ServeEngine(get_config(NAME), models[1], slots=2, max_len=64,
                      rt=RT, decode_chunk=4, cache_layout="paged",
                      device="cpu")
    first = Request(rid=0, prompt=p32, max_new_tokens=4)
    eng.submit(first)
    eng.run()
    donor = [e.page for e in eng.kv._prefix.values()]
    assert len(donor) >= 2
    snap = [(c["attn"]["k_pages"][donor].clone(),
             c["attn"]["v_pages"][donor].clone()) for c in eng.caches]
    second = Request(rid=1, prompt=p32, max_new_tokens=4)
    third = Request(rid=2, prompt=pdiv, max_new_tokens=4)
    eng.submit(second)
    eng.submit(third)
    eng.run()
    assert eng.stats["cow_copies"] >= 1
    for c, (k, v) in zip(eng.caches, snap):
        assert torch.equal(c["attn"]["k_pages"][donor], k)
        assert torch.equal(c["attn"]["v_pages"][donor], v)
    dense, _ = _ours(models, [p32, p32, pdiv], [4, 4, 4], slots=2,
                     max_len=64, decode_chunk=4)
    assert [first.generated, second.generated, third.generated] == dense
    eng.kv.check_invariants()


def test_prefix_eviction_under_pool_pressure(models):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (18, 25, 21, 30)]
    budgets = [4] * 4
    kw = dict(slots=2, max_len=64, decode_chunk=4)
    dense, _ = _ours(models, prompts, budgets, **kw)
    paged, pe = _ours(models, prompts, budgets, cache_layout="paged",
                      page_size=8, num_pages=8, **kw)
    assert dense == paged
    assert pe.kv.stats["prefix_evictions"] > 0
    pe.clear_prefix_cache()
    assert all(v == 0 for v in pe.kv.pages_in_use.values())


def test_page_aligned_stream_end_not_indexed(models):
    """A finished slot's masked decode steps rewrite its stream's last
    position; when the stream is page-aligned that page must not enter
    the index, and a prompt extending the stream still matches dense."""
    rng = np.random.default_rng(11)
    pa, pb = (rng.integers(0, 512, 6).astype(np.int32) for _ in range(2))
    tail = rng.integers(0, 512, 4).astype(np.int32)

    def run(layout, **kw):
        eng = ServeEngine(get_config(NAME), models[1], slots=2, max_len=64,
                          rt=RT, decode_chunk=8, cache_layout=layout,
                          device="cpu", **kw)
        ra = Request(rid=0, prompt=pa, max_new_tokens=2)
        rb = Request(rid=1, prompt=pb, max_new_tokens=10)
        eng.submit(ra)
        eng.submit(rb)
        eng.run()
        pc = np.concatenate([pa, np.asarray(ra.generated, np.int32), tail])
        if eng.kv is not None:
            assert eng.kv.match_prefix(pc) == 0
        rc = Request(rid=2, prompt=pc, max_new_tokens=4)
        eng.submit(rc)
        eng.run()
        return [list(r.generated) for r in (ra, rb, rc)], eng

    dense, _ = run("dense")
    paged, pe = run("paged", page_size=8)
    assert dense == paged
    assert pe.stats["prefix_hits"] == 0


def test_pool_drains_to_full_on_idle(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (20, 33, 17)]
    _, eng = _ours(models, prompts, [5, 5, 5], slots=2, max_len=64,
                   decode_chunk=4, cache_layout="paged")
    kv, pool = eng.kv, eng.kv.classes["full"].pool
    m = eng.memory_stats()
    assert m["resident_cache_bytes"] == 0
    assert m["prefix_cache"]["entries"] == pool.pages_in_use > 0
    assert eng.clear_prefix_cache() == m["prefix_cache"]["entries"]
    assert pool.pages_in_use == 0 and pool.free_pages == pool.num_pages
    kv.check_invariants()


def test_warmup_leaves_an_empty_index_and_the_same_streams(models):
    prompts, budgets = _shared_trace(2)
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout="paged")
    eng = ServeEngine(get_config(NAME), models[1], rt=RT, device="cpu", **kw)
    assert eng.warmup(sorted({len(p) for p in prompts})) > 0
    assert len(eng.kv._prefix) == 0 and eng.kv.prefix_enabled
    assert all(v == 0 for v in eng.stats.values())
    assert eng.kv.pages_in_use["full"] == 0
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    cold, _ = _ours(models, prompts, budgets, **kw)
    assert [r.generated for r in reqs] == cold


def test_pool_defaults_to_cuda_and_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(get_config(NAME), 2, 32, torch.float32)


@pytest.mark.parametrize("kw,item", [
    # the sharded pool is ported; a shard count that does not divide the
    # kv heads is refused with the reference's message
    (dict(shard=KVShard(("cpu", "cpu"))),
     "n_kv_heads=1 is not divisible by tp=2"),
])
def test_unported_pool_options_name_their_roadmap_item(kw, item):
    with pytest.raises(ValueError, match=item):
        _kv(slots=1, max_len=32, page_size=16, **kw)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--requests", "5", "--slots", "2", "--max-len", "64",
        "--prompt-len", "20", "--prompt-len-max", "40", "--new-tokens", "4",
        "--shared-prefix-len", "16", "--cache-layout", "both",
        "--repeats", "1", "--no-warmup", "--arch", NAME]


def test_launcher_both_layouts_match_and_keep_the_reference_schema(
        tmp_path):
    from repro.launch import serve as jax_serve

    out = tmp_path / "bench.json"
    ours = serve.main(["--device", "cpu", "--json", str(out)] + ARGV)
    saved = json.loads(out.read_text())
    assert saved["outputs_match"] is True
    assert list(saved["layouts"]) == ["dense", "paged", "paged_noprefix"]
    assert saved["layouts"]["paged"]["prefix"]["tokens_reused"] > 0
    assert saved["layouts"]["paged"]["kernel_launches"] == {
        "fusemax_prefill": 0, "decode_partials": 0,
        "paged_decode_partials": 0, "mla_paged_decode_partials": 0,
        "latent_decode_partials": 0}
    ref = jax_serve.main(["--json", str(tmp_path / "ref.json")] + ARGV)
    assert set(ref) <= set(saved), set(ref) - set(saved)
    assert ref["outputs_match"] is True
    for lo, leg in ref["layouts"].items():
        mine = saved["layouts"][lo]
        assert set(leg) <= set(mine), (lo, set(leg) - set(mine))
        for k in ("dispatches", "tokens_decoded", "preemptions",
                  "peak_live_tokens", "prefix", "prefix_caching"):
            assert mine[k] == leg[k], (lo, k)
        assert set(leg["memory"]) <= set(mine["memory"]), lo
    assert ours["_outputs_by_layout"]["paged"] == \
        ours["_outputs_by_layout"]["dense"]
