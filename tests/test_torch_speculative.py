"""The port's speculative verify (model) and draft pages (cache) against the
JAX reference.

* model — ``transformer.verify_step`` scores a P-token chain against the
  cache: the port's (plain kernels on the CPU: K2/K3's and the latent
  kernels' torch versions at P·G / P·H rows) against the reference's
  with its jnp executors and its Pallas kernels in interpret mode, on the
  dense and the paged layout, GQA (``stablelm-1.6b-smoke``) and MLA (the
  reference test's 2-layer ``MLA_CFG``), at ragged ``kv_len`` and
  ``span``, from the same numpy-seeded caches and bridged weights; and
  against P sequential port ``decode_step`` calls;
* cache — reserve / commit / drop of scratch draft pages driven on the
  port's and the reference's ``PagedKVCache`` by the same calls: the same
  tables, refcounts, owned / scratch rows and free list after each;
* proposer — the port's copy of ``NGramProposer`` proposes what the
  reference's does on random histories (a hypothesis property).

Tolerances: fp32 paths differ only in summation order — logits agree to
1e-5 of their scale; the chain's cache writes to rtol = atol = 1e-5;
every cache entry the chain must not write (past ``span``, past the
cache, other pages) stays bit for bit what it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving import speculate as jspec
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.model import attention as attn
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import speculate
from repro_torch.serving.kv_cache import PagedKVCache

RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
JRT = {"jnp": JaxRuntime(activation_dtype=jnp.float32,
                         param_dtype=jnp.float32),
       "pallas": JaxRuntime(attn_impl="pallas", interpret=True,
                            activation_dtype=jnp.float32,
                            param_dtype=jnp.float32)}
GQA = "stablelm-1.6b-smoke"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_REL = 1e-5

MLA_KW = dict(name="mla-spec-test", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=64)
MLA_LATENT = dict(q_lora_rank=64, kv_lora_rank=32, rope_dim=16, nope_dim=32,
                  v_dim=32)


def _cfgs(which: str):
    if which == "gqa":
        return jax_get_config(GQA), get_config(GQA)
    return (JaxModelConfig(**MLA_KW, mla=JaxMLAConfig(**MLA_LATENT)),
            ModelConfig(**MLA_KW, mla=MLAConfig(**MLA_LATENT)))


@pytest.fixture(scope="module", params=["gqa", "mla"])
def models(request):
    jcfg, cfg = _cfgs(request.param)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT["jnp"])
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return request.param, jcfg, cfg, params, model


# ---------------------------------------------------------------------------
# model: verify_step
# ---------------------------------------------------------------------------

B, MAX_LEN, P_TOTAL = 3, 32, 5
#: committed lengths incl. chain position 0 (kv_len), and real chain
#: positions (span): a full chain, a cut one, and one whose tail would run
#: past the cache (positions 30, 31, 32, 33 of a 32-slot row: two drop)
KV_LEN = np.array([7, 18, 31], np.int32)
SPAN = np.array([P_TOTAL, 2, 4], np.int32)
PAGE, N_PAGES = 8, 16


def _dense_caches(cfg, seed):
    """Per-layer dense caches filled from numpy: [layer][name] arrays."""
    rng = np.random.default_rng(seed)
    shapes = ({"ckv": (B, MAX_LEN, cfg.mla.kv_lora_rank),
               "krope": (B, MAX_LEN, cfg.mla.rope_dim)} if cfg.mla else
              {"k": (B, cfg.n_kv_heads, MAX_LEN, cfg.dh),
               "v": (B, cfg.n_kv_heads, MAX_LEN, cfg.dh)})
    return [{n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()} for _ in range(cfg.n_layers)]


def _paged_caches(cfg, seed):
    """Per-layer page pools of ``N_PAGES`` pages (no sink) and a permuted
    block table: row b holds the pages of its chain's real positions (up
    to the table's end), the rest of the row the sentinel."""
    rng = np.random.default_rng(seed)
    shapes = ({"ckv_pages": (N_PAGES, PAGE, cfg.mla.kv_lora_rank),
               "krope_pages": (N_PAGES, PAGE, cfg.mla.rope_dim)}
              if cfg.mla else
              {"k_pages": (N_PAGES, PAGE, cfg.n_kv_heads, cfg.dh),
               "v_pages": (N_PAGES, PAGE, cfg.n_kv_heads, cfg.dh)})
    pools = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(cfg.n_layers)]
    w = MAX_LEN // PAGE
    table = np.full((B, w), N_PAGES, np.int32)
    perm = rng.permutation(N_PAGES)
    at = 0
    for b, n in enumerate(KV_LEN):
        need = min(w, -(-(int(n) + int(SPAN[b]) - 1) // PAGE))
        table[b, :need] = perm[at:at + need]
        at += need
    return pools, table


def _to_port(arrays, sink: bool):
    out = []
    for layer in arrays:
        c = {}
        for n, a in layer.items():
            t = torch.from_numpy(a.copy())
            if sink:                       # the port's pools carry one more
                t = torch.cat([t, torch.zeros_like(t[:1])])
            c[n] = t
        out.append({"attn": c})
    return out


def _runs(jcfg):
    """(run, position, reps, depth-ordered layers) of the reference's
    run-grouped cache tree (a run of reps > 1 stacks its layers)."""
    layer = 0
    for pattern, reps in jcfg.runs():
        pos = []
        for j in range(len(pattern)):
            pos.append([layer + r * len(pattern) + j for r in range(reps)])
        yield pos, reps
        layer += reps * len(pattern)


def _to_jax(jcfg, arrays):
    out = []
    for pos, reps in _runs(jcfg):
        run = []
        for layers in pos:
            names = arrays[layers[0]]
            run.append({"attn": {n: jnp.asarray(
                np.stack([arrays[i][n] for i in layers]) if reps > 1
                else arrays[layers[0]][n]) for n in names}})
        out.append(run)
    return out


def _port_arrays(caches, sink: bool):
    return [{n: (t[:-1] if sink else t).numpy() for n, t in c["attn"].items()}
            for c in caches]


def _jax_arrays(jcfg, caches):
    out = {}
    for (pos, reps), run in zip(_runs(jcfg), caches):
        for layers, c in zip(pos, run):
            for r, i in enumerate(layers):
                out[i] = {n: np.asarray(a[r] if reps > 1 else a)
                          for n, a in c["attn"].items()}
    return [out[i] for i in sorted(out)]


def _chain(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, P_TOTAL)).astype(np.int32)


def _assert_logits(ours, ref):
    scale = float(np.abs(ref).max())
    for b in range(B):
        for j in range(int(SPAN[b])):
            np.testing.assert_allclose(ours[b, j], ref[b, j], rtol=0,
                                       atol=LOGIT_REL * scale)
            assert int(np.argmax(ours[b, j])) == int(np.argmax(ref[b, j]))


def _assert_caches(ours, ref, init):
    """Written entries agree to summation order; every entry the
    reference left alone is untouched in the port too (bitwise)."""
    for lo, lr, li in zip(ours, ref, init):
        for n in lr:
            same = lr[n] == li[n]
            np.testing.assert_array_equal(lo[n][same], li[n][same],
                                          err_msg=n)
            np.testing.assert_allclose(lo[n], lr[n], **F32_TOL, err_msg=n)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_matches_the_reference(models, layout, impl):
    """Logits at every real chain position and the caches after the
    chain's writes, dense (past-span and past-cache positions dropped
    without a sink row) and paged (masked writes in the sink page)."""
    _, jcfg, cfg, params, model = models
    chain = _chain(cfg, 1)
    if layout == "dense":
        init = _dense_caches(cfg, 2)
        ours, tables, jtables, sink = _to_port(init, False), None, None, False
    else:
        init, table = _paged_caches(cfg, 2)
        ours, sink = _to_port(init, True), True
        tables = {"full": torch.from_numpy(table)}
        jtables = {"full": jnp.asarray(table)}
    jlog, jcaches = jtf.verify_step(
        jcfg, params, jnp.asarray(chain), _to_jax(jcfg, init),
        jnp.asarray(KV_LEN), jnp.asarray(SPAN), JRT[impl],
        block_tables=jtables)
    logits, ours = tf.verify_step(
        cfg, model, torch.from_numpy(chain), ours,
        torch.from_numpy(KV_LEN), torch.from_numpy(SPAN), RT,
        block_tables=tables)
    assert logits.shape == (B, P_TOTAL, cfg.vocab)
    _assert_logits(logits.numpy(), np.asarray(jlog))
    _assert_caches(_port_arrays(ours, sink), _jax_arrays(jcfg, jcaches),
                   init)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_matches_stepwise_decode(models, layout):
    """``logits[:, j]`` of one verify call equals what ``decode_step``
    returns after committing the chain prefix, one row and one position at
    a time (the accept rule's induction step), at every real chain
    position inside the cache; the chain's cache entries equal the
    stepwise ones."""
    _, _, cfg, _, model = models
    chain = torch.from_numpy(_chain(cfg, 3))
    if layout == "dense":
        init = _dense_caches(cfg, 4)
        table, sink = None, False
    else:
        init, table = _paged_caches(cfg, 4)
        table, sink = torch.from_numpy(table), True
    # the engine never lets a chain run past the cache (a paged write there
    # wraps onto the row's first page, as the reference's does)
    live = np.minimum(SPAN, MAX_LEN - KV_LEN + 1)
    kv_len, span = torch.from_numpy(KV_LEN), torch.from_numpy(live)
    logits, ver = tf.verify_step(
        cfg, model, chain, _to_port(init, sink), kv_len, span, RT,
        block_tables=None if table is None else {"full": table})
    step = _to_port(init, sink)
    for b in range(B):
        rows = [{"attn": {n: t if sink else t[b:b + 1]
                          for n, t in c["attn"].items()}} for c in step]
        for j in range(int(live[b])):
            lg, _ = tf.decode_step(
                cfg, model, chain[b:b + 1, j:j + 1], rows, kv_len[b:b + 1] + j,
                RT, block_tables=None if table is None
                else {"full": table[b:b + 1]})
            np.testing.assert_allclose(
                logits[b, j].numpy(), lg[0].numpy(), rtol=0,
                atol=LOGIT_REL * float(lg.abs().max()), err_msg=(b, j))
            assert int(logits[b, j].argmax()) == int(lg[0].argmax())
    for lv, ls in zip(_port_arrays(ver, sink), _port_arrays(step, sink)):
        for n in lv:
            np.testing.assert_allclose(lv[n], ls[n], **F32_TOL, err_msg=n)


def test_dense_chain_write_never_aliases():
    """``write_chain_dense``: kept positions land, the rest of the row
    keeps its old bits, at every cut of the chain by span and by the end
    of the cache."""
    m, p = 6, 4
    rng = np.random.default_rng(5)
    for kv in range(0, m + 2):
        for sp in range(0, p + 1):
            cache = torch.from_numpy(rng.standard_normal((1, m, 3))
                                     .astype(np.float32))
            want = cache.clone()
            new = torch.from_numpy(rng.standard_normal((1, p, 3))
                                   .astype(np.float32))
            for j in range(sp):
                if 0 <= kv - 1 + j < m:
                    want[0, kv - 1 + j] = new[0, j]
            attn.write_chain_dense(cache, new, torch.tensor([kv]),
                                   torch.tensor([sp]))
            assert torch.equal(cache, want), (kv, sp)


# ---------------------------------------------------------------------------
# cache: draft pages by block-table surgery
# ---------------------------------------------------------------------------

def _pair(num_pages=10, page_size=8, slots=2, max_len=64, prefix=False):
    kw = dict(page_size=page_size, num_pages=num_pages,
              prefix_caching=prefix)
    return (PagedKVCache(get_config(GQA), slots, max_len, torch.float32,
                         device="cpu", **kw),
            JaxPagedKVCache(jax_get_config(GQA), slots, max_len,
                            jnp.float32, **kw))


def _state(kv):
    c = kv.classes["full"]
    return (c.table.tolist(), dict(c.pool._refcount), list(c.pool._free),
            [list(o) for o in c.owned], [list(s) for s in c.scratch])


def _both(pair, call, audit: bool = True):
    """Run ``call`` on both pools; results and states must agree, and the
    port's pool must audit clean (``audit``: no outside reference held)."""
    ours, ref = (call(kv) for kv in pair)
    assert ours == ref
    assert _state(pair[0]) == _state(pair[1])
    if audit:
        pair[0].check_invariants()
    return ours


def test_draft_lifecycle_equals_the_reference():
    """admit → reserve → partial commit (same page) → reserve → commit
    into scratch → reserve → drop → release: the same tables, refcounts,
    owned / scratch rows and free list at every step, and the free list
    restored at the end."""
    pair = _pair()
    free0 = _state(pair[0])[2]
    _both(pair, lambda kv: kv.admit(0, np.arange(12, dtype=np.int32), 13)
          ["cached_len"])
    assert _both(pair, lambda kv: kv.reserve_draft(0, 12, 17)) == []
    assert len(pair[0].classes["full"].scratch[0]) == 1
    assert pair[0].memory_stats()["draft_pages"] == {"full": 1}
    _both(pair, lambda kv: kv.tables() and None)
    _both(pair, lambda kv: kv.commit_draft(0, 14))
    _both(pair, lambda kv: kv.reserve_draft(0, 14, 19))
    _both(pair, lambda kv: kv.commit_draft(0, 17))
    assert len(pair[0].classes["full"].owned[0]) == 3
    _both(pair, lambda kv: kv.reserve_draft(0, 17, 22))
    _both(pair, lambda kv: kv.drop_draft(0))
    _both(pair, lambda kv: kv.release(0))
    assert sorted(_state(pair[0])[2]) == sorted(free0)
    assert pair[0].memory_stats()["draft_pages"] == {"full": 0}


def test_release_drains_a_staged_draft():
    """The preemption contract: ``release`` with a draft staged unrefs
    every scratch page before the slot requeues; with the prefix cache on,
    scratch pages never reach the index."""
    pair = _pair(prefix=True)
    toks = np.arange(12, dtype=np.int32)
    _both(pair, lambda kv: kv.admit(0, toks, 13)["cached_len"])
    _both(pair, lambda kv: kv.reserve_draft(0, 12, 18))
    _both(pair, lambda kv: kv.release(0, tokens=np.arange(17,
                                                          dtype=np.int32)))
    assert all(not s for s in pair[0].classes["full"].scratch)
    _both(pair, lambda kv: kv.clear_prefix())
    assert pair[0].classes["full"].pool.free_pages == 10


def test_cow_at_a_shared_mid_page_boundary():
    """A draft whose first write lands inside a page another owner still
    references copies that page: the slot's reference moves to the copy,
    and a commit inside the copied page keeps refcounts exact."""
    pair = _pair()
    _both(pair, lambda kv: kv.admit(0, np.arange(12, dtype=np.int32), 13)
          ["cached_len"])
    boundary = pair[0].classes["full"].owned[0][1]
    for kv in pair:
        kv.classes["full"].pool.ref(boundary)       # another reader
    pairs = _both(pair, lambda kv: kv.reserve_draft(0, 12, 17), audit=False)
    assert len(pairs) == 1 and pairs[0][:2] == ("full", boundary)
    # the copy itself: the port's pages[dst] = pages[src] in every layer
    ours = pair[0]
    for c in ours.caches:
        c["attn"]["k_pages"][boundary] = 1.0
    ours.caches = ours.apply_cow(ours.caches, pairs)
    pair[1].caches = pair[1].apply_cow(pair[1].caches, pairs)
    dst = pairs[0][2]
    assert all(bool((c["attn"]["k_pages"][dst] == 1.0).all())
               for c in ours.caches)
    assert _state(ours) == _state(pair[1])
    _both(pair, lambda kv: kv.commit_draft(0, 15), audit=False)
    _both(pair, lambda kv: kv.release(0), audit=False)
    for kv in pair:
        kv.classes["full"].pool.unref(boundary)
    ours.check_invariants()
    assert _state(ours)[2] == _state(pair[1])[2]
    assert ours.classes["full"].pool.free_pages == 10


def test_reserve_draft_is_all_or_nothing_and_evicts_prefix_pages():
    """A pool short of pages leaves the state unchanged (None); with the
    prefix cache on, index-only pages are evicted to back a draft, as the
    reference does."""
    pair = _pair(num_pages=4, prefix=True)
    _both(pair, lambda kv: kv.admit(0, np.arange(16, dtype=np.int32), 17)
          ["cached_len"])
    _both(pair, lambda kv: kv.release(0, tokens=np.arange(
        17, dtype=np.int32)))
    _both(pair, lambda kv: kv.admit(1, np.arange(100, 108, dtype=np.int32),
                                    9)["cached_len"])
    assert _both(pair, lambda kv: kv.reserve_draft(1, 8, 40)) is None
    assert _both(pair, lambda kv: kv.reserve_draft(1, 8, 30)) == []
    assert pair[0].stats["prefix_evictions"] == \
        pair[1].stats["prefix_evictions"]
    _both(pair, lambda kv: kv.commit_draft(1, 9))


def test_scratch_guards():
    pair = _pair()
    _both(pair, lambda kv: kv.admit(0, np.arange(12, dtype=np.int32), 13)
          ["cached_len"])
    _both(pair, lambda kv: kv.reserve_draft(0, 12, 18))
    for kv in pair:
        with pytest.raises(RuntimeError, match="already has a staged"):
            kv.reserve_draft(0, 12, 18)        # one staged draft per slot
        with pytest.raises(RuntimeError, match="staged draft"):
            kv.grow(0, 30)                     # growth under a draft
        with pytest.raises(RuntimeError, match="needs"):
            kv.commit_draft(0, 40)             # past the staged pages
    _both(pair, lambda kv: kv.drop_draft(0))
    _both(pair, lambda kv: kv.drop_draft(0))   # idempotent


def test_draft_branch_shares_the_trunk_by_reference():
    pair = _pair()
    _both(pair, lambda kv: kv.admit(0, np.arange(16, dtype=np.int32), 17)
          ["cached_len"])
    c = pair[0].classes["full"]
    trunk = list(c.owned[0])
    free = c.pool.free_pages
    br = speculate.DraftBranch(c.pool, trunk, scratch_pages=2)
    jbr = jspec.DraftBranch(pair[1].classes["full"].pool, trunk, 2)
    assert br.row == jbr.row and br.row[:len(trunk)] == trunk
    assert [c.pool.refcount(p) for p in trunk] == [2] * len(trunk)
    assert c.pool.free_pages == free - 2
    assert br.close(keep_scratch=1) == jbr.close(keep_scratch=1)
    assert _state(pair[0]) == _state(pair[1])
    with pytest.raises(RuntimeError, match="cannot back"):
        speculate.DraftBranch(c.pool, trunk, scratch_pages=99)
    assert _state(pair[0]) == _state(pair[1])


# ---------------------------------------------------------------------------
# proposer
# ---------------------------------------------------------------------------

_OPS = st.lists(st.tuples(st.integers(0, 3), st.integers(0, 5),
                          st.lists(st.integers(0, 6), min_size=1,
                                   max_size=9)),
                max_size=60)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, k=st.integers(1, 6), max_n=st.integers(1, 4))
def test_ngram_proposer_equals_the_reference(ops, k, max_n):
    """The same begin / extend / finish / propose sequence on random
    histories (small vocabularies, so n-grams repeat) gives the same
    proposals from the port's copy as from the reference's, and a small
    ``max_streams`` exercises the eviction of old streams."""
    ours = speculate.NGramProposer(k=k, max_n=max_n, max_streams=3)
    ref = jspec.NGramProposer(k=k, max_n=max_n, max_streams=3)
    for op, rid, toks in ops:
        for p in (ours, ref):
            if op == 0:
                p.begin(rid, toks)
            elif op == 1:
                p.extend(rid, toks)
            elif op == 2:
                p.finish(rid)
        if op == 3:
            got, want = ours.propose(rid), ref.propose(rid)
            assert got.dtype == want.dtype and list(got) == list(want)
            assert len(got) <= k
        assert list(ours.propose(rid, k=2)) == list(ref.propose(rid, k=2))


def test_ngram_proposer_drafts_a_duplicate_stream():
    p = speculate.NGramProposer(k=4)
    prompt, gen = [3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5]
    p.begin(0, prompt)
    p.extend(0, gen)
    p.finish(0)
    p.begin(1, prompt)
    assert list(p.propose(1)) == gen[:4]
    p.extend(1, gen[:3])
    assert list(p.propose(1)) == gen[3:6]
    p.clear()
    assert list(p.propose(1)) == []
    with pytest.raises(ValueError, match="k >= 1"):
        speculate.NGramProposer(k=0)
