"""The decode step as a captured graph: what the CPU can hold it to.

A CUDA graph replays the addresses it captured, so the port's serving
engine keeps every cache leaf in its storage for its whole life and steps
through static buffers (``repro_torch.model.transformer.DecodeState``,
``repro_torch.model.decode_graph``).  The capture
itself runs only on the card (chip_smoke's ``decode_graph`` phase holds
replays to the eager loop there); here:

(a) every cache leaf's address is the same after admission, prefill and
    decode steps as at construction, for GQA (granite), rings (gemma2),
    MLA + MoE (DeepSeek), Mamba (hymba) and mLSTM / sLSTM (xlstm) on both
    layouts and on an fp8 pool;
(b) ``decode_loop``, whose one step body writes in place, equals the
    loop written functionally (multinomial sampling included) bit for bit
    — tokens, logits, kv_len, remaining and caches — runs a given step on
    a given state (the engine's graph path) and its greedy stream equals
    the reference's ``repro.model.transformer.decode_loop``;
(c) a trace that admits, preempts, hits the prefix cache, copies on write
    and swaps leaves every leaf where it was;
(d) the launch counters' delta x replays accounting, on the kernels'
    own list of counted wrappers;
(e) ``DecodeGraph`` refuses a CPU state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import COUNTED_WRAPPERS
from repro_torch.kernels import decode as dec
from repro_torch.kernels import fusemax as fm
from repro_torch.model import decode_graph as dg
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)


def _leaf_sig(engine) -> list:
    return dg.signature(dg.cache_leaves(engine.caches))


def _model(name, seed=0):
    return tf.init(get_config(name), seed=seed, rt=RT, device="cpu")


# ---------------------------------------------------------------------------
# (a) leaf addresses across prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", ["granite-3-8b-smoke", "gemma2-9b-smoke",
                                  "deepseek-v3-671b-smoke",
                                  "hymba-1.5b-smoke", "xlstm-125m-smoke"])
def test_leaves_keep_their_storage_through_decode(name, layout):
    cfg = get_config(name)
    eng = ServeEngine(cfg, _model(name), rt=RT, device="cpu", slots=2,
                      max_len=32, decode_chunk=1, cache_layout=layout,
                      page_size=8)
    sig0 = _leaf_sig(eng)
    logits0 = eng._last_logits.data_ptr()
    assert eng.decode_graph_mode == "eager: cpu"
    rng = np.random.default_rng(0)
    for rid, n in enumerate((9, 5)):
        eng.submit(Request(rid=rid, max_new_tokens=4,
                           prompt=rng.integers(0, cfg.vocab, n).astype(
                               np.int32)))
    eng.step()                                # admission, prefill, step 1
    bufs = dg.signature(eng._decode_state.buffers())
    for _ in range(3):                        # three more decode steps
        eng.step()
    assert eng.stats["decode_steps"] == 4
    assert _leaf_sig(eng) == sig0
    assert dg.signature(eng._decode_state.buffers()) == bufs
    assert eng._last_logits.data_ptr() == logits0
    assert eng.stats["decode_graph_replays"] == 0


def test_fp8_pool_leaves_keep_their_storage():
    name = "granite-3-8b-smoke"
    cfg = get_config(name)
    eng = ServeEngine(cfg, _model(name), rt=RT, device="cpu", slots=2,
                      max_len=32, decode_chunk=2, cache_layout="paged",
                      page_size=8, kv_dtype="fp8_e4m3")
    sig0 = _leaf_sig(eng)
    assert any(t.dtype == torch.float8_e4m3fn
               for t in dg.cache_leaves(eng.caches))
    rng = np.random.default_rng(1)
    for rid, n in enumerate((12, 7, 3)):
        eng.submit(Request(rid=rid, max_new_tokens=5,
                           prompt=rng.integers(0, cfg.vocab, n).astype(
                               np.int32)))
    eng.run()
    assert eng.stats["tokens_decoded"] == 15
    assert _leaf_sig(eng) == sig0


# ---------------------------------------------------------------------------
# (b) the in-place step = decode_loop = the reference's loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    name = "granite-3-8b-smoke"
    jcfg = jax_get_config(name)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    cfg = get_config(name)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _clone(caches):
    return [{part: {k: t.clone() for k, t in c[part].items()}
             for part in c} for c in caches]


def _plain_loop(cfg, model, caches, kv_len, logits, remaining, n,
                tables=None, temperature=0.0, generator=None):
    """The decode loop written functionally, each step's values rebound
    rather than written in place, sampling through ``torch.multinomial``:
    what ``decode_loop``'s in-place step must equal bit for bit."""
    kv_len = torch.from_numpy(kv_len.copy())
    remaining = torch.from_numpy(remaining.copy())
    toks = []
    for _ in range(n):
        active = remaining > 0
        if temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].to(
                torch.int32)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        toks.append(nxt)
        kv_len = kv_len + active.to(torch.int32)
        new, caches = tf.decode_step(cfg, model, nxt[:, None], caches,
                                     kv_len, RT, tables)
        logits = torch.where(active[:, None], new.to(logits.dtype), logits)
        remaining = remaining - active.to(torch.int32)
    return torch.stack(toks), kv_len, logits, remaining


def _assert_caches_equal(a, b):
    for ca, cb in zip(a, b):
        for part in ca:
            for k in ca[part]:
                assert torch.equal(ca[part][k], cb[part][k]), (part, k)


def _granite_prefill(granite, layout, b=4):
    cfg, jcfg, params, model = granite
    rng = np.random.default_rng(2)
    s = 16
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    true_len = np.array([16, 11, 5, 1], np.int32)
    jkw, kw, tables = {}, {}, None
    if layout == "paged":
        n_pages, ps = 16, 8
        table = np.full((b, 6), n_pages, np.int32)
        table[0, :4] = [3, 9, 0, 14]
        table[1, :3] = [7, 2, 10]
        table[2, :3] = [1, 12, 5]
        tables = {"full": torch.from_numpy(table)}
        slot_ids = np.arange(b, dtype=np.int32)
        jc = jtf.init_paged_cache(jcfg, b, {"full": n_pages}, ps,
                                  jnp.float32)
        tc = tf.init_paged_cache(cfg, b, {"full": n_pages}, ps,
                                 torch.float32, "cpu")
        kw = dict(block_tables=tables, slot_ids=torch.from_numpy(slot_ids))
        jkw = dict(block_tables={"full": jnp.asarray(table)},
                   slot_ids=jnp.asarray(slot_ids))
    else:
        jc = jtf.init_cache(jcfg, b, 48, jnp.float32)
        tc = tf.init_cache(cfg, b, 48, torch.float32, "cpu")
    jl, jc = jtf.prefill(jcfg, params, {"inputs": jnp.asarray(toks)}, jc,
                         JRT, true_len=jnp.asarray(true_len), **jkw)
    tl, tc = tf.prefill(cfg, model, {"inputs": torch.from_numpy(toks)}, tc,
                        RT, true_len=torch.from_numpy(true_len), **kw)
    return (jl, jc, jkw.get("block_tables")), (tl, tc, tables)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_loop_equals_the_plain_loop_and_the_reference(granite,
                                                             layout):
    cfg, jcfg, params, model = granite
    (jl, jc, jtables), (tl, tc, tables) = _granite_prefill(granite, layout)
    kv_len = np.array([16, 11, 5, 0], np.int32)        # slot 3 is empty
    remaining = np.array([6, 2, 9, 0], np.int32)
    n = 8
    plain_caches = _clone(tc)
    ptoks, pkv, plog, prem = _plain_loop(cfg, model, plain_caches, kv_len,
                                         tl.clone(), remaining, n, tables)
    sig = dg.signature(dg.cache_leaves(tc))
    ltoks, _, lkv, llog, lrem, steps = tf.decode_loop(
        cfg, model, tc, torch.from_numpy(kv_len), tl.clone(),
        torch.from_numpy(remaining), n_steps=n, rt=RT,
        host_remaining=remaining, block_tables=tables)
    assert steps == n
    assert dg.signature(dg.cache_leaves(tc)) == sig
    assert torch.equal(ltoks, ptoks)
    assert torch.equal(llog, plog)
    assert torch.equal(lkv, pkv) and torch.equal(lrem, prem)
    _assert_caches_equal(tc, plain_caches)
    jout = jtf.decode_loop(jcfg, params, jc, jnp.asarray(kv_len), jl,
                           jnp.asarray(remaining), jax.random.PRNGKey(0),
                           n_steps=n, rt=JRT, **(
                               {} if jtables is None else
                               {"block_tables": jtables}))
    np.testing.assert_array_equal(np.asarray(jout[0]), ltoks.numpy())
    np.testing.assert_array_equal(np.asarray(jout[2]), lkv.numpy())


def test_sampled_decode_loop_equals_the_multinomial_loop(granite):
    """At temperature 0.9 decode_loop's stream is the one
    ``torch.multinomial`` draws from the same generator state."""
    cfg, _, _, model = granite
    _, (tl, tc, _) = _granite_prefill(granite, "dense")
    kv_len = np.array([16, 11, 5, 1], np.int32)
    remaining = np.array([5, 5, 3, 5], np.int32)
    plain_caches = _clone(tc)
    ptoks, _, plog, _ = _plain_loop(
        cfg, model, plain_caches, kv_len, tl.clone(), remaining, 5,
        temperature=0.9, generator=torch.Generator().manual_seed(7))
    ltoks, _, _, llog, _, _ = tf.decode_loop(
        cfg, model, tc, kv_len, tl.clone(), remaining, n_steps=5, rt=RT,
        temperature=0.9, generator=torch.Generator().manual_seed(7))
    assert torch.equal(ltoks, ptoks) and torch.equal(llog, plog)
    _assert_caches_equal(tc, plain_caches)


def test_decode_loop_runs_a_given_step_on_a_given_state(granite):
    """With ``state`` and ``step`` (the engine's graph path) the loop calls
    ``step`` once a step, up to the early exit, keeps the state's own
    buffers, and ends where the default path does."""
    cfg, _, _, model = granite
    _, (tl, tc, _) = _granite_prefill(granite, "dense")
    kv_len = np.array([16, 11, 5, 0], np.int32)
    remaining = np.array([3, 1, 2, 0], np.int32)
    ref_caches = _clone(tc)
    rtoks, _, rkv, rlog, rrem, rsteps = tf.decode_loop(
        cfg, model, ref_caches, kv_len, tl.clone(), remaining, n_steps=6,
        rt=RT)
    st = tf.DecodeState.for_logits(tl.clone())
    bufs = dg.signature(st.buffers())
    calls = []

    def step():
        calls.append(1)
        tf.step_in_place(cfg, model, tc, st, RT)

    toks, _, kv, log, rem, steps = tf.decode_loop(
        cfg, model, tc, kv_len, st.last_logits, remaining, n_steps=6,
        rt=RT, host_remaining=remaining, state=st, step=step)
    assert steps == rsteps == len(calls) == 3
    assert dg.signature(st.buffers()) == bufs
    assert kv is st.kv_len and log is st.last_logits and rem is st.remaining
    assert torch.equal(toks, rtoks) and torch.equal(log, rlog)
    assert torch.equal(kv, rkv) and torch.equal(rem, rrem)
    assert not toks[3:].any()
    _assert_caches_equal(tc, ref_caches)


def test_ssm_decode_loop_equals_the_plain_loop():
    """hymba's Mamba and xlstm's mLSTM / sLSTM state, stepped in place,
    ends bit for bit where the plain loop's rebound state does, and keeps
    its storage."""
    for name in ("hymba-1.5b-smoke", "xlstm-125m-smoke"):
        cfg = get_config(name)
        model = _model(name)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
        kv_len = np.array([8, 5], np.int32)
        tc = tf.init_cache(cfg, 2, 24, torch.float32, "cpu")
        tl, tc = tf.prefill(cfg, model, {"inputs": torch.from_numpy(toks)},
                            tc, RT, true_len=torch.from_numpy(kv_len))
        remaining = np.array([4, 3], np.int32)
        plain_caches = _clone(tc)
        ptoks, _, plog, _ = _plain_loop(cfg, model, plain_caches, kv_len,
                                        tl.clone(), remaining, 4)
        sig = dg.signature(dg.cache_leaves(tc))
        ltoks, _, _, llog, _, _ = tf.decode_loop(
            cfg, model, tc, kv_len, tl.clone(), remaining, n_steps=4, rt=RT)
        assert dg.signature(dg.cache_leaves(tc)) == sig, name
        assert torch.equal(ltoks, ptoks), name
        assert torch.equal(llog, plog), name
        _assert_caches_equal(tc, plain_caches)


def test_sampled_step_draws_what_multinomial_draws():
    """At temperature > 0 the step's draw (argmax of p / Exp(1), no host
    check) equals ``torch.multinomial``'s from the same generator state."""
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        0, 3, (6, 301)).astype(np.float32))
    for temperature in (0.7, 1.0, 2.5):
        g1 = torch.Generator().manual_seed(11)
        g2 = torch.Generator().manual_seed(11)
        for _ in range(5):
            ours = tf.sample_next(logits, temperature, g1)
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            ref = torch.multinomial(probs, 1, generator=g2)[:, 0]
            assert torch.equal(ours, ref.to(torch.int32))


# ---------------------------------------------------------------------------
# (c) every writer between dispatches writes in place
# ---------------------------------------------------------------------------

def test_preempt_prefix_cow_swap_trace_keeps_every_leaf():
    name = "granite-3-8b-smoke"
    cfg = get_config(name)
    eng = ServeEngine(cfg, _model(name), rt=RT, device="cpu", slots=2,
                      max_len=64, decode_chunk=4, cache_layout="paged",
                      page_size=8, num_pages=8, prefix_caching=True,
                      host_swap_bytes=1 << 30)
    sig0 = _leaf_sig(eng)
    rng = np.random.default_rng(5)
    pa = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    for rid, p in enumerate((pa, pb, pa)):   # demote A, promote, COW hit
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
        eng.run()
    for rid, n in enumerate((30, 28, 20, 25)):  # two slots, 8 pages
        eng.submit(Request(rid=10 + rid, max_new_tokens=12,
                           prompt=rng.integers(0, cfg.vocab, n).astype(
                               np.int32)))
    eng.run()
    st, kst = eng.stats, eng.kv.stats
    assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1, st
    assert st["preemptions"] >= 1, st
    assert kst["demotions"] >= 1 and kst["promotions"] >= 1, kst
    assert _leaf_sig(eng) == sig0
    eng.kv.check_invariants()


# ---------------------------------------------------------------------------
# (d) launch counters: delta x replays
# ---------------------------------------------------------------------------

def _fake_wrapper(name):
    def w():
        pass
    w.__name__ = name
    w.launches = 0
    w.launches_by_n_pos = {}
    w.launches_strips = 0
    return w


def test_counter_delta_times_replays():
    a, b = _fake_wrapper("a_cuda"), _fake_wrapper("b_cuda")
    ws = (a, b)

    def step():                       # what one captured step counts
        a.launches += 3
        a.launches_by_n_pos[1] = a.launches_by_n_pos.get(1, 0) + 3
        b.launches += 1
        b.launches_strips += 2

    a.launches, a.launches_by_n_pos = 5, {13: 2}      # earlier traffic
    before = dg.counter_snapshot(ws)
    step()                                            # "the capture"
    delta = dg.counter_delta(dg.counter_snapshot(ws), before)
    assert delta == {("a_cuda", "launches"): 3,
                     ("a_cuda", "launches_by_n_pos"): {1: 3},
                     ("b_cuda", "launches"): 1,
                     ("b_cuda", "launches_strips"): 2}
    dg.counter_add(delta, -1, ws)                     # capture ran nothing
    assert dg.counter_snapshot(ws) == before
    assert a.launches_by_n_pos == {13: 2}             # no zero key left
    for _ in range(7):                                # seven replays
        dg.counter_add(delta, 1, ws)
    assert a.launches == 5 + 21 and a.launches_by_n_pos == {13: 2, 1: 21}
    assert b.launches == 7 and b.launches_strips == 14
    eager = _fake_wrapper("a_cuda"), _fake_wrapper("b_cuda")
    a2, b2 = eager
    a2.launches, a2.launches_by_n_pos = 5, {13: 2}
    for _ in range(7):                                # seven eager steps
        a2.launches += 3
        a2.launches_by_n_pos[1] = a2.launches_by_n_pos.get(1, 0) + 3
        b2.launches += 1
        b2.launches_strips += 2
    assert dg.counter_snapshot(eager) == dg.counter_snapshot(ws)


def test_counted_wrappers_are_the_kernels():
    """The kernels package's list is every wrapper that counts launches,
    and the graph advances the counters of that list."""
    counting = {f for mod in (fm, dec) for f in vars(mod).values()
                if callable(f) and hasattr(f, "launches")}
    assert set(COUNTED_WRAPPERS) == counting
    assert len(COUNTED_WRAPPERS) == len(counting) == 5
    snap = dg.counter_snapshot()
    assert {w for w, _ in snap} == {f.__name__ for f in counting}
    assert ("paged_decode_partials_cuda", "launches_by_code") in snap


# ---------------------------------------------------------------------------
# (e) the graph is for the card
# ---------------------------------------------------------------------------

def test_decode_graph_refuses_a_cpu_state():
    name = "granite-3-8b-smoke"
    cfg = get_config(name)
    caches = tf.init_cache(cfg, 2, 16, torch.float32, "cpu")
    st = tf.DecodeState.for_logits(torch.zeros((2, cfg.vocab)))
    with pytest.raises(ValueError, match="CUDA"):
        dg.DecodeGraph(cfg, _model(name), caches, st, RT)
    assert dg.graph_refusal(caches, torch.device("cpu")) == \
        "eager: cpu"
