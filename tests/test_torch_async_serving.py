"""The port's async front end and dp routing against the JAX reference.

``repro_torch.serving.scheduler`` against ``repro.serving.scheduler`` on
the CPU, on reference weights through the bridge: the host-only
scheduler gives the same actions on the same fake drive, and the async
engine (dense, paged with the prefix cache off and on, dp = 2 replicas)
gives the reference async engine's greedy streams and counters, which
equal the synchronous engine's.  Port-only cases pin what interleaving
leans on: a parked slot's masked decode write lands at its next unwritten
position and nowhere else, quanta that are not page-aligned, gemma2's
ring continuation, progressive prefix registration, warmup and the
launcher's ``--async`` / ``--dp`` legs.
"""
import asyncio
import json

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
from repro.serving import scheduler as jsched
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve
from repro_torch.model.layers import Runtime
from repro_torch.serving import (
    AsyncRequest, AsyncServeEngine, DataParallelAsyncEngine, Request,
    ServeEngine, VirtualClock, interleave_supported, latency_metrics,
    poisson_arrivals,
)
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.kv_cache import PagedKVCache

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
NAME = "stablelm-1.6b-smoke"
#: the reference test's trace and engine settings
LENS, BUDGET = [5, 40, 12, 33, 7], 6
KW = dict(slots=2, max_len=64, page_size=8, prefill_quantum=8)
LAYOUTS = {"dense": ("dense", False), "paged_noprefix": ("paged", False),
           "paged": ("paged", True)}


def _models(name):
    jcfg = jax_get_config(name)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    cfg = get_config(name)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def smoke():
    return _models(NAME)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _async_run(mod, cfg, weights, prompts, budget, arrivals=None, rt=None,
               **kw):
    """Serve ``prompts`` through ``mod.AsyncServeEngine`` (reference or
    port) on a virtual clock; returns (engine, requests)."""
    if mod is tsched:
        kw.setdefault("device", "cpu")
    eng = mod.AsyncServeEngine(cfg, weights, rt=rt, temperature=0.0,
                               clock=mod.VirtualClock(), **kw)
    arrivals = arrivals or [0.0] * len(prompts)
    reqs = [mod.AsyncRequest(rid=i, prompt=p.copy(), max_new_tokens=budget,
                             arrival=a)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]
    eng.serve_trace(reqs)
    return eng, reqs


def _port_run(smoke, prompts, budget, **kw):
    _, _, cfg, model = smoke
    return _async_run(tsched, cfg, model, prompts, budget, rt=RT, **kw)


def _ref_run(smoke, prompts, budget, **kw):
    jcfg, params, _, _ = smoke
    return _async_run(jsched, jcfg, params, prompts, budget, rt=JRT, **kw)


def _sync_streams(smoke, prompts, budget, **kw):
    """The synchronous engine's streams; ``budget`` for every prompt or
    a list of one each."""
    _, _, cfg, model = smoke
    eng = ServeEngine(cfg, model, rt=RT, device="cpu", temperature=0.0,
                      **kw)
    budgets = budget if isinstance(budget, list) else [budget] * len(prompts)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs]


def _streams(reqs):
    return [list(r.generated) for r in reqs]


def _same_stats(ours, ref):
    """Every counter the reference engine keeps, equal in the port's."""
    assert {k: ours.stats[k] for k in ref.stats} == dict(ref.stats)


# -- scheduler policy (virtual clock, fake executor) ------------------------


def _fake_drive(sched, budgets, quantum):
    """Execute every action the scheduler hands out; each decode tick
    grows every active stream by one token.  Returns the action list."""
    actions = []
    generated = {rid: 0 for rid in budgets}
    for _ in range(10_000):
        if not sched.unfinished():
            break
        a = sched.next_action(0.0)
        actions.append(a)
        if a[0] == "prefill":
            e = sched.entries[a[1]]
            sched.advance(a[1], min(quantum, e.target - e.progress))
        elif a[0] == "decode":
            for rid, e in sched.entries.items():
                if e.state == "active":
                    generated[rid] += 1
                    if generated[rid] >= budgets[rid]:
                        sched.finished(rid)
        else:
            break
    return actions


def _dispatch_sequence(mod):
    sched = mod.AsyncScheduler(prefill_quantum=32)
    sched.submit(0, arrival=0.0, prompt_len=96)
    sched.submit(1, arrival=0.0, prompt_len=8)
    seen = [sched.admissible(0.0)]
    sched.admitted(0, cached_len=0, target=96)
    sched.admitted(1, cached_len=0, target=8)
    return seen + _fake_drive(sched, budgets={0: 3, 1: 2}, quantum=32)


def _long_admission(mod):
    sched = mod.AsyncScheduler(prefill_quantum=32)
    sched.submit(0, arrival=0.0, prompt_len=8)
    sched.admitted(0, cached_len=0, target=8)
    sched.advance(0, 8)
    sched.submit(1, arrival=0.0, prompt_len=2048)
    sched.admitted(1, cached_len=0, target=2048)
    return _fake_drive(sched, budgets={0: 80, 1: 1}, quantum=32)


def _edf_and_shedding(mod):
    sched = mod.AsyncScheduler(prefill_quantum=32, shed_expired=True)
    sched.submit(0, arrival=0.0, prompt_len=8)
    sched.submit(1, arrival=0.0, prompt_len=8, deadline=5.0)
    sched.submit(2, arrival=0.0, prompt_len=8, deadline=1.0)
    sched.submit(3, arrival=9.0, prompt_len=8)
    out = [sched.admissible(2.0), sched.take_shed(), sched.entries[2].state,
           sched.next_arrival(2.0)]
    return out + [sched.admissible(9.5), sched.take_shed(),
                  sched.unfinished()]


def _requeue(mod):
    sched = mod.AsyncScheduler(prefill_quantum=32)
    sched.submit(0, arrival=0.0, prompt_len=64)
    sched.submit(1, arrival=5.0, prompt_len=8)
    sched.admitted(0, cached_len=0, target=64)
    first = sched.next_action(0.0)
    sched.advance(0, 32)
    sched.requeue(0)
    return [first, sched.entries[0].progress, sched.entries[0].state,
            sched.admissible(6.0), sched.next_action(6.0)]


SCENARIOS = {
    "dispatch_sequence": (_dispatch_sequence, [
        [0, 1], ("prefill", 0), ("prefill", 0), ("prefill", 0),
        ("decode",), ("prefill", 1), ("decode",), ("decode",)]),
    "long_admission": (_long_admission, None),
    "edf_and_shedding": (_edf_and_shedding, [
        [1, 0], [2], "shed", 9.0, [0, 3], [1], 2]),
    "requeue": (_requeue, [("prefill", 0), 0, "waiting", [0, 1],
                           ("idle",)]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_actions_equal_reference(scenario):
    """The reference test's scheduler cases on the port's and the
    reference's AsyncScheduler: the same actions, and the reference
    test's expectations (the exact dispatch sequence, no two quanta in a
    row while a stream is active, EDF and shedding, a requeue keeping
    its original arrival's priority)."""
    drive, want = SCENARIOS[scenario]
    ours, ref = drive(tsched), drive(jsched)
    assert ours == ref
    if want is not None:
        assert ours == want
    else:
        assert sum(a[0] == "prefill" for a in ours) == 2048 // 32
        assert not any(a[0] == b[0] == "prefill"
                       for a, b in zip(ours, ours[1:]))


def test_interleave_supported_equals_reference_on_every_config():
    for name in ARCHS:
        for n in (name, name + "-smoke"):
            assert interleave_supported(get_config(n)) == \
                jsched.interleave_supported(jax_get_config(n)), n
    assert interleave_supported(get_config(NAME))
    assert interleave_supported(get_config("deepseek-v3-671b-smoke"))
    assert not interleave_supported(get_config("hymba-1.5b-smoke"))
    assert not interleave_supported(get_config("xlstm-125m-smoke"))


def test_latency_metrics_and_arrivals_equal_reference():
    def reqs(mod):
        r0 = mod.AsyncRequest(rid=0, prompt=np.zeros(4, np.int32),
                              max_new_tokens=3, arrival=1.0)
        r0.generated = [7, 8, 9]
        r0.token_times = [1.5, 2.0, 3.0]
        r1 = mod.AsyncRequest(rid=1, prompt=np.zeros(4, np.int32),
                              max_new_tokens=2, arrival=2.0)
        r1.shed = True
        r2 = mod.AsyncRequest(rid=2, prompt=np.zeros(4, np.int32),
                              max_new_tokens=4, arrival=1.25)
        r2.generated = [1, 2, 3, 4]
        r2.token_times = [1.75, 1.8, 2.9, 4.1]
        return [r0, r1, r2]

    m = latency_metrics(reqs(tsched))
    assert m == jsched.latency_metrics(reqs(jsched))
    assert m["requests"] == 3 and m["served"] == 2 and m["shed"] == 1
    assert m["tokens"] == 7
    assert m["ttft_s"]["max"] == pytest.approx(0.5)
    assert m["itl_s"]["max"] == pytest.approx(1.2)
    assert latency_metrics([]) == jsched.latency_metrics([])
    for rate, n, seed, t0 in ((4.0, 16, 0, 0.0), (0.5, 7, 3, 2.5)):
        np.testing.assert_array_equal(
            poisson_arrivals(rate, n, seed=seed, t0=t0),
            jsched.poisson_arrivals(rate, n, seed=seed, t0=t0))
    with pytest.raises(ValueError, match="rate > 0"):
        poisson_arrivals(0.0, 3)


# -- engine: async = reference async = sync, every layout -------------------


@pytest.fixture(scope="module")
def trace(smoke):
    return _prompts(smoke[2].vocab, LENS)


@pytest.fixture(scope="module")
def sync_streams(smoke, trace):
    return _sync_streams(smoke, trace, BUDGET, slots=2, max_len=64)


@pytest.fixture(scope="module")
def ref_layouts(smoke, trace):
    """The reference async engine on each layout: (stats, streams)."""
    out = {}
    for name, (layout, prefix) in LAYOUTS.items():
        eng, reqs = _ref_run(smoke, trace, BUDGET, cache_layout=layout,
                             prefix_caching=prefix, **KW)
        out[name] = (eng, _streams(reqs))
    return out


@pytest.mark.parametrize("leg", list(LAYOUTS))
def test_async_streams_and_counters_equal_reference_and_sync(
        smoke, trace, sync_streams, ref_layouts, leg):
    layout, prefix = LAYOUTS[leg]
    eng, reqs = _port_run(smoke, trace, BUDGET, cache_layout=layout,
                          prefix_caching=prefix, **KW)
    ref_eng, ref_streams = ref_layouts[leg]
    assert _streams(reqs) == ref_streams == sync_streams
    _same_stats(eng, ref_eng)
    assert eng.interleave == (layout == "paged") == ref_eng.interleave
    assert all(r.done for r in eng._reqs.values())
    assert eng.logits_finite()
    if eng.kv is not None:
        eng.kv.check_invariants()


def test_token_stream_iteration_and_timestamps(smoke):
    _, _, cfg, model = smoke
    eng = AsyncServeEngine(cfg, model, rt=RT, device="cpu", temperature=0.0,
                           cache_layout="paged", clock=VirtualClock(), **KW)
    req = AsyncRequest(rid=0, prompt=_prompts(cfg.vocab, [20])[0],
                       max_new_tokens=5, arrival=0.0)
    stream = eng.submit_async(req)
    toks = list(stream)                     # iteration drives the loop
    assert toks == req.generated and len(toks) == 5
    assert len(req.token_times) == len(req.generated)
    assert all(b >= a for a, b in zip(req.token_times, req.token_times[1:]))
    assert stream.closed

    # async iteration is the same pump underneath, on the clock's time
    eng.clock.advance(3.0)
    req2 = AsyncRequest(rid=1, prompt=_prompts(cfg.vocab, [8], seed=1)[0],
                        max_new_tokens=4, arrival=eng.clock.now())
    stream2 = eng.submit_async(req2)

    async def collect():
        return [t async for t in stream2]

    assert asyncio.run(collect()) == req2.generated
    assert len(req2.generated) == 4
    assert req2.token_times == [3.0] * 4
    assert _sync_streams(smoke, [req.prompt, req2.prompt], 5, slots=2,
                         max_len=64)[0] == toks


#: the reference test's tiny pool: two survivors' growth plus the victim's
#: registered chain fit, the three-resident peak does not
TINY = dict(slots=3, max_len=64, page_size=8, num_pages=15,
            prefill_quantum=8, decode_chunk=1)


@pytest.fixture(scope="module")
def ref_tiny(smoke):
    prompts = _prompts(smoke[2].vocab, [16, 16, 32], seed=2)
    eng, reqs = _ref_run(smoke, prompts, 20, cache_layout="paged",
                         prefix_caching=True, **TINY)
    return prompts, eng, _streams(reqs)


def test_preemption_under_a_tiny_pool_equals_reference(smoke, ref_tiny):
    prompts, ref_eng, ref_streams = ref_tiny
    eng, reqs = _port_run(smoke, prompts, 20, cache_layout="paged",
                          prefix_caching=True, **TINY)
    assert _streams(reqs) == ref_streams == _sync_streams(
        smoke, prompts, 20, slots=3, max_len=64, decode_chunk=1)
    _same_stats(eng, ref_eng)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["tokens_reused"] > 0
    eng.kv.check_invariants()
    # nothing leaked: once the index lets go, every page is free
    eng.kv.clear_prefix()
    assert all(n == 0 for n in eng.kv.pages_in_use.values())
    eng.kv.check_invariants()


def test_deadline_shed_closes_stream_empty(smoke):
    _, _, cfg, model = smoke
    eng = AsyncServeEngine(cfg, model, rt=RT, device="cpu", temperature=0.0,
                           cache_layout="paged", shed_expired=True,
                           clock=VirtualClock(t0=1.0), **KW)
    late = AsyncRequest(rid=0, prompt=_prompts(cfg.vocab, [12])[0],
                        max_new_tokens=4, arrival=0.0, deadline=0.5)
    ok = AsyncRequest(rid=1, prompt=_prompts(cfg.vocab, [12], seed=1)[0],
                      max_new_tokens=4, arrival=0.0)
    streams = eng.serve_trace([late, ok])
    assert late.shed and late.generated == [] and list(streams[0]) == []
    assert streams[0].closed
    assert not ok.shed and len(ok.generated) == 4
    m = latency_metrics([late, ok])
    assert m["shed"] == 1 and m["served"] == 1


def test_speculation_refused_with_the_reference_message(smoke):
    jcfg, params, cfg, model = smoke
    with pytest.raises(ValueError, match="speculative") as ours:
        AsyncServeEngine(cfg, model, rt=RT, device="cpu",
                         cache_layout="paged", slots=2, max_len=64,
                         speculate=4)
    with pytest.raises(ValueError, match="speculative") as ref:
        jsched.AsyncServeEngine(jcfg, params, rt=JRT, cache_layout="paged",
                                slots=2, max_len=64, speculate=4)
    assert str(ours.value) == str(ref.value)


# -- dp replicas + prefix-affinity routing ----------------------------------


DP_KW = dict(cache_layout="paged", prefix_caching=True, page_size=8,
             slots=2, max_len=96, prefill_quantum=16)


def _dp_prompts(vocab):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, 32).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, 8)
                            .astype(np.int32)]) for _ in range(6)]


def _dp_run(mod, cfg, weights, rt, prompts):
    """Staggered arrivals: under a virtual clock each request completes
    before the next arrives, so every later arrival routes against a
    registered prefix index."""
    clock = mod.VirtualClock()
    extra = dict(device="cpu") if mod is tsched else {}
    dpe = mod.DataParallelAsyncEngine([
        mod.AsyncServeEngine(cfg, weights, rt=rt, temperature=0.0,
                             clock=clock, **DP_KW, **extra)
        for _ in range(2)])
    reqs = [mod.AsyncRequest(rid=i, prompt=p.copy(), max_new_tokens=4,
                             arrival=0.1 * i) for i, p in enumerate(prompts)]
    dpe.serve_trace(reqs)
    return dpe, reqs


@pytest.fixture(scope="module")
def ref_dp(smoke):
    jcfg, params, cfg, _ = smoke
    prompts = _dp_prompts(cfg.vocab)
    single, sreqs = _ref_run(smoke, prompts, 4,
                             arrivals=[0.1 * i for i in range(6)], **DP_KW)
    dpe, dreqs = _dp_run(jsched, jcfg, params, JRT, prompts)
    return prompts, single, _streams(sreqs), dpe, _streams(dreqs)


def test_dp_prefix_affinity_equals_reference(smoke, ref_dp):
    """Shared-prefix arrivals route to the replica already holding the
    prefix (the reference test's checks), and the port's dp = 2 engine
    gives the reference's streams, routing and per-replica counters."""
    _, _, cfg, model = smoke
    prompts, ref_single, ref_single_streams, ref_dpe, ref_streams = ref_dp
    single, sreqs = _port_run(smoke, prompts, 4,
                              arrivals=[0.1 * i for i in range(6)], **DP_KW)
    assert _streams(sreqs) == ref_single_streams
    _same_stats(single, ref_single)
    dpe, dreqs = _dp_run(tsched, cfg, model, RT, prompts)
    assert isinstance(dpe, DataParallelAsyncEngine)
    assert _streams(dreqs) == ref_streams == ref_single_streams
    st = dpe.stats_summary()
    assert st == ref_dpe.stats_summary()
    assert dpe.assignment == ref_dpe.assignment
    for ours, ref in zip(dpe.engines, ref_dpe.engines):
        _same_stats(ours, ref)
        ours.kv.check_invariants()
    per = [p["tokens_reused"] for p in st["per_replica"]]
    assert st["routing"]["prefix_routed"] == len(prompts) - 1
    assert max(per) == st["tokens_reused"] and min(per) == 0
    assert st["tokens_reused"] >= single.stats["tokens_reused"] > 0


# -- port-only: what interleaving leans on ----------------------------------


def _slot_kv(eng, slot):
    """Every layer's K and V of ``slot`` by position, [layers, 2, n, ...]
    over the pages the slot owns."""
    pages = torch.tensor(eng.kv.classes["full"].owned[slot])
    return torch.stack([
        torch.stack([c["attn"][k][pages].flatten(0, 1)
                     for k in ("k_pages", "v_pages")])
        for c in eng.caches])


def _poison(eng, slot, lo, value):
    """Set ``slot``'s positions >= ``lo`` on its pages to ``value``."""
    ps = eng.kv.page_size
    for j, page in enumerate(eng.kv.classes["full"].owned[slot]):
        start = max(0, lo - j * ps)
        if start < ps:
            for c in eng.caches:
                for k in ("k_pages", "v_pages"):
                    c["attn"][k][page, start:] = value


def test_parked_slot_write_lands_at_its_next_unwritten_position(smoke):
    """A quantum of 24 on pages of 16 (no quantum ends on a page edge):
    while the long prompt is parked at ``kv_len = progress + 1``, every
    decode tick of the other slot writes the parked slot's K/V at
    ``progress`` and nowhere else — its written positions stay bit for
    bit, and positions past ``progress`` keep a poison the next quanta
    overwrite — and the streams equal the synchronous engine's."""
    _, _, cfg, model = smoke
    prompts = _prompts(cfg.vocab, [10, 100], seed=7)
    eng = AsyncServeEngine(cfg, model, rt=RT, device="cpu", temperature=0.0,
                           cache_layout="paged", prefix_caching=True,
                           slots=2, max_len=128, page_size=16,
                           prefill_quantum=24, decode_chunk=2,
                           clock=VirtualClock())
    poison = 1.0e4
    seen = []
    tick = eng._decode_tick

    def checked_tick():
        parked = {s: st.progress for s, st in eng._mid.items()}
        before = {}
        for s, p in parked.items():
            assert eng.kv_len[s] == p + 1 and eng.remaining[s] == 0
            assert p % 24 == 0
            _poison(eng, s, p, poison)
            before[s] = _slot_kv(eng, s)
        tick()
        for s, p in parked.items():
            after = _slot_kv(eng, s)
            assert torch.equal(after[:, :, :p], before[s][:, :, :p])
            assert (after[:, :, p] != poison).all()
            assert (after[:, :, p + 1:] == poison).all()
            seen.append(p)

    eng._decode_tick = checked_tick
    reqs = [AsyncRequest(rid=i, prompt=p.copy(), max_new_tokens=n,
                         arrival=0.0)
            for i, (p, n) in enumerate(zip(prompts, (12, 4)))]
    eng.serve_trace(reqs)
    assert seen == [0, 24, 48, 72, 96]
    assert eng.stats["prefill_dispatches"] == 1 + 5
    assert _streams(reqs) == _sync_streams(smoke, prompts, [12, 4], slots=2,
                                           max_len=128)
    eng.kv.check_invariants()


def _host_state(kv):
    c = kv.classes["full"]
    return (c.table.tolist(), [list(o) for o in c.owned],
            dict(c.pool._refcount), list(c.pool._free),
            {h: (e.page, e.parent) for h, e in kv._prefix.items()})


def test_progressive_registration_equals_reference_index():
    """``admit(register=False)`` then ``register_progress`` after each
    quantum (24 tokens on pages of 8, so quanta end mid-page), a second
    prompt sharing the written prefix, release: the same tables, owned
    rows, refcounts, free lists and prefix index as the reference's."""
    kw = dict(slots=2, max_len=64, page_size=8, num_pages=14)
    ours = PagedKVCache(get_config(NAME), dtype=torch.float32, device="cpu",
                        **kw)
    ref = JaxPagedKVCache(jax_get_config(NAME), dtype=jnp.float32, **kw)
    rng = np.random.default_rng(23)
    a = rng.integers(0, 512, 50).astype(np.int32)
    b = np.concatenate([a[:36], rng.integers(0, 512, 9)]).astype(np.int32)
    runs = []
    for kv in (ours, ref):
        out = [kv.admit(0, a, len(a) + 1, register=False), _host_state(kv)]
        for upto in (24, 48, 50):
            kv.register_progress(0, a, upto)
            out.append(_host_state(kv))
        out += [kv.match_prefix(b), kv.admit(1, b, len(b) + 1,
                                             register=False),
                _host_state(kv)]
        kv.register_progress(1, b, len(b))
        kv.release(0)
        kv.release(1)
        out.append(_host_state(kv))
        kv.check_invariants()
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[0][1][4] == {}                    # nothing indexed at admit
    assert runs[0][5] == 4                        # 32 written tokens match


def test_warmup_resets_stats_and_index_and_keeps_streams(smoke, trace,
                                                         sync_streams):
    _, _, cfg, model = smoke
    eng = AsyncServeEngine(cfg, model, rt=RT, device="cpu", temperature=0.0,
                           cache_layout="paged", prefix_caching=True,
                           clock=VirtualClock(), **KW)
    assert eng.warmup(sorted(set(LENS))) > 0
    assert all(v == 0 for v in eng.stats.values())
    assert len(eng.kv._prefix) == 0 and eng.kv.prefix_enabled
    assert not eng._reqs and not eng._mid and not eng.sched.entries
    assert all(n == 0 for n in eng.kv.pages_in_use.values())
    reqs = [AsyncRequest(rid=i, prompt=p.copy(), max_new_tokens=BUDGET,
                         arrival=0.0) for i, p in enumerate(trace)]
    eng.serve_trace(reqs)
    assert _streams(reqs) == sync_streams


@pytest.fixture(scope="module")
def gemma2():
    return _models("gemma2-9b-smoke")


def test_gemma2_ring_continuation_equals_reference(gemma2):
    """gemma2-9b-smoke (window 64 on layers 0 and 2) paged and
    interleaved: prompts past the window in quanta of 24, so the later
    quanta read the ring band through the table at offsets that are not
    page-aligned; streams and counters equal the reference async
    engine's and the synchronous engine's."""
    jcfg, params, cfg, model = gemma2
    prompts = _prompts(cfg.vocab, [70, 90], seed=9)
    kw = dict(cache_layout="paged", slots=2, max_len=128, page_size=16,
              prefill_quantum=24, decode_chunk=4)
    ref, rreqs = _async_run(jsched, jcfg, params, prompts, 6, rt=JRT, **kw)
    eng, reqs = _async_run(tsched, cfg, model, prompts, 6, rt=RT, **kw)
    assert eng.interleave and not eng.kv.prefix_enabled
    assert _streams(reqs) == _streams(rreqs) == _sync_streams(
        (jcfg, params, cfg, model), prompts, 6, slots=2, max_len=128,
        decode_chunk=4, cache_layout="paged", page_size=16)
    _same_stats(eng, ref)
    assert eng.stats["prefill_dispatches"] == 3 + 4
    eng.kv.check_invariants()


# -- the launcher ------------------------------------------------------------


#: the reference launcher's --async keys, nested (its serve_async_bench)
REF_KEYS = {
    "arch", "mode", "requests", "slots", "arrival_rate", "seed",
    "prompt_len", "long_prompt_len", "long_every", "shared_prefix_len",
    "new_tokens", "decode_chunk", "prefill_quantum", "page_size",
    "outputs_match", "async", "async_legs", "sync_open_loop",
    "itl_p95_sync_over_async", "tok_per_s", "ttft_s", "dp"}
LEG_KEYS = {"requests", "served", "shed", "tokens", "span_s", "tok_per_s",
            "ttft_s", "itl_s", "dispatches", "preemptions", "tokens_reused",
            "warmup_s", "interleave"}
DP_KEYS = {"dp", "per_replica", "tokens_reused", "prefix_hits",
           "tokens_decoded", "routing", "tp", "arrival_rate", "latency",
           "outputs_match"}


def test_launcher_async_dp_on_cpu_keeps_the_reference_keys(tmp_path):
    out = tmp_path / "async.json"
    m = serve.main(["--async", "--device", "cpu", "--arch", NAME,
                    "--dp", "2", "--requests", "6", "--slots", "2",
                    "--max-len", "96", "--prompt-len", "20",
                    "--prompt-len-max", "40", "--shared-prefix-len", "16",
                    "--long-prompt-len", "60", "--long-every", "3",
                    "--new-tokens", "4", "--prefill-quantum", "16",
                    "--page-size", "8", "--arrival-rate", "50",
                    "--dp-arrival-rate", "10",
                    "--no-warmup", "--json", str(out)])
    saved = json.loads(out.read_text())
    assert saved["outputs_match"] is True and m["outputs_match"] is True
    assert REF_KEYS <= set(saved) and "_outputs_by_leg" not in saved
    for leg in ("dense", "paged_noprefix", "paged"):
        got = saved["async_legs"][leg]
        assert LEG_KEYS <= set(got), leg
        assert got["served"] == 6 and got["logits_finite"]
        assert got["device"] == {"platform": "cpu", "kind": "cpu",
                                 "count": 1}
        assert set(got["kernel_launches"].values()) == {0}
    assert saved["async_legs"]["paged"]["interleave"]
    assert not saved["async_legs"]["dense"]["interleave"]
    assert DP_KEYS <= set(saved["dp"]) and saved["dp"]["outputs_match"]
    assert saved["dp"]["routing"]["prefix_routed"] >= 1
    outs = m["_outputs_by_leg"]
    assert set(outs) == {"dense", "paged_noprefix", "paged", "sync", "dp"}
    assert all(o == outs["sync"] for o in outs.values())
    assert [len(o) for o in outs["sync"]] == [4] * 6


@pytest.mark.parametrize("argv", [
    ["--long-prompt-len", "60", "--long-every", "2"],
    ["--prompt-len", "20", "--prompt-len-max", "40", "--shared-prefix-len",
     "16", "--long-prompt-len", "90", "--long-every", "3",
     "--long-new-tokens", "2", "--seed", "4"],
])
def test_launcher_async_trace_equals_reference(argv):
    """The same flags give the reference launcher's prompts and budgets."""
    from repro.launch import serve as jax_serve

    args = serve._parser().parse_args(["--async"] + argv)
    prompts, budgets = serve._async_trace(args, get_config(NAME))
    ref_prompts, ref_budgets = jax_serve._async_trace(
        args, jax_get_config(NAME))
    assert budgets == ref_budgets
    assert [p.tolist() for p in prompts] == [p.tolist() for p in ref_prompts]


@pytest.mark.parametrize("argv,msg", [
    # no CUDA device is visible here; a library caller passes devices=
    (["--async", "--mesh", "tp=2"], "needs 2 devices"),
    (["--async", "--dp", "2", "--mesh", "tp=2"], "needs 2 devices"),
    (["--async", "--speculate", "4"], "--speculate does not combine"),
], ids=["mesh", "dp-mesh", "speculate"])
def test_launcher_async_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(["--device", "cpu", "--arch", NAME, "--no-warmup",
                    "--json", ""] + argv)
