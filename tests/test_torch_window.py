"""Sliding windows, ring caches and softcaps (gemma2-9b) against the JAX
reference.

The same inputs, made with numpy from a seed, go through the reference
and the port on the CPU.  K1's plain version with a window and a softcap
is held to the reference's ``fusemax_attention`` under ``impl="pallas"``
(interpret mode) and ``impl="jnp"`` — whose banded evaluation of a
causal window (P = M a multiple of W >= 2W) is another summation of the
same function — at the smoke head dim 32 and gemma's 256: fp32 paths
differ only in summation order, rtol = atol = 1e-5 on unit-scale
outputs.  The model runs gemma2-9b-smoke (window 64 on even layers,
attention softcap 50, final softcap 30, post-norms, GeLU, embed scale) on
bridged reference weights: logits within rtol 1e-5, atol 2e-4 (O(10)
after the final softcap, 4 layers of fp32), greedy streams equal, with
prompts longer than the window so the rings wrap.
"""
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
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import fusemax as fm
from repro_torch.model import attention as attn
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVCache

F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-4)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
NAME = "gemma2-9b-smoke"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(NAME)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    cfg = get_config(NAME)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# K1's plain version: window and softcap
# ---------------------------------------------------------------------------

#: (b, hq, hkv, p, m, causal, window, softcap, q_offset); the first is the
#: reference's banded case (causal, q_offset 0, P = M = 4W)
K1_CASES = [
    (1, 4, 2, 128, 128, True, 32, 50.0, 0),
    (2, 4, 2, 50, 50, True, 20, None, 0),
    (1, 4, 2, 40, 56, True, 24, 30.0, 16),
    (2, 2, 2, 33, 33, True, None, 50.0, 0),
    (1, 4, 1, 70, 70, False, None, 50.0, 0),
]


@pytest.mark.parametrize("dims", [32, 256])
@pytest.mark.parametrize("case", K1_CASES,
                         ids=[f"p{c[3]}-m{c[4]}-w{c[6]}-cap{c[7]}-off{c[8]}"
                              for c in K1_CASES])
def test_k1_plain_window_softcap_matches_reference(dims, case):
    """The port's K1 path ("torch": the plain version at the reference's
    modeled tile) and the plain version at the CUDA kernel's own tile,
    against Pallas (interpret) and jnp."""
    b, hq, hkv, p, m, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(p + m + dims)
    q = rng.standard_normal((b, hq, p, dims)).astype(np.float32)
    k = rng.standard_normal((b, hkv, m, dims)).astype(np.float32)
    v = rng.standard_normal((b, hkv, m, dims)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    ours = ops.fusemax_attention(*map(torch.from_numpy, (q, k, v)),
                                 impl="torch", **kw).numpy()
    g = hq // hkv
    bq, bk = autotune.CUDA_PREFILL_TILES[(dims, dims)]
    q_f = ops._fold_decode_q(torch.from_numpy(q), b, hkv, g, dims)
    tile = fm.fusemax_attention_torch(
        q_f, torch.from_numpy(k).reshape(b * hkv, m, dims),
        torch.from_numpy(v).reshape(b * hkv, m, dims), scale=dims ** -0.5,
        group=g, block_q=bq, block_k=bk, **kw)
    tile = ops._unfold_decode_out(tile, b, hkv, g, dims, p=p).numpy()
    for impl in ("pallas", "jnp"):
        ref = np.asarray(jax_ops.fusemax_attention(
            *map(jnp.asarray, (q, k, v)), impl=impl, **kw))
        np.testing.assert_allclose(ours, ref, err_msg=impl, **F32_TOL)
        np.testing.assert_allclose(tile, ref, err_msg=f"{impl} (CUDA tile)",
                                   **F32_TOL)


# ---------------------------------------------------------------------------
# dense ring writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("off,s_len,slots,true_len", [
    (0, 16, 8, [16, 11, 5, 0]),        # whole prompt, wraps, padded rows
    (0, 8, 16, [8, 3, 1, 8]),          # shorter than the ring
    (24, 8, 16, [32, 27, 20, 30]),     # a continuation chunk, one row done
    (16, 32, 8, [48, 40, 17, 16]),     # the chunk alone wraps the ring
])
def test_ring_write_masked_matches_reference(off, s_len, slots, true_len):
    rng = np.random.default_rng(off + s_len + slots)
    kc, vc = (rng.standard_normal((4, 2, slots, 8)).astype(np.float32)
              for _ in range(2))
    k_new, v_new = (rng.standard_normal((4, 2, s_len, 8)).astype(np.float32)
                    for _ in range(2))
    tl = np.asarray(true_len, np.int32)
    jk, jv = jattn.ring_write_masked(*map(jnp.asarray, (kc, vc, k_new,
                                                        v_new)), off,
                                     jnp.asarray(tl))
    tk, tv = (torch.from_numpy(a.copy()) for a in (kc, vc))
    attn.ring_write_masked(tk, tv, torch.from_numpy(k_new),
                           torch.from_numpy(v_new), off, torch.from_numpy(tl))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# gemma2-9b-smoke: forward, prefill past the window, decode past the wrap
# ---------------------------------------------------------------------------

def test_gemma2_config_is_admitted_with_windows_and_softcaps(models):
    cfg = models[0]
    tf.check_supported(cfg)
    windows = [s.window for s in cfg.layer_specs()]
    assert windows.count(64) == 2 and windows.count(None) == 2
    assert (cfg.attn_softcap, cfg.final_softcap) == (50.0, 30.0)


def test_gemma2_forward_logits_match(models):
    cfg, jcfg, params, model = models
    toks = _tokens(cfg, 2, 150, seed=0)
    ref = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(toks)},
                                 JRT))
    ours = tf.forward(cfg, model, {"inputs": torch.from_numpy(toks)},
                      RT).numpy()
    np.testing.assert_allclose(ours, ref, **LOGIT_TOL)


def _pieces(s, chunk):
    return [(0, s)] if chunk is None else \
        [(o, min(chunk, s - o)) for o in range(0, s, chunk)]


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_gemma2_dense_prefill_and_decode_past_the_wrap(models,
                                                       prefill_chunk):
    """Bucket-padded prompts of 72, 70 and 50 tokens (two past the window
    of 64) into dense caches, whole or in 8-token chunks, then 16 decode
    steps (every row past the wrap): equal logits, tokens and ring
    contents."""
    cfg, jcfg, params, model = models
    toks = _tokens(cfg, 3, 72, seed=1)
    true_len = np.array([72, 70, 50], np.int32)
    jc = jtf.init_cache(jcfg, 3, 160, jnp.float32)
    tc = tf.init_cache(cfg, 3, 160, torch.float32, "cpu")
    last_j = last_t = None
    for off, c in _pieces(72, prefill_chunk):
        jl, jc = jtf.prefill(jcfg, params,
                             {"inputs": jnp.asarray(toks[:, off:off + c])},
                             jc, JRT, kv_offset=off,
                             true_len=jnp.asarray(true_len))
        tl, tc = tf.prefill(cfg, model,
                            {"inputs": torch.from_numpy(toks[:, off:off + c])},
                            tc, RT, kv_offset=off,
                            true_len=torch.from_numpy(true_len))
        sel = (true_len - 1 >= off) & (true_len - 1 < off + c)
        last_j = np.where(sel[:, None], np.asarray(jl),
                          0 if last_j is None else last_j)
        last_t = np.where(sel[:, None], tl.numpy(),
                          0 if last_t is None else last_t)
    np.testing.assert_allclose(last_t, last_j, **LOGIT_TOL)
    kv = true_len.copy()
    for _ in range(16):
        nxt = last_j.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(nxt, last_t.argmax(-1))
        kv = kv + 1
        jl, jc = jtf.decode_step(jcfg, params, jnp.asarray(nxt[:, None]), jc,
                                 jnp.asarray(kv), JRT)
        tl, tc = tf.decode_step(cfg, model, torch.from_numpy(nxt[:, None]),
                                tc, torch.from_numpy(kv), RT)
        last_j, last_t = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(last_t, last_j, **LOGIT_TOL)
    assert (kv > 64).all()
    # ring rows hold the same keys slot for slot (the reference stacks
    # each run's layers on axis 0; gemma2's pattern is (local, global))
    for layer, c in enumerate(tc):
        run = np.asarray(jc[0][layer % 2]["attn"]["k"])[layer // 2]
        np.testing.assert_allclose(c["attn"]["k"].numpy(), run, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("prefill_chunk", [None, 80])
def test_gemma2_dense_prefill_without_true_len(models, prefill_chunk):
    """Prompts of 160 tokens with no ``true_len``: the ring keeps each
    row's last 64 positions, also when one 80-token chunk alone wraps the
    ring (the reference's unmasked ring writes); equal last logits and
    ring contents."""
    cfg, jcfg, params, model = models
    toks = _tokens(cfg, 2, 160, seed=7)
    jc = jtf.init_cache(jcfg, 2, 192, jnp.float32)
    tc = tf.init_cache(cfg, 2, 192, torch.float32, "cpu")
    for off, c in _pieces(160, prefill_chunk):
        jl, jc = jtf.prefill(jcfg, params,
                             {"inputs": jnp.asarray(toks[:, off:off + c])},
                             jc, JRT, kv_offset=off)
        tl, tc = tf.prefill(cfg, model,
                            {"inputs": torch.from_numpy(toks[:, off:off + c])},
                            tc, RT, kv_offset=off)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for layer in (0, 2):                                  # the ring layers
        run = np.asarray(jc[0][0]["attn"]["v"])[layer // 2]
        np.testing.assert_allclose(tc[layer]["attn"]["v"].numpy(), run,
                                   rtol=1e-5, atol=1e-5)


def _paged_tables(n_pages, ps, widths, slots, rng):
    """One table per class: distinct random pages for every slot row."""
    tables = {}
    for key, w in widths.items():
        perm = rng.permutation(n_pages[key])
        tables[key] = perm[:slots * w].reshape(slots, w).astype(np.int32)
    return tables


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_gemma2_paged_prefill_and_decode_loop_match(models, prefill_chunk):
    """The paged layout: the ring class "w64" (4 pages of 16) and the full
    class, random page orders, prompts of 72 and 56 into slots 1 and 3,
    then the fused loop with the tables for 16 steps past the wrap: equal
    tokens, logits and pages."""
    cfg, jcfg, params, model = models
    toks = _tokens(cfg, 2, 72, seed=3)
    true_len = np.array([72, 56], np.int32)
    ps, slots = 16, 4
    widths = {"full": 8, "w64": 4}
    n_pages = {"full": 40, "w64": 20}
    tables = _paged_tables(n_pages, ps, widths, slots,
                           np.random.default_rng(4))
    slot_ids = np.array([1, 3], np.int32)
    jc = jtf.init_paged_cache(jcfg, slots, n_pages, ps, jnp.float32)
    tc = tf.init_paged_cache(cfg, slots, n_pages, ps, torch.float32, "cpu")
    jbt = {k: jnp.asarray(t) for k, t in tables.items()}
    tbt = {k: torch.from_numpy(t) for k, t in tables.items()}
    last_j = last_t = None
    for off, c in _pieces(72, prefill_chunk):
        jl, jc = jtf.prefill(jcfg, params,
                             {"inputs": jnp.asarray(toks[:, off:off + c])},
                             jc, JRT, kv_offset=off,
                             true_len=jnp.asarray(true_len),
                             block_tables=jbt, slot_ids=jnp.asarray(slot_ids))
        tl, tc = tf.prefill(cfg, model,
                            {"inputs": torch.from_numpy(toks[:, off:off + c])},
                            tc, RT, kv_offset=off,
                            true_len=torch.from_numpy(true_len),
                            block_tables=tbt,
                            slot_ids=torch.from_numpy(slot_ids))
        sel = (true_len - 1 >= off) & (true_len - 1 < off + c)
        last_j = np.where(sel[:, None], np.asarray(jl),
                          0 if last_j is None else last_j)
        last_t = np.where(sel[:, None], tl.numpy(),
                          0 if last_t is None else last_t)
    np.testing.assert_allclose(last_t, last_j, **LOGIT_TOL)
    lj = jnp.zeros((slots, cfg.vocab)).at[slot_ids].set(last_j)
    lt = torch.zeros((slots, cfg.vocab))
    lt[torch.from_numpy(slot_ids).long()] = torch.from_numpy(last_t)
    kv_len = np.array([0, 72, 0, 56], np.int32)
    remaining = np.array([0, 16, 0, 14], np.int32)
    jout = jtf.decode_loop(jcfg, params, jc, jnp.asarray(kv_len), lj,
                           jnp.asarray(remaining), jax.random.PRNGKey(0),
                           n_steps=16, rt=JRT, block_tables=jbt)
    tout = tf.decode_loop(cfg, model, tc, torch.from_numpy(kv_len), lt,
                          torch.from_numpy(remaining), n_steps=16, rt=RT,
                          host_remaining=remaining, block_tables=tbt)
    np.testing.assert_array_equal(np.asarray(jout[0]), tout[0].numpy())
    live = kv_len > 0
    np.testing.assert_allclose(tout[3].numpy()[live],
                               np.asarray(jout[3])[live], **LOGIT_TOL)
    for layer, c in enumerate(tout[1]):
        ref = np.asarray(jout[1][0][layer % 2]["attn"]["k_pages"])
        np.testing.assert_allclose(c["attn"]["k_pages"][:-1].numpy(),
                                   ref[layer // 2], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_port(model, cfg, prompts, new_tokens, layout, **kw):
    eng = ServeEngine(cfg, model, rt=RT, device="cpu", cache_layout=layout,
                      **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return eng, [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def trace(models):
    """One prompt for each slot, 40-100 tokens (two length buckets)."""
    cfg = models[0]
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in (40, 64, 77, 100)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma2_engine_streams_equal_reference_engine(models, trace, layout):
    """Prompts of 40-100 tokens, 48 new tokens each, 4 slots: every ring
    wraps before its request ends; the greedy streams and the dispatch
    counters equal the reference engine's."""
    cfg, jcfg, params, model = models
    kw = dict(slots=4, max_len=160, decode_chunk=8, cache_layout=layout)
    jeng = JaxServeEngine(jcfg, params, rt=JRT, **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=48)
             for i, p in enumerate(trace)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    kw.pop("cache_layout")
    teng, ours = _serve_port(model, cfg, trace, 48, layout, **kw)
    assert ours == [list(r.generated) for r in jreqs]
    assert all(len(g) == 48 for g in ours)
    assert min(len(p) for p in trace) + 48 > 64
    for key in ("prefill_dispatches", "decode_dispatches", "decode_steps",
                "tokens_decoded", "tokens_prefilled"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.logits_finite()


def test_gemma2_paged_ring_eviction_matches_dense_rotation(models):
    """The port's own dense and paged layouts on prompts past the window,
    page size 16 (the ring class is 4 pages), 4 requests through 2 slots
    so later requests reuse the ring pages of finished ones: equal greedy
    streams."""
    cfg, _, _, model = models
    w = cfg.layer_specs()[0].window
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (w + 9, 12, 2 * w + 5, w - 1)]
    kw = dict(slots=2, max_len=192, decode_chunk=8)
    _, dense = _serve_port(model, cfg, prompts, 16, "dense", **kw)
    pe, paged = _serve_port(model, cfg, prompts, 16, "paged", page_size=16,
                            **kw)
    assert dense == paged
    assert pe.kv.classes["w64"].table_width == 4
    pe.kv.check_invariants()


def test_gemma2_prefix_cache_turns_itself_off(models):
    """A ring working set is not reconstructible from retained pages: the
    prefix cache gates itself off for windowed configs (the reference's
    test_prefix_cache.py)."""
    cfg = models[0]
    kv = PagedKVCache(cfg, slots=2, max_len=128, dtype=torch.float32,
                      page_size=16, prefix_caching=True, device="cpu")
    assert not kv.prefix_supported and not kv.prefix_enabled
    assert set(kv.classes) == {"full", "w64"}
    info = kv.admit(0, np.arange(20, dtype=np.int32), 21)
    assert info == {"cached_len": 0, "reused": 0, "cow_pairs": [],
                    "promotes": []}
    assert kv.pages_in_use == {"full": 2, "w64": 2}
    kv.release(0, tokens=np.arange(20, dtype=np.int32))
    assert all(v == 0 for v in kv.pages_in_use.values())
    kv.check_invariants()


def test_paged_decode_capacity_cuts_the_ref_view():
    """``fusemax_decode_paged(capacity=...)``: the "ref" path reads only
    the first ``capacity`` logical tokens (a ring of 40 in a 48-token
    table), as the reference's jnp path does; "torch" runs K3's plain
    version on the table at ``kv_len <= capacity``."""
    rng = np.random.default_rng(6)
    b, hq, hkv, d, ps, w = 2, 4, 2, 32, 16, 3
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((8, ps, hkv, d)).astype(np.float32)
              for _ in range(2))
    table = np.array([[5, 0, 7], [2, 6, 1]], np.int32)
    kv_len = np.array([40, 23], np.int32)
    args = (q, kp, vp, table, kv_len)
    want = np.asarray(jax_ops.fusemax_decode_paged(
        *map(jnp.asarray, args), capacity=40, softcap=50.0, impl="jnp"))
    for impl in ("ref", "torch"):
        got = ops.fusemax_decode_paged(*map(torch.from_numpy, args),
                                       capacity=40, softcap=50.0,
                                       impl=impl).numpy()
        np.testing.assert_allclose(got, want, err_msg=impl, **F32_TOL)
