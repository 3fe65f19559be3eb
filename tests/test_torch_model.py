"""The port's configs, weight bridge and model against the JAX reference.

Same weights (the reference's ``init`` through ``repro_torch.bridge``),
same numpy-seeded tokens, CPU on both sides.  Logits are O(100) at smoke
size and both sides compute in fp32, differing only in summation order
through 4 layers: rtol 1e-5 with atol 2e-4.  Greedy token streams must be
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime

LOGIT_TOL = dict(rtol=1e-5, atol=2e-4)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)


def _pair(name):
    jcfg = jax_get_config(name)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    cfg = get_config(name)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return name, cfg, jcfg, params, model


@pytest.fixture(scope="module")
def pair():
    """(name, port cfg, reference cfg, reference params, port model) for
    the slice's model, granite-3-8b, at smoke size."""
    return _pair("granite-3-8b-smoke")


@pytest.fixture(scope="module")
def gemma7():
    """gemma-7b at smoke size: GeLU MLP, embeddings scaled by sqrt(d), a
    tied head, one kv head per query head."""
    return _pair("gemma-7b-smoke")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_configs_equal_field_for_field(name):
    for n in (name, name + "-smoke"):
        ours, ref = get_config(n), jax_get_config(n)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), n
        assert [dataclasses.asdict(s) for s in ours.layer_specs()] == \
            [dataclasses.asdict(s) for s in ref.layer_specs()], n
        assert [([dataclasses.asdict(s) for s in pat], r)
                for pat, r in ours.runs()] == \
            [([dataclasses.asdict(s) for s in pat], r)
             for pat, r in ref.runs()], n
        assert ours.param_count() == ref.param_count(), n
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


def test_layernorm_untied_forward_matches():
    """stablelm: LayerNorm with bias and an untied LM head."""
    name, cfg, jcfg, params, model = _pair("stablelm-1.6b-smoke")
    toks = _tokens(cfg, 2, 12)
    ref = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(toks)},
                                 JRT))
    ours = tf.forward(cfg, model, {"inputs": torch.from_numpy(toks)},
                      RT).numpy()
    np.testing.assert_allclose(ours, ref, **LOGIT_TOL)
    back = bridge.jax_from_model(cfg, model)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, b)


def test_bridge_round_trips(pair):
    name, cfg, jcfg, params, model = pair
    want = jax.device_get(params)
    back = bridge.jax_from_model(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_forward_logits_match(pair):
    name, cfg, jcfg, params, model = pair
    toks = _tokens(cfg, 2, 24)
    ref = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(toks)},
                                 JRT))
    ours = tf.forward(cfg, model, {"inputs": torch.from_numpy(toks)},
                      RT).numpy()
    np.testing.assert_allclose(ours, ref, **LOGIT_TOL)


def _prefill_both(cfg, jcfg, params, model, toks, true_len, max_len,
                  prefill_chunk=None):
    jc = jtf.init_cache(jcfg, toks.shape[0], max_len, jnp.float32)
    tc = tf.init_cache(cfg, toks.shape[0], max_len, torch.float32, "cpu")
    s = toks.shape[1]
    pieces = [(0, s)] if prefill_chunk is None else \
        [(o, min(prefill_chunk, s - o)) for o in range(0, s, prefill_chunk)]
    for off, c in pieces:
        jl, jc = jtf.prefill(jcfg, params,
                             {"inputs": jnp.asarray(toks[:, off:off + c])},
                             jc, JRT, kv_offset=off,
                             true_len=jnp.asarray(true_len))
        tl, tc = tf.prefill(cfg, model,
                            {"inputs": torch.from_numpy(toks[:, off:off + c])},
                            tc, RT, kv_offset=off,
                            true_len=torch.from_numpy(true_len))
    return jl, jc, tl, tc


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_prefill_and_decode_steps_match(pair, prefill_chunk):
    name, cfg, jcfg, params, model = pair
    toks = _tokens(cfg, 3, 24, seed=1)
    true_len = np.array([24, 17, 9], np.int32)
    jl, jc, tl, tc = _prefill_both(cfg, jcfg, params, model, toks, true_len,
                                   64, prefill_chunk)
    if prefill_chunk is None:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    kv = true_len.copy()
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(nxt, tl.argmax(-1).numpy())
        kv = kv + 1
        jl, jc = jtf.decode_step(jcfg, params, jnp.asarray(nxt[:, None]), jc,
                                 jnp.asarray(kv), JRT)
        tl, tc = tf.decode_step(cfg, model, torch.from_numpy(nxt[:, None]),
                                tc, torch.from_numpy(kv), RT)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_gemma7_forward_logits_match(gemma7):
    test_forward_logits_match(gemma7)


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_gemma7_prefill_and_decode_steps_match(gemma7, prefill_chunk):
    test_prefill_and_decode_steps_match(gemma7, prefill_chunk)


def test_decode_loop_greedy_streams_equal(pair):
    """The fused loop with ragged budgets (one slot empty, one finishing
    early): equal token blocks, steps, kv_len and remaining."""
    name, cfg, jcfg, params, model = pair
    toks = _tokens(cfg, 4, 16, seed=2)
    true_len = np.array([16, 11, 5, 1], np.int32)
    jl, jc, tl, tc = _prefill_both(cfg, jcfg, params, model, toks, true_len,
                                   48)
    kv_len = np.array([16, 11, 5, 0], np.int32)       # slot 3 is empty
    remaining = np.array([6, 2, 9, 0], np.int32)
    jout = jtf.decode_loop(jcfg, params, jc, jnp.asarray(kv_len), jl,
                           jnp.asarray(remaining), jax.random.PRNGKey(0),
                           n_steps=8, rt=JRT)
    tout = tf.decode_loop(cfg, model, tc, torch.from_numpy(kv_len), tl,
                          torch.from_numpy(remaining), n_steps=8, rt=RT,
                          host_remaining=remaining)
    jtoks, _, jkv, jlog, jrem, _, jsteps = jout
    ttoks, _, tkv, tlog, trem, tsteps = tout
    assert int(jsteps) == tsteps == 8
    np.testing.assert_array_equal(np.asarray(jtoks), ttoks.numpy())
    np.testing.assert_array_equal(np.asarray(jkv), tkv.numpy())
    np.testing.assert_array_equal(np.asarray(jrem), trem.numpy())
    live = np.array([True, True, True, False])
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               **LOGIT_TOL)


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_paged_prefill_and_decode_loop_match(pair, prefill_chunk):
    """The model on the paged layout: a bucketed prefill into two of four
    slots through their block tables (optionally in 8-token pieces), then
    the fused loop with the tables: equal tokens and logits, and pools
    equal page for page (the port's sink page aside)."""
    name, cfg, jcfg, params, model = pair
    toks = _tokens(cfg, 2, 24, seed=3)
    true_len = np.array([24, 13], np.int32)
    n_pages, ps = 12, 8
    table = np.full((4, 8), n_pages, np.int32)
    table[1, :5] = [7, 2, 10, 0, 4]
    table[3, :4] = [3, 11, 5, 8]
    slot_ids = np.array([1, 3], np.int32)
    jc = jtf.init_paged_cache(jcfg, 4, {"full": n_pages}, ps, jnp.float32)
    tc = tf.init_paged_cache(cfg, 4, {"full": n_pages}, ps, torch.float32,
                             "cpu")
    jbt, tbt = {"full": jnp.asarray(table)}, {"full": torch.from_numpy(table)}
    pieces = [(0, 24)] if prefill_chunk is None else \
        [(o, 8) for o in range(0, 24, 8)]
    for off, c in pieces:
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
    if prefill_chunk is None:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    last_j = jnp.zeros((4, cfg.vocab)).at[slot_ids].set(jl)
    last_t = torch.zeros((4, cfg.vocab))
    last_t[torch.from_numpy(slot_ids).long()] = tl
    kv_len = np.array([0, 24, 0, 13], np.int32)
    remaining = np.array([0, 5, 0, 8], np.int32)
    jout = jtf.decode_loop(jcfg, params, jc, jnp.asarray(kv_len), last_j,
                           jnp.asarray(remaining), jax.random.PRNGKey(0),
                           n_steps=8, rt=JRT, block_tables=jbt)
    tout = tf.decode_loop(cfg, model, tc, torch.from_numpy(kv_len), last_t,
                          torch.from_numpy(remaining), n_steps=8, rt=RT,
                          host_remaining=remaining, block_tables=tbt)
    np.testing.assert_array_equal(np.asarray(jout[0]), tout[0].numpy())
    live = kv_len > 0
    np.testing.assert_allclose(tout[3].numpy()[live],
                               np.asarray(jout[3])[live], **LOGIT_TOL)
    for name in ("k_pages", "v_pages"):
        ref = np.asarray(jout[1][0][0]["attn"][name])   # stacked layers
        for layer, c in enumerate(tout[1]):
            np.testing.assert_allclose(c["attn"][name][:-1].numpy(),
                                       ref[layer], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,item", [
    ("deepseek-v3-671b-smoke", "MoE"),
    ("hymba-1.5b-smoke", "SSM"),
    ("musicgen-large-smoke", "front end"),
    ("llama4-maverick-400b-a17b-smoke", "MoE"),
])
def test_unported_configs_raise(name, item):
    """The configs that once raised naming their ROADMAP item now build
    with the part that was missing: MoE (item 5b) with its expert layers,
    the SSM hybrid and the frame front end (item 6) with their ``ssm``
    modules and ``frontend_proj`` (tests/test_torch_moe.py and
    tests/test_torch_hybrid.py hold them to the reference)."""
    model = tf.init(get_config(name), 0, RT, device="cpu")
    part = {"MoE": lambda: any(hasattr(layer, "moe")
                               for layer in model.layers),
            "SSM": lambda: all(hasattr(layer, "ssm")
                               for layer in model.layers),
            "front end": lambda: tuple(model.frontend_proj.w.shape) == (
                get_config(name).d_model,) * 2}[item]
    assert part()


def test_init_defaults_to_cuda_and_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init(get_config("granite-3-8b-smoke"), 0, RT)
    model = tf.init(get_config("granite-3-8b-smoke"), 0, RT, device="cpu")
    assert model.embed.table.device.type == "cpu"
