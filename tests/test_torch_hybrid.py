"""The hybrid, SSM and front-end models (hymba-1.5b, xlstm-125m,
pixtral-12b, musicgen-large) in the port against the JAX reference.

Weights come from the reference's ``transformer.init`` through the bridge
(its Mamba / mLSTM / sLSTM leaves and ``frontend_proj`` included); inputs
from numpy with a seed; the reference runs in jnp on the CPU.

1. ``forward`` on hymba-1.5b-smoke (parallel GQA + Mamba, windows of 64
   except the first and last layer, G = 4), its G = 5 variant (10 q over
   2 kv heads, the full config's group) and xlstm-125m-smoke (mLSTM with
   sLSTM at layer 1, no attention, no MLP): logits within rtol 1e-5 /
   atol 2e-4 of the reference's; and ``prefill`` + ``decode_step`` against
   ``forward`` at the reference's own 2e-3 of scale
   (``tests/test_archs_smoke.py``).
2. The serving engine's greedy streams and counters equal the reference
   engine's on the dense and the paged layout, on a trace served with
   ``prefill_chunk`` (SSM state carried across chunks), after
   ``warmup()`` and, paged, on a pool small enough to preempt (a
   preempted request re-prefills from fresh state); the G = 5 variant on
   a plain trace.  The paged pool takes no prefix cache, and
   ``speculate`` is refused, as in the reference.
3. pixtral-12b-smoke (patches) and musicgen-large-smoke (frames,
   layernorm, GeLU, MHA) at the model level: ``forward``, ``prefill`` and
   ``decode_step`` on [B, S, d] embeddings against the reference's.
4. The launcher serves hymba / xlstm smoke on both layouts with equal
   streams and the SSM state in its memory report, and refuses the
   front-end archs with a ``SystemExit`` that says why.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch import serve
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-4)
HYMBA, XLSTM = "hymba-1.5b-smoke", "xlstm-125m-smoke"
HYMBA_G5 = "hymba-1.5b-smoke-g5"
PIXTRAL, MUSICGEN = "pixtral-12b-smoke", "musicgen-large-smoke"
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "peak_live_tokens",
             "prefix_hits", "tokens_reused", "cow_copies",
             "tokens_prefilled")


def _cfgs(name):
    if name == HYMBA_G5:
        kw = dict(n_heads=10, n_kv_heads=2, name=name)
        return (reduced(get_config("hymba-1.5b"), **kw),
                jax_reduced(jax_get_config("hymba-1.5b"), **kw))
    return get_config(name), jax_get_config(name)


@functools.lru_cache(maxsize=None)
def _pair(name):
    cfg, jcfg = _cfgs(name)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _inputs(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        return rng.integers(0, cfg.vocab, shape).astype(np.int32)
    return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. forward, prefill + decode
# ---------------------------------------------------------------------------

def test_the_configs_build_their_parts():
    """hymba: every layer has attention and a Mamba branch (the G = 5
    variant keeps the full config's group); xlstm: mLSTM / sLSTM layers
    with no attention, no MLP and no ln2."""
    cfg, _, _, model = _pair(HYMBA)
    assert all(hasattr(layer, "attn") and hasattr(layer, "ssm")
               and hasattr(layer, "mlp") for layer in model.layers)
    assert _cfgs(HYMBA_G5)[0].n_heads // _cfgs(HYMBA_G5)[0].n_kv_heads \
        == 5 == get_config("hymba-1.5b").n_heads \
        // get_config("hymba-1.5b").n_kv_heads
    cfg, _, _, model = _pair(XLSTM)
    kinds = [type(layer.ssm).__name__ for layer in model.layers]
    assert kinds == ["MLSTM", "SLSTM", "MLSTM", "MLSTM"]
    assert not any(hasattr(layer, n) for layer in model.layers
                   for n in ("attn", "mlp", "ln2", "moe"))


@pytest.mark.parametrize("name", [HYMBA, HYMBA_G5, XLSTM, PIXTRAL,
                                  MUSICGEN])
def test_forward_matches_reference(name):
    cfg, jcfg, params, model = _pair(name)
    x = _inputs(cfg, (2, 40), seed=5)
    want = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(x)},
                                  JRT))
    got = tf.forward(cfg, model, {"inputs": torch.from_numpy(x)}, RT)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("name", [HYMBA, XLSTM, PIXTRAL, MUSICGEN])
def test_prefill_decode_consistency(name):
    """The reference's check: a 24-token prefill and 2 decode steps
    against ``forward`` on the 26 tokens, within 2e-3 of the logits'
    scale; and each step's logits against the reference's own."""
    cfg, jcfg, params, model = _pair(name)
    b, s_pref, n_dec = 2, 24, 2
    x = _inputs(cfg, (b, s_pref + n_dec), seed=7)
    full = tf.forward(cfg, model, {"inputs": torch.from_numpy(x)}, RT)
    caches = tf.init_cache(cfg, b, s_pref + n_dec, torch.float32, "cpu")
    jc = jtf.init_cache(jcfg, b, s_pref + n_dec, jnp.float32)
    lg, caches = tf.prefill(cfg, model,
                            {"inputs": torch.from_numpy(x[:, :s_pref])},
                            caches, RT)
    jlg, jc = jtf.prefill(jcfg, params, {"inputs": jnp.asarray(
        x[:, :s_pref])}, jc, JRT)
    scale = float(full.abs().max()) + 1e-9
    assert float((lg - full[:, s_pref - 1]).abs().max()) / scale < 2e-3
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    for t in range(s_pref, s_pref + n_dec):
        kv = torch.full((b,), t + 1, dtype=torch.int32)
        lg, caches = tf.decode_step(cfg, model, torch.from_numpy(
            x[:, t:t + 1]), caches, kv, RT)
        jlg, jc = jtf.decode_step(jcfg, params, jnp.asarray(x[:, t:t + 1]),
                                  jc, jnp.asarray(kv.numpy()), JRT)
        assert float((lg - full[:, t]).abs().max()) / scale < 2e-3
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# 2. engines
# ---------------------------------------------------------------------------

def _serve(engine, req_cls, prompts, budgets, warmup=False):
    if warmup:
        engine.warmup(sorted({len(p) for p in prompts}))
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _trace(vocab, seed=7):
    """Prompts of lengths that are not powers of two (the 16- and 32-token
    buckets, one bucket row padded), some past the smoke window of 64
    only with their generated tokens."""
    rng = np.random.default_rng(seed)
    lens = (20, 13, 27, 11, 30)
    return ([rng.integers(0, vocab, n).astype(np.int32) for n in lens],
            [6, 4, 5, 6, 3])


def _both(name, layout, hard=False):
    """The port's and the reference's streams and engines on one trace;
    ``hard``: ``prefill_chunk`` 16, ``warmup()`` first and, paged, a
    6-page full class (a request needs up to 5 pages, two slots up to
    9)."""
    cfg, jcfg, params, model = _pair(name)
    prompts, budgets = _trace(cfg.vocab)
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout=layout,
              page_size=8)
    if hard:
        kw["prefill_chunk"] = 16
        if layout == "paged":
            kw["num_pages"] = 6
    teng = ServeEngine(cfg, model, rt=RT, device="cpu", **kw)
    ours = _serve(teng, Request, prompts, budgets, warmup=hard)
    jeng = JaxServeEngine(jcfg, params, rt=JRT, **kw)
    theirs = _serve(jeng, JaxRequest, prompts, budgets, warmup=hard)
    return ours, theirs, teng, jeng


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", [HYMBA, XLSTM])
def test_engine_streams_match_reference(name, layout):
    ours, theirs, teng, jeng = _both(name, layout, hard=True)
    assert ours == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.logits_finite()
    mem, jmem = teng.memory_stats(), jeng.memory_stats()
    assert mem["ssm_state_bytes"] == jmem["ssm_state_bytes"] > 0
    if layout == "paged":
        assert not teng.kv.prefix_supported and not teng.kv.prefix_enabled
        teng.kv.check_invariants()
        # xlstm holds no pages: nothing to run short of
        assert (teng.stats["preemptions"] > 0) == (name == HYMBA)
    if name == XLSTM:
        assert mem["peak_resident_cache_bytes"] == 0


def test_g5_hybrid_streams_match_reference():
    """hymba's full group, G = 5 (10 q over 2 kv heads), on both
    layouts: the folded decode rows and prefill groups of 5."""
    for layout in ("dense", "paged"):
        ours, theirs, _, _ = _both(HYMBA_G5, layout)
        assert ours == theirs, layout


@pytest.mark.parametrize("name", [HYMBA, XLSTM])
def test_speculation_refused(name):
    cfg, _, _, model = _pair(name)
    with pytest.raises(ValueError, match="SSM"):
        ServeEngine(cfg, model, slots=2, max_len=64, rt=RT, device="cpu",
                    speculate=2)


def test_engine_refuses_embedding_front_ends():
    cfg, _, _, model = _pair(PIXTRAL)
    with pytest.raises(ValueError, match="token prompts"):
        ServeEngine(cfg, model, slots=2, max_len=64, rt=RT, device="cpu")


# ---------------------------------------------------------------------------
# 4. the launcher
# ---------------------------------------------------------------------------

_ARGS = ["--device", "cpu", "--cache-layout", "both", "--requests", "4",
         "--slots", "2", "--max-len", "64", "--prompt-len", "10",
         "--prompt-len-max", "30", "--new-tokens", "4", "--repeats", "1",
         "--no-warmup", "--json", ""]


@pytest.mark.parametrize("name", [HYMBA, XLSTM])
def test_launcher_serves_the_ssm_archs(name):
    metrics = serve.main(["--arch", name] + _ARGS)
    assert metrics["outputs_match"] is True
    for lo in ("dense", "paged"):
        leg = metrics["layouts"][lo]
        assert leg["tokens_decoded"] == 16 and leg["logits_finite"]
        assert leg["memory"]["ssm_state_bytes"] > 0
        assert leg["prefix_caching"] is False
    if name == XLSTM:
        assert metrics["layouts"]["paged"]["memory"][
            "peak_resident_cache_bytes"] == 0


@pytest.mark.parametrize("name", [PIXTRAL, MUSICGEN, "pixtral-12b"])
def test_launcher_refuses_the_front_end_archs(name):
    with pytest.raises(SystemExit, match="token prompts"):
        serve.main(["--arch", name] + _ARGS)


def test_bridge_round_trips_the_new_leaves():
    """``jax_from_model`` gives back the reference's tree: the stacked
    runs' ``ssm`` leaves and ``frontend_proj`` included."""
    for name in (HYMBA, XLSTM, MUSICGEN):
        cfg, _, params, model = _pair(name)
        back = bridge.jax_from_model(cfg, model)
        ref = jax.device_get(params)
        ref.pop("mtp", None)
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        back_leaves = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in ref_leaves] == [p for p, _ in back_leaves]
        for (path, a), (_, b) in zip(ref_leaves, back_leaves):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
