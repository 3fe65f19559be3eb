"""The port's MoE (``repro_torch.model.moe``) against the JAX reference.

Inputs come from numpy with a seed; weights from the reference's
``moe_init`` / ``transformer.init`` through the bridge.  The reference
runs as its own tests run it: jnp on the CPU, ``Runtime()`` with fp32.

1. ``_route``, softmax and sigmoid at top-k 1, 2 and 4, on logits with
   exact ties in half the rows: expert picks equal (ties to the lower
   index, as ``jax.lax.top_k``), gates and probabilities within 1e-6.
2. ``moe_ffn`` with and without shared experts, at capacity factor 16
   (nothing drops) and 0.5 (picks drop): within rtol 2e-4 / atol 2e-5,
   tests/test_moe.py's tolerance for the same layer (fp32 products summed
   in another order).
3. Capacity follows the routed S: the serving engine prefills a
   20-token prompt in its 32-token bucket, as the reference does, so
   every MoE layer routes S = 32 (cap 10 on the smoke config: E 8, top-2,
   cf 1.25) and not the true 20 (cap 7).  On that prompt a pick drops at
   S = 32 and a real token's pick sits in a slot in [7, 10), so routing
   the true length would change the output — and the engine's streams
   equal the reference engine's.
4. Whole models, ``deepseek-v3-671b-smoke`` (MLA, layers 1-3 MoE with a
   shared expert, sigmoid router) and ``llama4-maverick-400b-a17b-smoke``
   (GQA, MoE every other layer, top-1): ``forward`` logits within rtol
   1e-5 / atol 2e-4 of the reference's, and greedy streams on a seeded
   trace (prompt lengths that are not powers of two) equal the reference
   engine's on the dense and the paged layout.  A stream that differs
   is reported with the smallest router margin (the k-th minus the
   (k+1)-th score) the port's run saw: a margin near 1e-7 is an ulp-level
   flip, anything larger a fault.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.model import moe as jmoe
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.model import moe
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-4)
DEEPSEEK, LLAMA4 = "deepseek-v3-671b-smoke", "llama4-maverick-400b-a17b-smoke"
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "peak_live_tokens",
             "prefix_hits", "tokens_reused", "cow_copies",
             "tokens_prefilled")


def _layer_cfgs(router, top_k, n_shared, cf):
    """A one-layer MoE config on both sides (d 32, 8 experts of 48)."""
    mo = dict(n_experts=8, top_k=top_k, d_ff_expert=48, n_shared=n_shared,
              capacity_factor=cf, router=router)
    kw = dict(n_layers=1, d_model=32, d_ff=64, family="moe")
    jcfg = jax_get_config(DEEPSEEK)
    jcfg = dataclasses.replace(jcfg, moe=type(jcfg.moe)(**mo), **kw)
    return dataclasses.replace(get_config(DEEPSEEK), moe=MoEConfig(**mo),
                               **kw), jcfg


def _port_moe(cfg, params) -> moe.MoE:
    p = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    flat: dict = {}
    bridge._flat("", jax.device_get(params), flat)
    assert set(flat) == {n for n, _ in p.named_parameters()}
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(flat[name])))
    return p


def _slots(gates_experts, e: int):
    """Each pick's slot in its expert (the exclusive count over S·k)."""
    experts = gates_experts.reshape(gates_experts.shape[0], -1)
    oh = torch.nn.functional.one_hot(experts, e)
    return ((torch.cumsum(oh, 1) - oh).gather(-1, experts[..., None]))[..., 0]


# ---------------------------------------------------------------------------
# 1.-2. the router and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_matches_reference(router, top_k):
    cfg, jcfg = _layer_cfgs(router, top_k, 0, 1.25)
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((4, 32, 8)).astype(np.float32)
    logits[:2] = np.round(logits[:2] * 2) / 2       # exact ties
    jg, je, jp = map(np.asarray, jmoe._route(jnp.asarray(logits), jcfg.moe))
    g, e, p = moe._route(torch.from_numpy(logits), cfg.moe)
    assert (e.numpy() == je).all()
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-6)
    # the tied rows do exercise the tie-break
    ties = [len(set(row)) < len(row) for row in logits[:2].reshape(-1, 8)]
    assert any(ties)


@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [16.0, 0.5], ids=["no-drops", "drops"])
def test_moe_ffn_matches_reference(n_shared, cf):
    cfg, jcfg = _layer_cfgs("sigmoid" if n_shared else "softmax", 2,
                            n_shared, cf)
    params, _ = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    port = _port_moe(cfg, params)
    assert hasattr(port, "shared") == bool(n_shared)
    x = np.random.default_rng(4).standard_normal((3, 24, 32)).astype(
        np.float32)
    want = np.asarray(jmoe.moe_ffn(params, jnp.asarray(x), jcfg, JRT))
    got = moe.moe_ffn(port, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, **MOE_TOL)
    # capacity 4 of 48 picks an expert on average at cf 0.5: picks drop
    _, experts, _ = moe._route(torch.from_numpy(x) @ port.router, cfg.moe)
    cap = max(4, int(np.ceil(24 * 2 / 8 * cf)))
    dropped = int((_slots(experts, 8) >= cap).sum())
    assert (dropped > 0) == (cf < 1.0)


# ---------------------------------------------------------------------------
# 3.-4. whole models and the engines
# ---------------------------------------------------------------------------

def _pair(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in (DEEPSEEK, LLAMA4)}


class _Spy:
    """Record the port's MoE calls: routed S and the inputs, and the
    smallest router margin (k-th minus (k+1)-th score)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.margin = float("inf")
        real = moe.moe_ffn

        def spy(p, x, cfg):
            self.calls.append(x.clone())
            logits = x.float() @ p.router
            scores = torch.sigmoid(logits) if cfg.moe.router == "sigmoid" \
                else torch.softmax(logits, dim=-1)
            top = torch.sort(scores, dim=-1, descending=True).values
            k = cfg.moe.top_k
            self.margin = min(self.margin,
                              float((top[..., k - 1] - top[..., k]).min()))
            return real(p, x, cfg)

        monkeypatch.setattr(moe, "moe_ffn", spy)


def _serve(engine, req_cls, prompts, budgets):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _trace(vocab, lens=(20, 13, 27, 11, 30), seed=7):
    """Prompts whose lengths are not powers of two (padded to the 16- and
    32-token buckets: two prefill shapes keep the reference's compiles
    few)."""
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, vocab, n).astype(np.int32) for n in lens],
            [6, 4, 5, 6, 3][:len(lens)])


@pytest.mark.parametrize("name", [DEEPSEEK, LLAMA4])
def test_forward_matches_reference(pairs, name):
    cfg, jcfg, params, model = pairs[name]
    assert {s.mlp for s in cfg.layer_specs()} == {"dense", "moe"}
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    want = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(toks)},
                                  JRT))
    got = tf.forward(cfg, model, {"inputs": torch.from_numpy(toks)},
                     RT).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", [DEEPSEEK, LLAMA4])
def test_engine_streams_match_reference(pairs, name, layout, monkeypatch):
    cfg, jcfg, params, model = pairs[name]
    prompts, budgets = _trace(cfg.vocab)
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout=layout,
              page_size=8)
    spy = _Spy(monkeypatch)
    teng = ServeEngine(cfg, model, rt=RT, device="cpu", **kw)
    ours = _serve(teng, Request, prompts, budgets)
    jeng = JaxServeEngine(jcfg, params, rt=JRT, **kw)
    theirs = _serve(jeng, JaxRequest, prompts, budgets)
    assert ours == theirs, (
        f"streams differ; the smallest router margin the port saw is "
        f"{spy.margin:.3g}")
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.logits_finite()
    if layout == "paged":
        assert not teng.kv.prefix_supported     # MoE, as the reference
        teng.kv.check_invariants()


def test_prefill_routes_the_padded_bucket(pairs, monkeypatch):
    """A 20-token prompt prefills in the 32-token bucket: every MoE layer
    routes S = 32, padding included, as the reference's engine does; at
    S = 32 a pick drops (cap 10), and a real token's pick sits in a slot
    of [7, 10), which the true length's cap of 7 would drop — so a port
    that routed S = 20 would change the output (shown on the first MoE
    layer's input) and fail the stream check below."""
    cfg, jcfg, params, model = pairs[DEEPSEEK]
    mo = cfg.moe
    prompts, budgets = _trace(cfg.vocab, lens=(20,), seed=1)
    spy = _Spy(monkeypatch)
    eng = ServeEngine(cfg, model, rt=RT, device="cpu", slots=1, max_len=64,
                      decode_chunk=4)
    ours = _serve(eng, Request, prompts, budgets)
    n_moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
    prefill = spy.calls[:n_moe]
    assert [tuple(x.shape[:2]) for x in prefill] == [(1, 32)] * n_moe
    assert all(x.shape[1] == 1 for x in spy.calls[n_moe:])   # decode
    cap = {s: max(4, int(np.ceil(s * mo.top_k / mo.n_experts
                                 * mo.capacity_factor))) for s in (20, 32)}
    assert cap == {20: 7, 32: 10}
    x = prefill[0]
    p = model.layers[1].moe
    _, experts, _ = moe._route(x.float() @ p.router, mo)
    slot = _slots(experts, mo.n_experts).reshape(32, mo.top_k)
    assert (slot >= cap[32]).any()
    assert ((slot[:20] >= cap[20]) & (slot[:20] < cap[32])).any()
    padded = moe.moe_ffn(p, x, cfg)[:, :20]
    true_len = moe.moe_ffn(p, x[:, :20], cfg)
    assert (padded - true_len).abs().max() > 1e-3
    jeng = JaxServeEngine(jcfg, params, rt=JRT, slots=1, max_len=64,
                          decode_chunk=4)
    assert ours == _serve(jeng, JaxRequest, prompts, budgets)
