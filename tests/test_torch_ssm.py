"""The port's recurrent mixers (``repro_torch.model.ssm``) against the JAX
reference (``repro.model.ssm``) and the reference's ``_prefill_ssm``.

Weights come from the reference's ``mamba_init`` / ``mlstm_init`` /
``slstm_init`` through the bridge's flattening; inputs from numpy with a
seed; the reference runs in jnp on the CPU.

1. Each mixer's ``*_forward``, ``*_step`` (a token at a time from fresh
   state, the states compared too) and ``*_ref`` against the reference's
   on the same weights and inputs: fp32 paths that differ only in
   summation order (Mamba's scan runs another tree inside a chunk), within
   rtol 1e-5 / atol 1e-5 on outputs of unit scale.
2. ``tests/test_ssm.py``'s four properties on the port, at its
   tolerances: the chunked forward equals the sequential oracle (Mamba
   rtol 1e-3 / atol 1e-4, mLSTM 2e-3 / 2e-4, over seeds, lengths and
   chunks), Mamba's step handoff equals the oracle, sLSTM's forward equals
   its step (1e-4 / 1e-5), and gates pushed 40 past the bias stay finite.
3. ``_prefill_ssm``, literal (one ``*_step`` a token) and hoisted (the
   state-independent products for the whole chunk, the recurrence per
   token), against the reference's on a padded bucket with ragged
   ``true_len`` (a row past the bucket's end, rows ending inside it, one
   ending before the chunk starts) and on a ``kv_offset`` continuation of
   that state: outputs (padding included) and every state leaf within
   1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.model import ssm as jssm
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro_torch import bridge
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
from repro_torch.model import ssm
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
_KW = dict(name="t", n_layers=1, d_model=48, n_heads=4, n_kv_heads=4,
           d_ff=96, vocab=64, family="hybrid")
CFG = ModelConfig(ssm=SSMConfig(state_dim=8, expand=2), **_KW)
JCFG = JaxModelConfig(ssm=JaxSSMConfig(state_dim=8, expand=2), **_KW)
JAX_INIT = {"mamba": jssm.mamba_init, "mlstm": jssm.mlstm_init,
            "slstm": jssm.slstm_init}
JAX_STATE = {"mamba": jssm.mamba_init_state, "mlstm": jssm.mlstm_init_state,
             "slstm": jssm.slstm_init_state}
JAX_STEP = {"mamba": jssm.mamba_step, "mlstm": jssm.mlstm_step,
            "slstm": jssm.slstm_step}
KINDS = ("mamba", "mlstm", "slstm")


@functools.lru_cache(maxsize=None)
def _pair(kind: str, seed: int = 0):
    """The reference's params for ``kind`` and the port's module holding
    them (strict: the same leaf names, every parameter covered)."""
    params, _ = JAX_INIT[kind](jax.random.PRNGKey(seed), JCFG)
    mod = ssm.ssm_init(CFG, kind, dtype=torch.float32, device="cpu")
    flat: dict = {}
    bridge._flat("", jax.device_get(params), flat)
    assert set(flat) == {n for n, _ in mod.named_parameters()}
    with torch.no_grad():
        for name, t in mod.named_parameters():
            assert tuple(flat[name].shape) == tuple(t.shape), name
            t.copy_(torch.from_numpy(np.array(flat[name])))
    return params, mod


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# 1. each mixer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,chunk", [("mamba", 16), ("mamba", 64),
                                        ("mlstm", 16), ("mlstm", 64),
                                        ("slstm", None)])
def test_forward_matches_reference(kind, chunk):
    params, mod = _pair(kind)
    x = _x((2, 100, 48))
    kw = {} if chunk is None else {"chunk": chunk}
    want = getattr(jssm, f"{kind}_forward")(params, jnp.asarray(x), JCFG,
                                            JRT, **kw)
    got = ssm.FORWARD[kind](mod, torch.from_numpy(x), CFG, RT, **kw)
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_reference(kind):
    """24 decode steps from fresh state: every output and, at the end,
    every state leaf."""
    params, mod = _pair(kind)
    x = _x((2, 24, 48), seed=3)
    jst = JAX_STATE[kind](JCFG, 2, jnp.float32)
    st = ssm.INIT_STATE[kind](CFG, 2, torch.float32, "cpu")
    assert set(st) == set(jst)
    for t in range(24):
        jy, jst = JAX_STEP[kind](params, jnp.asarray(x[:, t:t + 1]), jst,
                                 JCFG, JRT)
        y, st = ssm.STEP[kind](mod, torch.from_numpy(x[:, t:t + 1]), st,
                               CFG, RT)
        _close(y, jy)
    for name in jst:
        _close(st[name], jst[name])


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_ref_matches_reference(kind):
    params, mod = _pair(kind)
    x = _x((2, 40, 48), seed=4)
    want = getattr(jssm, f"{kind}_ref")(params, jnp.asarray(x), JCFG)
    got = getattr(ssm, f"{kind}_ref")(mod, torch.from_numpy(x), CFG)
    _close(got, want)


# ---------------------------------------------------------------------------
# 2. the reference's properties, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,t,chunk", [(0, 48, 16), (11, 64, 32),
                                          (23, 100, 16), (5, 100, 32)])
def test_mamba_chunked_equals_sequential(seed, t, chunk):
    _, mod = _pair("mamba", seed)
    x = torch.from_numpy(_x((2, t, 48), seed=seed + 1))
    y1 = ssm.mamba_forward(mod, x, CFG, RT, chunk=chunk)
    y2 = ssm.mamba_ref(mod, x, CFG)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed,t,chunk", [(0, 48, 16), (11, 64, 32),
                                          (23, 100, 16), (5, 100, 32)])
def test_mlstm_chunked_equals_sequential(seed, t, chunk):
    _, mod = _pair("mlstm", seed)
    x = torch.from_numpy(_x((2, t, 48), seed=seed + 1))
    y1 = ssm.mlstm_forward(mod, x, CFG, RT, chunk=chunk)
    y2 = ssm.mlstm_ref(mod, x, CFG)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-3, atol=2e-4)


def test_mamba_decode_state_handoff():
    _, mod = _pair("mamba")
    x = torch.from_numpy(_x((2, 24, 48)))
    ref = ssm.mamba_ref(mod, x, CFG)
    st = ssm.mamba_init_state(CFG, 2, x.dtype, "cpu")
    outs = []
    for t in range(24):
        y, st = ssm.mamba_step(mod, x[:, t:t + 1], st, CFG, RT)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_slstm_forward_step_agree():
    _, mod = _pair("slstm")
    x = torch.from_numpy(_x((2, 20, 48)))
    full = ssm.slstm_forward(mod, x, CFG, RT)
    st = ssm.slstm_init_state(CFG, 2, x.dtype, "cpu")
    outs = []
    for t in range(20):
        y, st = ssm.slstm_step(mod, x[:, t:t + 1], st, CFG, RT)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_mlstm_exponential_gate_stability():
    """Gate pre-activations pushed 40 up must not produce NaN / Inf (the
    running-max stabilizer with its finite -1e30 seed)."""
    mod = ssm.ssm_init(CFG, "mlstm", dtype=torch.float32, device="cpu")
    mod.load_state_dict(_pair("mlstm")[1].state_dict())
    with torch.no_grad():
        mod.b_gates += 40.0
    x = torch.from_numpy(_x((1, 64, 48), scale=5.0))
    assert torch.isfinite(ssm.mlstm_forward(mod, x, CFG, RT, chunk=16)).all()
    st = ssm.mlstm_init_state(CFG, 1, x.dtype, "cpu")
    y, _ = ssm.mlstm_prefill(mod, x, st, CFG)
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# 3. _prefill_ssm: literal and hoisted against the reference's
# ---------------------------------------------------------------------------

def _spec(kind):
    return LayerSpec(attn="none", mlp="none", ssm=kind), \
        JaxLayerSpec(attn="none", mlp="none", ssm=kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", ["literal", "hoisted"])
def test_prefill_ssm_matches_reference(kind, form):
    """A 24-token bucket of 4 rows with true_len 24 (full), 17, 3 and 26
    (past the bucket: every token real), then a continuation chunk at
    kv_offset 24 from the handed-off state where row 2's prompt already
    ended (its state stays frozen throughout) and row 1's ends at 30."""
    params, mod = _pair(kind)
    spec, jspec = _spec(kind)
    prefill = tf._prefill_ssm_literal if form == "literal" \
        else tf._prefill_ssm
    true_len = np.array([24, 17, 3, 26], np.int32)
    x = _x((4, 24, 48), seed=8)
    jst = JAX_STATE[kind](JCFG, 4, jnp.float32)
    st = ssm.INIT_STATE[kind](CFG, 4, torch.float32, "cpu")
    for off, chunk in ((0, x), (24, _x((4, 16, 48), seed=9))):
        tl = true_len if off == 0 else np.array([40, 30, 3, 26], np.int32)
        jy, jst = jtf._prefill_ssm(params, jnp.asarray(chunk), jst, JCFG,
                                   jspec, JRT, jnp.asarray(tl), off)
        y, st = prefill(mod, torch.from_numpy(chunk), st, CFG, spec, RT,
                        torch.from_numpy(tl), off)
        _close(y, jy)
        assert set(st) == set(jst)
        for name in jst:
            _close(st[name], jst[name])


@pytest.mark.parametrize("kind", KINDS)
def test_hoisted_prefill_equals_literal_without_true_len(kind):
    """With no ``true_len`` every token of every row steps: hoisted and
    literal agree within 1e-5, states included."""
    _, mod = _pair(kind)
    spec, _ = _spec(kind)
    x = torch.from_numpy(_x((2, 20, 48), seed=12))
    st0 = ssm.INIT_STATE[kind](CFG, 2, torch.float32, "cpu")
    ya, sa = tf._prefill_ssm_literal(mod, x, dict(st0), CFG, spec, RT)
    yb, sb = tf._prefill_ssm(mod, x, dict(st0), CFG, spec, RT)
    np.testing.assert_allclose(yb.numpy(), ya.numpy(), **TOL)
    for name in sa:
        np.testing.assert_allclose(sb[name].numpy(), sa[name].numpy(),
                                   **TOL)
