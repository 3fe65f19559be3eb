"""The port's training path against the reference's: the loss and every
gradient, the MoE load-balance loss, and the train step.

Weights come from the reference's ``init`` through the bridge (the MTP
head included), batches from numpy with a seed, handed to both.  The
reference runs in fp32 as its own tests run it on the CPU (``impl="jnp"``
attention: its custom VJP, banded on gemma2's local layers), the port
through K1's plain version with a log-sum-exp output and the recompute
backward, each (pattern, repeat) rematerialized.

1. ``loss_fn`` and ``jax.value_and_grad(repro...loss_fn)`` on three
   2-layer smoke configs: ``stablelm-1.6b-smoke`` (B 2 x S 32, a ragged
   ``loss_mask``), ``gemma2-9b-smoke`` (B 1 x S 128: a 64-token window
   that binds, attention softcap 50, final softcap 30, post-norms, tied
   embeddings) and ``deepseek-v3-671b-smoke`` (MLA at K1's smoke dims
   (48, 32), a dense then an MoE layer, the MTP head on ``mtp_targets``).
   The loss within 1e-5 relative, each metric too; every parameter's
   gradient within 1e-4 of its own leaf's largest magnitude.
2. ``moe_ffn(..., return_aux=True)``: the load-balance loss and output
   against the reference's (rtol 2e-4 / atol 2e-5, tests/test_moe.py's).
3. The train step (AdamW, warmup-cosine, clip 1.0): three steps from a
   bridged reference ``TrainState`` against the reference's jitted step,
   parameters within rtol 2e-4 / atol 2e-5 and the metrics; and one step
   from the state the reference reached after two (its optimizer moments
   and count bridged).  Then the port alone, as
   tests/test_train_integration.py: 4 microbatches = 1, the loss halves
   on one batch, int8 error feedback trains.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.model import moe as jmoe
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.training import train_step as jts
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.model import moe
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.training import train_step as ts

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)

#: (arch, batch, seq)
LOSS_CASES = [("stablelm-1.6b-smoke", 2, 32), ("gemma2-9b-smoke", 1, 128),
              ("deepseek-v3-671b-smoke", 2, 32)]


def _cfgs(arch: str, **kw):
    kw = {"n_layers": 2, **kw}
    return (dataclasses.replace(get_config(arch), **kw),
            dataclasses.replace(jax_get_config(arch), **kw))


def _batch(cfg, b: int, s: int, seed: int, ragged_mask: bool = False):
    """The same numpy batch for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1 + cfg.n_mtp))
    batch = {"inputs": toks[:, :s].astype(np.int32),
             "targets": toks[:, 1:s + 1].astype(np.int32),
             "loss_mask": np.ones((b, s), np.float32)}
    if ragged_mask:
        batch["loss_mask"][0, s // 2:] = 0.0
    if cfg.n_mtp:
        batch["mtp_targets"] = np.stack(
            [toks[:, 2 + j:s + 2 + j] for j in range(cfg.n_mtp)],
            axis=-1).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=LOSS_CASES, ids=[c[0] for c in
                                                         LOSS_CASES])
def loss_case(request):
    arch, b, s = request.param
    cfg, jcfg = _cfgs(arch)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    batch = _batch(cfg, b, s, seed=1, ragged_mask=arch.startswith("stable"))
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, _jax_batch(batch), JRT),
        has_aux=True)(params)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu", with_mtp=True)
    names = [n for n, _ in model.named_parameters()]
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = tf.loss_fn(cfg, model, _torch_batch(batch), RT)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return dict(cfg=cfg, loss=loss.detach(),
                metrics={k: v.detach() for k, v in metrics.items()},
                jloss=jloss,
                jmetrics=jmetrics, grads=dict(zip(names, grads)),
                jgrads=bridge.state_from_jax(cfg, jax.device_get(jgrads),
                                             with_mtp=True))


def test_loss_matches_reference(loss_case):
    c = loss_case
    np.testing.assert_allclose(float(c["loss"]), float(c["jloss"]),
                               rtol=1e-5, atol=0)
    assert set(c["metrics"]) == set(c["jmetrics"])
    for k, v in c["jmetrics"].items():
        np.testing.assert_allclose(float(c["metrics"][k]), float(v),
                                   rtol=1e-5, atol=0, err_msg=k)
    if c["cfg"].n_mtp:
        assert float(c["metrics"]["mtp_loss"]) > 0


def test_every_grad_matches_reference(loss_case):
    c = loss_case
    assert set(c["grads"]) == set(c["jgrads"])
    if c["cfg"].n_mtp:
        assert any(k.startswith("mtp.") for k in c["grads"])
    bad = {}
    for name, want in c["jgrads"].items():
        got = c["grads"][name].numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > 1e-4 * max(scale, 1e-30):
            bad[name] = (err, scale)
    assert not bad, bad


def test_moe_aux_loss_matches_reference():
    cfg, jcfg = _cfgs("deepseek-v3-671b-smoke", n_layers=1, d_model=32,
                      d_ff=64)
    mo = dict(n_experts=8, top_k=2, d_ff_expert=48, n_shared=1,
              capacity_factor=1.25, router="softmax", aux_loss_weight=0.01)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **mo))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **mo))
    params, _ = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    port = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    flat: dict = {}
    bridge._flat("", jax.device_get(params), flat)
    with torch.no_grad():
        for name, t in port.named_parameters():
            t.copy_(torch.from_numpy(np.array(flat[name])))
    x = np.random.default_rng(4).standard_normal((3, 24, 32)).astype(
        np.float32)
    jy, jaux = jmoe.moe_ffn(params, jnp.asarray(x), jcfg, JRT,
                            return_aux=True)
    y, aux = moe.moe_ffn(port, torch.from_numpy(x), cfg, return_aux=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-4, atol=0)
    assert float(aux) > 0
    assert torch.equal(moe.moe_ffn(port, torch.from_numpy(x), cfg), y)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_ARCH = "stablelm-1.6b-smoke"


@pytest.fixture(scope="module")
def step_setup():
    """The reference's state and jitted step, and its state after two
    steps, on three numpy batches."""
    cfg, jcfg = _cfgs(STEP_ARCH)
    jopt = joptim.make_optimizer("adamw")
    jstate, _ = jts.init_train_state(jcfg, jax.random.PRNGKey(0), jopt, JRT)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt,
                                        joptim.warmup_cosine(2e-3, 2, 40),
                                        JRT))
    batches = [_batch(cfg, 4, 32, seed=10 + i) for i in range(3)]
    states, metrics = [jax.device_get(jstate)], []
    for b in batches:
        jstate, m = jstep(jstate, _jax_batch(b))
        states.append(jax.device_get(jstate))
        metrics.append(jax.device_get(m))
    return dict(cfg=cfg, states=states, metrics=metrics, batches=batches)


def _port_step(cfg, microbatches=1, compression=False):
    return ts.make_train_step(cfg, optim.make_optimizer("adamw"),
                              optim.warmup_cosine(2e-3, 2, 40), RT,
                              microbatches=microbatches,
                              compression=compression)


def _assert_params_match(cfg, state, jstate):
    want = bridge.state_from_jax(cfg, jstate.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **STEP_TOL)


def test_three_steps_match_reference(step_setup):
    c = step_setup
    cfg = c["cfg"]
    state = bridge.train_state_from_jax(cfg, c["states"][0], RT,
                                        device="cpu")
    step = _port_step(cfg)
    for b, jm in zip(c["batches"], c["metrics"]):
        state, m = step(state, _torch_batch(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=0, err_msg=key)
    assert int(state.step) == 3 and int(state.opt_state["count"]) == 3
    _assert_params_match(cfg, state, c["states"][3])


def test_step_from_reference_state_after_two_steps(step_setup):
    c = step_setup
    cfg = c["cfg"]
    state = bridge.train_state_from_jax(cfg, c["states"][2], RT,
                                        device="cpu")
    assert int(state.step) == 2 and int(state.opt_state["count"]) == 2
    want_m = bridge.state_from_jax(cfg, c["states"][2].opt_state["m"])
    for name, m in state.opt_state["m"].items():
        assert np.array_equal(m.numpy(), want_m[name])
    state, m = _port_step(cfg)(state, _torch_batch(c["batches"][2]))
    np.testing.assert_allclose(float(m["loss"]), float(c["metrics"][2]
                                                       ["loss"]), rtol=1e-5)
    _assert_params_match(cfg, state, c["states"][3])


#: the per-tensor statistics the reference takes over a run's stacked
#: layers: Adafactor's update-clipping RMS, the int8 scale, the top-k
#: threshold and its k — (optimizer, compression, peak lr).  Adafactor's
#: step is RMS-normalised, so its lr is the step's size: at 2e-2 the
#: clipping binds enough to show a per-layer RMS at the 1e-4 gate.
STAT_CASES = {"adafactor": ("adafactor", False, 2e-2),
              "int8": ("adamw", "int8", 2e-3),
              "topk": ("adamw", "topk", 2e-3)}


def run_stat_case(case: str, monkeypatch):
    """Three steps of the port and of the reference's jitted step from one
    bridged state on one numpy batch each: (port losses, reference
    losses, port params, reference params by the port's names)."""
    opt_name, compression, lr = STAT_CASES[case]
    cfg, jcfg = _cfgs(STEP_ARCH)
    jopt = joptim.make_optimizer(opt_name)
    jstate, _ = jts.init_train_state(jcfg, jax.random.PRNGKey(0), jopt, JRT,
                                     compression=bool(compression))
    if compression == "topk":
        monkeypatch.setattr(jts, "ef_int8_compress", joptim.ef_topk_compress)
    jstep = jax.jit(jts.make_train_step(
        jcfg, jopt, joptim.warmup_cosine(lr, 2, 40), JRT,
        compression=bool(compression)))
    state = bridge.train_state_from_jax(cfg, jax.device_get(jstate), RT,
                                        device="cpu")
    step = ts.make_train_step(cfg, optim.make_optimizer(opt_name),
                              optim.warmup_cosine(lr, 2, 40), RT,
                              compression=compression)
    losses, jlosses = [], []
    for i in range(3):
        b = _batch(cfg, 4, 32, seed=20 + i)
        jstate, jm = jstep(jstate, _jax_batch(b))
        state, m = step(state, _torch_batch(b))
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    want = bridge.state_from_jax(cfg, jax.device_get(jstate).params)
    got = {k: p.detach().numpy() for k, p in state.params.items()}
    return losses, jlosses, got, want


@pytest.mark.parametrize("case", list(STAT_CASES))
def test_three_steps_match_reference_run_statistics(case, monkeypatch):
    """Three steps on stablelm-1.6b-smoke, whose two layers are one
    (pattern, repeat) run: the reference stacks them in one leaf, so each
    statistic spans both layers; the port groups its per-layer leaves the
    same way (per-layer statistics put 75 / 5.5 / 19 % of a leaf's
    elements past the gate on Adafactor / int8 / top-k, and top-k's third
    loss 9.5e-5 off).  The reference's
    step has int8 error feedback only, so the top-k case runs it with
    ``ef_topk_compress`` in its place.  Losses within 1e-5 relative,
    every parameter within 1e-4 — on int8 but for at most 1 in 1000 of a
    leaf's elements: a last-bit difference in a gradient moves an int8
    code across its rounding boundary, and AdamW turns one code's change
    into a step of ~lr on that element (1–5 such elements a leaf)."""
    losses, jlosses, got, want = run_stat_case(case, monkeypatch)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    allowed = 1e-3 if case == "int8" else 0.0
    bad = {}
    for k, w in want.items():
        n = int((np.abs(got[k] - w) > 1e-4).sum())
        if n > allowed * w.size:
            bad[k] = (n, w.size, float(np.abs(got[k] - w).max()))
    assert not bad, bad


def _fresh(cfg, compression=False):
    return ts.init_train_state(cfg, 0, optim.make_optimizer("adamw"), RT,
                               compression=compression, device="cpu")


def test_microbatch_accumulation_matches_full_batch():
    cfg, _ = _cfgs(STEP_ARCH)
    b = _torch_batch(_batch(cfg, 4, 32, seed=3))
    s1, m1 = _port_step(cfg)(_fresh(cfg), b)
    s4, m4 = _port_step(cfg, microbatches=4)(_fresh(cfg), b)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for (name, a), c in zip(s1.params.items(), s4.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   err_msg=name, **STEP_TOL)


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "int8_ef"])
def test_loss_falls_on_one_batch(compression):
    cfg, _ = _cfgs(STEP_ARCH)
    state = _fresh(cfg, compression)
    step = _port_step(cfg, compression=compression)
    b = _torch_batch(_batch(cfg, 4, 32, seed=1))
    losses = []
    for _ in range(15):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    # tests/test_train_integration.py: halves; with compression, 0.6
    assert losses[-1] < (0.6 if compression else 0.5) * losses[0], losses
    assert (state.ef_residual is not None) == compression
