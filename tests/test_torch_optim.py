"""The port's optimizers (``repro_torch.optim``) against the reference's.

Each reference function runs on jnp arrays, the port's on torch tensors
made from the same numpy trees (seeded); the port updates its tensors in
place.  Compared within rtol 1e-5 / atol 1e-6 (fp32, the same
elementwise formulas; sums in another order):

1. ``adamw`` with fp32 and bf16 state, ``adafactor`` factored
   (``min_dim_factored`` met by a [48, 40] leaf) and not, over four steps
   of changing gradients and a warmup-cosine learning rate: parameters,
   moments / statistics and counts.
2. ``global_norm``, ``clip_by_global_norm`` (clipped and not),
   ``warmup_cosine`` at every step of a schedule, ``ef_int8_compress``
   and ``ef_topk_compress`` (distinct magnitudes, so the top-k threshold
   is one value) with their residuals.
3. The properties of tests/test_optim.py: both optimizers converge on the
   same objective, Adafactor's factored state is small, bf16 AdamW state
   stays bf16 and finite, the clip reaches norm 1, error feedback is
   unbiased over time, and training with it converges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro import optim as joptim
from repro_torch import optim

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"w": (48, 40), "b": (40,), "x": (3, 5, 6)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


OPTS = {
    "adamw_fp32": (lambda: joptim.adamw(),
                   lambda: optim.adamw()),
    "adamw_bf16": (lambda: joptim.adamw(state_dtype=jnp.bfloat16),
                   lambda: optim.adamw(state_dtype=torch.bfloat16)),
    "adafactor_factored": (lambda: joptim.adafactor(min_dim_factored=32),
                           lambda: optim.adafactor(min_dim_factored=32)),
    "adafactor_full": (lambda: joptim.adafactor(weight_decay=0.01),
                       lambda: optim.adafactor(weight_decay=0.01)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    make_j, make_t = OPTS[name]
    jopt, topt = make_j(), make_t()
    rng = np.random.default_rng(len(name))
    p0 = _tree(rng)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _t(p0)
    jst, tst = jopt.init(jp), topt.init(tp)
    jlr, tlr = joptim.warmup_cosine(1e-2, 2, 6), optim.warmup_cosine(1e-2,
                                                                       2, 6)
    for step in range(4):
        g = _tree(rng, 0.1 * (step + 1))
        jp, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp, jlr(step + 1))
        tp, tst = topt.update(_t(g), tst, tp, tlr(step + 1))
    _close(tp, jp)
    assert int(tst["count"]) == int(jst["count"]) == 4
    if "m" in jst:
        assert tst["m"]["w"].dtype == (torch.bfloat16 if "bf16" in name
                                       else torch.float32)
        # bf16 moments: one rounding of the same fp32 value apart at most
        tol = dict(rtol=1e-2, atol=1e-6) if "bf16" in name else {}
        _close(tst["m"], jst["m"], **tol)
        _close(tst["v"], jst["v"], **tol)
    else:
        _close(tst["stats"], jst["stats"])
        factored = "vr" in tst["stats"]["w"]
        assert factored == (name == "adafactor_factored")


def test_norms_schedule_and_compression_match_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jt, tt = {k: jnp.asarray(v) for k, v in tree.items()}, _t(tree)
    _close(optim.global_norm(tt), joptim.global_norm(jt))
    for max_norm in (1.0, 1e3):                       # clipped, not clipped
        tc, tn = optim.clip_by_global_norm(tt, max_norm)
        jc, jn = joptim.clip_by_global_norm(jt, max_norm)
        _close(tc, jc)
        _close(tn, jn)
    jlr, tlr = joptim.warmup_cosine(3e-4, 10, 100), optim.warmup_cosine(
        3e-4, 10, 100)
    for s in range(0, 110, 7):
        _close(tlr(s), jlr(s))
        _close(tlr(torch.tensor(s, dtype=torch.int32)), jlr(s))

    res = _tree(rng, 0.01)
    jg, jr = joptim.ef_int8_compress(jt, {k: jnp.asarray(v)
                                          for k, v in res.items()})
    tg, tr = optim.ef_int8_compress(tt, _t(res))
    _close(tg, jg)
    _close(tr, jr)
    # distinct magnitudes: a 1-in-10 top-k keeps the same entries
    distinct = {k: (np.arange(np.prod(s)).reshape(s) - 7.5).astype(
        np.float32) * rng.choice([-1, 1], s) for k, s in SHAPES.items()}
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jg, jr = joptim.ef_topk_compress(
        {k: jnp.asarray(v) for k, v in distinct.items()},
        {k: jnp.asarray(v) for k, v in zeros.items()}, frac=0.1)
    tg, tr = optim.ef_topk_compress(_t(distinct), _t(zeros), frac=0.1)
    _close(tg, jg, rtol=0, atol=0)
    _close(tr, jr, rtol=0, atol=0)
    assert optim.init_error_feedback(tt)["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the properties of tests/test_optim.py
# ---------------------------------------------------------------------------

def _rosenbrock_ish(params):
    x, y = params["x"], params["y"]
    return torch.sum((1 - x) ** 2) + 5 * torch.sum((y - x * x) ** 2)


def _grads(params):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    gs = torch.autograd.grad(_rosenbrock_ish(p), list(p.values()))
    return dict(zip(p, gs))


@pytest.mark.parametrize("make,lr,steps,factor", [
    (lambda: optim.adamw(weight_decay=0.0), 3e-2, 400, 0.05),
    (lambda: optim.adafactor(min_dim_factored=4), 2e-2, 800, 0.05),
], ids=["adamw", "adafactor"])
def test_optimizers_converge(make, lr, steps, factor):
    opt = make()
    params = {"x": torch.zeros((8, 8)), "y": torch.zeros((8, 8))}
    state = opt.init(params)
    l0 = float(_rosenbrock_ish(params))
    for _ in range(steps):
        params, state = opt.update(_grads(params), state, params, lr)
    assert float(_rosenbrock_ish(params)) < factor * l0


def test_adafactor_factored_state_is_small():
    st = optim.adafactor().init({"w": torch.zeros((256, 512))})
    assert sum(x.numel() for x in optim.tree_leaves(st["stats"])) == 256 + 512


def test_adamw_bf16_states():
    opt = optim.adamw(state_dtype=torch.bfloat16)
    p = {"w": torch.ones((16, 16))}
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.bfloat16
    p2, _ = opt.update({"w": torch.full((16, 16), 0.1)}, st, p, 1e-2)
    assert bool(torch.isfinite(p2["w"]).all())
    assert st["v"]["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(90 + 160), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_int8_error_feedback_is_unbiased_over_time():
    gen = np.random.default_rng(0)
    res = optim.init_error_feedback({"w": torch.zeros((64, 64))})
    total_true = torch.zeros((64, 64))
    total_sent = torch.zeros((64, 64))
    for i in range(50):
        g = {"w": torch.from_numpy(gen.standard_normal((64, 64)).astype(
            np.float32)) * (0.1 + 0.01 * i)}
        dq, res = optim.ef_int8_compress(g, res)
        total_true += g["w"]
        total_sent += dq["w"]
    assert float((total_true - total_sent - res["w"]).abs().max()) < 1e-3


def test_topk_keeps_largest():
    g = {"w": torch.tensor([[1.0, -5.0, 0.1, 3.0]])}
    dq, res = optim.ef_topk_compress(g, optim.init_error_feedback(g),
                                     frac=0.5)
    assert dq["w"][0].tolist() == [0.0, -5.0, 0.0, 3.0]
    np.testing.assert_allclose(res["w"][0].numpy(), [1.0, 0.0, 0.1, 0.0],
                               atol=1e-6)


def test_training_with_compression_converges():
    opt = optim.adamw(weight_decay=0.0)
    params = {"x": torch.zeros((8, 8)), "y": torch.zeros((8, 8))}
    state = opt.init(params)
    res = optim.init_error_feedback(params)
    for _ in range(400):
        grads, res = optim.ef_int8_compress(_grads(params), res)
        params, state = opt.update(grads, state, params, 3e-2)
    assert float(_rosenbrock_ish(params)) < 0.2


def test_make_optimizer():
    assert isinstance(optim.make_optimizer("adamw"), optim.Optimizer)
    assert isinstance(optim.make_optimizer("adafactor"), optim.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("sgd")
