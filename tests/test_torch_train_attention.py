"""The port's differentiable attention (``ops.FuseMaxAttention``) against
the reference's custom VJP (``repro.kernels.ops._make_flash_jnp``).

Inputs come from numpy with a seed; the reference runs as its own tests
run it on the CPU (``impl="jnp"`` under ``jax.grad``), the port through
K1's plain version (``impl="torch"``: the CPU's "auto") with a
log-sum-exp output, and the recompute backward in torch ops.

1. out, the log-sum-exp and (dq, dk, dv) at tests/test_kernels.py's
   training shapes (causal GQA; window 40 with softcap 20), at E ≠ F with
   a ``q_offset``, and through ``impl="ref"`` (plain autograd), within
   rtol 1e-3 / atol 1e-4 — the reference's own test's tolerance.
2. gemma2's banded case (P = M, M % W == 0, M / W = 4): the reference
   evaluates it per 2W-key band (``_banded_window_jnp``), the port with
   the window in K1's loop bounds; out and grads at the same tolerance.
3. ``torch.autograd.gradcheck`` of the Function in float64 on a tiny
   causal, windowed, softcapped GQA shape with a ``q_offset``.
4. Grad mode on the CPU launches nothing: K1's counters stay 0, and the
   forward gives the same bits with and without gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.kernels import ops as jops
from repro_torch.kernels import fusemax as fm
from repro_torch.kernels import ops

TOL = dict(rtol=1e-3, atol=1e-4)

#: (name, b, hq, hkv, p, m, e, f, causal, window, softcap, q_offset)
CASES = [
    ("causal_gqa", 1, 4, 2, 32, 128, 32, 32, True, None, None, 0),
    ("window40_softcap20", 1, 2, 2, 24, 96, 16, 16, True, 40, 20.0, 0),
    ("e_ne_f_q_offset", 2, 4, 1, 16, 64, 48, 32, True, None, None, 48),
]


def _inputs(seed, b, hq, hkv, p, m, e, f):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, p, e), (b, hkv, m, e), (b, hkv, m, f),
                      (b, hq, p, f))]


def _port(q, k, v, w, impl, **kw):
    """(out, (dq, dk, dv)) of sum(out * w) through the port."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ops.fusemax_attention(tq, tk, tv, impl=impl, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _reference(q, k, v, w, **kw):
    def loss(q, k, v):
        return jnp.sum(jops.fusemax_attention(q, k, v, impl="jnp", **kw) * w)

    out = jops.fusemax_attention(q, k, v, impl="jnp", **kw)
    return np.asarray(out), [np.asarray(g) for g in
                             jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _reference_lse(q, k, v, causal, window, softcap, q_offset):
    """The reference forward's saved LSE [B, Hkv, G, P]."""
    b, hq, p, e = q.shape
    hkv, m = k.shape[1], k.shape[2]
    flash = jops._make_flash_jnp(causal, window, softcap, e ** -0.5,
                                 q_offset, 64 if m % 64 == 0 else m, False)
    q5 = jnp.asarray(q).reshape(b, hkv, hq // hkv, p, e)
    _, (_, _, _, _, lse) = flash.fwd(q5, jnp.asarray(k), jnp.asarray(v))
    return np.asarray(lse)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_reference_custom_vjp(case):
    _, b, hq, hkv, p, m, e, f, causal, window, softcap, q_offset = case
    q, k, v, w = _inputs(len(CASES) + hq + p, b, hq, hkv, p, m, e, f)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    out, grads = _port(q, k, v, w, "torch", **kw)
    want, want_grads = _reference(q, k, v, w, **kw)
    np.testing.assert_allclose(out, want, **TOL)
    for name, g, wg in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, wg, err_msg=f"d{name}", **TOL)

    # the log-sum-exp the forward saves, in the folded row order
    g = hq // hkv
    q_f = torch.from_numpy(q).reshape(b, hkv, g, p, e).transpose(2, 3) \
        .reshape(b * hkv, p * g, e)
    _, lse = fm.fusemax_attention_torch(
        q_f, torch.from_numpy(k).reshape(b * hkv, m, e),
        torch.from_numpy(v).reshape(b * hkv, m, f), scale=e ** -0.5,
        group=g, return_lse=True, **kw)
    lse = lse.reshape(b, hkv, p, g).transpose(2, 3).numpy()
    np.testing.assert_allclose(
        lse, _reference_lse(q, k, v, causal, window, softcap, q_offset),
        **TOL)


def test_ref_impl_is_plain_autograd():
    q, k, v, w = _inputs(7, 1, 4, 2, 32, 128, 32, 32)
    kw = dict(causal=True, window=40, softcap=20.0)
    out, grads = _port(q, k, v, w, "ref", **kw)
    want, want_grads = _reference(q, k, v, w, **kw)
    np.testing.assert_allclose(out, want, **TOL)
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g, wg, **TOL)


def test_banded_window_matches_reference_bands(monkeypatch):
    """gemma2's local layers in training: the reference bands them."""
    monkeypatch.delenv("REPRO_NO_BANDING", raising=False)
    q, k, v, w = _inputs(11, 1, 4, 2, 128, 128, 32, 32)
    kw = dict(causal=True, window=32, softcap=50.0)
    out, grads = _port(q, k, v, w, "torch", **kw)
    want, want_grads = _reference(q, k, v, w, **kw)
    np.testing.assert_allclose(out, want, **TOL)
    for name, g, wg in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, wg, err_msg=f"d{name}", **TOL)


def test_gradcheck_float64():
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                            requires_grad=True)
               for s in ((1, 4, 6, 8), (1, 2, 10, 8), (1, 2, 10, 8)))
    fn = lambda q, k, v: ops.fusemax_attention(
        q, k, v, causal=True, window=6, softcap=3.0, q_offset=4,
        impl="torch", block_q=8, block_k=128)
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_grad_mode_launches_nothing_on_cpu(monkeypatch):
    monkeypatch.setattr(fm.fusemax_attention_cuda, "launches", 0)
    monkeypatch.setattr(fm.fusemax_attention_cuda, "launches_lse", 0)
    q, k, v, _ = _inputs(3, 2, 4, 2, 32, 32, 32, 32)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with_grad = ops.fusemax_attention(tq, tk, tv, causal=True)
    assert with_grad.grad_fn is not None
    with torch.no_grad():
        without = ops.fusemax_attention(tq, tk, tv, causal=True)
    assert without.grad_fn is None
    assert torch.equal(with_grad.detach(), without)
    with_grad.sum().backward()
    assert fm.fusemax_attention_cuda.launches == 0
    assert fm.fusemax_attention_cuda.launches_lse == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.fusemax_attention(tq, tk, tv, causal=True, impl="cuda")
