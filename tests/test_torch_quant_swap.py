"""The port's quantized KV pages and host swap tier against the JAX
reference.

Quantized pools store K/V (GQA) or the latents (MLA) as fp8 e4m3 or int8
codes with fp16 scales per token in parallel pools; the port's
``quantize_kv`` must give the reference's codes and scales bit for bit.
On the CPU the port's decode takes K3's and K4's plain versions, which
dequantize each gathered tile; they are held to the reference's Pallas
kernels in interpret mode on the same codes and scales (fp32, rtol = atol
= 1e-5: the paths differ only in summation order, as in
tests/test_torch_paged.py), and to themselves on the dequantized pool,
bit for bit (``code × scale`` is exact in fp32).  Rows with kv_len = 0
follow the Pallas kernel (output 0).

The swap tier is held to the reference engine's counters (demotions,
promotions, host drops, tokens reused) and greedy streams on the
reference's own traces (tests/test_kv_quant_swap.py), and the port's
quantized engines' greedy streams to the reference engine's quantized
streams on stablelm-1.6b-smoke (both code dtypes), the MLA smoke tower
with its MoE cut (fp8) and gemma2-9b-smoke's rings (fp8).  Engines run
once per scenario (module-scoped fixtures) and several tests read them.
"""
import dataclasses
import json

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
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import decode as dec
from repro_torch.launch import serve
from repro_torch.model import attention as attn
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVCache

F32_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-5, atol=2e-5)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
KV_DTYPES = ("fp8_e4m3", "int8")
GQA = "stablelm-1.6b-smoke"
MLA = "deepseek-v3-671b-smoke"
RING = "gemma2-9b-smoke"
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "prefix_hits",
             "tokens_reused", "cow_copies", "tokens_prefilled")
SWAP_KEYS = ("prefix_evictions", "demotions", "promotions", "host_drops",
             "reregistered")


# ---------------------------------------------------------------------------
# helpers: codes between the two frameworks, bit views
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits (1- or 2-byte elements) as numpy."""
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy()
    return t.view(torch.int16).numpy().view(np.uint16)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else np.uint16)


def _to_jax(t: torch.Tensor):
    """A port tensor as a jnp array of the same dtype and bits."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _quant(x: np.ndarray, kv_dtype: str):
    """(codes, fp16 scales) of ``x`` through the port's quantize_kv."""
    return attn.quantize_kv(torch.from_numpy(x),
                            attn.kv_quant_dtype(kv_dtype))


def _with_sink(t: torch.Tensor) -> torch.Tensor:
    """A port pool (pages + one sink page) holding ``t``'s pages."""
    out = torch.zeros((t.shape[0] + 1, *t.shape[1:]), dtype=t.dtype)
    out[:-1] = t
    return out


# ---------------------------------------------------------------------------
# quantize_kv / dequantize_kv / pools
# ---------------------------------------------------------------------------

def _tokens(which: str) -> np.ndarray:
    """[5, 16, 32] unit-normal tokens with the edge cases of
    tests/test_kv_quant_swap.py: an all-zero token, a tiny one (scale
    floored at fp16's smallest subnormal), a huge one."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 16, 32)).astype(np.float32)
    if which == "zero":
        v[0, 0] = 0.0
    elif which == "tiny":
        v[0, 1] = 1e-6 * v[0, 1]
        v[1, 2] = 1e-9 * v[1, 2]
    elif which == "huge":
        v[0, 2] = 1e4 * v[0, 2]
    return v


@pytest.mark.parametrize("which", ["normal", "zero", "tiny", "huge"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_codes_and_scales_equal_the_reference(kv_dtype, which):
    v = _tokens(which)
    jq, js = jattn.quantize_kv(jnp.asarray(v),
                               jattn.kv_quant_dtype(kv_dtype))
    tq, ts = _quant(v, kv_dtype)
    assert tq.dtype == attn.kv_quant_dtype(kv_dtype)
    assert ts.dtype == torch.float16 and tuple(ts.shape) == v.shape[:-1]
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))
    back = attn.dequantize_kv(tq, ts).numpy()
    np.testing.assert_array_equal(back,
                                  np.asarray(jattn.dequantize_kv(jq, js)))


def test_unknown_kv_dtype_raises():
    assert attn.kv_quant_dtype(None) is None
    with pytest.raises(ValueError, match="fp8_e4m3 | int8"):
        attn.kv_quant_dtype("fp4")


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_pools_match_the_reference_layout(kv_dtype):
    """GQA pools ``[P + 1, ps, Hkv, dh]`` of codes with fp16 scale pools
    ``[P + 1, ps, Hkv]`` of ones; MLA latent pools with per-token scales
    ``[P + 1, ps]`` — the reference's shapes plus the port's sink page."""
    for name, init_t, init_j in (
            (GQA, attn.gqa_init_paged_cache, jattn.gqa_init_paged_cache),
            (MLA, attn.mla_init_paged_cache, jattn.mla_init_paged_cache)):
        cfg, jcfg = get_config(name), jax_get_config(name)
        ours = init_t(cfg, 6, 8, torch.float32, "cpu", kv_dtype=kv_dtype)
        theirs = init_j(jcfg, 6, 8, jnp.float32, kv_dtype=kv_dtype)
        assert sorted(ours) == sorted(theirs)
        for k, t in ours.items():
            ref = np.asarray(theirs[k])
            assert tuple(t.shape) == (7, *ref.shape[1:]), k
            np.testing.assert_array_equal(_bits(t)[:-1], _jbits(ref))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_page_write_and_gather_parity(kv_dtype):
    """Codes and scales scattered through ``write_pages`` and gathered back
    through a block table equal the direct round trip and the reference's
    pools, bit for bit."""
    cfg = get_config(GQA)
    rng = np.random.default_rng(1)
    k_new = rng.normal(size=(1, 16, cfg.n_kv_heads, cfg.dh)).astype(
        np.float32)
    cache = attn.gqa_init_paged_cache(cfg, 6, 8, torch.float32, "cpu",
                                      kv_dtype=kv_dtype)
    q, s = _quant(k_new, kv_dtype)
    bt = torch.tensor([[2, 4]], dtype=torch.int32)
    pos = torch.arange(16)[None]
    attn.write_pages(cache["k_pages"], bt, pos, q, 64)
    attn.write_pages(cache["k_scale"], bt, pos, s, 64)
    got = attn.dequantize_kv(
        ops.gather_pages(attn.pool_pages(cache["k_pages"]), bt)[:, :16],
        ops.gather_pages(attn.pool_pages(cache["k_scale"]), bt)[:, :16])
    np.testing.assert_array_equal(got.numpy(),
                                  attn.dequantize_kv(q, s).numpy())
    jc = jattn.gqa_init_paged_cache(jax_get_config(GQA), 6, 8, jnp.float32,
                                    kv_dtype=kv_dtype)
    jpos = jnp.arange(16, dtype=jnp.int32)[None]
    jpages = jattn.write_pages(jc["k_pages"], jnp.asarray(bt.numpy()), jpos,
                               _to_jax(q), 64)
    jscales = jattn.write_pages(jc["k_scale"], jnp.asarray(bt.numpy()), jpos,
                                _to_jax(s), 64)
    np.testing.assert_array_equal(_bits(cache["k_pages"])[:-1],
                                  _jbits(jpages))
    np.testing.assert_array_equal(_bits(cache["k_scale"])[:-1],
                                  _jbits(jscales))


# ---------------------------------------------------------------------------
# K3's and K4's plain quantized versions
# ---------------------------------------------------------------------------

def _paged_pools(seed, b, hq, hkv, p, e, ps, w, n_pages, kv_len):
    """q, K/V pools and a table of distinct random pages per row, entries
    past the pages ``kv_len + p - 1`` keys need holding the sentinel."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, p, e)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, e)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, e)).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    used = 0
    for i, n in enumerate(kv_len):
        need = -(-(n + p - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(kv_len, np.int32)


K3_CASES = [
    # kv_dtype, b, hq, hkv, P, e, ps, w, pages, kv_len, softcap
    ("fp8_e4m3", 4, 8, 2, 1, 32, 8, 4, 20, [0, 1, 13, 32], None),
    ("int8", 3, 8, 4, 1, 32, 16, 8, 30, [77, 128, 5], 30.0),
    ("fp8_e4m3", 3, 8, 2, 2, 32, 8, 8, 30, [0, 5, 63], None),
    ("int8", 2, 8, 2, 4, 64, 16, 8, 20, [1, 120], 20.0),
]


@pytest.mark.parametrize("case", K3_CASES,
                         ids=["fp8-P1-kv0", "int8-P1-softcap", "fp8-P2",
                              "int8-P4-d64"])
def test_quantized_k3_plain_matches_pallas(case):
    """K3's plain version on codes and scales against the reference's
    Pallas kernel (interpret mode) on the same codes and scales, at P = 1
    and verify rows with sentinels; and bit for bit against itself on the
    pool the codes decode to."""
    kv, b, hq, hkv, p, e, ps, w, n_pages, kvl, cap = case
    q, kp, vp, bt, kv_len = _paged_pools(sum(kvl) + p, b, hq, hkv, p, e, ps,
                                         w, n_pages, kvl)
    (kc, ks), (vc, vs) = _quant(kp, kv), _quant(vp, kv)
    tq, tbt, tkl = map(torch.from_numpy, (q, bt, kv_len))
    ours = ops.fusemax_decode_paged(tq, kc, vc, tbt, tkl, impl="torch",
                                    softcap=cap, k_scale=ks, v_scale=vs)
    pallas = np.asarray(jax.jit(
        lambda *a: jax_ops.fusemax_decode_paged(
            *a[:5], impl="pallas", interpret=True, softcap=cap,
            k_scale=a[5], v_scale=a[6]))(
        jnp.asarray(q), _to_jax(kc), _to_jax(vc), jnp.asarray(bt),
        jnp.asarray(kv_len), _to_jax(ks), _to_jax(vs)))
    np.testing.assert_allclose(ours.numpy(), pallas, **F32_TOL)
    if p == 1:
        assert np.all(ours.numpy()[kv_len == 0] == 0.0)
    deq = ops.fusemax_decode_paged(tq, attn.dequantize_kv(kc, ks),
                                   attn.dequantize_kv(vc, vs), tbt, tkl,
                                   impl="torch", softcap=cap)
    assert torch.equal(ours, deq)
    live = kv_len >= 1
    ref = ops.fusemax_decode_paged(tq, kc, vc, tbt, tkl, impl="ref",
                                   softcap=cap, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(ref.numpy()[live], ours.numpy()[live],
                               **F32_TOL)


def _latents(seed, b, h, p, r, rd, ps, w, n_pages, kv_len):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, p, r + rd)).astype(np.float32)
    ckv = rng.standard_normal((n_pages, ps, r)).astype(np.float32)
    kr = rng.standard_normal((n_pages, ps, rd)).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    used = 0
    for i, n in enumerate(kv_len):
        need = -(-(n + p - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, ckv, kr, table, np.asarray(kv_len, np.int32)


K4_CASES = [
    # kv_dtype, b, h, P, r, rd, ps, w, pages, kv_len
    ("fp8_e4m3", 4, 4, 1, 32, 16, 8, 6, 30, [0, 1, 40, 25]),
    ("int8", 3, 4, 1, 32, 16, 8, 6, 30, [13, 16, 48]),
    ("fp8_e4m3", 3, 4, 2, 32, 16, 8, 4, 14, [0, 5, 31]),
]


@pytest.mark.parametrize("case", K4_CASES,
                         ids=["fp8-P1-kv0", "int8-P1", "fp8-P2"])
def test_quantized_k4_plain_matches_pallas(case):
    """K4's plain version on latent codes and per-token scales against the
    reference's Pallas kernel (interpret mode), and bit for bit against
    itself on the decoded pools."""
    kv, b, h, p, r, rd, ps, w, n_pages, kvl = case
    q, ckv, kr, bt, kv_len = _latents(sum(kvl) + 7 * p, b, h, p, r, rd, ps,
                                      w, n_pages, kvl)
    (cc, cs), (rc, rs) = _quant(ckv, kv), _quant(kr, kv)
    tq, tbt, tkl = map(torch.from_numpy, (q, bt, kv_len))
    ours = ops.fusemax_mla_decode_paged(tq, cc, rc, tbt, tkl, impl="torch",
                                        ckv_scale=cs, krope_scale=rs)
    pallas = np.asarray(jax.jit(
        lambda *a: jax_ops.fusemax_mla_decode_paged(
            *a[:5], impl="pallas", interpret=True, ckv_scale=a[5],
            krope_scale=a[6]))(
        jnp.asarray(q), _to_jax(cc), _to_jax(rc), jnp.asarray(bt),
        jnp.asarray(kv_len), _to_jax(cs), _to_jax(rs)))
    np.testing.assert_allclose(ours.numpy(), pallas, **F32_TOL)
    if p == 1:
        assert np.all(ours.numpy()[kv_len == 0] == 0.0)
    deq = ops.fusemax_mla_decode_paged(
        tq, attn.dequantize_kv(cc, cs), attn.dequantize_kv(rc, rs), tbt,
        tkl, impl="torch")
    assert torch.equal(ours, deq)


def test_quantized_wrappers_refuse_cpu_tensors_and_half_scales():
    """The CUDA wrappers take no CPU tensor (no fallback), and a code pool
    needs both of its scale pools."""
    q, kp, vp, bt, kv_len = (torch.from_numpy(a) for a in _paged_pools(
        3, 2, 4, 2, 1, 32, 8, 4, 10, [5, 9]))
    kc, ks = attn.quantize_kv(kp, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_decode_paged(q, kc, kc, bt, kv_len, impl="cuda",
                                 k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="scale pools"):
        dec.paged_decode_partials_cuda(
            q[:, :, 0].reshape(4, 2, 32), kc, kc, bt.int(), kv_len.int(),
            scale=0.1, hkv=2, splits=1, block_k=8, k_scale=ks)
    with pytest.raises(ValueError, match="both"):
        ops.fusemax_mla_decode_paged(
            torch.zeros(2, 4, 1, 48), torch.zeros(10, 8, 32),
            torch.zeros(10, 8, 16), bt, kv_len, impl="torch",
            ckv_scale=torch.ones(10, 8, dtype=torch.float16))


# ---------------------------------------------------------------------------
# the quantized layer paths against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gqa_models():
    """stablelm-1.6b-smoke on both sides (the reference's swap tests' model):
    (port cfg, reference cfg, reference params, port model)."""
    return _pair(GQA)


def _gqa_layer(models):
    cfg, jcfg, params, model = models
    jp = jax.tree.map(lambda a: a[0], params["runs"][0][0]["attn"])
    return cfg, jcfg, jp, model.layers[0].attn, cfg.layer_specs()[0], \
        jcfg.layer_specs()[0]


def _quant_pools(cfg, rng, n_pages, ps, kv_dtype):
    """A quantized GQA pool of random codes and scales (port side, with
    its sink page) and the same pool for the reference."""
    shape = (n_pages, ps, cfg.n_kv_heads, cfg.dh)
    tc, jc = {}, {}
    for name in ("k", "v"):
        codes, scales = _quant(rng.standard_normal(shape).astype(np.float32),
                               kv_dtype)
        tc[f"{name}_pages"], tc[f"{name}_scale"] = \
            _with_sink(codes), _with_sink(scales)
        jc[f"{name}_pages"], jc[f"{name}_scale"] = \
            _to_jax(codes), _to_jax(scales)
    return tc, jc


@pytest.mark.parametrize("kv_dtype,off", [("fp8_e4m3", 0), ("int8", 24)])
def test_quantized_gqa_prefill_paged_matches_reference(gqa_models, kv_dtype,
                                                       off):
    """A prefill chunk into a quantized pool (off = 0 attends its K/V as
    computed; off = 24 attends the dequantized history and its own
    round-tripped K/V): outputs within tolerance, codes and scales equal
    the reference's page for page."""
    cfg, jcfg, jp, tp, spec, jspec = _gqa_layer(gqa_models)
    rng = np.random.default_rng(off + 1)
    b, s, ps, n_pages = 2, 16, 8, 20
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tc, jc = _quant_pools(cfg, rng, n_pages, ps, kv_dtype)
    bt = np.array([[4, 9, 2, 17, 11, 0, n_pages, n_pages],
                   [7, 1, 13, 5, 3, 19, n_pages, n_pages]], np.int32)
    true_len = np.array([off + 16, off + 9], np.int32)
    cached_len = np.array([off, off + 3], np.int32)
    jy, jc = jax.jit(lambda *a: jattn.gqa_prefill_paged(
        jp, a[0], a[1], a[2], off, jcfg, jspec, JRT, a[3], a[4]))(
        jnp.asarray(x), jc, jnp.asarray(bt), jnp.asarray(true_len),
        jnp.asarray(cached_len))
    ty, tc = attn.gqa_prefill_paged(
        tp, torch.from_numpy(x), tc, torch.from_numpy(bt), off, cfg, spec,
        RT, torch.from_numpy(true_len), torch.from_numpy(cached_len))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        ours, theirs = _bits(tc[name])[:-1], _jbits(jc[name])
        # a fresh code may land one grid step away where the projections
        # differ in their last bit; all but a few stay equal
        assert (ours != theirs).mean() < 0.02, name


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_gqa_decode_paged_matches_reference(gqa_models, kv_dtype):
    """One decode step on a quantized pool with an inactive slot: live
    outputs within tolerance; the pools hold the reference's codes and
    scales wherever the fresh token's projections agree."""
    cfg, jcfg, jp, tp, spec, jspec = _gqa_layer(gqa_models)
    rng = np.random.default_rng(5)
    b, ps, n_pages = 3, 8, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    tc, jc = _quant_pools(cfg, rng, n_pages, ps, kv_dtype)
    bt = np.array([[3, 8, n_pages, n_pages], [n_pages] * 4,
                   [12, 0, 6, 15]], np.int32)
    kv_len = np.array([11, 0, 32], np.int32)
    jy, jc = jax.jit(lambda *a: jattn.gqa_decode_paged(
        jp, a[0], a[1], a[2], a[3], jcfg, jspec, JRT))(
        jnp.asarray(x), jc, jnp.asarray(bt), jnp.asarray(kv_len))
    ty, tc = attn.gqa_decode_paged(tp, torch.from_numpy(x), tc,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(kv_len), cfg, spec, RT)
    live = kv_len > 0
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               **LAYER_TOL)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        ours, theirs = _bits(tc[name])[:-1], _jbits(jc[name])
        assert (ours != theirs).mean() < 0.02, name
        # pages no live row writes are untouched
        np.testing.assert_array_equal(ours[[1, 2, 4, 5]],
                                      theirs[[1, 2, 4, 5]])


# ---------------------------------------------------------------------------
# engines: quantized greedy streams against the reference engine's
# ---------------------------------------------------------------------------

def _dense_ffn(get_config_fn, name, **kw):
    return dataclasses.replace(get_config_fn(name), moe=None, family="dense",
                               n_mtp=0, **kw)


def _pair(name: str, **cut):
    """(port cfg, reference cfg, reference params, port model)."""
    if name == MLA:
        jcfg, cfg = _dense_ffn(jax_get_config, name, **cut), \
            _dense_ffn(get_config, name, **cut)
    else:
        jcfg = dataclasses.replace(jax_get_config(name), **cut)
        cfg = dataclasses.replace(get_config(name), **cut)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _serve(engine, req_cls, prompts, budgets):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _both(pair, prompts, budgets, **kw):
    """The port's and the reference's engine on the same trace."""
    cfg, jcfg, params, model = pair
    ours = ServeEngine(cfg, model, rt=RT, device="cpu", **kw)
    theirs = JaxServeEngine(jcfg, params, rt=JRT, **kw)
    return (_serve(ours, Request, prompts, budgets), ours,
            _serve(theirs, JaxRequest, prompts, budgets), theirs)


STREAM_CASES = [(GQA, "fp8_e4m3"), (GQA, "int8"), (MLA, "fp8_e4m3"),
                (RING, "fp8_e4m3")]


@pytest.fixture(scope="module")
def quant_streams():
    """Each STREAM_CASES config served quantized by both engines (two
    layers): on stablelm a shared prefix (hits, one exact-cover COW) and
    mixed lengths; on the MLA tower and gemma2 (whose 16-token rings the
    prompts run past) two prompts of mixed lengths."""
    rng = np.random.default_rng(2)
    out = {}
    for name in (GQA, MLA, RING):
        pair = _pair(name, n_layers=2)
        vocab = pair[0].vocab
        if name == GQA:
            shared = rng.integers(0, vocab, 16)
            prompts = [np.concatenate([shared, rng.integers(0, vocab, t)])
                       .astype(np.int32) for t in (9, 14)]
            prompts += [prompts[0][:16].copy()]
            budgets = [5, 4, 3]
        else:
            prompts = [rng.integers(0, vocab, t).astype(np.int32)
                       for t in (30, 21)]
            budgets = [6, 5]
        for case, kv in STREAM_CASES:
            if case == name:
                out[(name, kv)] = _both(
                    pair, prompts, budgets, slots=2, max_len=64,
                    decode_chunk=4, cache_layout="paged", page_size=8,
                    kv_dtype=kv)
    return out


@pytest.mark.parametrize("name,kv_dtype", STREAM_CASES,
                         ids=[f"{n}-{k}" for n, k in STREAM_CASES])
def test_quantized_engine_streams_equal_the_reference(quant_streams, name,
                                                      kv_dtype):
    ours, teng, theirs, jeng = quant_streams[(name, kv_dtype)]
    assert ours == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.memory_stats() == jeng.memory_stats()
    assert teng.kv.kv_dtype == kv_dtype
    teng.kv.check_invariants()
    assert teng.logits_finite()


def test_quantized_pools_hold_codes_and_scales(quant_streams):
    """The quantized engines' pools hold codes of their dtype beside fp16
    scale pools covering the same pages (the audit's scale check), and a
    page costs the reference's honest bytes."""
    for (name, kv), (_, teng, _, jeng) in quant_streams.items():
        for c in teng.caches:
            a = c["attn"]
            codes = [k for k in a if not k.endswith("_scale")]
            for k in codes:
                assert a[k].dtype == attn.kv_quant_dtype(kv)
            assert len(a) == 2 * len(codes)
        assert {k: c.bytes_per_page for k, c in teng.kv.classes.items()} \
            == {k: c.bytes_per_page for k, c in jeng.kv.classes.items()}


def test_check_invariants_catches_a_scale_pool_off_its_pages(quant_streams):
    _, teng, _, _ = quant_streams[(GQA, "int8")]
    a = teng.caches[0]["attn"]
    full = a["k_scale"]
    a["k_scale"] = full[:-1]
    try:
        with pytest.raises(AssertionError, match="k_scale"):
            teng.kv.check_invariants()
    finally:
        a["k_scale"] = full
    teng.kv.check_invariants()


# ---------------------------------------------------------------------------
# the host swap tier: the reference's cases, held to its counters
# ---------------------------------------------------------------------------

def _swap_kw(**kw):
    return dict(slots=2, max_len=64, decode_chunk=4, cache_layout="paged",
                page_size=8, prefix_caching=True, **kw)


def _one_by_one(engine, req_cls, prompts):
    """Serve each prompt to completion before the next (4 new tokens)."""
    out = []
    for i, p in enumerate(prompts):
        r = req_cls(rid=i, prompt=p, max_new_tokens=4)
        engine.submit(r)
        engine.run()
        assert r.done
        out.append(list(r.generated))
    return out


@pytest.fixture(scope="module")
def swap_runs(gqa_models):
    """The reference's swap traces (tests/test_kv_quant_swap.py) on both
    engines: A (3 pages), B (5+ pages) that must evict A's chain from an
    8-page pool, then A again; unquantized and fp8, with a never-evicting
    64-page pool beside each; and a 2-page host cap that must drop."""
    cfg, jcfg, params, model = gqa_models
    rng = np.random.default_rng(5)
    pa = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    runs = {}
    for kv in (None, "fp8_e4m3"):
        for label, kw in (("never", dict(num_pages=64)),
                          ("swap", dict(num_pages=8,
                                        host_swap_bytes=1 << 30))):
            ours = ServeEngine(cfg, model, rt=RT, device="cpu",
                               **_swap_kw(kv_dtype=kv, **kw))
            theirs = JaxServeEngine(jcfg, params, rt=JRT,
                                    **_swap_kw(kv_dtype=kv, **kw))
            streams = []
            for eng, req in ((ours, Request), (theirs, JaxRequest)):
                streams.append(_one_by_one(eng, req, [pa]))
                streams[-1] += _one_by_one(eng, req, [pb])
                mid = dict(eng.kv.stats)
                if eng is ours:
                    ours.kv.check_invariants()
                    ours_mid = (mid, eng.memory_stats()["host_tier"])
                streams[-1] += _one_by_one(eng, req, [pa])
            runs[(kv, label)] = (streams[0], ours, streams[1], theirs,
                                 ours_mid)
    bpp = PagedKVCache(cfg, 2, 64, torch.float32, page_size=8,
                       device="cpu").classes["full"].bytes_per_page
    cap = {}
    for eng in (ServeEngine(cfg, model, rt=RT, device="cpu",
                            **_swap_kw(num_pages=8, host_swap_bytes=2 * bpp)),
                JaxServeEngine(jcfg, params, rt=JRT,
                               **_swap_kw(num_pages=8,
                                          host_swap_bytes=2 * bpp))):
        req = Request if isinstance(eng, ServeEngine) else JaxRequest
        _one_by_one(eng, req, [pa, pb])
        cap[req] = eng
    runs["cap"] = (cap[Request], cap[JaxRequest], bpp)
    return runs


@pytest.mark.parametrize("kv_dtype", [None, "fp8_e4m3"],
                         ids=["fp32", "fp8"])
def test_demote_promote_hit_gives_the_never_evicted_streams(swap_runs,
                                                            kv_dtype):
    """Serving B demotes A's chain to host memory; resending A promotes it
    back and hits (23 of its 24 tokens reused behind the exact-cover COW);
    the streams equal a never-evicting pool's, and the counters and
    streams equal the reference engine's (fp8: the swap tier carries
    quantized pages as raw bytes)."""
    ours, teng, theirs, jeng, (mid, host_mid) = \
        swap_runs[(kv_dtype, "swap")]
    never, neng, _, _, _ = swap_runs[(kv_dtype, "never")]
    assert neng.kv.stats["demotions"] == 0
    assert ours == never == theirs
    assert mid["demotions"] >= 3 and host_mid["demoted_pages"] > 0
    st = teng.kv.stats
    assert st["promotions"] >= 3, st
    assert {k: st[k] for k in SWAP_KEYS} == \
        {k: jeng.kv.stats[k] for k in SWAP_KEYS}
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] >= 1
    assert teng.stats["tokens_reused"] == jeng.stats["tokens_reused"] >= 23
    assert teng.memory_stats()["host_tier"] == \
        jeng.memory_stats()["host_tier"]
    teng.kv.check_invariants()


def test_demoted_entries_hold_one_host_copy_per_page(swap_runs):
    """A demoted entry's host copy is one flat buffer of the page's bytes:
    every full-class leaf's page (codes, then scales) in leaf order, as
    many bytes as the pool counts per page; the swap tier's host time is
    accounted."""
    _, teng, _, _, _ = swap_runs[("fp8_e4m3", "swap")]
    demoted = [e for e in teng.kv._prefix.values() if e.page < 0]
    assert demoted
    bpp = teng.kv.classes["full"].bytes_per_page
    leaves = teng.kv._full_leaves(teng.caches)
    assert sum(a[0].numel() * a.element_size() for a in leaves) == bpp
    for e in demoted:
        assert e.host.dtype == torch.uint8 and e.host.numel() == bpp
    assert teng.kv.swap_ms["demote"] > 0 and teng.kv.swap_ms["promote"] > 0


def test_host_tier_byte_cap_drops_lru(swap_runs):
    """A 2-page host cap cannot hold A's 3-page chain: it is dropped, not
    demoted (HBM → host → drop), as the reference does."""
    ours, theirs, bpp = swap_runs["cap"]
    assert ours.kv.stats["demotions"] == 0
    assert ours.kv.stats["host_drops"] == 0
    assert ours.kv.stats["prefix_evictions"] > 0
    assert ours.kv._host_bytes <= 2 * bpp
    assert {k: ours.kv.stats[k] for k in SWAP_KEYS} == \
        {k: theirs.kv.stats[k] for k in SWAP_KEYS}
    ours.kv.check_invariants()


def test_host_tier_drains_on_clear_and_warmup(swap_runs):
    """clear_prefix, and so warmup, leaves no demoted page and no host
    bytes, and the pool drains fully."""
    _, teng, _, _, _ = swap_runs[(None, "swap")]
    assert teng.memory_stats()["host_tier"]["demoted_pages"] > 0
    teng.clear_prefix_cache()
    ht = teng.memory_stats()["host_tier"]
    assert ht["demoted_pages"] == 0 and ht["demoted_bytes"] == 0
    assert teng.kv._host_bytes == 0
    assert all(v == 0 for v in teng.kv.pages_in_use.values())
    teng.kv.check_invariants()
    teng.warmup([24, 40])
    ht = teng.memory_stats()["host_tier"]
    assert ht["demoted_pages"] == 0 and ht["demoted_bytes"] == 0
    teng.kv.check_invariants()


def test_cow_on_a_quantized_shared_page_leaves_the_donor_untouched(
        gqa_models):
    """A full-page hit on a quantized shared page copies it before the
    tail rewrite: the donor's codes and scales stay bit for bit, and the
    identical resend gives the donor's stream."""
    cfg, _, _, model = gqa_models
    rng = np.random.default_rng(3)
    p32 = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    pdiv = p32.copy()
    pdiv[20] = (pdiv[20] + 1) % cfg.vocab
    eng = ServeEngine(cfg, model, slots=2, max_len=64, rt=RT, device="cpu",
                      decode_chunk=4, cache_layout="paged", page_size=16,
                      kv_dtype="fp8_e4m3")
    first = Request(rid=0, prompt=p32, max_new_tokens=4)
    eng.submit(first)
    eng.run()
    donor = [e.page for e in eng.kv._prefix.values()]
    assert len(donor) >= 2
    attn0 = eng.caches[0]["attn"]
    snap = {k: {p: _bits(t[p]).copy() for p in donor}
            for k, t in attn0.items()}
    second = Request(rid=1, prompt=p32, max_new_tokens=4)
    third = Request(rid=2, prompt=pdiv, max_new_tokens=4)
    eng.submit(second)
    eng.submit(third)
    eng.run()
    assert eng.stats["cow_copies"] >= 1
    for k, pages in snap.items():
        for p, before in pages.items():
            np.testing.assert_array_equal(_bits(attn0[k][p]), before,
                                          err_msg=k)
    assert second.generated == first.generated


# ---------------------------------------------------------------------------
# byte-budget sizing and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [GQA, MLA])
@pytest.mark.parametrize("kv_dtype", [None, "fp8_e4m3", "int8"])
def test_pool_bytes_sizing_equals_the_reference(name, kv_dtype):
    """Honest page bytes (codes plus fp16 scales) and the pages a byte
    budget buys, as the reference computes them; a quantized GQA pool
    gets ~3.9x the fp32 pages from the same budget."""
    cfg = _dense_ffn(get_config, name) if name == MLA else get_config(name)
    jcfg = _dense_ffn(jax_get_config, name) if name == MLA \
        else jax_get_config(name)
    budget = 1 << 20
    ours = PagedKVCache(cfg, 2, 64, torch.float32, page_size=16,
                        kv_dtype=kv_dtype, pool_bytes=budget, device="cpu")
    theirs = JaxPagedKVCache(jcfg, 2, 64, jnp.float32, page_size=16,
                             kv_dtype=kv_dtype, pool_bytes=budget)
    for k in theirs.classes:
        assert ours.classes[k].bytes_per_page == \
            theirs.classes[k].bytes_per_page
        assert ours.classes[k].pool.num_pages == \
            theirs.classes[k].pool.num_pages
    assert ours.memory_stats()["physical_cache_bytes"] == \
        theirs.memory_stats()["physical_cache_bytes"]
    ours.check_invariants()
    if name == GQA and kv_dtype is not None:
        fp32 = PagedKVCache(cfg, 2, 64, torch.float32, page_size=16,
                            pool_bytes=budget, device="cpu")
        ratio = ours.classes["full"].pool.num_pages \
            / fp32.classes["full"].pool.num_pages
        assert 3.5 < ratio < 4.0, ratio


def test_dense_layout_refuses_quantized_pages(gqa_models):
    model = gqa_models[3]
    for kw in (dict(kv_dtype="int8"), dict(pool_bytes=1 << 20),
               dict(host_swap_bytes=1 << 20)):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(get_config(GQA), model, slots=2, max_len=32, rt=RT,
                        device="cpu", **kw)


QUANT_ARGV = ["--arch", GQA, "--cache-layout", "paged", "--requests", "5",
              "--slots", "2", "--max-len", "64", "--prompt-len", "20",
              "--prompt-len-max", "40", "--new-tokens", "4",
              "--num-pages", "8", "--repeats", "1", "--no-warmup"]


def test_launcher_serves_the_quantized_and_swap_legs(tmp_path):
    """``--kv-dtype int8 --host-swap-gb 1`` on an 8-page pool: the
    ``paged_swap`` leg demotes and joins ``outputs_match`` (lossless), the
    ``paged_quant`` leg carries the swap tier and reports ``quant_quality``
    with the reference's fields; the legs' schema, counters and host-tier
    stats equal the reference launcher's (the two launchers draw their
    weights from different generators, so their streams differ).
    ``--pool-mb`` sizes the pools from bytes."""
    from repro.launch import serve as jax_serve

    argv = QUANT_ARGV + ["--kv-dtype", "int8", "--host-swap-gb", "1"]
    out = tmp_path / "ours.json"
    ours = serve.main(["--device", "cpu", "--json", str(out)] + argv)
    saved = json.loads(out.read_text())
    assert list(saved["layouts"]) == ["paged", "paged_swap", "paged_quant"]
    assert saved["outputs_match"] is True
    assert ours["_outputs_by_layout"]["paged_swap"] == \
        ours["_outputs_by_layout"]["paged"]
    assert saved["kv_dtype"] == "int8" and saved["host_swap_gb"] == 1
    assert saved["layouts"]["paged_quant"]["memory"]["kv_dtype"] == "int8"
    swap = saved["layouts"]["paged_swap"]
    assert swap["memory"]["host_tier"]["demotions"] > 0
    assert swap["host_swap_ms"]["demote"] > 0
    ref = jax_serve.main(["--json", str(tmp_path / "ref.json")] + argv)
    assert set(ref) <= set(saved), set(ref) - set(saved)
    assert set(saved["quant_quality"]) == set(ref["quant_quality"])
    assert saved["quant_quality"]["streams"] == 5
    for lo, leg in ref["layouts"].items():
        mine = saved["layouts"][lo]
        assert set(leg) <= set(mine), (lo, set(leg) - set(mine))
        for k in ("dispatches", "tokens_decoded", "preemptions"):
            assert mine[k] == leg[k], (lo, k)
        for k in ("host_tier", "physical_cache_bytes", "num_pages",
                  "kv_dtype"):
            assert mine["memory"][k] == leg["memory"][k], (lo, k)

    budget = serve.main(["--device", "cpu", "--json", ""] + QUANT_ARGV
                        + ["--kv-dtype", "fp8_e4m3", "--pool-mb", "0.5"])
    pages = {lo: m["memory"]["num_pages"]["full"]
             for lo, m in budget["layouts"].items()}
    assert budget["pool_mb"] == 0.5
    assert pages["paged_quant"] > 3 * pages["paged"], pages
