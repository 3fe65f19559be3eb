"""The port's MLA path on the dense cache layout against the JAX reference.

The reference's dense MLA decode is the only E ≠ F call of its dense
split-K kernel: ``fusemax_decode(q_cat, [ckv | krope][:, None],
ckv[:, None], kv_len)``, one fiber with every head in its group.  On the
CPU the port takes that kernel's plain torch version
(``latent_decode_partials_torch``, the code the CUDA kernel is held to on
the card), compared here with the reference's Pallas kernel in interpret
mode (``impl="pallas"``) and its jnp executor on the concatenation; the
layer paths (``mla_prefill_chunk``, ``mla_decode``) with the reference's
on bridged weights; the dense engine's greedy streams with the reference
engine's; and the launcher's dense and ``both`` legs.  Inputs come from
numpy with a seed.  The model is ``deepseek-v3-671b-smoke`` with its MoE
swapped for a dense FFN (no MTP head), as tests/test_torch_mla.py serves
it.

Tolerances (as tests/test_torch_mla.py): fp32 paths differ only in
summation order — unit-scale attention outputs agree to rtol = atol =
1e-5, layer outputs to rtol 1e-5 / atol 2e-5.  Rows with kv_len = 0
follow the Pallas kernel (output 0; the jnp executor returns a mean of the
latents there), so they are compared with Pallas only.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.kernels import autotune as jax_autotune
from repro.kernels import ops as jax_ops
from repro.model import attention as jattn
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import decode as dec
from repro_torch.launch import serve
from repro_torch.model import attention as attn
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

F32_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-5, atol=2e-5)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
NAME = "deepseek-v3-671b-smoke"
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "peak_live_tokens",
             "prefix_hits", "tokens_reused", "cow_copies",
             "tokens_prefilled")


def _dense_ffn(get_config_fn, **kw):
    """The MLA tower with its MoE swapped for a dense FFN (no MTP head)."""
    return dataclasses.replace(get_config_fn(NAME), moe=None, family="dense",
                               n_mtp=0, **kw)


@pytest.fixture(scope="module")
def models():
    """The smoke tower cut to two layers (both MLA + dense FFN)."""
    jcfg = _dense_ffn(jax_get_config, n_layers=2)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    cfg = _dense_ffn(get_config, n_layers=2)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _jax(fn, *arrays, **kw):
    return np.asarray(jax.jit(functools.partial(fn, **kw))(
        *map(jnp.asarray, arrays)), np.float32)


def _torch(fn, *arrays, **kw):
    return fn(*map(torch.from_numpy, arrays), **kw).float().numpy()


# ---------------------------------------------------------------------------
# K2's E ≠ F branch: the plain version against the Pallas kernel and jnp
# ---------------------------------------------------------------------------

def _latents(seed, b, h, p, r, rd, m, kv_len):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, p, r + rd)).astype(np.float32),
            rng.standard_normal((b, m, r)).astype(np.float32),
            rng.standard_normal((b, m, rd)).astype(np.float32),
            np.asarray(kv_len, np.int32))


def _ref_decode(impl, q, ckv, kr, kv_len, **kw):
    """The reference's ``fusemax_decode`` as ``mla_decode`` calls it."""
    return _jax(lambda q, c, k, n: jax_ops.fusemax_decode(
        q, jnp.concatenate([c, k], axis=-1)[:, None], c[:, None], n,
        impl=impl, **kw), q, ckv, kr, kv_len)


LATENT_CASES = [
    # b, h, P, r, rd, M, kv_len, splits, block_k, softcap
    (6, 4, 1, 32, 16, 32, [0, 1, 7, 16, 17, 32], 2, None, None),
    (5, 4, 1, 32, 16, 32, [1, 7, 16, 17, 32], None, None, 30.0),
    (3, 16, 1, 64, 16, 64, [0, 17, 64], 4, 16, None),
    (3, 4, 3, 32, 16, 32, [0, 7, 30], 2, None, None),
    (2, 16, 3, 64, 16, 64, [16, 40], 4, 16, 20.0),
]


@pytest.mark.parametrize("case", LATENT_CASES,
                         ids=["kv-edges-splits2", "tuned-softcap",
                              "wide-h16-bk16", "p3-verify",
                              "p3-wide-softcap"])
def test_latent_decode_matches_pallas_and_jnp(case):
    """``fusemax_decode_latent`` (the plain partials + combine) against the
    reference's dense decode on the concatenation, Pallas and jnp."""
    b, h, p, r, rd, m, kvl, splits, bk, cap = case
    q, ckv, kr, kv_len = _latents(sum(kvl) + p, b, h, p, r, rd, m, kvl)
    kw = dict(splits=splits, block_k=bk, softcap=cap)
    ours = _torch(ops.fusemax_decode_latent, q, ckv, kr, kv_len,
                  impl="torch", **kw)
    assert ours.shape == (b, h, p, r)
    pallas = _ref_decode("pallas", q, ckv, kr, kv_len, **kw)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    if p == 1:
        assert np.all(ours[kv_len == 0] == 0.0)
    live = kv_len >= 1
    jnp_out = _ref_decode("jnp", q, ckv, kr, kv_len, splits=splits,
                          softcap=cap)
    np.testing.assert_allclose(ours[live], jnp_out[live], **F32_TOL)
    ref = _torch(ops.fusemax_decode_latent, q, ckv, kr, kv_len, impl="ref",
                 softcap=cap)
    np.testing.assert_allclose(ref[live], jnp_out[live], **F32_TOL)


def test_latent_partials_are_the_dense_partials_on_the_concatenation():
    """The plain latent partials are bit for bit K2's plain partials on
    K = [ckv | krope], V = ckv with Hkv = 1 (one fiber, all heads), and
    combine to the op's output."""
    b, h, r, rd, m = 3, 4, 32, 16, 48
    q, ckv, kr, kv_len = (torch.from_numpy(a) for a in _latents(
        9, b, h, 1, r, rd, m, [0, 20, 48]))
    qf = q[:, :, 0]
    kw = dict(scale=0.2, splits=3, block_k=16)
    got = dec.latent_decode_partials_torch(qf, ckv, kr, kv_len, **kw)
    want = dec.decode_partials_torch(qf, torch.cat([ckv, kr], -1), ckv,
                                     kv_len, hkv=1, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = dec.combine_partials(*got, torch.float32)
    op = ops.fusemax_decode_latent(q, ckv, kr, kv_len, scale=0.2, splits=3,
                                   block_k=16, impl="torch")
    assert torch.equal(op[:, :, 0], out)


@pytest.mark.parametrize("m", [32, 256, 2048])
def test_latent_decode_geometry_matches_the_reference(m):
    """The op resolves (splits, block_k) as the reference's
    ``fusemax_decode`` does for the latent call: ``decode_params(M,
    max(G, 8), r + rd, r)``; DeepSeek's decode (M 2048, G 128) gets 16
    splits of 128-key tiles."""
    for g, r, rd in ((128, 512, 64), (4, 32, 16)):
        got = autotune.decode_params(m, max(g, 8), r + rd, r)
        want = jax_autotune.decode_params(m, max(g, 8), r + rd, r)
        assert (got.splits, got.block_k) == (want.splits, want.block_k)
    if m == 2048:
        tuned = autotune.decode_params(2048, 128, 576, 512)
        assert (tuned.splits, tuned.block_k) == (16, 128)


def test_latent_cuda_path_refuses_cpu_tensors_and_unbuilt_latents():
    """No fallback: ``impl="cuda"`` and the kernel's wrapper refuse CPU
    tensors; the dims check refuses a latent the kernel is not built
    for."""
    q, ckv, kr, kv_len = (torch.from_numpy(a) for a in _latents(
        3, 2, 4, 1, 32, 16, 32, [5, 9]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_decode_latent(q, ckv, kr, kv_len, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dec.latent_decode_partials_cuda(q[:, :, 0], ckv, kr, kv_len,
                                        scale=0.1, splits=1, block_k=16)
    assert set(dec.CUDA_LATENT_DIMS) == {(512, 64), (32, 16)}
    assert (48, 16) not in dec.CUDA_LATENT_DIMS


# ---------------------------------------------------------------------------
# the dense MLA layer paths on bridged weights
# ---------------------------------------------------------------------------

def _layer(models, i=0):
    cfg, jcfg, params, model = models
    jp = jax.tree.map(lambda a: a[i], params["runs"][0][0]["attn"])
    return cfg, jcfg, jp, model.layers[i].attn, cfg.layer_specs()[i], \
        jcfg.layer_specs()[i]


def _cache(cfg, rng, b, m):
    mm = cfg.mla
    return (rng.standard_normal((b, m, mm.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, m, mm.rope_dim)).astype(np.float32))


@pytest.mark.parametrize("off", [0, 8])
def test_mla_prefill_chunk_matches_reference(models, off):
    """A chunk's latents written at [off, off + S) of the dense cache and
    its absorbed attention over [0, off + S) (K1 at (48, 32)): outputs
    within tolerance, caches equal."""
    cfg, jcfg, jp, tp, spec, jspec = _layer(models, 1)
    rng = np.random.default_rng(off + 11)
    b, s, m = 2, 12, 32
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ckv, kr = _cache(cfg, rng, b, m)
    jy, jc = jax.jit(lambda *a: jattn.mla_prefill_chunk(
        jp, a[0], {"ckv": a[1], "krope": a[2]}, off, jcfg, jspec, JRT))(
        *map(jnp.asarray, (x, ckv, kr)))
    tc = {"ckv": torch.from_numpy(ckv.copy()),
          "krope": torch.from_numpy(kr.copy())}
    ty, tc = attn.mla_prefill_chunk(tp, torch.from_numpy(x), tc, off, cfg,
                                    spec, RT)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)


def test_mla_decode_matches_reference(models):
    """One decode step through the latent branch's plain version with an
    empty slot (kv_len = 0: it writes the last row, as the reference's
    index -1 does) and a full one (kv_len = M): live outputs within
    tolerance, caches equal."""
    cfg, jcfg, jp, tp, spec, jspec = _layer(models)
    rng = np.random.default_rng(5)
    b, m = 3, 32
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ckv, kr = _cache(cfg, rng, b, m)
    kv_len = np.array([11, 0, 32], np.int32)
    jy, jc = jax.jit(lambda *a: jattn.mla_decode(
        jp, a[0], {"ckv": a[1], "krope": a[2]}, a[3], jcfg, jspec, JRT))(
        *map(jnp.asarray, (x, ckv, kr, kv_len)))
    tc = {"ckv": torch.from_numpy(ckv.copy()),
          "krope": torch.from_numpy(kr.copy())}
    ty, tc = attn.mla_decode(tp, torch.from_numpy(x), tc,
                             torch.from_numpy(kv_len), cfg, spec, RT)
    live = kv_len > 0
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               **LAYER_TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **F32_TOL)
    # the empty slot's write landed in its last row
    assert not np.array_equal(tc["ckv"][1, -1].numpy(), ckv[1, -1])


def test_scatter_cache_slots_lands_latents_in_their_rows(models):
    """The bucketed prefill's mini-cache lands in the slot rows with the
    sequence on axis 1 for MLA, rows past it zeroed."""
    cfg = models[0]
    caches = tf.init_cache(cfg, 3, 16, torch.float32, "cpu")
    for c in caches:
        for t in c["attn"].values():
            t.fill_(7.0)
    sub = tf.init_cache(cfg, 2, 8, torch.float32, "cpu")
    for c in sub:
        for t in c["attn"].values():
            t.normal_()
    tf.scatter_cache_slots(cfg, caches, sub, torch.tensor([2, 0]))
    for c, s in zip(caches, sub):
        assert set(c["attn"]) == {"ckv", "krope"}
        for name in ("ckv", "krope"):
            dst, src = c["attn"][name], s["attn"][name]
            assert torch.equal(dst[2, :8], src[0])
            assert torch.equal(dst[0, :8], src[1])
            assert torch.all(dst[[0, 2], 8:] == 0.0)
            assert torch.all(dst[1] == 7.0)


# ---------------------------------------------------------------------------
# the dense engine against the reference engine
# ---------------------------------------------------------------------------

def _trace(seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (19, 5, 11, 26, 8)]
    return prompts, [5, 4, 3, 4, 6]


def _serve(engine_cls, req_cls, cfg, model, prompts, budgets, rt, **kw):
    eng = engine_cls(cfg, model, rt=rt, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        steps += 1
        assert steps < 500
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng


@pytest.fixture(scope="module")
def dense_streams(models):
    """The trace on the port's dense engine, whole prompts and in 8-token
    prefill chunks, and on the reference's dense engine."""
    cfg, jcfg, params, model = models
    prompts, budgets = _trace()
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout="dense")
    out = {}
    for name, extra in (("whole", {}), ("chunk8", dict(prefill_chunk=8))):
        out[name] = _serve(ServeEngine, Request, cfg, model, prompts,
                           budgets, RT, device="cpu", **kw, **extra)
    out["reference"] = _serve(JaxServeEngine, JaxRequest, jcfg, params,
                              prompts, budgets, JRT, **kw)
    return out


def test_dense_mla_engine_matches_reference(dense_streams):
    ours, teng = dense_streams["whole"]
    theirs, jeng = dense_streams["reference"]
    assert ours == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.memory_stats() == jeng.memory_stats()
    assert teng.logits_finite()


def test_dense_mla_prefill_chunks_equal_whole_prompts(dense_streams):
    """``prefill_chunk=8`` (the continuation chunks through
    ``mla_prefill_chunk``) gives the whole-prompt streams."""
    assert dense_streams["chunk8"][0] == dense_streams["whole"][0]
    assert dense_streams["chunk8"][1].stats["prefill_dispatches"] == \
        dense_streams["whole"][1].stats["prefill_dispatches"]


@pytest.mark.parametrize("engine_kw", [dict(), dict(prefill_chunk=8)],
                         ids=["whole", "prefill-chunk-8"])
def test_dense_equals_paged_inside_the_port(models, dense_streams,
                                            engine_kw):
    """The dense layout's greedy streams equal the paged layout's on the
    same trace (K2's latent branch vs K4's plain versions)."""
    cfg, _, _, model = models
    prompts, budgets = _trace()
    paged, _ = _serve(ServeEngine, Request, cfg, model, prompts, budgets, RT,
                      device="cpu", slots=2, max_len=64, decode_chunk=4,
                      cache_layout="paged", page_size=8, **engine_kw)
    assert paged == dense_streams["whole"][0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "both"])
def test_launcher_serves_the_mla_arch_on_the_dense_layout(tmp_path, layout):
    out = tmp_path / "bench.json"
    metrics = serve.main(["--device", "cpu", "--arch", NAME,
                          "--cache-layout", layout, "--requests", "4",
                          "--slots", "2", "--max-len", "64", "--prompt-len",
                          "10", "--prompt-len-max", "30", "--new-tokens",
                          "4", "--repeats", "1", "--json", str(out)])
    saved = json.loads(out.read_text())
    assert "moe_cut" not in saved and saved["cache_layout"] == layout
    assert list(saved["layouts"]) == \
        (["dense"] if layout == "dense" else ["dense", "paged"])
    if layout == "both":
        assert saved["outputs_match"] is True
    assert saved["kernel_launches"] == {
        "fusemax_prefill": 0, "decode_partials": 0,
        "paged_decode_partials": 0, "mla_paged_decode_partials": 0,
        "latent_decode_partials": 0}
    assert all(len(o) == 4 for o in metrics["_outputs"])


def test_dense_entry_points_take_mla(models):
    """What refused MLA on the dense layout before this branch was ported
    now builds: the engine, the per-layer latent caches."""
    cfg, _, _, model = models
    eng = ServeEngine(cfg, model, slots=2, max_len=32, rt=RT, device="cpu")
    m = cfg.mla
    for c in eng.caches:
        assert tuple(c["attn"]["ckv"].shape) == (2, 32, m.kv_lora_rank)
        assert tuple(c["attn"]["krope"].shape) == (2, 32, m.rope_dim)
