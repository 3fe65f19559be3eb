"""The port's MLA path (DeepSeek latent attention on the paged pool) against
the JAX reference.

On the CPU the port takes its kernels' plain torch versions: K4's
(``mla_paged_decode_partials_torch``, the code the CUDA kernel is held to
on the card) and K1's at MLA head dims.  They are compared with the
reference's Pallas kernels in interpret mode (``impl="pallas"``), its jnp
executors and its 3-pass oracle, as tests/test_mla_paged.py runs them;
the model paths with the reference's layers on bridged weights; the
serving engine with the reference engine on the same traces.  Inputs come
from numpy with a seed.  The model is ``deepseek-v3-671b-smoke`` with its
MoE swapped for a dense FFN (``moe=None, family="dense"``, no MTP head),
as tests/test_mla_paged.py serves it: the absorbed form is exact math but
not exact floats, which a top-k router would turn into different expert
picks (the MoE tower itself is held to the reference by
tests/test_torch_moe.py).

Tolerances: fp32 paths differ only in summation order — unit-scale
attention outputs agree to rtol = atol = 1e-5 (K4 sums its score over
[ckv | krope] in one dot where the Pallas kernel sums two), layer outputs
to rtol 1e-5 / atol 2e-5, logits to rtol 1e-5 / atol 2e-4; bf16 inputs
are accumulated in fp32 and the output rounded once (one bf16 ulp:
rtol 2**-7, atol 1e-2).  Rows with kv_len = 0 follow the Pallas kernel
(output 0; the jnp executor returns a mean of the latents there), so they
are compared with Pallas only.
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
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.decode import mla_paged_decode_partials_cuda
from repro_torch.launch import serve
from repro_torch.model import attention as attn
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVCache

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)
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
    """``fn`` of the reference, jitted with ``kw`` static (interpret-mode
    Pallas and the per-page jnp sweep run 3-4x faster compiled than
    op by op)."""
    return np.asarray(jax.jit(functools.partial(fn, **kw))(
        *map(jnp.asarray, arrays)), np.float32)


def _torch(fn, *arrays, **kw):
    return fn(*map(torch.from_numpy, arrays), **kw).float().numpy()


# ---------------------------------------------------------------------------
# K4's plain version against the Pallas kernel and the jnp executor
# ---------------------------------------------------------------------------

def _latent_inputs(seed, b, h, p, r, rd, ps, w, n_pages, kv_len):
    """Absorbed queries, latent pools and a table of distinct random pages
    per row, entries past the pages ``kv_len + p - 1`` keys need holding
    the sentinel."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, p, r + rd)).astype(np.float32)
    ckv = rng.standard_normal((n_pages, ps, r)).astype(np.float32)
    krope = rng.standard_normal((n_pages, ps, rd)).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((b, w), n_pages, np.int32)
    used = 0
    for i, n in enumerate(kv_len):
        need = -(-(n + p - 1) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return q, ckv, krope, table, np.asarray(kv_len, np.int32)


MLA_CASES = [
    # b, h, P, r, rd, ps, w, pages, kv_len, splits, block_k, softcap
    (5, 4, 1, 32, 16, 8, 6, 30, [0, 1, 13, 16, 48], None, None, None),
    (4, 4, 1, 32, 16, 8, 6, 30, [0, 1, 40, 25], 3, 4, None),
    (2, 16, 1, 64, 16, 16, 8, 20, [77, 128], 4, 8, 30.0),
    (3, 4, 2, 32, 16, 8, 4, 14, [0, 5, 31], None, None, None),
    (2, 16, 2, 64, 16, 16, 4, 10, [1, 60], 2, 16, 20.0),
]


@pytest.mark.parametrize("case", MLA_CASES,
                         ids=["smoke-latent-tuned", "kv0-kv1-subpage",
                              "wide-softcap", "p2-verify",
                              "p2-wide-softcap"])
def test_mla_decode_matches_pallas_and_jnp(case):
    b, h, p, r, rd, ps, w, n_pages, kvl, splits, bk, cap = case
    q, ckv, kr, bt, kv_len = _latent_inputs(sum(kvl) + p, b, h, p, r, rd,
                                            ps, w, n_pages, kvl)
    kw = dict(splits=splits, block_k=bk, softcap=cap)
    ours = _torch(ops.fusemax_mla_decode_paged, q, ckv, kr, bt, kv_len,
                  impl="torch", **kw)
    assert ours.shape == (b, h, p, r)
    pallas = _jax(jax_ops.fusemax_mla_decode_paged, q, ckv, kr, bt, kv_len,
                  impl="pallas", **kw)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    if p == 1:
        assert np.all(ours[kv_len == 0] == 0.0)
    live = kv_len >= 1
    jnp_out = _jax(jax_ops.fusemax_mla_decode_paged, q, ckv, kr, bt, kv_len,
                   impl="jnp", **kw)
    np.testing.assert_allclose(ours[live], jnp_out[live], **F32_TOL)
    ref = _torch(ops.fusemax_mla_decode_paged, q, ckv, kr, bt, kv_len,
                 impl="ref", softcap=cap)
    np.testing.assert_allclose(ref[live], jnp_out[live], **F32_TOL)


def test_mla_decode_bf16():
    q, ckv, kr, bt, kv_len = _latent_inputs(7, 2, 8, 1, 64, 16, 16, 8, 24,
                                            [100, 7])
    qb, cb, kb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, ckv, kr))
    ours = ops.fusemax_mla_decode_paged(qb, cb, kb, torch.from_numpy(bt),
                                        torch.from_numpy(kv_len),
                                        impl="torch")
    assert ours.dtype == torch.bfloat16
    qj, cj, kj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (qb, cb, kb))
    ref = jax_ops.fusemax_mla_decode_paged(qj, cj, kj, jnp.asarray(bt),
                                           jnp.asarray(kv_len),
                                           impl="pallas")
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


@pytest.mark.parametrize("w,ps,g,rank,rope", [
    (128, 16, 128, 512, 64), (32, 16, 128, 512, 64), (8, 8, 4, 32, 16),
    (4, 16, 16, 64, 16),
])
def test_mla_autotune_matches_reference(w, ps, g, rank, rope):
    got = autotune.mla_paged_decode_params(w, ps, g, rank, rope)
    want = jax_autotune.mla_paged_decode_params(w, ps, g, rank, rope)
    assert (got.splits, got.block_k) == (want.splits, want.block_k)
    if (w, ps, g, rank, rope) == (128, 16, 128, 512, 64):
        assert (got.splits, got.block_k) == (16, 16)   # DeepSeek's decode


def test_mla_decode_scales_and_cpu_tensors_raise():
    """A latent pool given one scale pool of two raises (quantized pools
    take both, tests/test_torch_quant_swap.py); the CUDA path refuses CPU
    tensors."""
    q, ckv, kr, bt, kv_len = (torch.from_numpy(a) for a in _latent_inputs(
        3, 2, 4, 1, 32, 16, 8, 4, 10, [5, 9]))
    with pytest.raises(ValueError, match="both"):
        ops.fusemax_mla_decode_paged(q, ckv, kr, bt, kv_len, impl="torch",
                                     ckv_scale=torch.ones(10, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_mla_decode_paged(q, ckv, kr, bt, kv_len, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        mla_paged_decode_partials_cuda(q[:, :, 0], ckv, kr, bt, kv_len,
                                       scale=0.1, splits=1, block_k=8)
    assert ops.resolve_impl("auto", q) == "torch"


# ---------------------------------------------------------------------------
# K1's plain version at MLA head dims, through the model's attention
# ---------------------------------------------------------------------------

def _layer(models, i=0):
    cfg, jcfg, params, model = models
    jp = jax.tree.map(lambda a: a[i], params["runs"][0][0]["attn"])
    return cfg, jcfg, jp, model.layers[i].attn, cfg.layer_specs()[i], \
        jcfg.layer_specs()[i]


@pytest.mark.parametrize("off", [0, 21])
def test_mla_absorbed_attend_matches_reference(models, off):
    """K1 at (E, F) = (r + rd, r) = (48, 32) with every head in one group
    and a history offset: the absorbed chunk attention."""
    cfg, jcfg, jp, tp, _, _ = _layer(models)
    m = cfg.mla
    rng = np.random.default_rng(off + 1)
    b, s, h = 2, 11, cfg.n_heads
    q_nope = rng.standard_normal((b, h, s, m.nope_dim)).astype(np.float32)
    q_rope = rng.standard_normal((b, h, s, m.rope_dim)).astype(np.float32)
    ckv = rng.standard_normal((b, off + s, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, off + s, m.rope_dim)).astype(np.float32)
    ours = attn._mla_absorbed_attend(
        tp, *map(torch.from_numpy, (q_nope, q_rope, ckv, kr)), off, cfg,
        RT).numpy()
    ref = _jax(lambda *a: jattn._mla_absorbed_attend(jp, *a, off, jcfg, JRT),
               q_nope, q_rope, ckv, kr)
    np.testing.assert_allclose(ours, ref, **LAYER_TOL)


def test_mla_k1_plain_matches_pallas_at_48_32():
    """The plain K1 at (E, F) = (48, 32) against the Pallas kernel in
    interpret mode: the absorbed form's layout (Hkv = 1, group 4) with a
    query offset, and the expanded form's (group 1)."""
    rng = np.random.default_rng(4)
    for hkv, hq, p, m, off in ((1, 4, 13, 40, 27), (4, 4, 24, 24, 0)):
        q = rng.standard_normal((2, hq, p, 48)).astype(np.float32)
        k = rng.standard_normal((2, hkv, m, 48)).astype(np.float32)
        v = rng.standard_normal((2, hkv, m, 32)).astype(np.float32)
        ours = _torch(ops.fusemax_attention, q, k, v, causal=True,
                      q_offset=off, impl="torch")
        ref = _jax(jax_ops.fusemax_attention, q, k, v, causal=True,
                   q_offset=off, impl="pallas")
        np.testing.assert_allclose(ours, ref, **F32_TOL)


# ---------------------------------------------------------------------------
# paged prefill and decode layers on bridged weights
# ---------------------------------------------------------------------------

def _with_sink(a: np.ndarray) -> torch.Tensor:
    t = torch.zeros((a.shape[0] + 1, *a.shape[1:]))
    t[:-1] = torch.from_numpy(a)
    return t


def _latent_pools(cfg, rng, n_pages, ps):
    m = cfg.mla
    return (rng.standard_normal((n_pages, ps, m.kv_lora_rank))
            .astype(np.float32),
            rng.standard_normal((n_pages, ps, m.rope_dim)).astype(np.float32))


@pytest.mark.parametrize("off", [0, 24])
def test_mla_prefill_paged_matches_reference(models, off):
    """A prompt chunk into the latent pool (off = 0: ``mla_forward``, K1
    at (E, F) = (nope + rope, v) = (48, 32), on both sides) and a
    continuation (off = 24, absorbed form over the latents gathered from
    the pages after the chunk's writes, writes below ``cached_len`` and
    past ``true_len`` dropped — so row 1 reads positions 24..26 from its
    pages): outputs within tolerance, pools equal page for page."""
    cfg, jcfg, jp, tp, spec, jspec = _layer(models, 1)
    rng = np.random.default_rng(off + 3)
    b, s, ps, n_pages = 2, 16, 8, 20
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cp, kp = _latent_pools(cfg, rng, n_pages, ps)
    bt = np.array([[4, 9, 2, 17, 11, 0, n_pages, n_pages],
                   [7, 1, 13, 5, 3, 19, n_pages, n_pages]], np.int32)
    true_len = np.array([off + 16, off + 9], np.int32)
    cached_len = np.array([off, off + 3], np.int32)
    jy, jc = jax.jit(lambda *a: jattn.mla_prefill_paged(
        jp, a[0], {"ckv_pages": a[1], "krope_pages": a[2]}, a[3], off, jcfg,
        jspec, JRT, a[4], a[5]))(
        *map(jnp.asarray, (x, cp, kp, bt, true_len, cached_len)))
    tc = {"ckv_pages": _with_sink(cp), "krope_pages": _with_sink(kp)}
    ty, tc = attn.mla_prefill_paged(
        tp, torch.from_numpy(x), tc, torch.from_numpy(bt), off, cfg, spec,
        RT, torch.from_numpy(true_len), torch.from_numpy(cached_len))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for name, orig in (("ckv_pages", cp), ("krope_pages", kp)):
        np.testing.assert_allclose(tc[name][:-1].numpy(),
                                   np.asarray(jc[name]), **F32_TOL)
        mapped = set(bt.ravel()) - {n_pages}
        for pg in set(range(n_pages)) - mapped:
            np.testing.assert_array_equal(tc[name][pg].numpy(), orig[pg])


def test_mla_decode_paged_matches_reference(models):
    """One decode step through K4's plain version with an inactive slot
    (kv_len = 0, released row) and a page-aligned one: live outputs
    within tolerance, pools equal page for page (the inactive write is
    dropped)."""
    cfg, jcfg, jp, tp, spec, jspec = _layer(models)
    rng = np.random.default_rng(5)
    b, ps, n_pages = 3, 8, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    cp, kp = _latent_pools(cfg, rng, n_pages, ps)
    bt = np.array([[3, 8, n_pages, n_pages], [n_pages] * 4,
                   [12, 0, 6, 15]], np.int32)
    kv_len = np.array([11, 0, 32], np.int32)
    jy, jc = jax.jit(lambda *a: jattn.mla_decode_paged(
        jp, a[0], {"ckv_pages": a[1], "krope_pages": a[2]}, a[3], a[4], jcfg,
        jspec, JRT))(*map(jnp.asarray, (x, cp, kp, bt, kv_len)))
    tc = {"ckv_pages": _with_sink(cp), "krope_pages": _with_sink(kp)}
    ty, tc = attn.mla_decode_paged(tp, torch.from_numpy(x), tc,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(kv_len), cfg, spec, RT)
    live = kv_len > 0
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               **LAYER_TOL)
    for name in ("ckv_pages", "krope_pages"):
        np.testing.assert_allclose(tc[name][:-1].numpy(),
                                   np.asarray(jc[name]), **F32_TOL)


# ---------------------------------------------------------------------------
# the paged engine against the reference engine
# ---------------------------------------------------------------------------

def _serve(engine_cls, req_cls, cfg, model, prompts, budgets, rt, audit,
           **kw):
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
        if audit:
            eng.kv.check_invariants()      # every step ends quiescent
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng


def _shared_trace(seed=0, page=8):
    """Prompts opening with the same two pages (prefix-cache hits, the
    absorbed tail prefill), one exactly covered by its hit (COW), and
    mixed lengths."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, 2 * page)
    prompts = [np.concatenate([shared, rng.integers(0, 512, t)])
               .astype(np.int32) for t in (8, 11, 3)]
    prompts.append(prompts[0][:2 * page].copy())
    prompts.append(rng.integers(0, 512, 21).astype(np.int32))
    return prompts, [5, 4, 3, 4, 6]


@pytest.mark.parametrize("engine_kw", [
    dict(),
    dict(prefix_caching=False),
    dict(prefill_chunk=8),
], ids=["prefix", "no-prefix", "prefill-chunk-8"])
def test_paged_mla_engine_matches_reference(models, engine_kw):
    cfg, jcfg, params, model = models
    prompts, budgets = _shared_trace()
    kw = dict(slots=2, max_len=64, decode_chunk=4, cache_layout="paged",
              page_size=8, **engine_kw)
    ours, teng = _serve(ServeEngine, Request, cfg, model, prompts, budgets,
                        RT, True, device="cpu", **kw)
    theirs, jeng = _serve(JaxServeEngine, JaxRequest, jcfg, params, prompts,
                          budgets, JRT, False, **kw)
    assert ours == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.memory_stats() == jeng.memory_stats()
    if engine_kw.get("prefix_caching", True):
        assert teng.stats["tokens_reused"] > 0
        assert teng.stats["cow_copies"] > 0
    assert teng.logits_finite()


def test_pool_bytes_per_page_equal_the_reference():
    """MLA layers join the "full" class at page_size·(r + rd) elements
    per page and layer — 2304 B per token and layer at DeepSeek-V3's
    widths in fp32 — at smoke size and at full width (3 layers)."""
    full = dict(n_layers=3)
    for cfg, jcfg in (
            (_dense_ffn(get_config), _dense_ffn(jax_get_config)),
            (dataclasses.replace(get_config("deepseek-v3-671b"), **full),
             dataclasses.replace(jax_get_config("deepseek-v3-671b"),
                                 **full))):
        ours = PagedKVCache(cfg, 2, 64, torch.float32, page_size=16,
                            device="cpu")
        theirs = JaxPagedKVCache(jcfg, 2, 64, jnp.float32, page_size=16)
        m = cfg.mla
        assert list(ours.classes) == list(theirs.classes) == ["full"]
        assert ours.classes["full"].bytes_per_page == \
            theirs.classes["full"].bytes_per_page == \
            cfg.n_layers * 16 * (m.kv_lora_rank + m.rope_dim) * 4
        assert ours.memory_stats()["physical_cache_bytes"] == \
            theirs.memory_stats()["physical_cache_bytes"]
        assert ours.prefix_supported and theirs.prefix_supported
        for c in ours.caches:          # 8 pages + the sink page
            assert tuple(c["attn"]["ckv_pages"].shape) == \
                (9, 16, m.kv_lora_rank)
            assert tuple(c["attn"]["krope_pages"].shape) == \
                (9, 16, m.rope_dim)
    assert (m.kv_lora_rank + m.rope_dim) * 4 == 2304


# ---------------------------------------------------------------------------
# the MoE tower builds and serves; what stays unported raises
# ---------------------------------------------------------------------------

def test_moe_raises_naming_item_5b():
    """MoE is ported (item 5b): the MLA smoke config builds with its
    expert layers (layer 0 dense, layers 1-3 MoE with a shared expert);
    an SSM config builds too since item 6, with its Mamba branches."""
    cfg = get_config(NAME)
    model = tf.init(cfg, 0, RT, device="cpu")
    kinds = [s.mlp for s in cfg.layer_specs()]
    assert kinds == ["dense", "moe", "moe", "moe"]
    for layer, kind in zip(model.layers, kinds):
        assert hasattr(layer, "moe") == (kind == "moe")
        assert hasattr(layer, "mlp") == (kind == "dense")
    moe = model.layers[1].moe
    assert tuple(moe.wi_gate.shape) == (cfg.moe.n_experts, cfg.d_model,
                                        cfg.moe.d_ff_expert)
    assert moe.router.dtype == torch.float32 and hasattr(moe, "shared")
    hymba = tf.init(get_config("hymba-1.5b-smoke"), 0, RT, device="cpu")
    assert all(hasattr(layer, "ssm") for layer in hymba.layers)


def test_launcher_serves_the_mla_arch_with_its_moe_cut(tmp_path):
    """The launcher serves the MLA smoke config with its expert layers,
    no cut: the JSON has no ``moe_cut`` key, the paged leg and its
    prefix-cache-off twin give equal streams, and, as in the reference,
    an MoE arch takes no prefix cache (nothing reused)."""
    out = tmp_path / "bench.json"
    metrics = serve.main(["--device", "cpu", "--arch", NAME,
                          "--cache-layout", "paged", "--requests", "4",
                          "--slots", "2", "--max-len", "64", "--page-size",
                          "8", "--prompt-len", "10", "--prompt-len-max",
                          "30", "--new-tokens", "4", "--repeats", "1",
                          "--shared-prefix-len", "16", "--json", str(out)])
    saved = json.loads(out.read_text())
    assert "moe_cut" not in saved and saved["n_layers"] == 4
    assert list(saved["layouts"]) == ["paged", "paged_noprefix"]
    assert saved["outputs_match"] is True
    assert saved["layouts"]["paged"]["prefix"]["tokens_reused"] == 0
    assert saved["kernel_launches"] == {
        "fusemax_prefill": 0, "decode_partials": 0,
        "paged_decode_partials": 0, "mla_paged_decode_partials": 0,
        "latent_decode_partials": 0}
    assert all(len(o) == 4 for o in metrics["_outputs"])


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trips_mla_and_skips_only_mtp():
    """With an MTP head in the reference's tree (``n_mtp = 1``), the port
    loads every other leaf strictly and round-trips them bit for bit; the
    only subtree it leaves out is ``mtp``."""
    jcfg = _dense_ffn(jax_get_config, n_layers=2)
    jcfg = dataclasses.replace(jcfg, n_mtp=1)
    cfg = dataclasses.replace(_dense_ffn(get_config, n_layers=2), n_mtp=1)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(1), JRT)
    want = jax.device_get(params)
    assert "mtp" in want
    model = bridge.model_from_jax(cfg, want, RT, device="cpu")
    prefix = "layers.0.attn."
    names = {n[len(prefix):] for n, _ in model.named_parameters()
             if n.startswith(prefix)}
    assert names == {"w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo",
                     "q_norm.scale", "kv_norm.scale"}
    back = bridge.jax_from_model(cfg, model)
    assert set(want) - set(back) == {"mtp"}
    want = {k: v for k, v in want.items() if k != "mtp"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_forward_logits_match(models):
    cfg, jcfg, params, model = models
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 19)) \
        .astype(np.int32)
    ref = np.asarray(jtf.forward(jcfg, params, {"inputs": jnp.asarray(toks)},
                                 JRT))
    ours = tf.forward(cfg, model, {"inputs": torch.from_numpy(toks)},
                      RT).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-4)
