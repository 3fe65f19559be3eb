"""The device-sharded paged pool (``mesh=``) of repro_torch on the CPU.

The reference's contract (``tests/test_sharded_pool.py``): greedy streams
of a sharded engine equal the single-pool paged engine's — prefix hits,
COW, preemption, chunked prefill, windows and the swap tier included —
and per-device bytes are total / tp.  Here the shards sit on a repeated
``cpu`` device list (the reference's tests put several host "devices" on
one CPU the same way) and run the kernels' plain versions.  Each case
serves the reference test's config and tp through the port's sharded
engine and its unsharded one: equal streams and counters, and the
sharded pools, once unsharded, bit-equal to the unsharded pool.  Two
cases (GQA with prefix hits and COW, MLA with chunked prefill) also run
the reference's unsharded paged engine in process on bridged weights and
hold all three streams equal; the others' configs and features are held
to the reference's engine unsharded in their own files
(``test_torch_paged``, ``test_torch_mla``, ``test_torch_window``,
``test_torch_quant_swap``), which keeps this module's JAX compiles — most
of its time — to two.  The kernel-level cases hold K3 on head shards and
the latent strips, concatenated, to the unsharded call exactly.
"""
import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.model.attention import (
    dequantize_kv, pool_pages, quantize_kv,
)
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
GQA = "stablelm-1.6b-smoke"          # 4 kv heads
MLA = "deepseek-v3-671b-smoke"       # rank 32, rope 16, MoE layers
RING = "gemma2-9b-smoke"             # 2 kv heads, windows and softcaps


def cpu_mesh(tp: int):
    return mesh_mod.make_mesh(tp, ["cpu"] * tp)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run small tensors: one intra-op thread is as
    fast alone and keeps this module from crowding the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """name → (port cfg, reference cfg, reference params, port model),
    built once a module (the reference's init jitted: 2-3x faster than
    op by op here; both engines take the same bridged weights)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, jcfg = get_config(name), jax_get_config(name)
            params = jax.jit(lambda key: jtf.init(jcfg, key, JRT)[0])(
                jax.random.PRNGKey(0))
            model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                          device="cpu")
            cache[name] = (cfg, jcfg, params, model)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def models():
    """name → (port cfg, port model from the port's own seeded init),
    for the cases held to the unsharded port engine only."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = get_config(name)
            cache[name] = (cfg, tf.init(cfg, 0, RT, device="cpu"))
        return cache[name]

    return get


def _kw(**kw):
    base = dict(slots=2, max_len=64, decode_chunk=8, cache_layout="paged",
                page_size=8)
    base.update(kw)
    return base


def _serve(engine, req_cls, prompts, new_tokens):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _prompts(vocab, plens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in plens]


def _two(cfg, model, prompts, tp, new_tokens=5, **kw):
    """The port's sharded and unsharded engines on one trace: (sharded
    streams, unsharded streams, sharded engine, unsharded engine), the
    pools audited."""
    sharded = ServeEngine(cfg, model, rt=RT, device="cpu",
                          mesh=cpu_mesh(tp), **_kw(**kw))
    single = ServeEngine(cfg, model, rt=RT, device="cpu", **_kw(**kw))
    o_sh = _serve(sharded, Request, prompts, new_tokens)
    o_one = _serve(single, Request, prompts, new_tokens)
    for e in (sharded, single):
        e.kv.check_invariants()
    return o_sh, o_one, sharded, single


def _reference(pair, prompts, new_tokens=5, **kw):
    """The reference's unsharded paged engine's streams on the trace."""
    _, jcfg, params, _ = pair
    return _serve(JaxServeEngine(jcfg, params, rt=JRT, **_kw(**kw)),
                  JaxRequest, prompts, new_tokens)


def _unshard(caches):
    """A sharded paged cache list with every leaf whole on the CPU: the
    shards concatenated on their axis (the reference's global array)."""
    def whole(name, leaf):
        parts = shd.leaf_parts(leaf)
        return parts[0] if len(parts) == 1 else torch.cat(
            parts, dim=shd._PAGED_SHARD_DIMS[name])

    return [{part: {name: whole(name, leaf) for name, leaf in leaves.items()}
             for part, leaves in c.items()} for c in caches]


def _assert_pools_equal(sharded, single):
    """The sharded pools, concatenated back on their axes, bit-equal to the
    unsharded engine's (the readable pages: the sink page takes masked
    writes and is never read); each shard 1/tp of its leaf."""
    tp = sharded.kv.shard.size
    whole = _unshard(sharded.caches)
    for a, b, c in zip(whole, single.caches, sharded.caches):
        assert a.keys() == b.keys()
        for name in b.get("attn", {}):
            assert torch.equal(pool_pages(a["attn"][name]),
                               pool_pages(b["attn"][name])), name
            parts = shd.leaf_parts(c["attn"][name])
            if name in shd._PAGED_SHARD_DIMS:
                assert len(parts) == tp
                assert all(p.numel() * tp == b["attn"][name].numel()
                           for p in parts), name
            else:
                assert len(parts) == 1


def _assert_memory(sharded, single):
    tp = sharded.kv.shard.size
    m1, m0 = sharded.memory_stats(), single.memory_stats()
    assert m0["sharding"] is None
    sh = m1["sharding"]
    assert sh["tp"] == tp and sh["axis"] == "model"
    for k in ("resident_cache_bytes", "peak_resident_cache_bytes",
              "physical_cache_bytes"):
        assert sh["per_device"][k] * tp == m1[k], (k, sh, m1[k])
    assert m0["peak_resident_cache_bytes"] == m1["peak_resident_cache_bytes"]
    assert sh["shard_bytes"]["per_shard"] * tp \
        + sh["shard_bytes"]["replicated"] == m1["physical_cache_bytes"]


# ---------------------------------------------------------------------------
# host logic against the reference's functions
# ---------------------------------------------------------------------------

VALIDATE_CASES = [(GQA, 4), (RING, 2), (MLA, 4), ("granite-3-8b-smoke", 1),
                  ("granite-3-8b-smoke", 4), (RING, 4), (MLA, 3),
                  ("granite-3-8b", 8), ("granite-3-8b", 16), (MLA, 64),
                  ("hymba-1.5b", 5), ("xlstm-125m", 4)]


@pytest.mark.parametrize("name,tp", VALIDATE_CASES,
                         ids=[f"{n}-tp{t}" for n, t in VALIDATE_CASES])
def test_validate_kv_shard_matches_reference(name, tp):
    """Accepts exactly the (config, tp) pairs the reference accepts, and
    refuses the others with its message."""
    def outcome(fn, cfg):
        try:
            fn(cfg, tp)
            return None
        except ValueError as e:
            return str(e)

    ours = outcome(shd.validate_kv_shard, get_config(name))
    theirs = outcome(jax_sharding.validate_kv_shard, jax_get_config(name))
    assert ours == theirs


GROUP_CASES = [(1, 1, 1), (2, 1, 1), (3, 1, 2), (2, 2, 4), (2, 2, 5),
               (1, 4, 4), (4, 2, 8), (2, 2, 3), (0, 1, 2), (2, 0, 4)]


@pytest.mark.parametrize("dp,tp,n", GROUP_CASES,
                         ids=[f"dp{d}-tp{t}-n{n}" for d, t, n in GROUP_CASES])
def test_replica_device_groups_matches_reference(dp, tp, n):
    def outcome(fn):
        try:
            return fn(dp, tp, list(range(n)))
        except ValueError as e:
            return str(e)

    assert outcome(shd.replica_device_groups) == \
        outcome(jax_sharding.replica_device_groups)


def test_meshes_take_the_visible_cuda_devices_or_a_given_list():
    mesh = mesh_mod.make_mesh(3, ["cpu", "cpu", "cpu", "cpu"])
    assert mesh.shape == {"model": 3} and mesh.axis_names == ("model",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2"):
            mesh_mod.make_mesh(2)
    assert mesh_mod.make_replica_meshes(3, 1) == [None] * 3
    meshes = mesh_mod.make_replica_meshes(2, 2, ["cpu"] * 4)
    assert [m.shape["model"] for m in meshes] == [2, 2]
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh_mod.make_replica_meshes(2, 2, ["cpu"] * 3)


def test_sharding_modules_import_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.distributed.sharding, "
            "repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# the reference test's engine cases
# ---------------------------------------------------------------------------

def test_sharded_gqa_with_prefix_and_cow(pairs):
    """stablelm smoke at tp 4 with the prefix cache live: shared-prefix
    hits and a COW admission (a resent prompt exactly covering resident
    pages); equal streams and counters, 1/4 of the bytes a device."""
    cfg, _, _, model = pairs(GQA)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab,
                                                    size=(t,))])
               .astype(np.int32) for t in (8, 5, 6, 7)]
    # request 4 resends request 0's three-page prompt after it completed:
    # its hit covers the prompt exactly, so the last page is copied (COW)
    prompts.append(prompts[0].copy())
    o_sh, o_one, sharded, single = _two(cfg, model, prompts, 4)
    assert o_sh == o_one == _reference(pairs(GQA), prompts)
    for e in (sharded, single):
        assert e.stats["prefix_hits"] >= 3, e.stats
        assert e.stats["tokens_reused"] >= 3 * 16, e.stats
        assert e.stats["cow_copies"] >= 1, e.stats
    assert sharded.stats == single.stats
    _assert_memory(sharded, single)
    _assert_pools_equal(sharded, single)


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_sharded_mla(pairs, models, chunk):
    """deepseek smoke (MLA + MoE) at tp 4: rank-sliced latent pages,
    chunked prefill's rank-complete history, strip decode; the chunked
    trace also against the reference's engine."""
    pair = pairs(MLA) if chunk else models(MLA)
    prompts = _prompts(pair[0].vocab, (12, 20, 9, 17))
    o_sh, o_one, sharded, single = _two(pair[0], pair[-1], prompts, 4,
                                        prefill_chunk=chunk)
    assert o_sh == o_one
    if chunk:
        assert o_one == _reference(pair, prompts, prefill_chunk=chunk)
    _assert_memory(sharded, single)
    _assert_pools_equal(sharded, single)


def test_sharded_mla_strips_of_several_splits(models):
    """A 32-page table: K4's geometry has 2 splits there, so each of tp 2
    shards sweeps a strip of one (the smoke tables above have one split,
    which one shard sweeps)."""
    cfg, model = models(MLA)
    splits, _, strips = ops.mla_strips(32, 8, cfg.n_heads,
                                       cfg.mla.kv_lora_rank,
                                       cfg.mla.rope_dim, 2)
    assert splits == 2 and strips == [(0, 1), (1, 1)]
    prompts = _prompts(cfg.vocab, (20, 41, 33), seed=4)
    o_sh, o_one, sharded, single = _two(cfg, model, prompts, 2,
                                        new_tokens=6, max_len=256,
                                        decode_chunk=6)
    assert o_sh == o_one
    _assert_pools_equal(sharded, single)


def test_sharded_windowed_chunked(models):
    """gemma2 smoke (global + sliding-window layers, 2 kv heads) at tp 2
    with chunked prefill: the ring band read per head shard."""
    cfg, model = models(RING)
    prompts = _prompts(cfg.vocab, (20, 11, 27, 14))
    o_sh, o_one, sharded, single = _two(cfg, model, prompts, 2,
                                        prefill_chunk=8)
    assert o_sh == o_one
    _assert_memory(sharded, single)
    _assert_pools_equal(sharded, single)


def test_sharded_preemption_tiny_pool(models):
    """A 6-page pool forces back-pressure and youngest-first preemption;
    the recompute replays identically on the sharded pool."""
    cfg, model = models(GQA)
    prompts = _prompts(cfg.vocab, (20, 21, 22, 23))
    o_sh, o_one, sharded, single = _two(cfg, model, prompts, 4,
                                        new_tokens=8, num_pages=6)
    assert o_sh == o_one
    assert sharded.stats["preemptions"] == single.stats["preemptions"] > 0
    _assert_pools_equal(sharded, single)


def test_sharded_swap_tier(models):
    """The host swap tier at tp 2: demotion copies every shard's pages,
    promotion writes them back — demote → promote → hit streams and the
    swap counters equal the unsharded engine's."""
    cfg, model = models(GQA)
    rng = np.random.default_rng(9)
    pa = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    kw = _kw(decode_chunk=4, num_pages=8, host_swap_bytes=1 << 30)
    engines = [ServeEngine(cfg, model, rt=RT, device="cpu",
                           mesh=cpu_mesh(2), **kw),
               ServeEngine(cfg, model, rt=RT, device="cpu", **kw)]
    outs = []
    for eng in engines:
        streams = []
        for rid, p in enumerate((pa, pb, pa)):
            r = Request(rid=rid, prompt=p, max_new_tokens=4)
            eng.submit(r)
            eng.run()
            streams.append(list(r.generated))
        outs.append(streams)
    assert outs[0] == outs[1]
    sharded, single = engines
    for e in engines:
        assert e.kv.stats["demotions"] >= 3, e.kv.stats
        assert e.kv.stats["promotions"] >= 3, e.kv.stats
    assert sharded.kv.stats == single.kv.stats
    sharded.kv.check_invariants()
    _assert_pools_equal(sharded, single)


@pytest.mark.parametrize("name", [GQA, MLA], ids=["gqa", "mla"])
def test_sharded_fp8_pool(models, name):
    """fp8 e4m3 pages at tp 2: GQA codes and scales split on the heads
    (quantization is per token and head); MLA codes on the rank with the
    whole-vector scales replicated, decode dequantizing the rank-complete
    view before the strips (the reference's order)."""
    cfg, model = models(name)
    prompts = _prompts(cfg.vocab, (12, 20, 9, 17))
    o_sh, o_one, sharded, single = _two(cfg, model, prompts, 2,
                                        prefill_chunk=8, kv_dtype="fp8_e4m3")
    assert o_sh == o_one
    _assert_memory(sharded, single)
    _assert_pools_equal(sharded, single)


# ---------------------------------------------------------------------------
# kernel level: head shards and latent strips, concatenated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4, 8])
def test_k3_on_head_shards_concatenates_to_the_whole_pool(tp):
    """K3's plain version on each kv-head shard of a pool (queries sliced
    by their group), concatenated on the heads: exactly the call on the
    whole pool, fp32 and fp8 codes."""
    gen = torch.Generator().manual_seed(tp)
    b, hq, hkv, d, ps, w, n_pages = 3, 32, 8, 32, 8, 8, 30
    q = torch.randn(b, hq, 1, d, generator=gen)
    kp = torch.randn(n_pages, ps, hkv, d, generator=gen)
    vp = torch.randn(n_pages, ps, hkv, d, generator=gen)
    bt = torch.stack([torch.randperm(n_pages, generator=gen)[:w]
                      for _ in range(b)]).int()
    kv_len = torch.tensor([w * ps, 37, 0])
    for codes in (False, True):
        ks = vs = None
        k, v = kp, vp
        if codes:
            k, ks = quantize_kv(kp, torch.float8_e4m3fn)
            v, vs = quantize_kv(vp, torch.float8_e4m3fn)
        whole = ops.fusemax_decode_paged(q, k, v, bt, kv_len, impl="torch",
                                         k_scale=ks, v_scale=vs)
        parts = []
        for i in range(tp):
            h, g = shd.shard_slice(hkv, i, tp), shd.shard_slice(hq, i, tp)
            parts.append(ops.fusemax_decode_paged(
                q[:, g], k[:, :, h], v[:, :, h], bt, kv_len, impl="torch",
                k_scale=None if ks is None else ks[:, :, h],
                v_scale=None if vs is None else vs[:, :, h]))
        assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("tp", [2, 4])
def test_latent_strips_concatenate_to_k4(tp):
    """At DeepSeek's latent (r 512, rd 64) with 16 splits: each shard's
    strip, on the pool (K4's plain version) and on the rank-complete view
    (the dense latent kernel's), combined in split order, equals K4's
    plain version on the whole table exactly — and on fp8 codes, the
    strips on the dequantized view equal K4 on the codes."""
    gen = torch.Generator().manual_seed(10 + tp)
    b, h, r, rd, ps, w, n_pages = 2, 16, 512, 64, 16, 128, 300
    q = torch.randn(b, h, 1, r + rd, generator=gen)
    ckv = torch.randn(n_pages, ps, r, generator=gen)
    kr = torch.randn(n_pages, ps, rd, generator=gen)
    bt = torch.stack([torch.randperm(n_pages, generator=gen)[:w]
                      for _ in range(b)]).int()
    kv_len = torch.tensor([w * ps, 700])
    for codes in (False, True):
        cs = krs = None
        c, k = ckv, kr
        if codes:
            c, cs = quantize_kv(ckv, torch.float8_e4m3fn)
            k, krs = quantize_kv(kr, torch.float8_e4m3fn)
        whole = ops.fusemax_mla_decode_paged(q, c, k, bt, kv_len,
                                             impl="torch", ckv_scale=cs,
                                             krope_scale=krs)
        splits, block_k, strips = ops.mla_strips(
            w, ps, h, r, rd, tp, elem_bytes=c.element_size())
        assert splits == 16 and all(n == 16 // tp for _, n in strips)
        view_c = ops.gather_pages(c, bt)
        view_k = ops.gather_pages(k, bt)
        if codes:
            view_c = dequantize_kv(view_c, ops.gather_pages(cs, bt))
            view_k = dequantize_kv(view_k, ops.gather_pages(krs, bt))
        kw = dict(splits=splits, block_k=block_k, impl="torch")
        on_view = [ops.fusemax_mla_decode_strip(
            q, view_c, view_k, kv_len, split_first=f, n_splits=n, **kw)
            for f, n in strips]
        assert torch.equal(ops.combine_strips(on_view, q), whole)
        on_pool = [ops.fusemax_mla_decode_strip(
            q, c, k, kv_len, block_table=bt, split_first=f, n_splits=n,
            ckv_scale=cs, krope_scale=krs, **kw) for f, n in strips]
        assert torch.equal(ops.combine_strips(on_pool, q), whole)


def test_strips_refuse_what_lies_outside_the_sweep():
    q = torch.zeros(1, 4, 1, 48)
    ckv, kr = torch.zeros(1, 64, 32), torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="not inside 4 splits"):
        ops.fusemax_mla_decode_strip(q, ckv, kr, torch.tensor([3]),
                                     splits=4, block_k=8, split_first=3,
                                     n_splits=2, impl="torch")
    with pytest.raises(ValueError, match="3-pass oracle"):
        ops.fusemax_mla_decode_strip(q, ckv, kr, torch.tensor([3]),
                                     splits=4, block_k=8, split_first=0,
                                     n_splits=2, impl="ref")


# ---------------------------------------------------------------------------
# the engine's and the launcher's gates
# ---------------------------------------------------------------------------

def test_engine_gates(models):
    """The reference's refusals: a kv-head count tp does not divide, the
    dense layout, speculation, an MLA table width tp does not divide, a
    mesh without the shard axis."""
    _, gmodel = models(GQA)
    granite = get_config("granite-3-8b-smoke")
    with pytest.raises(ValueError, match="n_kv_heads=1 is not divisible by "
                                         "tp=4"):
        ServeEngine(granite, None, rt=RT, device="cpu", mesh=cpu_mesh(4),
                    **_kw())
    cfg = get_config(GQA)
    with pytest.raises(ValueError, match="requires cache_layout='paged'"):
        ServeEngine(cfg, gmodel, rt=RT, device="cpu", mesh=cpu_mesh(2),
                    **_kw(cache_layout="dense"))
    with pytest.raises(ValueError, match="device-sharded pool"):
        ServeEngine(cfg, gmodel, rt=RT, device="cpu", mesh=cpu_mesh(2),
                    speculate=4, **_kw())
    with pytest.raises(ValueError, match="no 'data' axis"):
        ServeEngine(cfg, gmodel, rt=RT, device="cpu", mesh=cpu_mesh(2),
                    shard_axis="data", **_kw())
    mcfg, mmodel = models(MLA)
    with pytest.raises(ValueError, match="table width 5"):
        ServeEngine(mcfg, mmodel, rt=RT, device="cpu", mesh=cpu_mesh(4),
                    **_kw(max_len=40))
    # a one-device mesh is no shard
    one = ServeEngine(cfg, gmodel, rt=RT, device="cpu", mesh=cpu_mesh(1),
                      **_kw())
    assert one.kv.shard is None and one.memory_stats()["sharding"] is None


ARGV = ["--device", "cpu", "--arch", GQA, "--requests", "4", "--slots",
        "2", "--max-len", "64", "--prompt-len", "12", "--prompt-len-max",
        "30", "--new-tokens", "4", "--repeats", "1", "--no-warmup",
        "--json", ""]


def test_launcher_mesh_serves_a_cpu_mesh():
    """``--mesh tp=2`` over a CPU device list no longer raises
    NotImplementedError: it adds the paged_sharded leg to outputs_match,
    with the mesh, the tok/s ratio and the per-device bytes."""
    m = serve.main(ARGV + ["--cache-layout", "both", "--mesh", "tp=2"],
                   devices=["cpu", "cpu"])
    assert list(m["layouts"]) == ["dense", "paged", "paged_sharded"]
    assert m["outputs_match"] is True
    assert m["mesh"] == {"tp": 2, "axes": ["model"],
                         "devices": ["cpu", "cpu"]}
    assert m["sharded_vs_paged_tok_per_s"] > 0
    sh = m["layouts"]["paged_sharded"]["memory"]["sharding"]
    assert sh["per_device"]["physical_cache_bytes"] * 2 == \
        m["layouts"]["paged_sharded"]["memory"]["physical_cache_bytes"]


def test_launcher_async_dp_over_sharded_replicas():
    """``--async --dp 2 --mesh tp=2``: two replicas, each sharded over its
    own two devices of a CPU list, streams equal to the sync engine's."""
    m = serve.main(ARGV + ["--async", "--dp", "2", "--mesh", "tp=2",
                           "--shared-prefix-len", "8"],
                   devices=["cpu"] * 4)
    assert m["dp"]["tp"] == 2 and m["dp"]["outputs_match"] is True
    assert m["outputs_match"] is True


@pytest.mark.parametrize("argv,msg", [
    (["--cache-layout", "dense", "--mesh", "tp=2"],
     "--mesh shards the paged pool"),
    (["--cache-layout", "paged", "--mesh", "tp=2", "--speculate", "4"],
     "device-sharded pool"),
    (["--cache-layout", "paged", "--mesh", "tp=3"], "needs 3 devices"),
    (["--cache-layout", "paged", "--mesh", "pp=2"], "expects tp=N"),
], ids=["dense", "speculate", "too-few", "axis"])
def test_launcher_mesh_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(ARGV + argv, devices=["cpu", "cpu"])
