"""The port's training and serving over a device mesh on CPU device
lists, against the reference's single-device results — the three tests of
tests/test_distributed.py, at their configs, sizes and tolerances.

Every mesh position is ``cpu`` (one controller over a device list, as
the reference's tests put 8 host "devices" on one CPU).  Weights come
from the reference's ``init`` through the bridge; batches are the
reference's ``SyntheticSource`` batches (numpy), handed to both.

1. The train step (AdamW, warmup-cosine, clip 1.0) on granite-3-8b-smoke
   over a 4 x 2 mesh under ``fsdp_tp`` and under ``tp``: its four losses
   equal the reference's jitted single-device step's within rtol 2e-4; a
   1 x 1 mesh is the unsharded step bit for bit; Adafactor and int8 error
   feedback under ``fsdp_tp`` (the whole-leaf statistics: the update RMS,
   the factored moments, the compressor's scale) the same way.
2. The elastic restore: stablelm-1.6b-smoke on 4 x 2, three steps, a
   checkpoint, two more (the uninterrupted run); ``ElasticMeshManager``
   plans 2 x 2 for 4 survivors, a fresh state there restores the
   checkpoint and its two steps' last loss equals the uninterrupted one
   within 2e-4; a sharded checkpoint holds whole leaves.
3. The decode step of gemma2-9b-smoke with parameters placed by the
   ``serve`` rules and caches by ``cache_shardings`` on 2 x 4 (2 kv heads
   on a 4-way model axis: the caches split on their slots, decode runs K2's
   plain version on each strip): within 2e-3 of the reference's
   ``decode_step``; and on random history — gemma2's slot strips and
   stablelm-1.6b-smoke's kv-head shards (4 kv heads divide the axis) —
   within 1e-5 of the port's unsharded step.
4. The launcher's ``--mesh 2x2 --rules fsdp_tp`` on the CPU.
"""
import copy
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
from repro.data import DataConfig, SyntheticSource
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.training import train_step as jts
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharded_decode as sdec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import ElasticMeshManager
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.training import train_step as ts

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
RTOL = 2e-4


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _reference_losses(arch, opt_name, compression, src, steps):
    """The reference's jitted single-device step, and its initial state."""
    jcfg = jax_get_config(arch)
    jopt = joptim.make_optimizer(opt_name)
    jstate, _ = jts.init_train_state(jcfg, jax.random.PRNGKey(0), jopt, JRT,
                                     compression=compression)
    init = jax.device_get(jstate)
    jstep = jax.jit(jts.make_train_step(
        jcfg, jopt, joptim.warmup_cosine(1e-3, 2, 20), JRT,
        compression=compression))
    losses = []
    for i in range(steps):
        jstate, m = jstep(jstate, src.batch_at(i))
        losses.append(float(m["loss"]))
    return losses, init


def _port_losses(arch, opt_name, compression, src, steps, init, mesh=None,
                 mode="fsdp_tp"):
    cfg = get_config(arch)
    state = bridge.train_state_from_jax(cfg, init, RT, device="cpu")
    rules = None
    if mesh is not None:
        rules = shd.make_rules(mesh, mode)
        state = ts.shard_train_state(state, cfg, mesh, rules)
    step = ts.make_train_step(cfg, optim.make_optimizer(opt_name),
                              optim.warmup_cosine(1e-3, 2, 20), RT,
                              compression=compression, mesh=mesh,
                              rules=rules)
    losses = []
    for i in range(steps):
        state, m = step(state, _tb(src.batch_at(i)))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-3-8b-smoke")
    src = SyntheticSource(DataConfig(global_batch=8, seq_len=32,
                                     vocab=cfg.vocab, seed=2))
    losses, init = _reference_losses("granite-3-8b-smoke", "adamw", False,
                                     src, 4)
    return dict(src=src, ref=losses, init=init)


@pytest.mark.parametrize("mode", ["fsdp_tp", "tp"])
def test_sharded_train_step_matches_single_device(granite, mode):
    got, state = _port_losses("granite-3-8b-smoke", "adamw", False,
                              granite["src"], 4, granite["init"],
                              mesh=_mesh((4, 2)), mode=mode)
    np.testing.assert_allclose(got, granite["ref"], rtol=RTOL)
    assert isinstance(state, ts.ShardedTrainState)
    # every position holds its shard's bytes, one copy per region
    planned = [a + b for a, b in zip(state.position_bytes()["params"],
                                     state.position_bytes()["opt_state"])]
    assert planned == state.held_position_bytes()


def test_one_position_mesh_is_the_unsharded_step(granite):
    a, sa = _port_losses("granite-3-8b-smoke", "adamw", False,
                         granite["src"], 2, granite["init"])
    b, sb = _port_losses("granite-3-8b-smoke", "adamw", False,
                         granite["src"], 2, granite["init"],
                         mesh=_mesh((1, 1)))
    assert a == b
    for k, p in sa.params.items():
        assert torch.equal(p, sb.params[k]), k


@pytest.mark.parametrize("opt_name,compression", [("adafactor", False),
                                                  ("adamw", True)])
def test_whole_leaf_statistics_under_fsdp_tp(opt_name, compression):
    """Adafactor's update RMS and factored moments, and the int8
    compressor's scale, span every shard of a leaf and every layer of its
    run: the sharded step's losses are the reference's."""
    arch = "stablelm-1.6b-smoke"
    src = SyntheticSource(DataConfig(global_batch=8, seq_len=32,
                                     vocab=get_config(arch).vocab, seed=3))
    ref, init = _reference_losses(arch, opt_name, compression, src, 3)
    got, _ = _port_losses(arch, opt_name, compression, src, 3, init,
                          mesh=_mesh((4, 2)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_elastic_restore_onto_smaller_mesh(tmp_path):
    arch = "stablelm-1.6b-smoke"
    cfg = get_config(arch)
    opt = optim.make_optimizer("adamw")
    src = SyntheticSource(DataConfig(global_batch=8, seq_len=32,
                                     vocab=cfg.vocab, seed=5))

    def build(shape, seed):
        mesh = _mesh(shape)
        rules = shd.make_rules(mesh, "fsdp_tp")
        whole = ts.init_train_state(cfg, seed, opt, RT, device="cpu")
        sh = ts.state_shardings(whole, shd.param_axes(cfg, whole.model),
                                mesh, rules)
        state = ts.shard_train_state(whole, cfg, mesh, rules)
        step = ts.make_train_step(cfg, opt, optim.warmup_cosine(1e-3, 2, 20),
                                  RT, mesh=mesh, rules=rules)
        return state, step, sh

    state, step, _ = build((4, 2), 0)
    for i in range(3):
        state, _ = step(state, _tb(src.batch_at(i)))
    ckpt.save(str(tmp_path), 3, state.as_tree())
    for i in range(3, 5):
        state, mref = step(state, _tb(src.batch_at(i)))
    whole = ckpt.restore(str(tmp_path), 3, ts.init_train_state(
        cfg, 0, opt, RT, device="cpu").as_tree())
    assert whole["params"]["embed.table"].shape == (cfg.vocab, cfg.d_model)

    plan = ElasticMeshManager(model_parallel=2, devices_per_pod=8).plan(4)
    assert plan.shape == (2, 2), plan
    state4, step4, sh4 = build(plan.shape, 1)
    state4.load_tree(ckpt.restore(str(tmp_path), 3, state4.as_tree(), sh4))
    for i in range(3, 5):
        state4, mres = step4(state4, _tb(src.batch_at(i)))
    np.testing.assert_allclose(float(mref["loss"]), float(mres["loss"]),
                               rtol=RTOL)


@pytest.fixture(scope="module")
def gemma2_decode():
    arch = "gemma2-9b-smoke"
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    return dict(cfg=cfg, jcfg=jcfg, params=params)


def _sharded_decode(cfg, model, caches, toks, kv_len, mesh):
    rt = dataclasses.replace(RT, decode_splits=mesh.shape["model"])
    params = sdec.place_params(cfg, model, mesh, shd.make_rules(mesh,
                                                                "serve"))
    caches = sdec.shard_caches(cfg, caches, mesh)
    out, caches = sdec.decode_step(cfg, model, params, toks, caches, kv_len,
                                   rt, mesh)
    return out, caches


def test_serve_step_sharded_matches_reference(gemma2_decode):
    g = gemma2_decode
    cfg, jcfg, params = g["cfg"], g["jcfg"], g["params"]
    b, max_len = 4, 64
    jcaches = jtf.init_cache(jcfg, b, max_len, jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (b, 1), 0, cfg.vocab)
    kv_len = jnp.asarray([1, 1, 1, 1], jnp.int32)
    ref, _ = jtf.decode_step(jcfg, params, toks, jcaches, kv_len, JRT)

    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    caches = tf.init_cache(cfg, b, max_len, torch.float32, "cpu")
    mesh = _mesh((2, 4))
    out, caches = _sharded_decode(
        cfg, model, caches, torch.from_numpy(np.array(toks)),
        torch.from_numpy(np.array(kv_len)), mesh)
    # 2 kv heads on a 4-way model axis: the slots split
    assert caches[0]["attn"]["k"].sharding.spec == ("data", None, "model",
                                                    None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch,dim", [("gemma2-9b-smoke", 2),
                                      ("stablelm-1.6b-smoke", 1)])
def test_serve_step_sharded_on_history(arch, dim):
    """On random history (past a ring's wrap on gemma2), the sharded
    decode equals the port's unsharded step at the same split geometry:
    on slot strips where the kv heads do not divide the model axis
    (gemma2's 2 on 4), on kv-head shards where they do (stablelm's 4)."""
    cfg = get_config(arch)
    model = tf.init(cfg, 0, RT, device="cpu")
    b, max_len = 4, 64
    caches = tf.init_cache(cfg, b, max_len, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    for c in caches:
        for t in c["attn"].values():
            t.normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
    kv_len = torch.tensor([1, 17, 40, 90])
    mesh = _mesh((2, 4))
    ref, ref_caches = tf.decode_step(
        cfg, copy.deepcopy(model), toks, copy.deepcopy(caches), kv_len,
        dataclasses.replace(RT, decode_splits=4))
    out, caches = _sharded_decode(cfg, model, caches, toks, kv_len, mesh)
    assert "model" == caches[0]["attn"]["k"].sharding.spec[dim]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for c, r in zip(caches, ref_caches):
        for k in ("k", "v"):
            np.testing.assert_allclose(c["attn"][k].gather("cpu").numpy(),
                                       r["attn"][k].numpy(), atol=1e-5)


def test_launcher_trains_on_a_mesh():
    argv = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
            "32", "--fp32", "--warmup", "1"]
    whole = train.main(argv)
    m = train.main(argv + ["--mesh", "2x2", "--rules", "fsdp_tp"])
    np.testing.assert_allclose(m["losses"], whole["losses"], rtol=RTOL)
    assert m["mesh"] == "2x2" and len(m["position_bytes"]["params"]) == 4
    # a quarter of every split leaf, the replicated norms whole
    one, total = m["position_bytes"]["params"][0], \
        whole["position_bytes"]["params"][0]
    assert total / 4 <= one < total / 3
