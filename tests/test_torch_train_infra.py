"""The port's training infrastructure: data, checkpoints, fault tolerance,
shape cells and the training launcher, on the CPU.

1. ``SyntheticSource`` as tests/test_data.py holds the reference's: a
   batch is a function of (seed, step, shard) — equal across instances,
   shards disjoint, targets the inputs shifted, MTP targets shifted
   further — and ``PrefetchIterator`` resumes at its ``state()``; the
   frame front end's embeddings; ``FileSource`` on a temporary token file
   against the reference's ``FileSource`` on the same file (equal
   tokens).  The stream's draws are numpy's, not JAX's (ROADMAP item 9).
2. Checkpoints as tests/test_checkpoint.py holds the reference's: round
   trip (fp32, bf16, int32, nested dicts and lists), uncommitted
   directories ignored, corruption and shape mismatches refused, async
   save; and a training run resumed from a checkpoint equals the run that
   went on, bit for bit (tests/test_train_integration.py).
3. ``fault_tolerance``: the reference test's host-only cases on the
   port's copy.
4. ``configs.shapes``: the cells, ``SUBQUADRATIC`` and
   ``cell_applicable`` over every arch equal the reference's, and
   ``input_specs`` gives the reference's shapes on the ``meta`` device.
5. ``launch/train.py``'s ``main`` at its default arch on ``--device cpu``
   (the reference's printed lines, a metrics dict, K1 never launched on
   the CPU), with checkpoints and ``--resume``, and its refusal of a
   malformed ``--mesh`` / unknown ``--rules``.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro.data import DataConfig as JaxDataConfig
from repro.data import FileSource as JaxFileSource
from repro_torch.configs import get_config, shapes
from repro_torch.data import (
    DataConfig, FileSource, PrefetchIterator, SyntheticSource,
)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (
    ElasticMeshManager, HeartbeatMonitor, RecoveryLog, retry_step,
)
from repro_torch.launch import train
from repro_torch.model.layers import Runtime
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.training import init_train_state, make_train_step

CFG = DataConfig(global_batch=8, seq_len=16, vocab=101, seed=3)


# ---------------------------------------------------------------------------
# 1. data
# ---------------------------------------------------------------------------

def test_synthetic_source_is_a_function_of_seed_step_shard():
    a, b = SyntheticSource(CFG).batch_at(7), SyntheticSource(CFG).batch_at(7)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["inputs"], SyntheticSource(CFG).batch_at(8)[
        "inputs"])
    assert torch.equal(a["inputs"][:, 1:], a["targets"][:, :-1])
    assert a["inputs"].dtype == torch.int64
    assert int(a["inputs"].max()) < CFG.vocab
    s0 = SyntheticSource(CFG, shard=0, n_shards=2).batch_at(5)
    s1 = SyntheticSource(CFG, shard=1, n_shards=2).batch_at(5)
    assert s0["inputs"].shape[0] == CFG.global_batch // 2
    assert not torch.equal(s0["inputs"], s1["inputs"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticSource(CFG, n_shards=3)


def test_mtp_targets_and_frames():
    b = SyntheticSource(DataConfig(global_batch=2, seq_len=8, vocab=50,
                                   n_mtp=1)).batch_at(0)
    assert b["mtp_targets"].shape == (2, 8, 1)
    assert torch.equal(b["mtp_targets"][:, :-1, 0], b["targets"][:, 1:])
    f = SyntheticSource(DataConfig(global_batch=2, seq_len=8, vocab=50,
                                   frontend="frames", d_model=12)).batch_at(1)
    assert f["inputs"].shape == (2, 8, 12)
    assert f["inputs"].dtype == torch.float32
    assert f["targets"].shape == (2, 8)


def test_prefetch_resume_matches_direct():
    src = SyntheticSource(CFG)
    it = PrefetchIterator(src, start_step=0, prefetch=2)
    seq1 = [next(it)["inputs"] for _ in range(4)]
    resume_at = it.state()
    it.close()
    it2 = PrefetchIterator(src, start_step=resume_at, prefetch=2)
    nxt = next(it2)["inputs"]
    it2.close()
    assert resume_at == 4
    assert torch.equal(nxt, src.batch_at(4)["inputs"])
    for i, b in enumerate(seq1):
        assert torch.equal(b, src.batch_at(i)["inputs"])


def test_file_source_matches_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(global_batch=4, seq_len=32, vocab=1000)
    for shard in (0, 1):
        port = FileSource(path, DataConfig(**kw), shard=shard, n_shards=2)
        ref = JaxFileSource(path, JaxDataConfig(**kw), shard=shard,
                            n_shards=2)
        for step in (0, 3, 40):
            a, b = port.batch_at(step), ref.batch_at(step)
            for key in ("inputs", "targets", "loss_mask"):
                assert np.array_equal(a[key].numpy(), np.asarray(b[key]))


# ---------------------------------------------------------------------------
# 2. checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "h": torch.linspace(-2, 2, 7).to(torch.bfloat16)},
            "l": [torch.zeros(2), torch.full((1,), 3.5)],
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b) -> bool:
    la, lb = ckpt._flatten(a), ckpt._flatten(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree)
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert _equal(ckpt.restore(str(tmp_path), 7, _tree()), tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == 6
    assert {m["dtype"] for m in manifest["leaves"]} >= {"bfloat16", "int32"}


def test_checkpoint_refusals(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_000000005.tmp"))
    os.makedirs(os.path.join(d, "step_000000009"))          # no COMMITTED
    assert ckpt.latest_step(d) == 1
    assert ckpt.latest_step(os.path.join(d, "missing")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 9, _tree())
    bad = _tree()
    bad["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, bad)
    with open(os.path.join(d, "step_000000001", "arrays", "0.bin"),
              "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore(d, 1, _tree())


def test_async_checkpoint_snapshots_before_return(tmp_path):
    tree = _tree()
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save_async(3, tree)
    tree["a"].add_(100.0)                  # training goes on meanwhile
    saver.wait()
    assert _equal(ckpt.restore(str(tmp_path), 3, _tree()), _tree())


def test_resume_is_bitwise(tmp_path):
    cfg = dataclasses.replace(get_config("stablelm-1.6b-smoke"), n_layers=2)
    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    opt = make_optimizer("adamw")
    step = make_train_step(cfg, opt, warmup_cosine(2e-3, 2, 40), rt)
    src = SyntheticSource(DataConfig(global_batch=4, seq_len=32,
                                     vocab=cfg.vocab, seed=1))
    state = init_train_state(cfg, 0, opt, rt, device="cpu")
    for i in range(3):
        state, _ = step(state, src.batch_at(i))
    ckpt.save(str(tmp_path), 3, state.as_tree())
    direct = state
    for i in range(3, 6):
        direct, md = step(direct, src.batch_at(i))
    restored = init_train_state(cfg, 1, opt, rt, device="cpu")   # other seed
    restored.load_tree(ckpt.restore(str(tmp_path), 3, restored.as_tree()))
    assert int(restored.step) == 3
    for i in range(3, 6):
        restored, mr = step(restored, src.batch_at(i))
    assert float(md["loss"]) == float(mr["loss"])
    assert _equal(direct.as_tree(), restored.as_tree())


# ---------------------------------------------------------------------------
# 3. fault tolerance (tests/test_fault_tolerance.py's cases)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeats_and_stragglers():
    clock = FakeClock()
    mon = HeartbeatMonitor(4, deadline_s=30, clock=clock)
    clock.t = 10
    for w in (0, 1, 2):
        mon.heartbeat(w, 1.0)
    clock.t = 35
    assert mon.check()["dead"] == [3]
    assert mon.alive_workers() == [0, 1, 2]

    clock = FakeClock()
    mon = HeartbeatMonitor(8, deadline_s=1000, straggler_sigma=3,
                           strike_limit=3, clock=clock)
    for rnd in range(2):
        clock.t += 1
        for w in range(8):
            mon.heartbeat(w, 10.0 if w == 5 and rnd == 0 else 1.0)
        mon.check()
    assert 5 in mon.alive_workers()
    for _ in range(3):
        clock.t += 1
        for w in range(8):
            mon.heartbeat(w, 25.0 if w == 5 else 1.0 + 0.01 * w)
        mon.check()
    assert 5 not in mon.alive_workers()


def test_elastic_plan_retry_and_log():
    mgr = ElasticMeshManager(model_parallel=16, devices_per_pod=256)
    assert mgr.plan(512, n_pods=2).shape == (2, 16, 16)
    plan = mgr.plan(512 - 16, n_pods=2)
    assert plan.shape[-1] == 16 and plan.n_devices % 16 == 0
    assert mgr.plan(7) is None
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    seen = []
    assert retry_step(flaky, retries=2,
                      on_retry=lambda a, e: seen.append(a)) == "ok"
    assert seen == [0, 1]
    log = RecoveryLog()
    log.record("resume", step=3)
    assert log.events == [{"kind": "resume", "step": 3}]


# ---------------------------------------------------------------------------
# 4. shape cells
# ---------------------------------------------------------------------------

def test_shape_cells_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    got = {(a, s) for a in JAX_ARCHS for s in shapes.SHAPES
           if shapes.cell_applicable(get_config(a), s)}
    want = {(a, s) for a in JAX_ARCHS for s in jshapes.SHAPES
            if jshapes.cell_applicable(jax_get_config(a), s)}
    assert got == want
    for arch in ("deepseek-v3-671b", "musicgen-large", "xlstm-125m"):
        for s in shapes.SHAPES:
            port = shapes.input_specs(get_config(arch), s)
            ref = jshapes.input_specs(jax_get_config(arch), s,
                                      act_dtype=jnp.bfloat16)
            assert set(port) == set(ref)
            for k, t in port.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref[k].shape), (arch, s, k)


# ---------------------------------------------------------------------------
# 5. the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
            "--warmup", "1", "--fp32", "--lr", "2e-3", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    m = train.main(argv)
    out = capsys.readouterr().out
    assert "step      4 loss" in out and out.rstrip().endswith("done")
    assert m["arch"] == "stablelm-1.6b-smoke"
    assert len(m["losses"]) == 4 and all(np.isfinite(m["losses"]))
    assert m["fusemax_prefill_launches"] == 0
    assert m["device"]["platform"] == "cpu"
    assert ckpt.latest_step(str(tmp_path)) == 4
    # resume from step 4 and go on to 6
    m2 = train.main(argv[:2] + ["--steps", "6"] + argv[4:] + ["--resume"])
    assert m2["start_step"] == 4 and len(m2["losses"]) == 2
    assert "resumed from step 4" in capsys.readouterr().out
    # the launcher's default dtype is bf16
    m3 = train.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                     "--seq", "16"])
    assert np.isfinite(m3["losses"][0]) and not m3["fp32"]


@pytest.mark.parametrize("argv,match", [(["--mesh", "2x"], "expected DxM"),
                                        (["--rules", "dp"], "2")])
def test_launcher_refuses_sharded_training(argv, match):
    """Sharded training runs (tests/test_torch_distributed.py); what the
    launcher refuses is a mesh it cannot parse and rules it does not
    have."""
    with pytest.raises(SystemExit, match=match):
        train.main(["--device", "cpu"] + argv)
