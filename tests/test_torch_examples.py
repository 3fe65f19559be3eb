"""The port's last two examples against the reference's, on the CPU.

``examples/torch_train_100m.py`` carries over ``config_100m()`` of
``examples/train_100m.py`` field for field (the reference's file is loaded
by path) and trains two small steps through the port's launcher;
``examples/torch_serve_batched.py`` serves the reference example's trace
on both cache layouts with equal greedy streams.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_example"), os.path.join(ROOT, "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, *args: str) -> subprocess.CompletedProcess:
    out = subprocess.run(
        [sys.executable, os.path.join("examples", name), *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out


def test_config_100m_equals_reference():
    ref = _load("train_100m.py").config_100m()
    port = _load("torch_train_100m.py").config_100m()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert (port.name, port.n_layers, port.d_model, port.n_heads,
            port.n_kv_heads, port.head_dim, port.d_ff, port.vocab) == (
        "granite-100m", 8, 640, 10, 2, 64, 1792, 32768)


def test_train_100m_runs_on_the_cpu():
    out = _run("torch_train_100m.py", "--device", "cpu", "--steps", "2",
               "--batch", "1", "--seq", "32")
    assert "step      2 loss" in out.stdout and "done" in out.stdout
    assert "trained 2 steps on cpu" in out.stdout


def test_serve_batched_runs_on_the_cpu():
    out = _run("torch_serve_batched.py", "--device", "cpu")
    assert "served 6 requests" in out.stdout
    assert "greedy outputs match across layouts: True" in out.stdout
