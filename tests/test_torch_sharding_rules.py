"""The port's logical axes and sharding rules against the reference's.

For every parameter leaf of the smoke configs of granite, stablelm,
gemma2 and DeepSeek-V3 (its MTP head included), under the three modes
(``tp``, ``fsdp_tp``, ``serve``) and on meshes 1 x 1, 4 x 2, 2 x 2, 2 x 4,
16 x 16 and 2 x 16 x 16:

* :func:`repro_torch.distributed.sharding.param_axes` on the port model
  equals the reference's ``init`` axes of the leaf (a stacked run's
  leading ``"layers"`` dropped: the port keeps one leaf per layer);
* the port's spec (:func:`~repro_torch.distributed.sharding.
  param_shardings`) equals the reference's ``_divisible(_spec_for(...))``
  on the reference's leaf shape, called on a stand-in mesh that has the
  ``axis_names`` and ``shape`` it reads (a stacked leaf's spec without its
  leading ``None``).

Then, in a subprocess with 8 host devices (as tests/test_distributed.py
runs the reference), the reference's ``param_shardings``,
``cache_shardings`` (the sequence-shard fallback, and without it) and
``batch_shardings`` on 4 x 2 and 2 x 4 meshes against the port's.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro_torch.bridge import _layer_slices
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.model import transformer as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["granite-3-8b-smoke", "stablelm-1.6b-smoke", "gemma2-9b-smoke",
         "deepseek-v3-671b-smoke"]
MODES = ["tp", "fsdp_tp", "serve"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What the reference's rule functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _flat(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _flat(key, v, out)
        else:
            out[key] = v


def _reference_leaves(cfg, jcfg) -> dict:
    """{port name: (reference axes, reference shape, stacked)} from the
    reference's ``init`` (traced abstractly)."""
    box = {}

    def build(key):
        p, a = jtf.init(jcfg, key, JaxRuntime(param_dtype=jnp.float32))
        box["axes"] = a
        return p

    params = jax.eval_shape(build, jax.random.PRNGKey(0))
    axes = box["axes"]
    out: dict = {}

    def top(name, p, a):
        fp, fa = {}, {}
        _flat(name, p, fp)
        _flat(name, a, fa)
        for k in fp:
            out[k] = (fa[k], tuple(fp[k].shape), False)

    for name in ("embed", "unembed", "frontend_proj", "final_norm"):
        if name in params:
            top(name, params[name], axes[name])
    for j, (p, a) in enumerate(zip(params.get("mtp", []),
                                   axes.get("mtp", []))):
        top(f"mtp.{j}", p, a)
    for layer, i, j, r, reps in _layer_slices(cfg):
        fp, fa = {}, {}
        _flat("", params["runs"][i][j], fp)
        _flat("", axes["runs"][i][j], fa)
        for k in fp:
            out[f"layers.{layer}.{k}"] = (fa[k], tuple(fp[k].shape), reps > 1)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def leaves(request):
    arch = request.param
    cfg = get_config(arch)
    model = tf.Model(cfg, dtype=torch.float32, device="meta", with_mtp=True)
    return dict(cfg=cfg, model=model,
                ref=_reference_leaves(cfg, jax_get_config(arch)),
                axes=shd.param_axes(cfg, model))


def test_param_axes_equal_the_reference(leaves):
    ref, axes = leaves["ref"], leaves["axes"]
    assert set(axes) == set(ref)
    for name, (ax, _, stacked) in ref.items():
        want = tuple(ax[1:]) if stacked else tuple(ax)
        if stacked:
            assert ax[0] == "layers", name
        assert axes[name] == want, name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_param_specs_equal_the_reference(leaves, mode, mesh_name):
    shape, names = MESHES[mesh_name]
    stand_in = StandIn(shape, names)
    mesh = make_mesh(shape, names, ["meta"] * int(torch.tensor(shape)
                                                  .prod()))
    rules = shd.make_rules(mesh, mode)
    jrules = jshd.make_rules(stand_in, mode)
    named = dict(leaves["model"].named_parameters())
    got = shd.param_shardings(leaves["axes"], named, mesh, rules)
    for name, (ax, jshape, stacked) in leaves["ref"].items():
        spec = tuple(jshd._divisible(
            jshape, jshd._spec_for(ax, jrules["param"]), stand_in))
        want = spec[1:] if stacked else spec
        assert got[name].spec == want, (name, got[name].spec, want)
        assert tuple(named[name].shape) == (jshape[1:] if stacked
                                            else jshape), name


SUB = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh
from repro.model import transformer as tf
from repro.model.layers import Runtime

out = {}
for arch in ("gemma2-9b-smoke", "granite-3-8b-smoke"):
    cfg = get_config(arch)
    rt = Runtime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
    params, axes = tf.init(cfg, jax.random.PRNGKey(0), rt)
    caches = tf.init_cache(cfg, 4, 64, jnp.float32)
    for shape in ((4, 2), (2, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        key = f"{arch} {shape[0]}x{shape[1]}"
        for mode in ("tp", "fsdp_tp", "serve"):
            rules = shd.make_rules(mesh, mode)
            ps = shd.param_shardings(axes, params, mesh, rules)
            out[f"{key} {mode} embed"] = list(ps["embed"]["table"].spec)
            out[f"{key} {mode} wq"] = list(
                ps["runs"][0][0]["attn"]["wq"].spec)
            out[f"{key} {mode} mlp.wo"] = list(
                ps["runs"][0][0]["mlp"]["wo"].spec)
        for fb in (True, False):
            cs = shd.cache_shardings(tf.cache_axes(cfg), caches, mesh,
                                     seq_shard_fallback=fb)
            out[f"{key} cache {fb}"] = [
                list(cs[i][j]["attn"]["k"].spec)
                for i in range(len(cs)) for j in range(len(cs[i]))]
        bs = shd.batch_shardings(
            {"inputs": jax.ShapeDtypeStruct((8, 32), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 32), jnp.int32)}, mesh)
        out[f"{key} batch"] = {k: list(v.spec) for k, v in bs.items()}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shardings():
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.path.join(REPO, "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB)],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [x for x in run.stdout.splitlines() if x.startswith("JSON")][0]
    return json.loads(line[4:])


def _j(spec) -> list:
    """A spec as the subprocess's JSON writes it."""
    return [list(p) if isinstance(p, tuple) else p for p in spec]


@pytest.mark.parametrize("arch", ["gemma2-9b-smoke", "granite-3-8b-smoke"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_shardings_equal_the_reference_on_8_devices(reference_shardings,
                                                    arch, shape):
    ref = reference_shardings
    cfg = get_config(arch)
    key = f"{arch} {shape[0]}x{shape[1]}"
    mesh = make_mesh(shape, ("data", "model"), ["meta"] * 8)
    model = tf.Model(cfg, dtype=torch.float32, device="meta")
    named = dict(model.named_parameters())
    axes = shd.param_axes(cfg, model)
    for mode in MODES:
        ps = shd.param_shardings(axes, named, mesh, shd.make_rules(mesh,
                                                                   mode))
        assert _j(ps["embed.table"].spec) == ref[f"{key} {mode} embed"]
        # layer 0 is rep 0 of run 0, a stacked run here: its spec is the
        # stacked leaf's less the leading "layers" entry
        assert cfg.runs()[0][1] > 1
        for leaf, short in (("attn.wq", "wq"), ("mlp.wo", "mlp.wo")):
            want = ref[f"{key} {mode} {short}"]
            got = _j(ps[f"layers.0.{leaf}"].spec)
            assert want[0] is None and got == want[1:], (mode, leaf, got,
                                                         want)
    caches = tf.init_cache(cfg, 4, 64, torch.float32, "meta")
    flat = {f"{i}.attn.{k}": t for i, c in enumerate(caches)
            for k, t in c["attn"].items()}
    cax = {f"{i}.attn.{k}": a for i, c in enumerate(shd.cache_axes(cfg))
           for k, a in c["attn"].items()}
    for fb in (True, False):
        cs = shd.cache_shardings(cax, flat, mesh, seq_shard_fallback=fb)
        want = ref[f"{key} cache {fb}"]
        got = [_j(cs[f"{i}.attn.k"].spec) for i in range(len(caches))]
        # the reference stacks runs: compare each distinct spec, less the
        # stacked leaf's leading entry
        assert sorted({json.dumps(g) for g in got}) == sorted(
            {json.dumps(w[1:] if len(w) == 5 else w) for w in want})
    bs = shd.batch_shardings({"inputs": torch.empty(8, 32),
                              "odd": torch.empty(3, 32)}, mesh)
    assert {k: _j(v.spec) for k, v in bs.items()} == ref[f"{key} batch"]
