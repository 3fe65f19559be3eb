"""The port's dry run, roofline, collectives and hill climb (ROADMAP item
10c) on the CPU, against the reference where it has a counterpart.

1. ``active_param_count`` / ``model_flops`` equal the reference's on all
   ten archs; the peaks are the H100 SXM's and an unknown card is refused.
2. Per-card parameter bytes of a dry-run cell equal those the
   reference's specs imply (its ``_spec_for`` / ``_divisible`` on a
   stand-in of the production mesh, on its ``init``'s shapes).
3. The meta FLOP count of smoke train cells lies within 5 % under 8·N·D
   for the layer stack (forward, remat and backward) plus 6·V·d·D for the
   unembedding plus the attention formula (the remat recompute stops
   early); decode and prefill count their attention by formula too.
4. The roofline pass: on a uniform stack the depth-extrapolated
   quantities equal the full-depth count.
5. Each hill-climb lever moves its term the stated way (on the smoke
   configs over the production mesh).
6. ``--list`` lists the reference's 32 cells, and a production cell runs
   with every tensor it makes on ``meta``.
"""
import contextlib
import io
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.analysis import roofline as jroof
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro_torch.analysis import roofline as roof
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import hillclimb as hc
from repro_torch.launch import roofline_pass as rp


@pytest.fixture(autouse=True)
def _out(tmp_path, monkeypatch):
    monkeypatch.setenv(roof.OUT_ENV, str(tmp_path))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roof.active_param_count(cfg) == jroof.active_param_count(jcfg)
    for train in (False, True):
        assert roof.model_flops(cfg, tokens=4096, train=train) == \
            jroof.model_flops(jcfg, tokens=4096, train=train)


def test_peaks_are_the_h100s():
    p = roof.card_peaks("NVIDIA H100 80GB HBM3")
    assert p.flops["bfloat16"] == 989e12 and p.flops["float32"] == 67e12
    assert p.hbm_bytes_per_s == 3.35e12 and p.nvlink_bytes_per_s == 450e9
    assert roof.card_peaks() is roof.H100_SXM     # no card: the target's
    with pytest.raises(KeyError, match="no published peaks"):
        roof.card_peaks("NVIDIA A100-SXM4-40GB")


class _StandIn:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _reference_param_bytes(arch, mode, shape, axes):
    jcfg = jax_get_config(arch)
    box = {}

    def build(key):
        p, a = jtf.init(jcfg, key, JaxRuntime(param_dtype=jnp.bfloat16))
        box["axes"] = a
        return p

    params = jax.eval_shape(build, jax.random.PRNGKey(0))
    mesh = _StandIn(shape, axes)
    rules = jshd.make_rules(mesh, mode)
    leaves = jax.tree_util.tree_leaves(params)
    specs = jax.tree_util.tree_leaves(
        box["axes"], is_leaf=lambda t: isinstance(t, tuple))
    total = 0
    for leaf, ax in zip(leaves, specs):
        spec = jshd._divisible(leaf.shape, jshd._spec_for(ax, rules["param"]),
                               mesh)
        n = leaf.size
        for part in tuple(spec):
            if part is not None:
                for a in ((part,) if isinstance(part, str) else part):
                    n //= mesh.shape[a]
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("granite-3-8b-smoke", "train_4k"),
                                        ("deepseek-v3-671b-smoke",
                                         "decode_32k"),
                                        ("gemma2-9b", "decode_32k")])
def test_per_card_param_bytes_equal_the_reference_specs(arch, shape):
    rec = dr.lower_cell(arch, shape)
    mode = "fsdp_tp" if shape.startswith("train") else "serve"
    want = _reference_param_bytes(arch, mode, (16, 16), ("data", "model"))
    assert rec["memory"]["param_bytes"] == want


@pytest.mark.parametrize("arch", ["stablelm-1.6b-smoke",
                                  "granite-3-8b-smoke", "gemma2-9b-smoke"])
def test_train_count_is_8nd_plus_attention(arch):
    """Layers: forward, remat recompute, backward = 8·N·D; the
    unembedding (outside the remat units) 6·V·d·D; attention by formula.
    The rest (norms, rope) is elementwise, which the counter skips.  The
    recompute stops once it has rebuilt what the backward reads (torch's
    non-reentrant checkpoint), so a unit's last product is not redone: the
    count lies under that sum, within 5 % of it, and above 6·N·D for the
    layers."""
    cfg = get_config(arch)
    b, s = 4, 256
    mesh = dr.make_production_mesh()
    rec = dr.lower_cell(arch, "train_4k", batch=b, seq=s,
                        dtype=torch.float32, mesh=dr.shd.Mesh(
                            ("meta",), ("data", "model"), (1, 1)))
    assert mesh.size == 256
    tokens = b * s
    n_head = cfg.vocab * cfg.d_model
    n_layers = cfg.param_count() - n_head * (1 if cfg.tie_embeddings else 2)
    attn = dr.attention_flops(cfg, "train", b, s)
    want = 8 * n_layers * tokens + 6 * n_head * tokens + attn
    got = rec["cost"]["flops"]
    assert rec["cost"]["attention_flops"] == attn
    floor = 6 * n_layers * tokens + 6 * n_head * tokens + attn
    assert floor < got <= want and want - got <= 0.05 * want, (got, want)


def test_inference_cells_count_their_attention():
    cfg = get_config("gemma2-9b-smoke")
    dec = dr.lower_cell("gemma2-9b-smoke", "decode_32k")
    pre = dr.lower_cell("gemma2-9b-smoke", "prefill_32k")
    assert dec["cost"]["attention_flops"] * 256 == dr.attention_flops(
        cfg, "decode", 128, 32768)
    assert pre["cost"]["attention_flops"] * 256 == dr.attention_flops(
        cfg, "prefill", 32, 32768)
    # the window: a local layer's pairs are the band's, not the triangle's
    assert dr._pairs(32768, 64) == 64 * 65 // 2 + (32768 - 64) * 64


def test_roofline_pass_extrapolates_to_the_full_depth():
    rec = rp.run_cell("granite-3-8b", "train_4k", force=True)
    assert rec["ok"], rec.get("error")
    for k in ("flops", "bytes", "coll"):
        assert math.isclose(rec["quantities"][k], rec["full_depth"][k],
                            rel_tol=1e-9), k


def test_hillclimb_levers_move_their_terms():
    b, a = hc.lever1_window_aware_prefill("gemma2-9b-smoke")
    assert a["roofline"]["compute_s"] < b["roofline"]["compute_s"]
    b, a = hc.lever2_grad_sharding("deepseek-v3-671b-smoke")
    assert a["collectives"]["total_bytes"] < b["collectives"]["total_bytes"]
    assert "grad_reduce_scatter" in a["collectives"]["bytes_by_kind"]
    assert a["memory"]["grad_bytes"] < b["memory"]["grad_bytes"]
    b, a = hc.lever2b_bf16_grad_accum("deepseek-v3-671b-smoke")
    assert a["memory"]["grad_bytes"] * 2 == b["memory"]["grad_bytes"]
    assert a["roofline"]["collective_s"] < b["roofline"]["collective_s"]
    b, a = hc.lever3_seq_sharded_cache("gemma2-9b-smoke")
    assert a["memory"]["cache_bytes"] * 16 == b["memory"]["cache_bytes"]
    assert a["roofline"]["memory_s"] < b["roofline"]["memory_s"]
    assert "strip_partial_gather" in a["collectives"]["bytes_by_kind"]


class _Devices(TorchDispatchMode):
    """The devices of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.numel() > 1:
                self.seen.add(t.device.type)
        return out


def test_list_and_a_production_cell_allocate_nothing():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dr.main(["--list"]) == 0
    lines = out.getvalue().strip().splitlines()
    assert lines[-1] == "32 applicable cells" and len(lines) == 33
    mode = _Devices()
    with mode:
        rec = dr.run_cell("deepseek-v3-671b", "decode_32k", "multi",
                          force=True)
    assert rec["ok"], rec.get("error")
    assert mode.seen == {"meta"}, mode.seen
    assert rec["chips"] == 512 and rec["model_axis_spans_hosts"]
