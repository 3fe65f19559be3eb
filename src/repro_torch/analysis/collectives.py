"""Per-card collective wire bytes of a step, reckoned from its sharding
plan.

The counterpart of ``repro.analysis.hlo_stats``: the reference parses the
partitioned HLO's collectives; the port has no HLO, so this module counts
what the plan and the step's structure imply, per card, for ring
collectives over a group of ``n`` cards moving a whole of ``W`` bytes:

  all-gather / reduce-scatter   (n - 1) / n · W
  all-reduce                    2 (n - 1) / n · W
  all-to-all                    (n - 1) / n · W

Kinds (``CollectiveStats.bytes_by_kind``):

  ``fsdp_all_gather``        a leaf sharded over the data axes, gathered
                             before use: forward and backward (remat), per
                             microbatch;
  ``grad_reduce_scatter``    grads of a data-sharded leaf onto its shards,
                             with ``shard_grads`` (per microbatch);
  ``grad_all_reduce``        every other grad over the data axes;
  ``tp_activation_all_reduce`` the partial sums of a tensor-parallel
                             block's output ([B, S, d] over "model"): the
                             attention's and the MLP's, forward, remat and
                             backward in a train step;
  ``moe_all_to_all``         tokens to experts sharded over "model" and
                             back;
  ``strip_partial_gather``   a sequence-sharded cache's strips' split-K
                             partials, gathered for the one combine.

A collective over an axis whose groups span hosts of 8
(:func:`repro_torch.launch.mesh.axis_spans_hosts`) counts in
``network_bytes`` as well, for the roofline's network rate.  The
cross-entropy's vocab-sharded max / sum (a few bytes a token) is left
out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import Mesh, Sharding, _data_axes
from repro_torch.launch.mesh import axis_spans_hosts


@dataclasses.dataclass
class CollectiveStats:
    #: per-kind summed wire bytes (per card)
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    #: the part of the wire bytes on axes that span hosts
    network_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, nbytes: float, events: int,
            network: bool) -> None:
        if nbytes <= 0 or events <= 0:
            return
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) \
            + nbytes * events
        self.counts[kind] = self.counts.get(kind, 0) + events
        if network:
            self.network_bytes += nbytes * events


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _split(mesh: Mesh, sh: Sharding, ndim: int, axes) -> int:
    """How many ways ``sh`` splits a leaf over ``axes``."""
    used = {a for part in sh.parts(ndim) for a in _axes_of(part)}
    return math.prod(mesh.shape[a] for a in used if a in axes)


def _spans(mesh: Mesh, axes) -> bool:
    return any(axis_spans_hosts(mesh, a) for a in axes)


def collective_stats(cfg: ModelConfig, *, kind: str, mesh: Mesh,
                     param_sh: Dict[str, Sharding], param_shapes: dict,
                     param_bytes: int, batch: int, seq: int,
                     act_bytes: int, microbatches: int = 1,
                     shard_grads: bool = False, grad_bytes: int = 4,
                     cache_sh: Optional[Dict[str, Sharding]] = None,
                     cache_shapes: Optional[dict] = None,
                     splits: Optional[int] = None) -> CollectiveStats:
    """The wire bytes per card of one step of ``kind`` ("train",
    "prefill", "decode") at global ``batch`` x ``seq`` tokens (decode: one
    token per sequence), the parameters placed by ``param_sh`` (shapes in
    ``param_shapes``, ``param_bytes`` per element) and, for decode, the
    caches by ``cache_sh``; ``splits`` is the decode's split count."""
    st = CollectiveStats()
    dp = _data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in dp)
    tp = mesh.shape.get("model", 1)
    train = kind == "train"
    mb = microbatches if train else 1
    b_dev = batch // n_data if batch % n_data == 0 else batch
    tokens = b_dev * (seq if kind != "decode" else 1) // mb
    ring = lambda n: (n - 1) / n if n > 1 else 0.0

    # parameters: FSDP gathers; grads over the data axes
    for name, sh in param_sh.items():
        shape = param_shapes[name]
        nd = _split(mesh, sh, len(shape), dp)
        nm = _split(mesh, sh, len(shape), ("model",))
        whole = math.prod(shape) / nm            # this model shard's leaf
        if nd > 1:
            st.add("fsdp_all_gather", ring(nd) * whole * param_bytes,
                   2 * mb if train else 1, _spans(mesh, dp))
        if train and n_data > 1:
            if shard_grads and nd > 1:
                st.add("grad_reduce_scatter",
                       ring(n_data) * whole * grad_bytes, mb,
                       _spans(mesh, dp))
            else:
                st.add("grad_all_reduce",
                       2 * ring(n_data) * whole * grad_bytes, mb,
                       _spans(mesh, dp))

    # tensor-parallel blocks: their output partial sums over "model"
    passes = 3 * mb if train else 1
    act = tokens * cfg.d_model * act_bytes
    net_m = "model" in mesh.shape and _spans(mesh, ("model",))
    for i, spec in enumerate(cfg.layer_specs()):
        blocks = []
        if spec.attn != "none":
            wo = f"layers.{i}.attn.wo"
            blocks.append(wo)
        if spec.mlp == "dense":
            blocks.append(f"layers.{i}.mlp.wo")
        for leaf in blocks:
            sh = param_sh.get(leaf)
            if sh is not None and _split(mesh, sh, len(param_shapes[leaf]),
                                         ("model",)) > 1:
                st.add("tp_activation_all_reduce", 2 * ring(tp) * act,
                       passes, net_m)
        if spec.mlp == "moe" and tp > 1:
            k = cfg.moe.top_k
            st.add("moe_all_to_all", 2 * ring(tp) * act * k, passes, net_m)

    # a sequence-sharded cache's partials: each strip's (m, l, acc)
    if kind == "decode" and cache_sh and tp > 1:
        g = cfg.n_heads // max(cfg.n_kv_heads, 1)
        for name, sh in cache_sh.items():
            if not name.endswith(".k"):
                continue
            shape = cache_shapes[name]
            slots_split = _axes_of(sh.parts(len(shape))[2])
            if "model" not in slots_split:
                continue
            bdev = shape[0] // _split(mesh, sh, len(shape), dp)
            partials = bdev * shape[1] * (splits or tp) * g \
                * (shape[3] + 2) * 4
            st.add("strip_partial_gather", ring(tp) * partials, 1, net_m)
    return st
