"""Sharding of the serving tier's paged KV pool over a list of devices.

Port of the paged-pool part of ``repro.distributed.sharding``: the page
arrays of :mod:`repro_torch.serving.kv_cache` split along the *kv-head*
axis (GQA ``k_pages`` / ``v_pages`` and their ``k_scale`` / ``v_scale``)
or the *latent-rank* axis (MLA ``ckv_pages`` / ``krope_pages``), while
the page dimension stays whole on every shard.  Page ids are therefore
global: block tables, free lists and the prefix index stay on the host,
one copy, and admission, growth, preemption and COW are unchanged.  MLA
scale pools (one scalar per latent vector, no rank axis) and SSM slot
state are replicated.  :func:`validate_kv_shard` refuses head / rank
counts the shard count does not divide, with the reference's messages.

One controller drives every shard, as the reference's ``shard_map`` does
from one process: a sharded leaf of a layer's cache is a list of ``tp``
tensors, shard ``d`` on ``KVShard.devices[d]``, each with its own sink
page (``[P + 1, ...]``).  The attention paths
(:mod:`repro_torch.model.attention`) run each shard's kernel on that
shard's device and gather the results in shard order on the engine's
device — head outputs (GQA) or the page strips' partials (MLA) — which
stands in for the reference's ``all_gather``.  A device list may repeat
a device: on one card every shard sits on ``cuda:0``, as the reference's
tests put several host "devices" on one CPU.  Weights, activations and
the SSM state stay on the engine's device.

The reference's training and dry-run rules (``make_rules``,
``param_shardings``, ``act_sharder``, ``batch_shardings``,
``cache_shardings``) and ``shard_map_fn`` have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices`` (``torch.device``, repeats
    allowed) along ``axis_names[0]``.  ``shape`` maps the axis to its
    size, as a jax mesh's does."""
    devices: tuple
    axis_names: tuple = ("model",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh has one axis here, got "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


@dataclasses.dataclass(frozen=True)
class KVShard:
    """Device sharding of the paged KV pool: pages split along the kv-head
    (GQA) / latent-rank (MLA) axis over ``devices``, shard ``d`` on
    ``devices[d]``.  Threaded through ``Runtime.kv_shard`` into the paged
    attention paths, which keep greedy streams bit-identical to the
    unsharded pool's."""
    devices: tuple
    axis: str = "model"

    @property
    def size(self) -> int:
        return len(self.devices)


def validate_kv_shard(cfg, tp: int) -> None:
    """Reject configs whose paged-pool shard axes ``tp`` does not divide:
    GQA pages shard on ``n_kv_heads`` (query heads follow: Hq = Hkv x
    group), MLA latent pages on ``kv_lora_rank`` and ``rope_dim``."""
    if tp <= 1:
        return
    problems = []
    attns = {spec.attn for spec in cfg.layer_specs()}
    if "gqa" in attns and cfg.n_kv_heads % tp:
        problems.append(
            f"n_kv_heads={cfg.n_kv_heads} is not divisible by tp={tp}")
    if "mla" in attns:
        if cfg.mla.kv_lora_rank % tp:
            problems.append(
                f"mla.kv_lora_rank={cfg.mla.kv_lora_rank} is not "
                f"divisible by tp={tp}")
        if cfg.mla.rope_dim % tp:
            problems.append(
                f"mla.rope_dim={cfg.mla.rope_dim} is not divisible by "
                f"tp={tp}")
    if problems:
        raise ValueError(
            "cannot shard the paged KV pool over "
            f"{tp} devices: " + "; ".join(problems) +
            " — pick a tp that divides the kv-head/latent axes, or serve "
            "this config unsharded (mesh=None)")


#: paged-cache leaf name → the dimension (from the right) that shards:
#: GQA page arrays are [P + 1, page_size, Hkv, dh] (head axis at -2) and
#: their scale pools [P + 1, page_size, Hkv] (-1); MLA latent pages are
#: [P + 1, page_size, r] (rank axis at -1).  Every other leaf — the MLA
#: scale pools [P + 1, page_size], SSM state — is replicated.
_PAGED_SHARD_DIMS = {"k_pages": -2, "v_pages": -2,
                     "ckv_pages": -1, "krope_pages": -1,
                     "k_scale": -1, "v_scale": -1}


def leaf_parts(leaf) -> List[torch.Tensor]:
    """The tensors of a cache leaf: its shards, or the leaf itself."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def shard_slice(n: int, d: int, tp: int) -> slice:
    """Shard ``d``'s part of an axis of ``n`` (``tp`` divides ``n``)."""
    return slice(d * n // tp, (d + 1) * n // tp)


def shard_paged_caches(caches: list, shard: KVShard) -> list:
    """Split every sharded leaf of an ``init_paged_cache`` list into
    ``shard.size`` tensors per :data:`_PAGED_SHARD_DIMS`, shard ``d``
    moved to ``shard.devices[d]``, in place (a layer at a time, so the
    whole pool is never held twice).  Returns ``caches``."""
    for c in caches:
        attn = c.get("attn", {})
        for name, dim in _PAGED_SHARD_DIMS.items():
            if name in attn:
                attn[name] = [part.contiguous().to(dev) for part, dev in
                              zip(attn[name].chunk(shard.size, dim),
                                  shard.devices)]
    return caches


def visible_devices() -> List[torch.device]:
    """The CUDA devices this process sees, in order."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def replica_device_groups(dp: int, tp: int = 1,
                          devices: Optional[Sequence] = None) -> list:
    """Partition ``devices`` (default: :func:`visible_devices`) into ``dp``
    contiguous groups of ``tp`` for data-parallel serving replicas —
    replica i owns devices [i*tp, (i+1)*tp); replicas never communicate
    (routing is host-side).  With fewer than ``dp*tp`` devices and ``tp
    == 1`` the groups wrap round-robin (every replica may share one
    device); with ``tp > 1`` the device count must cover every group."""
    if dp < 1 or tp < 1:
        raise ValueError(f"need dp >= 1 and tp >= 1, got dp={dp} tp={tp}")
    devs = list(devices) if devices is not None else visible_devices()
    need = dp * tp
    if len(devs) < need:
        if tp > 1 or not devs:
            raise ValueError(
                f"dp={dp} tp={tp} needs {need} devices, have {len(devs)}")
        return [[devs[i % len(devs)]] for i in range(dp)]
    return [devs[i * tp:(i + 1) * tp] for i in range(dp)]
