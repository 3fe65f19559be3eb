"""Serving meshes: the device lists a sharded page pool spans.

Port of ``make_mesh`` and ``make_replica_meshes`` of
``repro.launch.mesh`` for the one axis the serving tier shards over
("model").  Functions, never module-level constants, so importing this
module touches no device.  By default a mesh takes the visible CUDA
devices and too few of them raise, as ``jax.make_mesh`` does; an explicit
``devices`` list may repeat a device, which is how one card (or the CPU)
holds several shards.  The reference's ``make_production_mesh`` (a
256 / 512-chip training mesh) has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.distributed.sharding import (
    Mesh, replica_device_groups, visible_devices,
)


def make_mesh(tp: int, devices: Optional[Sequence] = None,
              axis: str = "model") -> Mesh:
    """A ``tp``-device mesh along ``axis``: the first ``tp`` of
    ``devices`` (default: the visible CUDA devices)."""
    if tp < 1:
        raise ValueError(f"need tp >= 1, got {tp}")
    devs = list(devices) if devices is not None else visible_devices()
    if len(devs) < tp:
        raise ValueError(f"a mesh of {tp} devices needs {tp}, have "
                         f"{len(devs)}")
    return Mesh(tuple(devs[:tp]), (axis,))


def make_replica_meshes(dp: int, tp: int = 1,
                        devices: Optional[Sequence] = None) -> list:
    """Per-replica meshes for data-parallel serving: ``dp`` engine
    replicas, each sharded over its own ``tp`` contiguous devices (see
    :func:`repro_torch.distributed.sharding.replica_device_groups`).
    Replicas never communicate; ``tp == 1`` returns ``[None] * dp``
    (unsharded engines)."""
    if tp <= 1:
        if dp < 1:
            raise ValueError(f"need dp >= 1, got {dp}")
        return [None] * dp
    return [Mesh(tuple(g), ("model",))
            for g in replica_device_groups(dp, tp, devices)]
