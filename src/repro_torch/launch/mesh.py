"""Device meshes: the serving tier's sharded pools, sharded training, and
the dry run's production meshes.

Port of ``repro.launch.mesh``.  Functions, never module-level constants,
so importing this module touches no device.  By default a mesh takes the
visible CUDA devices and too few of them raise, as ``jax.make_mesh``
does; an explicit ``devices`` list may repeat a device, which is how one
card (or the CPU) holds several positions.  The production meshes (16 x
16 and 2 x 16 x 16 H100s) are built on ``meta`` devices: the dry run
places nothing.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.distributed.sharding import (
    Mesh, replica_device_groups, visible_devices,
)

#: H100s a host holds (an HGX board's NVLink domain); an axis whose
#: groups span more than one host runs its collectives over the network
GPUS_PER_HOST = 8


def make_mesh(shape, axes=None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` (a tuple of axis sizes) over ``axes`` (axis
    names): the first ``prod(shape)`` of ``devices`` (default: the visible
    CUDA devices) in row-major order.  An int ``shape`` is the serving
    tier's one-axis form, ``make_mesh(tp, devices=None)``: ``tp`` devices
    along ``"model"`` (or the axis name given as ``axes``)."""
    if isinstance(shape, int):
        if axes is not None and not isinstance(axes, str):
            devices, axes = axes, None
        shape, axes = (shape,), (axes or "model",)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if any(n < 1 for n in shape) or len(shape) != len(axes):
        raise ValueError(f"bad mesh shape {shape} over axes {axes}")
    need = math.prod(shape)
    devs = list(devices) if devices is not None else visible_devices()
    if len(devs) < need:
        if len(shape) == 1:
            raise ValueError(f"a mesh of {need} devices needs {need}, have "
                             f"{len(devs)}")
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} "
                         f"devices, have {len(devs)}")
    return Mesh(tuple(devs[:need]), axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes on ``meta`` devices: 16 x 16
    ("data", "model"; 256 cards) or 2 x 16 x 16 ("pod", "data", "model";
    512).  A 16-way model axis spans two hosts of :data:`GPUS_PER_HOST`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, ["meta"] * math.prod(shape))


def axis_spans_hosts(mesh: Mesh, axis: str) -> bool:
    """Whether the groups of ``axis`` (positions that differ only in it)
    span more than one host, positions filling hosts of
    :data:`GPUS_PER_HOST` in row-major order."""
    if axis not in mesh.axis_names:
        raise KeyError(axis)
    for pos in range(mesh.size):
        first = dict(mesh.coords(pos), **{axis: 0})
        if pos // GPUS_PER_HOST != mesh.position(first) // GPUS_PER_HOST:
            return True
    return False


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
