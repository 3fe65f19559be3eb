"""A leaf held as the shards of its spec over a device list.

One controller drives every mesh position (ROADMAP "Design choices",
item 8): the shard at position ``i`` of a :class:`~repro_torch.
distributed.sharding.Mesh` lives on ``mesh.devices[i]``.  Positions that
hold the same region of a leaf on the same device share one tensor, so a
leaf replicated over positions of one card is held once (``--rules tp``
on one card keeps one copy of the parameters, not one per data shard).

:class:`ShardedTensor` is the container; :func:`place` splits a whole
tensor into it, :meth:`ShardedTensor.gather` assembles the whole leaf on
a device (differentiably: grads flow back to the shards), and
:meth:`ShardedTensor.scatter_` writes a whole leaf back onto its shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.distributed.sharding import Sharding


@dataclasses.dataclass
class ShardedTensor:
    """A ``shape`` / ``dtype`` leaf placed by ``sharding``: ``blocks``
    (the distinct shards, each a tensor on its device), ``regions`` (the
    slices of the whole leaf each block holds) and ``block_of`` (mesh
    position → block index)."""
    shape: tuple
    dtype: torch.dtype
    sharding: Sharding
    blocks: List[torch.Tensor]
    regions: List[tuple]
    block_of: List[int]

    def at(self, pos: int) -> torch.Tensor:
        """The shard mesh position ``pos`` holds."""
        return self.blocks[self.block_of[pos]]

    def _picks(self, prefer: Optional[List[int]]) -> Dict[tuple, int]:
        """For each distinct region, the block to read it from: the first
        of ``prefer``'s positions that holds it, else its first block."""
        picks: Dict[tuple, int] = {}
        for pos in prefer or ():
            b = self.block_of[pos]
            picks.setdefault(_key(self.regions[b]), b)
        for b, reg in enumerate(self.regions):
            picks.setdefault(_key(reg), b)
        return picks

    def gather(self, device, prefer: Optional[List[int]] = None
               ) -> torch.Tensor:
        """The whole leaf on ``device``, assembled from one copy of each
        region (preferring the blocks of positions ``prefer``); autograd
        routes its grad back to those blocks."""
        picks = self._picks(prefer)
        if len(picks) == 1:
            return self.blocks[next(iter(picks.values()))].to(device)
        whole = torch.empty(self.shape, dtype=self.dtype, device=device)
        for b in picks.values():
            whole[self.regions[b]] = self.blocks[b].to(device)
        return whole

    @torch.no_grad()
    def scatter_(self, whole: torch.Tensor) -> "ShardedTensor":
        """Write a whole leaf onto every block (in place)."""
        for blk, reg in zip(self.blocks, self.regions):
            blk.copy_(whole[reg].to(blk.device, blk.dtype))
        return self


def _key(region: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in region)


def place(whole: torch.Tensor, sharding: Sharding,
          dtype: Optional[torch.dtype] = None) -> ShardedTensor:
    """``whole`` split into the shards of ``sharding``: position ``i``'s
    region on ``mesh.devices[i]``, one tensor per distinct (region,
    device)."""
    mesh = sharding.mesh
    shape = tuple(whole.shape)
    dtype = dtype or whole.dtype
    blocks, regions, block_of, seen = [], [], [], {}
    for pos, dev in enumerate(mesh.devices):
        reg = sharding.region(shape, pos)
        key = (_key(reg), str(dev))
        if key not in seen:
            seen[key] = len(blocks)
            with torch.no_grad():
                blocks.append(whole[reg].to(device=dev, dtype=dtype,
                                            copy=True).contiguous())
            regions.append(reg)
        block_of.append(seen[key])
    return ShardedTensor(shape, dtype, sharding, blocks, regions, block_of)


def bind_param(model, name: str, t: torch.Tensor) -> None:
    """Make ``t`` the tensor ``model`` reads as its parameter ``name`` (a
    gathered leaf for a step, or a ``meta`` placeholder between steps)."""
    mod_name, _, attr = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    mod._parameters.pop(attr, None)
    setattr(mod, attr, t)


def unbind_params(model, params: Dict[str, "ShardedTensor"]) -> None:
    """Bind ``meta`` placeholders for ``params`` (the gathered leaves are
    freed)."""
    for name, st in params.items():
        bind_param(model, name, torch.empty(st.shape, dtype=st.dtype,
                                            device="meta"))
