"""The decode step over a device mesh: parameters placed by the ``serve``
rules, dense caches by :func:`~repro_torch.distributed.sharding.
cache_shardings`.

The counterpart of the reference's jitted ``decode_step`` with
``param_shardings`` / ``cache_shardings`` in and out.  One controller
drives every position:

  * the batch splits over the data axes, as the caches' batch dimension
    does; each data shard gathers the parameters onto its lead device;
  * a cache leaf split over "model" is handed to the attention as
    :class:`~repro_torch.distributed.sharding.DenseCacheShards` — slot
    strips (the sequence-sharded fallback where the kv heads do not divide
    the axis: K2 runs on each strip, its partials gather in strip order
    and combine once) or kv-head shards — and is written in place;
  * a leaf the model axis does not split is read and written at the data
    shard's lead position, then copied to its other replicas.

Recurrent (SSM) state has no sharded decode here: a config with SSM
layers is refused.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.placement import (
    ShardedTensor, bind_param, place, unbind_params,
)
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime


def place_params(cfg, model: tf.Model, mesh: shd.Mesh,
                 rules: dict) -> Dict[str, ShardedTensor]:
    """``model``'s parameters placed on ``mesh`` by ``rules``
    (:func:`~repro_torch.distributed.sharding.param_axes`); each whole leaf
    is freed once placed (the model keeps ``meta`` placeholders)."""
    axes = shd.param_axes(cfg, model)
    named = dict(model.named_parameters())
    sh = shd.param_shardings(axes, named, mesh, rules)
    out = {}
    for name, p in named.items():
        out[name] = place(p.detach(), sh[name])
        bind_param(model, name, torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"))
    return out


def _flat(caches: list) -> dict:
    return {f"{i}.{grp}.{k}": t for i, c in enumerate(caches)
            for grp, leaves in c.items() for k, t in leaves.items()}


def shard_caches(cfg, caches: list, mesh: shd.Mesh,
                 seq_shard_fallback: bool = True) -> list:
    """:func:`~repro_torch.model.transformer.init_cache`'s list with every
    leaf placed by :func:`~repro_torch.distributed.sharding.
    cache_shardings` (in place of the whole leaves)."""
    if any(spec.ssm is not None for spec in cfg.layer_specs()):
        raise NotImplementedError(
            f"{cfg.name}: the sharded decode step has no SSM state path")
    axes = _flat(shd.cache_axes(cfg))
    sh = shd.cache_shardings(axes, _flat(caches), mesh,
                             seq_shard_fallback=seq_shard_fallback)
    for i, c in enumerate(caches):
        for grp, leaves in c.items():
            for k in list(leaves):
                leaves[k] = place(leaves[k], sh[f"{i}.{grp}.{k}"])
    return caches


def _view(st: ShardedTensor, pos: list):
    """Data shard ``pos``'s view of a cache leaf: the parts along the
    model axis, or its lead position's block."""
    dims = [i for i, part in enumerate(st.sharding.parts(len(st.shape)))
            if part is not None and "model" in
            ((part,) if isinstance(part, str) else part)]
    if dims and len(pos) > 1:
        return shd.DenseCacheShards([st.at(p) for p in pos], dims[0])
    return st.at(pos[0])


@torch.no_grad()
def _sync_replicas(st: ShardedTensor, pos: list) -> None:
    """Copy the blocks data shard ``pos`` wrote to the other blocks that
    hold the same regions (replicas on other devices)."""
    written = {st.block_of[p] for p in pos}
    for b in written:
        for other, reg in enumerate(st.regions):
            if other != b and reg == st.regions[b]:
                st.blocks[other].copy_(st.blocks[b].to(
                    st.blocks[other].device))


@torch.no_grad()
def decode_step(cfg, model: tf.Model, params: Dict[str, ShardedTensor],
                tokens: torch.Tensor, caches: list, kv_len: torch.Tensor,
                rt: Runtime, mesh: shd.Mesh):
    """:func:`~repro_torch.model.transformer.decode_step` over ``mesh``:
    ``params`` from :func:`place_params`, ``caches`` from
    :func:`shard_caches` (updated in place).  Returns (logits [B, vocab]
    on the first device, caches)."""
    shards = shd.data_shards(mesh)
    b = tokens.shape[0]
    n = len(shards) if b % len(shards) == 0 else 1
    rows = b // n
    logits = []
    for d in range(n):
        pos = shards[d]
        lead = mesh.devices[pos[0]]
        for name, st in params.items():
            bind_param(model, name, st.gather(lead, prefer=pos))
        view = [{grp: {k: _view(st, pos) for k, st in leaves.items()}
                 for grp, leaves in c.items()} for c in caches]
        sl = slice(d * rows, (d + 1) * rows)
        out, _ = tf.decode_step(cfg, model, tokens[sl].to(lead), view,
                                kv_len[sl].to(lead), rt)
        logits.append(out.to(mesh.devices[0]))
        for c in caches:
            for leaves in c.values():
                for st in leaves.values():
                    _sync_replicas(st, pos)
    unbind_params(model, params)
    return torch.cat(logits), caches
