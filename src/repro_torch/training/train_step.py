"""Train-step factory: grads, clip, optional error feedback, optimizer,
microbatch accumulation — on one device or over a device mesh.

Port of ``repro.training.train_step``:

  * the loss is :func:`repro_torch.model.transformer.loss_fn`, whose
    attention runs K1 (or its plain version) forward and the recompute
    backward, each (pattern, repeat) of layers rematerialized;
  * microbatches are a loop that sums each one's grads in
    ``grad_accum_dtype`` (the reference's ``lax.scan``), then divides;
  * then, as the reference: clip by the global norm, optional error
    feedback (int8, the reference's, or top-k; the residual lives in the
    state), the learning rate of ``state.step``, the optimizer's update
    (in place);
  * the compressor's and the optimizer's per-tensor statistics span the
    layers of a (pattern, repeat) run, which the reference stacks in one
    leaf (:func:`repro_torch.bridge.leaf_groups`).

Over a mesh (``make_train_step(..., mesh=, rules=)``; the state from
:func:`shard_train_state`) only the placement changes, as under the
reference's ``jit`` with shardings:

  * every parameter, its optimizer state and its EF residual is held as
    the shards its spec gives (:func:`state_shardings`,
    :class:`~repro_torch.distributed.placement.ShardedTensor`), a region
    replicated over positions of one device once;
  * the batch splits over the data axes (:func:`~repro_torch.distributed.
    sharding.batch_shardings`); each data shard gathers every leaf it uses
    onto its lead device (the FSDP all-gather) and computes its loss and
    grads there, the model axis splitting the work
    (``Runtime.tp_devices``: K1 + LSE and its recompute backward per
    kv-head shard, the MLP by columns, the unembedding by vocab rows, the
    partial sums reduced in shard order);
  * losses weigh by their tokens, so the step's loss is the whole batch's
    mean; grads flow back onto the shards and sum over data shards in
    shard order (the all-reduce / reduce-scatter);
  * the clip, the compressor and the optimizer run on whole leaves, one
    leaf group at a time, gathered on the leaf's first device and written
    back to its shards — so the global norm, Adafactor's update RMS and
    factored moments and the compressors' scale, threshold and k span
    every shard of a leaf and every layer of its run, as unsharded;
  * a mesh of one position is the unsharded step, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.bridge import leaf_groups
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.placement import (
    ShardedTensor, bind_param, place, unbind_params,
)
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.optim import (
    Optimizer, clip_by_global_norm, ef_int8_compress, ef_topk_compress,
    init_error_feedback,
)
from repro_torch.optim.common import partition_leaves, tree_leaves

#: error-feedback compressors by name; ``compression=True`` is "int8", the
#: reference's only scheme inside its step
COMPRESSORS = {"int8": ef_int8_compress, "topk": ef_topk_compress}


@dataclasses.dataclass
class TrainState:
    """The model (its parameters require grad), the optimizer state keyed
    like ``model.named_parameters()``, the step (0-d int32) and the
    error-feedback residual (with compression)."""
    model: tf.Model
    opt_state: dict
    step: torch.Tensor
    ef_residual: Optional[dict] = None

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def as_tree(self) -> dict:
        """Every tensor of the state by name (the checkpoint's tree);
        parameters are the model's own storage."""
        tree = {"params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": self.opt_state, "step": self.step}
        if self.ef_residual is not None:
            tree["ef_residual"] = self.ef_residual
        return tree

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "TrainState":
        """Copy a tree of :meth:`as_tree`'s structure into this state."""
        def copy(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k])
            else:
                dst.copy_(src)

        copy(self.as_tree(), tree)
        return self


def init_train_state(cfg: ModelConfig, seed: int, optimizer: Optimizer,
                     rt: Runtime = Runtime(), compression: bool | str = False,
                     device="cuda") -> TrainState:
    """A model with seeded random weights (with its MTP head, if the config
    has one) whose parameters require grad, and a fresh optimizer state."""
    model = tf.init(cfg, seed, rt, device=device, with_mtp=True)
    for p in model.parameters():
        p.requires_grad_(True)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(
        model=model, opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        ef_residual=init_error_feedback(params) if compression else None)


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d params; a parameter the loss does not reach (the MTP
    head without ``mtp_targets``) gets zeros, as under ``jax.grad``."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    lr_schedule: Callable,
    rt: Runtime = Runtime(),
    *,
    grad_clip: float = 1.0,
    microbatches: int = 1,
    compression: bool | str = False,
    grad_accum_dtype: torch.dtype = torch.float32,
    mesh: Optional[shd.Mesh] = None,
    rules: Optional[dict] = None,
):
    """Returns step(state, batch) → (state, metrics).  With a ``mesh`` of
    more than one position the step takes and returns the
    :class:`ShardedTrainState` of :func:`shard_train_state` (the step
    reads the placement off the state; ``rules`` give the activation hook,
    :func:`~repro_torch.distributed.sharding.act_sharder`).  ``compression``:
    False, True (= ``"int8"``) or a name of :data:`COMPRESSORS`.  ``batch`` holds
    tensors on the model's device; metrics are 0-d tensors: the loss
    function's (``loss``, ``tokens``, [``mtp_loss``], ``total_loss``; with
    microbatches only ``loss``), ``grad_norm`` (before clipping) and
    ``lr``."""

    compress = None
    if compression:
        compress = COMPRESSORS["int8" if compression is True else compression]
    if mesh is not None and mesh.size > 1:
        if rules is not None:
            rt = dataclasses.replace(
                rt, shard_activation=shd.act_sharder(mesh, rules))
        return _sharded_step(cfg, optimizer, lr_schedule, rt, mesh,
                             grad_clip=grad_clip, microbatches=microbatches,
                             compress=compress,
                             grad_accum_dtype=grad_accum_dtype)

    def step(state: TrainState, batch: dict):
        params = state.params
        if microbatches == 1:
            loss, metrics = tf.loss_fn(cfg, state.model, batch, rt)
            grads = _grads(loss, params)
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
        else:
            grads = {k: torch.zeros(p.shape, dtype=grad_accum_dtype,
                                    device=p.device)
                     for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state.step.device)
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, _ = tf.loss_fn(cfg, state.model, mb, rt)
                for k, g in _grads(loss, params).items():
                    grads[k] += g.to(grad_accum_dtype)
                loss_sum = loss_sum + loss.detach()
            grads = {k: g / microbatches for k, g in grads.items()}
            metrics = {"loss": loss_sum / microbatches}

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        groups = leaf_groups(cfg, params)
        ef = state.ef_residual
        if compress is not None:
            grads, ef = compress(grads, ef, groups=groups)
        lr = lr_schedule(state.step)
        optimizer.update(grads, state.opt_state, params, lr, groups=groups)
        new_state = TrainState(model=state.model, opt_state=state.opt_state,
                               step=state.step + 1, ef_residual=ef)
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return new_state, metrics

    return step


# ---------------------------------------------------------------------------
# The step over a device mesh
# ---------------------------------------------------------------------------

def opt_state_axes(opt_state: dict, axes: Dict[str, tuple]) -> dict:
    """Logical axes of an optimizer state's leaves (the reference's
    ``opt_state_axes``): AdamW's moments mirror the parameters';
    Adafactor's factored ``vr`` / ``vc`` drop the last / second-to-last
    axis; the count is replicated (None)."""
    out: dict = {}
    if "m" in opt_state:
        out["m"] = dict(axes)
        out["v"] = dict(axes)
    if "stats" in opt_state:
        out["stats"] = {
            k: ({"vr": tuple(axes[k][:-1]),
                 "vc": tuple(axes[k][:-2]) + (axes[k][-1],)}
                if "vr" in st else {"v": tuple(axes[k])})
            for k, st in opt_state["stats"].items()}
    out["count"] = None
    return out


def _map2(fn, axes, leaves):
    """``fn(axes, leaf)`` over two trees of nested dicts (axes None at a
    replicated leaf)."""
    if isinstance(leaves, dict):
        return {k: _map2(fn, None if axes is None else axes[k], v)
                for k, v in leaves.items()}
    return fn(axes, leaves)


def state_shardings(state: TrainState, axes: Dict[str, tuple],
                    mesh: shd.Mesh, rules: dict) -> dict:
    """A :class:`~repro_torch.distributed.sharding.Sharding` for every leaf
    of ``state.as_tree()`` (the reference's ``state_shardings``): the
    parameters and EF residual by their axes, the optimizer state by
    :func:`opt_state_axes`, the step and counts replicated."""
    pr = rules["param"]

    def one(ax, leaf):
        spec = () if ax is None else shd._divisible(
            tuple(leaf.shape), shd._spec_for(ax, pr), mesh)
        return shd.Sharding(mesh, spec)

    tree = state.as_tree()
    out = {"params": _map2(one, axes, tree["params"]),
           "opt_state": _map2(one, opt_state_axes(state.opt_state, axes),
                              tree["opt_state"]),
           "step": shd.Sharding(mesh, ())}
    if "ef_residual" in tree:
        out["ef_residual"] = _map2(one, axes, tree["ef_residual"])
    return out


@dataclasses.dataclass
class ShardedTrainState:
    """A train state held over ``mesh``: ``params``, the optimizer
    state's tensors and ``ef_residual`` as
    :class:`~repro_torch.distributed.placement.ShardedTensor` leaves (the
    counts and ``step`` are 0-d tensors on the first device), and
    ``model``, the module tree the step binds each data shard's gathered
    parameters to (between steps it holds ``meta`` placeholders)."""
    model: tf.Model
    params: Dict[str, ShardedTensor]
    opt_state: dict
    step: torch.Tensor
    mesh: shd.Mesh
    ef_residual: Optional[Dict[str, ShardedTensor]] = None

    def as_tree(self) -> dict:
        """The checkpoint's tree (:meth:`TrainState.as_tree`'s structure,
        sharded leaves; :mod:`~repro_torch.distributed.checkpoint` writes
        them whole)."""
        tree = {"params": dict(self.params), "opt_state": self.opt_state,
                "step": self.step}
        if self.ef_residual is not None:
            tree["ef_residual"] = self.ef_residual
        return tree

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "ShardedTrainState":
        """Copy a tree of :meth:`as_tree`'s structure (sharded or whole
        leaves) into this state's shards."""
        def copy(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k])
            elif isinstance(dst, ShardedTensor):
                if isinstance(src, ShardedTensor) \
                        and src.sharding == dst.sharding:
                    for a, b in zip(dst.blocks, src.blocks):
                        a.copy_(b)
                else:
                    whole = src.gather(dst.blocks[0].device) \
                        if isinstance(src, ShardedTensor) else src
                    dst.scatter_(whole)
            else:
                dst.copy_(src)

        copy(self.as_tree(), tree)
        return self

    def position_bytes(self) -> dict:
        """Per mesh position, the bytes of parameters and of optimizer
        state (moments / statistics; the EF residual beside) that position
        holds, from the shard shapes."""
        def per_pos(leaves) -> list:
            out = [0] * self.mesh.size
            for st in leaves:
                for pos in range(self.mesh.size):
                    n = math.prod(s.stop - s.start for s in
                                  st.sharding.region(st.shape, pos))
                    out[pos] += n * st.blocks[0].element_size()
            return out

        opt = [x for x in tree_leaves(self.opt_state)
               if isinstance(x, ShardedTensor)]
        out = {"params": per_pos(self.params.values()),
               "opt_state": per_pos(opt)}
        if self.ef_residual is not None:
            out["ef_residual"] = per_pos(self.ef_residual.values())
        return out

    def held_position_bytes(self) -> list:
        """Per mesh position, the bytes of the shard tensors it reads
        (parameters and optimizer state): the check of
        :meth:`position_bytes` against what was placed."""
        leaves = list(self.params.values()) + [
            x for x in tree_leaves(self.opt_state)
            if isinstance(x, ShardedTensor)]
        return [sum(st.at(pos).numel() * st.at(pos).element_size()
                    for st in leaves) for pos in range(self.mesh.size)]


def shard_train_state(state: TrainState, cfg: ModelConfig, mesh: shd.Mesh,
                      rules: dict):
    """``state`` placed on ``mesh`` by ``rules``
    (:func:`state_shardings` of :func:`~repro_torch.distributed.sharding.
    param_axes`): a :class:`ShardedTrainState` whose model holds ``meta``
    placeholders, each whole leaf freed once placed.  A one-position mesh
    returns ``state`` as it is (the unsharded step's state)."""
    if mesh.size == 1:
        return state
    axes = shd.param_axes(cfg, state.model)
    sh = state_shardings(state, axes, mesh, rules)
    model = state.model
    params = {}
    for name, p in list(model.named_parameters()):
        st = place(p.detach(), sh["params"][name])
        for blk in st.blocks:
            blk.requires_grad_(True)
        params[name] = st
        bind_param(model, name, torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"))
        del p

    def place_tree(tree, shardings):
        if isinstance(tree, dict):
            return {k: place_tree(tree[k], shardings[k]) for k in tree}
        if tree.ndim == 0:
            return tree
        return place(tree, shardings)

    opt_state = place_tree(state.opt_state, sh["opt_state"])
    ef = None
    if state.ef_residual is not None:
        ef = place_tree(state.ef_residual, sh["ef_residual"])
    return ShardedTrainState(model=model, params=params, opt_state=opt_state,
                             step=state.step, mesh=mesh, ef_residual=ef)


def _sharded_step(cfg: ModelConfig, optimizer: Optimizer,
                  lr_schedule: Callable, rt: Runtime, mesh: shd.Mesh, *,
                  grad_clip: float, microbatches: int, compress,
                  grad_accum_dtype: torch.dtype):
    shards = shd.data_shards(mesh)
    n_data = len(shards)

    def split(v: torch.Tensor, d: int, n: int) -> torch.Tensor:
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[d]

    def step(state: ShardedTrainState, batch: dict):
        params = state.params
        names = list(params)
        blocks = [(k, b) for k in names
                  for b in range(len(params[k].blocks))]
        inputs = [params[k].blocks[b] for k, b in blocks]
        bgrads = [torch.zeros(t.shape, dtype=grad_accum_dtype,
                              device=t.device) for t in inputs]
        sums: dict = {}
        for i in range(microbatches):
            mb = {k: split(v, i, microbatches) for k, v in batch.items()} \
                if microbatches > 1 else batch
            n = n_data if all(v.shape[0] % n_data == 0
                              for v in mb.values()) else 1
            parts = [{k: split(v, d, n) for k, v in mb.items()}
                     if n > 1 else mb for d in range(n)]
            toks = [p["loss_mask"].float().sum() if "loss_mask" in p
                    else torch.tensor(float(p["targets"].numel()))
                    for p in parts]
            tot = torch.clamp(sum(t.to(toks[0].device) for t in toks),
                              min=1.0)
            for d, part in enumerate(parts):
                pos = shards[d]
                lead = mesh.devices[pos[0]]
                for k in names:
                    bind_param(state.model, k,
                               params[k].gather(lead, prefer=pos))
                rt_d = dataclasses.replace(
                    rt, tp_devices=tuple(mesh.devices[p] for p in pos)
                    if len(pos) > 1 else None)
                part = {k: v.to(lead) for k, v in part.items()}
                loss, metrics = tf.loss_fn(cfg, state.model, part, rt_d)
                w = (toks[d].to(lead) / tot.to(lead)) / microbatches
                gs = torch.autograd.grad(metrics["total_loss"] * w, inputs,
                                         allow_unused=True)
                for acc, g in zip(bgrads, gs):
                    if g is not None:
                        acc += g.to(acc.device, grad_accum_dtype)
                for k, v in metrics.items():
                    if isinstance(v, torch.Tensor) and k != "tokens":
                        v = v.detach().to(mesh.devices[0]) \
                            * w.to(mesh.devices[0])
                        sums[k] = sums.get(k, 0.0) + v
                    elif k == "tokens":
                        sums[k] = sums.get(k, 0.0) \
                            + v.detach().to(mesh.devices[0])
                del loss, metrics, gs
                unbind_params(state.model, params)
        metrics = sums if microbatches == 1 else {"loss": sums["loss"]}

        # grads whole on each leaf's first device: the shards' sums
        grads = {}
        for k in names:
            st = params[k]
            g = torch.zeros(st.shape, dtype=grad_accum_dtype,
                            device=st.blocks[0].device)
            grads[k] = g
        for (k, b), acc in zip(blocks, bgrads):
            grads[k][params[k].regions[b]] += acc.to(grads[k].device)
        del bgrads
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        groups = leaf_groups(cfg, names)
        if compress is not None:
            with torch.no_grad():
                ef = {k: st.gather(st.blocks[0].device)
                      for k, st in state.ef_residual.items()}
            grads, ef = compress(grads, ef, groups=groups)
            for k, st in state.ef_residual.items():
                st.scatter_(ef[k])
            del ef
        lr = lr_schedule(state.step)
        count = state.opt_state["count"]
        with torch.no_grad():
            for group in partition_leaves(names, groups):
                whole = {k: params[k].gather(params[k].blocks[0].device)
                         for k in group}
                sub = _gather_state(state.opt_state, group, count)
                optimizer.update({k: grads[k] for k in group}, sub, whole,
                                 lr, groups=[group] if len(group) > 1
                                 else None)
                for k in group:
                    params[k].scatter_(whole[k])
                _scatter_state(state.opt_state, sub, group)
                for k in group:
                    del grads[k]
        state.opt_state["count"] = count + 1
        new_state = dataclasses.replace(state, step=state.step + 1)
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return new_state, metrics

    return step


def _gather_state(opt_state: dict, group: list, count) -> dict:
    """The optimizer state of ``group``'s leaves, whole (AdamW ``m`` /
    ``v``, Adafactor ``stats``), and the step's ``count``."""
    def whole(st):
        return st.gather(st.blocks[0].device) \
            if isinstance(st, ShardedTensor) else st

    sub: dict = {"count": count}
    for key in ("m", "v"):
        if key in opt_state:
            sub[key] = {k: whole(opt_state[key][k]) for k in group}
    if "stats" in opt_state:
        sub["stats"] = {k: {s: whole(t) for s, t in
                            opt_state["stats"][k].items()} for k in group}
    return sub


def _scatter_state(opt_state: dict, sub: dict, group: list) -> None:
    """Write :func:`_gather_state`'s updated leaves back to the shards."""
    def back(dst, src):
        if isinstance(dst, ShardedTensor):
            dst.scatter_(src)
        elif dst is not src:
            dst.copy_(src)

    for key in ("m", "v"):
        if key in opt_state:
            for k in group:
                back(opt_state[key][k], sub[key][k])
    if "stats" in opt_state:
        for k in group:
            for s, t in opt_state["stats"][k].items():
                back(t, sub["stats"][k][s])
