"""Train-step factory: grads, clip, optional error feedback, optimizer,
microbatch accumulation.

Port of ``repro.training.train_step`` on one device (the sharding rules
that place a step over a device list are ROADMAP item 9b):

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.bridge import leaf_groups
from repro_torch.configs.base import ModelConfig
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.optim import (
    Optimizer, clip_by_global_norm, ef_int8_compress, ef_topk_compress,
    init_error_feedback,
)

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
):
    """Returns step(state, batch) → (state, metrics).  ``compression``:
    False, True (= ``"int8"``) or a name of :data:`COMPRESSORS`.  ``batch`` holds
    tensors on the model's device; metrics are 0-d tensors: the loss
    function's (``loss``, ``tokens``, [``mtp_loss``], ``total_loss``; with
    microbatches only ``loss``), ``grad_norm`` (before clipping) and
    ``lr``."""

    compress = None
    if compression:
        compress = COMPRESSORS["int8" if compression is True else compression]

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
