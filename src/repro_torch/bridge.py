"""Weight bridge between the JAX package's parameter pytree and the port.

The reference stacks the parameters of each *run* of equal layers on a
leading axis (``ModelConfig.runs()``: run i is ``(pattern, reps)`` and
``params["runs"][i][j]`` holds pattern position j for all reps).  The
port keeps one module per layer, so :func:`state_from_jax` unstacks:
layer ``L`` of run i is rep ``r``, position ``j`` with
``L = start_i + r·len(pattern) + j``.  :func:`jax_from_model` restacks,
so the two round-trip.

The leaves map one to one under the reference's names, GQA
(``wq``/``wk``/``wv``/``wo``) and MLA (``w_dq``, ``w_uq``, ``w_dkv``,
``w_uk``, ``w_uv``, ``wo``, ``q_norm.scale``, ``kv_norm.scale``) alike,
and so do a dense MLP's (``mlp.*``), an MoE layer's (``moe.router``,
``moe.wi_gate`` / ``wi_up`` [E, d, ff], ``moe.wo`` and the shared
experts' ``moe.shared.*``), a recurrent mixer's (``ssm.*``: Mamba's
``w_in`` … ``w_out``, mLSTM's and sLSTM's gates, norms and projections)
and a frame / patch front end's ``frontend_proj.w``.
DeepSeek's multi-token-prediction head (``params["mtp"]``, present when
``cfg.n_mtp > 0``) is left out on purpose: only the reference's training
loss runs it, serving never does, and the port builds no such module.

This module imports nothing of the JAX package: callers hand it
``jax.device_get(params)`` (a nested dict/list of numpy arrays).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.model.layers import Runtime, resolve_device
from repro_torch.model.transformer import Model, check_supported


def _flat(prefix: str, tree: dict, out: dict) -> None:
    for name, leaf in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(leaf, dict):
            _flat(key, leaf, out)
        else:
            out[key] = np.asarray(leaf)


def _layer_slices(cfg: ModelConfig):
    """Yield (layer index, run i, pattern position j, rep r, reps)."""
    layer = 0
    for i, (pattern, reps) in enumerate(cfg.runs()):
        for r in range(reps):
            for j in range(len(pattern)):
                yield layer, i, j, r, reps
                layer += 1


def state_from_jax(cfg: ModelConfig, params: Any) -> dict[str, np.ndarray]:
    """The port's state dict (numpy leaves) from a JAX params tree.  Reads
    ``embed``, ``unembed``, ``frontend_proj``, ``final_norm`` and
    ``runs``; ``mtp`` (the training-only MTP head) is skipped, see the
    module docstring."""
    check_supported(cfg)
    state: dict[str, np.ndarray] = {}
    _flat("embed", params["embed"], state)
    for name in ("unembed", "frontend_proj"):
        if name in params:
            _flat(name, params[name], state)
    _flat("final_norm", params["final_norm"], state)
    for layer, i, j, r, reps in _layer_slices(cfg):
        p = params["runs"][i][j]
        flat: dict[str, np.ndarray] = {}
        _flat("", p, flat)
        for name, leaf in flat.items():
            state[f"layers.{layer}.{name}"] = leaf[r] if reps > 1 else leaf
    return state


def load_jax_params(model: Model, cfg: ModelConfig, params: Any) -> Model:
    """Copy a JAX params tree into ``model``'s parameters (strict: every
    parameter must be covered and every leaf used)."""
    state = state_from_jax(cfg, params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, t in own.items():
            src = torch.from_numpy(np.array(state[name]))   # writable copy
            if src.shape != t.shape:
                raise ValueError(f"{name}: {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return model


def model_from_jax(cfg: ModelConfig, params: Any, rt: Runtime = Runtime(),
                   device="cuda") -> Model:
    """A port model holding the JAX package's weights."""
    dev = resolve_device(device)
    model = Model(cfg, dtype=rt.param_dtype, device=dev)
    return load_jax_params(model, cfg, params)


def jax_from_model(cfg: ModelConfig, model: Model) -> dict:
    """The JAX-layout params tree (numpy leaves, runs restacked) of a port
    model — the inverse of :func:`state_from_jax`."""
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}

    def nest(prefix: str) -> dict:
        out: dict = {}
        for key, val in state.items():
            if not key.startswith(prefix + "."):
                continue
            parts = key[len(prefix) + 1:].split(".")
            d = out
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = val
        return out

    tree: dict = {"embed": nest("embed"), "final_norm": nest("final_norm")}
    if "unembed.table" in state:
        tree["unembed"] = nest("unembed")
    if "frontend_proj.w" in state:
        tree["frontend_proj"] = nest("frontend_proj")
    runs: list = [[None] * len(pattern) for pattern, _ in cfg.runs()]
    per_pos: dict = {}
    for layer, i, j, r, reps in _layer_slices(cfg):
        per_pos.setdefault((i, j), []).append(nest(f"layers.{layer}"))
    for (i, j), layers in per_pos.items():
        if len(layers) == 1:
            runs[i][j] = layers[0]
        else:
            runs[i][j] = _stack(layers)
    tree["runs"] = runs
    return tree


def _stack(trees: list) -> dict:
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = _stack([t[k] for t in trees])
        else:
            out[k] = np.stack([t[k] for t in trees])
    return out
