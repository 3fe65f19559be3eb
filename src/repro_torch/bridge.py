"""Weight bridge between the JAX package's parameter pytree and the port.

The reference stacks the parameters of each *run* of equal layers on a
leading axis (``ModelConfig.runs()``: run i is ``(pattern, reps)`` and
``params["runs"][i][j]`` holds pattern position j for all reps).  The
port keeps one module per layer, so :func:`state_from_jax` unstacks:
layer ``L`` of run i is rep ``r``, position ``j`` with
``L = start_i + r·len(pattern) + j``.  :func:`jax_from_model` restacks,
so the two round-trip.  Where the reference takes one statistic over a
stacked leaf (an optimizer's update clipping, a compressor's scale),
:func:`leaf_groups` names the port's leaves that make it up.

The leaves map one to one under the reference's names, GQA
(``wq``/``wk``/``wv``/``wo``) and MLA (``w_dq``, ``w_uq``, ``w_dkv``,
``w_uk``, ``w_uv``, ``wo``, ``q_norm.scale``, ``kv_norm.scale``) alike,
and so do a dense MLP's (``mlp.*``), an MoE layer's (``moe.router``,
``moe.wi_gate`` / ``wi_up`` [E, d, ff], ``moe.wo`` and the shared
experts' ``moe.shared.*``), a recurrent mixer's (``ssm.*``: Mamba's
``w_in`` … ``w_out``, mLSTM's and sLSTM's gates, norms and projections)
and a frame / patch front end's ``frontend_proj.w``.
DeepSeek's multi-token-prediction head (``params["mtp"]``, present when
``cfg.n_mtp > 0``) maps to ``mtp.<j>.*`` of a model built ``with_mtp``
(training); a serving model has none and the bridge leaves it out.

:func:`train_state_from_jax` carries a reference ``TrainState`` — its
params, its optimizer state (AdamW ``m`` / ``v`` / ``count``, Adafactor
``stats`` / ``count``), ``step`` and error-feedback residual — into the
port's, so a reference state after N steps takes step N + 1 in the port.

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


def leaf_groups(cfg: ModelConfig, names) -> list[list[str]]:
    """The parameter names (``layers.<L>.<leaf>``) that the reference
    stacks into one leaf: for each run i, pattern position j and leaf,
    the reps of ``L = start_i + r·len(pattern) + j``, in rep order.  A
    name outside the runs (embeddings, final norm, the MTP head) and a run
    of one rep form no group."""
    where = {layer: (i, j) for layer, i, j, _, reps in _layer_slices(cfg)
             if reps > 1}
    groups: dict = {}
    for name in names:
        parts = name.split(".", 2)
        if parts[0] != "layers" or int(parts[1]) not in where:
            continue
        groups.setdefault((*where[int(parts[1])], parts[2]), []).append(name)
    return [sorted(g, key=lambda n: int(n.split(".")[1]))
            for g in groups.values()]


def state_from_jax(cfg: ModelConfig, params: Any,
                   with_mtp: bool = False) -> dict[str, np.ndarray]:
    """The port's state dict (numpy leaves) from a JAX params tree (or a
    tree of the same structure: an optimizer's moments).  Reads
    ``embed``, ``unembed``, ``frontend_proj``, ``final_norm``, ``runs``
    and, ``with_mtp``, ``mtp`` (the training-only MTP head)."""
    check_supported(cfg)
    state: dict[str, np.ndarray] = {}
    _flat("embed", params["embed"], state)
    for name in ("unembed", "frontend_proj"):
        if name in params:
            _flat(name, params[name], state)
    _flat("final_norm", params["final_norm"], state)
    if with_mtp:
        for j, p in enumerate(params.get("mtp", [])):
            _flat(f"mtp.{j}", p, state)
    for layer, i, j, r, reps in _layer_slices(cfg):
        p = params["runs"][i][j]
        flat: dict[str, np.ndarray] = {}
        _flat("", p, flat)
        for name, leaf in flat.items():
            state[f"layers.{layer}.{name}"] = leaf[r] if reps > 1 else leaf
    return state


def load_jax_params(model: Model, cfg: ModelConfig, params: Any) -> Model:
    """Copy a JAX params tree into ``model``'s parameters (strict: every
    parameter must be covered and every leaf used; the MTP head's leaves
    go to a model that has one)."""
    state = state_from_jax(cfg, params, with_mtp=hasattr(model, "mtp"))
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, t in own.items():
            src = _tensor(state[name], "cpu")
            if src.shape != t.shape:
                raise ValueError(f"{name}: {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return model


def model_from_jax(cfg: ModelConfig, params: Any, rt: Runtime = Runtime(),
                   device="cuda", with_mtp: bool = False) -> Model:
    """A port model holding the JAX package's weights (``with_mtp``: the
    MTP head's too)."""
    dev = resolve_device(device)
    model = Model(cfg, dtype=rt.param_dtype, device=dev, with_mtp=with_mtp)
    return load_jax_params(model, cfg, params)


def _tensor(arr, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype (bfloat16, which numpy holds
    as ml_dtypes' type, through fp32: exact)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tensors(state: dict, model: Model) -> dict:
    """numpy leaves keyed like the model's parameters → tensors on the
    parameter's device (dtypes as stored)."""
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise KeyError(f"bridge mismatch: {sorted(set(own) ^ set(state))}")
    return {k: _tensor(state[k], own[k].device) for k in own}


def opt_state_from_jax(cfg: ModelConfig, opt_state: Any,
                       model: Model) -> dict:
    """A reference optimizer state (numpy leaves) as the port's: AdamW
    ``{"m", "v", "count"}`` or Adafactor ``{"stats", "count"}``, the
    moments and statistics keyed like ``model.named_parameters()``."""
    mtp = hasattr(model, "mtp")
    dev = next(model.parameters()).device
    out = {"count": torch.tensor(int(np.asarray(opt_state["count"])),
                                 dtype=torch.int32, device=dev)}
    if "m" in opt_state:
        for key in ("m", "v"):
            out[key] = _tensors(state_from_jax(cfg, opt_state[key], mtp),
                                model)
        return out
    stats: dict = {}
    for key, leaf in state_from_jax(cfg, opt_state["stats"], mtp).items():
        name, stat = key.rsplit(".", 1)          # ...wq.vr / .vc / .v
        stats.setdefault(name, {})[stat] = leaf
    own = dict(model.named_parameters())
    if set(stats) != set(own):
        raise KeyError(f"bridge mismatch: {sorted(set(own) ^ set(stats))}")
    out["stats"] = {k: {s: _tensor(v, own[k].device)
                        for s, v in stats[k].items()} for k in own}
    return out


def train_state_from_jax(cfg: ModelConfig, state: Any,
                         rt: Runtime = Runtime(), device="cuda"):
    """The port's :class:`~repro_torch.training.TrainState` from a
    reference ``TrainState`` (``jax.device_get`` of it: numpy leaves)."""
    from repro_torch.training.train_step import TrainState

    model = model_from_jax(cfg, state.params, rt, device=device,
                           with_mtp=bool(cfg.n_mtp))
    for p in model.parameters():
        p.requires_grad_(True)
    dev = next(model.parameters()).device
    ef = None
    if state.ef_residual is not None:
        ef = _tensors(state_from_jax(cfg, state.ef_residual,
                                     hasattr(model, "mtp")), model)
    return TrainState(
        model=model, opt_state=opt_state_from_jax(cfg, state.opt_state,
                                                  model),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        ef_residual=ef)


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
    if hasattr(model, "mtp"):
        tree["mtp"] = [nest(f"mtp.{j}") for j in range(len(model.mtp))]
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
