"""Decoder model: per-layer modules, forward, serving prefill and decode.

Port of ``repro.model.transformer``: GQA attention, global or
sliding-window (ring caches), or DeepSeek's MLA, on the dense or the paged
layout — with a dense MLP or a mixture of experts
(:mod:`repro_torch.model.moe`), attention and final logit softcaps; the
recurrent mixers of :mod:`repro_torch.model.ssm` (Mamba beside attention in
a hybrid layer, whose two branches are mean-fused; mLSTM / sLSTM layers
with no attention and no MLP), their per-slot state in the caches of both
layouts; and the token front end or precomputed frame / patch embeddings
(``frontend_proj``).
The reference stacks the parameters of equal layers and ``lax.scan``s
them; the port keeps one module per layer (the weight bridge unstacks)
and loops in Python, and its caches are a flat per-layer list.

Entry points:
  ``init``             → :class:`Model` with seeded random weights
  ``forward``          → logits [B, S, vocab]             (no grad)
  ``loss_fn``          → (loss, metrics)                  (training)
  ``init_cache``       → per-layer dense caches
  ``init_paged_cache`` → per-layer page pools (paged layout)
  ``prefill``          → (last-token logits, caches)
  ``decode_step``      → (logits, caches)
  ``decode_loop``      → fused multi-step greedy / sampled decode, each
                         step ``step_in_place`` on a ``DecodeState``
  ``layer_verify``     → one layer of a P-token speculative verify
  ``verify_step``      → (logits [B, P, vocab], caches) of a draft chain
  ``speculative_step`` → fused speculate→verify→accept step (greedy)
  ``scatter_cache_slots`` → land a batched prefill in its slot rows
  ``copy_cache_pages`` → copy-on-write of shared prefix pages

``block_tables`` (``{"full": [slots, W] int32}`` on the device) selects
the paged layout in ``prefill`` / ``decode_step`` / ``decode_loop`` /
``verify_step`` / ``speculative_step``.  On a device-sharded pool
(``Runtime.kv_shard``; its page leaves are lists of shards, see
:mod:`repro_torch.distributed.sharding`) the paged prefill, decode step
and loop, and the COW copies run the attention layers' sharded paths;
block tables, write positions, activations and SSM state stay on the
engine's device, and speculative verify is refused by the engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import leaf_parts
from repro_torch.model import attention as attn_mod
from repro_torch.model import moe as moe_mod
from repro_torch.model import ssm as ssm_mod
from repro_torch.model.layers import (
    MLP, Dense, Embedding, Norm, Runtime, apply_norm, dense, embed, mlp,
    resolve_device, softcap, tp_count, unembed,
)

#: the logical axes of the residual stream (``Runtime.shard_activation``)
_ACT_AXES = ("batch", "seq", "embed")


#: the profiler range around every SSM call (a layer's prefill or decode
#: step), so a trace can tell the mixers' kernels from the rest
SSM_RANGE = "ssm"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a part of ``cfg`` the port has no
    module for: every kind the registry's configs use is ported (GQA / MLA
    / no attention, dense / MoE / no MLP, Mamba / mLSTM / sLSTM, the
    token, frame and patch front ends)."""
    def no(detail: str):
        raise NotImplementedError(f"{cfg.name}: {detail} has no port")

    if cfg.frontend not in ("tokens", "frames", "patches"):
        no(f"the {cfg.frontend!r} front end")
    for spec in cfg.layer_specs():
        if spec.attn not in ("gqa", "mla", "none"):
            no(f"attention kind {spec.attn!r}")
        if spec.mlp not in ("dense", "moe", "none"):
            no(f"mlp kind {spec.mlp!r}")
        if spec.ssm not in (None, "mamba", "mlstm", "slstm"):
            no(f"ssm kind {spec.ssm!r}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer: ln1, [attn], [ssm], [post1], then (unless the
    spec has no MLP) ln2, mlp or moe, [post2] — the reference's
    ``layer_init``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        nk = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **nk)
        if spec.attn != "none":
            init_attn = attn_mod.mla_init if spec.attn == "mla" \
                else attn_mod.gqa_init
            self.attn = init_attn(cfg, gen=gen, **nk)
        if spec.ssm is not None:
            self.ssm = ssm_mod.ssm_init(cfg, spec.ssm, gen=gen, **nk)
        if cfg.post_norm and (spec.attn != "none" or spec.ssm is not None):
            self.post1 = Norm(cfg.d_model, cfg.norm, **nk)
        if spec.mlp != "none":
            self.ln2 = Norm(cfg.d_model, cfg.norm, **nk)
            if spec.mlp == "moe":
                self.moe = moe_mod.MoE(cfg, gen=gen, **nk)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, gen=gen, **nk)
            if cfg.post_norm:
                self.post2 = Norm(cfg.d_model, cfg.norm, **nk)


class Model(nn.Module):
    """All parameters: ``embed``, [``unembed``], [``frontend_proj`` — the
    [d, d] projection of precomputed frame / patch embeddings],
    ``layers`` (one module per layer, in depth order), ``final_norm``, and
    with ``with_mtp`` (training a config with ``n_mtp > 0``) ``mtp``:
    DeepSeek's multi-token-prediction layers, each built like the last
    layer of the stack (the reference's ``params["mtp"]``).  Serving never
    runs the MTP head, so the serving entry points build none."""

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None,
                 with_mtp: bool = False):
        super().__init__()
        check_supported(cfg)
        nk = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, gen=gen, **nk)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.vocab, cfg.d_model, gen=gen, **nk)
        if cfg.frontend != "tokens":
            self.frontend_proj = Dense(cfg.d_model, (cfg.d_model,), gen=gen,
                                       **nk)
        self.layers = nn.ModuleList(
            Layer(cfg, spec, gen=gen, **nk) for spec in cfg.layer_specs())
        self.final_norm = Norm(cfg.d_model, cfg.norm, **nk)
        if with_mtp and cfg.n_mtp:
            spec = cfg.layer_specs()[-1]
            self.mtp = nn.ModuleList(Layer(cfg, spec, gen=gen, **nk)
                                     for _ in range(cfg.n_mtp))

    @property
    def head(self) -> Embedding:
        return self.unembed if hasattr(self, "unembed") else self.embed


def init(cfg: ModelConfig, seed: int = 0, rt: Runtime = Runtime(),
         device="cuda", with_mtp: bool = False) -> Model:
    """A model with N(0, fan-in) random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the same
    distributions as the reference's init, not the same numbers).
    ``with_mtp`` adds the MTP head (drawn after every other weight)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, dtype=rt.param_dtype, device=dev, gen=gen,
                 with_mtp=with_mtp)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _mlp_block(p: Layer, x: torch.Tensor, cfg: ModelConfig,
               spec: LayerSpec, rt: Optional[Runtime] = None) -> torch.Tensor:
    """The FFN half of a layer, dense or MoE (none: x as is).  An MoE
    layer routes each batch row of x [B, S, d] as one capacity group of S
    tokens: the S a caller passes (a prefill bucket, a decode step's 1)
    sets the capacity, as in the reference."""
    if spec.mlp == "none":
        return x
    h2 = apply_norm(p.ln2, x, cfg.norm)
    if spec.mlp == "moe":
        y2 = moe_mod.moe_ffn(p.moe, h2, cfg)
    else:
        y2 = mlp(p.mlp, h2, cfg.mlp_act,
                 shards=1 if rt is None else tp_count(rt))
    if cfg.post_norm:
        y2 = apply_norm(p.post2, y2, cfg.norm)
    return x + y2


def _residual(p: Layer, x: torch.Tensor, parts: list,
              cfg: ModelConfig) -> torch.Tensor:
    """x plus the mixer output: one part as is, a hybrid layer's two
    (attention first, then the SSM) mean-fused as the reference's
    ``sum(parts) / len(parts)``."""
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    if len(parts) > 1:
        y = y / len(parts)
    if hasattr(p, "post1"):
        y = apply_norm(p.post1, y, cfg.norm)
    return x + y


def layer_forward(p: Layer, x: torch.Tensor, cfg: ModelConfig,
                  spec: LayerSpec, rt: Runtime) -> torch.Tensor:
    """Training / prefill-shape layer. x: [B, S, d]."""
    h = apply_norm(p.ln1, x, cfg.norm)
    parts = []
    if spec.attn != "none":
        attend = attn_mod.mla_forward if spec.attn == "mla" \
            else attn_mod.gqa_forward
        parts.append(attend(p.attn, h, cfg, spec, rt))
    if spec.ssm is not None:
        parts.append(ssm_mod.FORWARD[spec.ssm](p.ssm, h, cfg, rt))
    x = _residual(p, x, parts, cfg)
    return _mlp_block(p, x, cfg, spec, rt)


def layer_decode(p: Layer, x: torch.Tensor, cache: dict,
                 kv_len: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                 rt: Runtime, block_tables: Optional[dict] = None,
                 slots: Optional[dict] = None):
    """One-token decode. x: [B, 1, d]; kv_len includes the current token.
    With ``block_tables`` the layer reads and writes its page pool through
    its class's table (``slots``: the step's write positions per class,
    shared by the class's layers; computed here when absent).  An SSM
    steps its per-slot state (``cache["ssm"]``, dense on either layout)
    in place (:func:`repro_torch.model.ssm.step_into`); the state of a
    slot the decode loop masks moves too, and admission resets it, as in
    the reference."""
    h = apply_norm(p.ln1, x, cfg.norm)
    parts = []
    if spec.attn != "none" and block_tables is not None:
        key = attn_mod.paged_cache_key(spec)
        decode_paged = attn_mod.mla_decode_paged if spec.attn == "mla" \
            else attn_mod.gqa_decode_paged
        y, cache["attn"] = decode_paged(
            p.attn, h, cache["attn"], block_tables[key], kv_len, cfg, spec,
            rt, slots=None if slots is None else slots.get(key))
        parts.append(y)
    elif spec.attn != "none":
        decode = attn_mod.mla_decode if spec.attn == "mla" \
            else attn_mod.gqa_decode
        y, cache["attn"] = decode(p.attn, h, cache["attn"], kv_len, cfg,
                                  spec, rt)
        parts.append(y)
    if spec.ssm is not None:
        with torch.profiler.record_function(SSM_RANGE):
            y = ssm_mod.step_into(spec.ssm, p.ssm, h, cache["ssm"], cfg,
                                  rt)
        parts.append(y)
    x = _residual(p, x, parts, cfg)
    return _mlp_block(p, x, cfg, spec), cache


def layer_verify(p: Layer, x: torch.Tensor, cache: dict,
                 kv_len: torch.Tensor, span: torch.Tensor, cfg: ModelConfig,
                 spec: LayerSpec, rt: Runtime,
                 block_tables: Optional[dict] = None):
    """P-position speculative verify through one layer (the chain analogue
    of :func:`layer_decode`; x: [B, P, d]).  Global attention only: a ring
    holds a trailing window, which a partly rejected chain would leave
    with phantom writes, and SSM state cannot be rolled back by page
    surgery, so the engine never speculates on either."""
    if spec.ssm is not None:
        raise ValueError("speculative verify does not support SSM layers")
    if spec.window is not None:
        raise ValueError("speculative verify does not support sliding-"
                         "window layers")
    h = apply_norm(p.ln1, x, cfg.norm)
    if block_tables is not None:
        verify_paged = attn_mod.mla_verify_paged if spec.attn == "mla" \
            else attn_mod.gqa_verify_paged
        y, cache["attn"] = verify_paged(
            p.attn, h, cache["attn"],
            block_tables[attn_mod.paged_cache_key(spec)], kv_len, span, cfg,
            spec, rt)
    else:
        verify = attn_mod.mla_verify if spec.attn == "mla" \
            else attn_mod.gqa_verify
        y, cache["attn"] = verify(p.attn, h, cache["attn"], kv_len, span,
                                  cfg, spec, rt)
    x = _residual(p, x, [y], cfg)
    return _mlp_block(p, x, cfg, spec), cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, model: Model, inputs: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    """Token ids [B, S] through the embedding, or (frame / patch front
    ends) precomputed embeddings [B, S, d] through ``frontend_proj``."""
    if cfg.frontend == "tokens":
        x = embed(model.embed, inputs, rt.activation_dtype)
    else:
        x = dense(model.frontend_proj, inputs.to(rt.activation_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(cfg: ModelConfig, model: Model, x: torch.Tensor,
            shards: int = 1) -> torch.Tensor:
    """The final norm, the tied unembedding and the final softcap.  The
    unembedding runs over ``shards`` vocab-row shards (tensor parallelism
    over "vocab"; a count that does not divide the vocab is one shard),
    whose logits concatenate in shard order, so a cross-entropy's max and
    log-sum-exp span every shard."""
    x = apply_norm(model.final_norm, x, cfg.norm)
    if cfg.vocab % shards:
        shards = 1
    n = cfg.vocab // shards
    parts = [unembed(model.head, x, slice(j * n, (j + 1) * n))
             for j in range(shards)]
    logits = parts[0] if shards == 1 else torch.cat(parts, dim=-1)
    return softcap(logits, cfg.final_softcap)


@torch.no_grad()
def forward(cfg: ModelConfig, model: Model, batch: dict,
            rt: Runtime = Runtime()) -> torch.Tensor:
    """Training-shape forward without gradients (evaluation, the serving
    paths' reference). Returns logits [B, S, vocab]."""
    x = _embed_inputs(cfg, model, batch["inputs"], rt)
    for spec, p in zip(cfg.layer_specs(), model.layers):
        x = layer_forward(p, x, cfg, spec, rt)
    return _logits(cfg, model, x)


def _trunk(cfg: ModelConfig, model: Model, inputs: torch.Tensor,
           rt: Runtime) -> torch.Tensor:
    """The layer stack's output (before the final norm) with gradients,
    rematerialized per (pattern, repeat) of ``cfg.runs()`` as the
    reference's ``_run_forward`` wraps each in ``jax.checkpoint``: only a
    unit's input is kept, and its layers run again in the backward."""
    x = rt.shard_activation(_embed_inputs(cfg, model, inputs, rt),
                            _ACT_AXES)
    layer = 0
    for pattern, reps in cfg.runs():
        for _ in range(reps):
            unit = list(zip(pattern, model.layers[layer:layer + len(pattern)]))
            layer += len(pattern)

            def apply_pattern(h, unit=unit):
                for spec, p in unit:
                    h = rt.shard_activation(layer_forward(p, h, cfg, spec,
                                                          rt), _ACT_AXES)
                return h

            x = checkpoint(apply_pattern, x, use_reentrant=False)
    return x


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token cross-entropy in fp32."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) \
        - lf.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, model: Model, batch: dict,
            rt: Runtime = Runtime()):
    """Causal LM loss (next-token cross-entropy under ``loss_mask``) plus,
    with ``mtp_targets`` and an MTP head, 0.1 x the MTP losses: head j
    applies one more layer to the running trunk output and predicts token
    t + 2 + j.  Returns (loss, metrics) as the reference's ``loss_fn``:
    ``loss`` (next-token), ``tokens``, [``mtp_loss``], ``total_loss``.
    The reference runs the trunk a second time for the MTP head; it is the
    same function of the same inputs, so the port reuses its output."""
    x = _trunk(cfg, model, batch["inputs"], rt)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=targets.device) if mask is None else mask.float()
    tp = tp_count(rt)
    loss = _xent(_logits(cfg, model, x, tp), targets, mask)
    metrics = {"loss": loss, "tokens": mask.sum()}
    if cfg.n_mtp and "mtp_targets" in batch:
        if not hasattr(model, "mtp"):
            raise ValueError(f"{cfg.name}: mtp_targets given but the model "
                             "has no MTP head (build it with_mtp=True)")
        spec = cfg.layer_specs()[-1]
        mtp_loss = 0.0
        for j, p in enumerate(model.mtp):
            x = layer_forward(p, x, cfg, spec, rt)
            mtp_loss = mtp_loss + _xent(_logits(cfg, model, x, tp),
                                        batch["mtp_targets"][..., j], mask)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.1 * mtp_loss
    metrics["total_loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> list:
    """Per-layer dense caches ``[{"attn": {"k", "v"}}, ...]`` (MLA layers:
    ``{"ckv", "krope"}``), and an SSM layer's state under ``"ssm"``
    (Mamba ``{"h", "conv"}``, mLSTM ``{"c", "n", "m", "conv"}``, sLSTM
    ``{"c", "n", "m", "h"}``, batch first)."""
    def cache(spec):
        c = {}
        if spec.attn == "mla":
            c["attn"] = attn_mod.mla_init_cache(cfg, batch, max_len, dtype,
                                                device)
        elif spec.attn == "gqa":
            c["attn"] = attn_mod.gqa_init_cache(cfg, spec, batch, max_len,
                                                dtype, device)
        if spec.ssm is not None:
            c["ssm"] = ssm_mod.INIT_STATE[spec.ssm](cfg, batch, dtype,
                                                    device)
        return c

    return [cache(spec) for spec in cfg.layer_specs()]


def init_paged_cache(cfg: ModelConfig, slots: int, num_pages: dict,
                     page_size: int, dtype, device,
                     kv_dtype: Optional[str] = None) -> list:
    """Per-layer page pools ``[{"attn": {"k_pages", "v_pages"}}, ...]``
    (MLA layers: ``{"ckv_pages", "krope_pages"}`` in the "full" class),
    ``num_pages`` keyed like the block tables ("full" / "w<window>").
    Every layer owns its pages; the tables (one per class, shared by the
    class's layers) are managed by
    :class:`repro_torch.serving.kv_cache.PagedKVCache`.  An SSM layer's
    state stays dense per slot (``"ssm"``, ``slots`` rows, as in
    :func:`init_cache`): it is O(1) a slot."""
    def pool(spec):
        c = {}
        if spec.attn != "none":
            init_pool = attn_mod.mla_init_paged_cache \
                if spec.attn == "mla" else attn_mod.gqa_init_paged_cache
            c["attn"] = init_pool(
                cfg, num_pages[attn_mod.paged_cache_key(spec)], page_size,
                dtype, device, kv_dtype=kv_dtype)
        if spec.ssm is not None:
            c["ssm"] = ssm_mod.INIT_STATE[spec.ssm](cfg, slots, dtype,
                                                    device)
        return c

    return [pool(spec) for spec in cfg.layer_specs()]


def copy_cache_pages(cfg: ModelConfig, caches: list, key: str,
                     src: torch.Tensor, dst: torch.Tensor) -> list:
    """``pages[dst] = pages[src]`` in every layer of capacity class
    ``key`` (MLA layers: the "full" class, both latent pools) — one
    indexed copy per pool, shard and layer for all pairs at once
    (copy-on-write of shared prefix pages).  Returns ``caches``."""
    for spec, c in zip(cfg.layer_specs(), caches):
        if "attn" not in c or attn_mod.paged_cache_key(spec) != key:
            continue
        for leaf in c["attn"].values():
            for a in leaf_parts(leaf):
                a[dst.to(a.device)] = a[src.to(a.device)]
    return caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                caches: list, kv_len: torch.Tensor, rt: Runtime = Runtime(),
                block_tables: Optional[dict] = None):
    """One decode step for the whole batch.  tokens: [B, 1] int, or
    [B, 1, d] embeddings on a frame / patch front end; kv_len: [B]
    sequence length *including* the current token.  ``block_tables``
    selects the paged layout.  Caches update in place.  Returns (logits
    [B, vocab], caches)."""
    x = _embed_inputs(cfg, model, tokens, rt)
    slots: dict = {}
    for spec, p, c in zip(cfg.layer_specs(), model.layers, caches):
        if block_tables is not None and "attn" in c:
            key = attn_mod.paged_cache_key(spec)
            if key not in slots:      # one write index per class and step
                slots[key] = attn_mod.decode_slots(
                    c["attn"], block_tables[key], kv_len, spec)
        x, _ = layer_decode(p, x, c, kv_len, cfg, spec, rt, block_tables,
                            slots)
    return _logits(cfg, model, x[:, 0]), caches


@torch.no_grad()
def verify_step(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                caches: list, kv_len: torch.Tensor, span: torch.Tensor,
                rt: Runtime = Runtime(),
                block_tables: Optional[dict] = None):
    """Score a P-token draft chain in one dispatch.

    tokens: [B, P] int — chain position 0 is the model's own next token
    (the base decode step), positions 1..P-1 the drafts.  kv_len: [B]
    cache length *including* chain position 0; position j sits at
    ``kv_len - 1 + j`` and attends keys ``< kv_len + j``.  span: [B] real
    chain positions per row (writes past it never land, outputs past it
    are ignored).  Caches update in place.  Returns (logits [B, P,
    vocab], caches): ``logits[:, j]`` is what :func:`decode_step` returns
    after committing ``tokens[:, :j+1]`` — the attention reads run the
    single-token split geometry (splits keyed on M, never on P), and the
    [B, P, d] projections and MLP match the [B, 1, d] ones to fp32
    summation order, so the greedy argmax the accept rule reads agrees."""
    x = _embed_inputs(cfg, model, tokens, rt)
    for spec, p, c in zip(cfg.layer_specs(), model.layers, caches):
        x, _ = layer_verify(p, x, c, kv_len, span, cfg, spec, rt,
                            block_tables)
    return _logits(cfg, model, x), caches


@torch.no_grad()
def speculative_step(cfg: ModelConfig, model: Model,
                     last_logits: torch.Tensor, drafts: torch.Tensor,
                     caches: list, kv_len: torch.Tensor,
                     remaining: torch.Tensor, rt: Runtime = Runtime(),
                     block_tables: Optional[dict] = None):
    """One fused speculate→verify→accept step (greedy).

    last_logits: [B, vocab] — each slot's logits over its last committed
    token.  drafts: [B, P-1] proposer guesses for the tokens *after* the
    model's next one.  kv_len: [B] committed lengths (not counting the
    next token); remaining: [B] tokens each slot may still emit (0 =
    spent).

    The chain fed to :func:`verify_step` is ``[argmax(last_logits),
    drafts]``: position 0 is the ordinary decode step, so a fully rejected
    draft still commits one token.  A draft is accepted while each equals
    the argmax of the previous position's verify logits, so every
    committed token is the model's own argmax and the stream equals
    token-by-token :func:`decode_step`.

    Returns (tokens [P, B], advance [B], kv_len, remaining, last_logits,
    caches), all on the device: ``tokens[:advance[i], i]`` is slot i's
    committed chain, and the state equals ``advance[i]`` steps of the
    base loop."""
    b = last_logits.shape[0]
    p_total = drafts.shape[1] + 1
    dev = last_logits.device
    kv_len = kv_len.to(device=dev, dtype=torch.int32)
    remaining = remaining.to(device=dev, dtype=torch.int32)
    active = remaining > 0
    nxt = torch.argmax(last_logits, dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, torch.zeros_like(nxt))
    fed = torch.cat([nxt[:, None], drafts.to(device=dev, dtype=torch.int32)],
                    dim=1)                               # [B, P]
    span = torch.where(active, torch.clamp(remaining, max=p_total),
                       torch.zeros_like(remaining))
    kv0 = kv_len + active.to(torch.int32)                # incl. position 0

    logits, caches = verify_step(cfg, model, fed, caches, kv0, span, rt,
                                 block_tables)

    guess = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, P]
    ok = (fed[:, 1:] == guess[:, :-1]) & (
        torch.arange(1, p_total, device=dev)[None] < span[:, None])
    acc = torch.cumprod(ok.to(torch.int32), dim=1)
    advance = torch.where(active, 1 + acc.sum(dim=1, dtype=torch.int32),
                          torch.zeros_like(remaining))
    new_last = logits[torch.arange(b, device=dev),
                      torch.clamp(advance.long() - 1, min=0)]
    last_logits = torch.where(active[:, None],
                              new_last.to(last_logits.dtype), last_logits)
    return (fed.T, advance, kv_len + advance, remaining - advance,
            last_logits, caches)


def _prefill_attn(p: Layer, h: torch.Tensor, cache: dict, cfg: ModelConfig,
                  spec: LayerSpec, rt: Runtime, s_len: int, kv_offset: int,
                  true_len, bt_rows, cached_len) -> torch.Tensor:
    """The attention branch of :func:`_prefill_layer`: its output, its
    cache filled."""
    ac = cache["attn"]
    if bt_rows is not None:
        prefill_paged = attn_mod.mla_prefill_paged if spec.attn == "mla" \
            else attn_mod.gqa_prefill_paged
        y, cache["attn"] = prefill_paged(
            p.attn, h, ac, bt_rows[attn_mod.paged_cache_key(spec)],
            kv_offset, cfg, spec, rt, true_len, cached_len)
    elif spec.attn == "mla" and kv_offset:
        y, cache["attn"] = attn_mod.mla_prefill_chunk(
            p.attn, h, ac, kv_offset, cfg, spec, rt)
    elif spec.attn == "mla":
        # the chunk attends itself in the expanded form; its latents, all
        # s_len of them as the reference writes them, land in the cache
        positions = torch.arange(s_len, device=h.device).expand(
            h.shape[0], s_len)
        latent = attn_mod._mla_qkv_latent(p.attn, h, cfg, positions)
        y = attn_mod.mla_forward(p.attn, h, cfg, spec, rt, latent=latent)
        ac["ckv"][:, :s_len] = latent[2]
        ac["krope"][:, :s_len] = latent[3]
    elif kv_offset:
        y, cache["attn"] = attn_mod.gqa_prefill_chunk(
            p.attn, h, ac, kv_offset, cfg, spec, rt, true_len)
    else:
        positions = torch.arange(s_len, device=h.device).expand(
            h.shape[0], s_len)
        qkv = attn_mod._proj_qkv(p.attn, h, cfg, positions)
        y = attn_mod.gqa_forward(p.attn, h, cfg, spec, rt, qkv=qkv)
        if spec.window is not None:
            # ring (+ bucket padding): each row keeps its last
            # min(true_len, window) real positions
            attn_mod.ring_write_masked(ac["k"], ac["v"], qkv[1], qkv[2], 0,
                                       true_len)
        else:
            ac["k"][:, :, :s_len] = qkv[1]
            ac["v"][:, :, :s_len] = qkv[2]
    return y


def _prefill_ssm(p: nn.Module, h: torch.Tensor, state: dict,
                 cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                 true_len=None, kv_offset: int = 0):
    """The SSM over a prompt chunk with exact state handoff, as the
    reference's ``_prefill_ssm``: :data:`repro_torch.model.ssm.PREFILL`
    runs its step recurrence with the state-independent products computed
    for the whole chunk, and masked stepping — a row whose real prompt
    ended before global position ``kv_offset + t`` keeps its state frozen
    through the padded tail, so the handed-off state is the state after
    its last real token.  :func:`_prefill_ssm_literal` is the plain
    version it is held to.  Returns (y [B, S, d], state)."""
    n_real = None if true_len is None else \
        true_len.to(h.device).long() - kv_offset
    return ssm_mod.PREFILL[spec.ssm](p, h, state, cfg, n_real)


def _prefill_ssm_literal(p: nn.Module, h: torch.Tensor, state: dict,
                         cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                         true_len=None, kv_offset: int = 0):
    """The reference's ``_prefill_ssm`` as it is written: one ``*_step``
    call a token, the state frozen by ``torch.where`` past each row's
    ``true_len``."""
    step = ssm_mod.STEP[spec.ssm]
    ys = []
    for t in range(h.shape[1]):
        y, st_new = step(p, h[:, t:t + 1], state, cfg, rt)
        if true_len is not None:
            keep = (kv_offset + t) < true_len.to(h.device)          # [B]
            st_new = {k: torch.where(
                keep.reshape((-1,) + (1,) * (v.ndim - 1)), v, state[k])
                for k, v in st_new.items()}
        state = st_new
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), state


def _prefill_layer(p: Layer, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                   spec: LayerSpec, rt: Runtime, s_len: int,
                   kv_offset: int = 0, true_len=None, bt_rows=None,
                   cached_len=None, slot_ids=None):
    """Layer forward that also fills the cache: positions [kv_offset,
    kv_offset + S).  With ``kv_offset > 0`` (chunked-prefill or prefix-hit
    continuation) queries attend the cached history.  ``bt_rows`` (the
    rows' block tables by class) selects the paged layout, where an SSM's
    state lives in the slot rows ``slot_ids`` of the [slots, ...] state:
    gathered (fresh at ``kv_offset == 0``, admission), stepped, scattered
    back.  On the dense layout an SSM continues from ``cache["ssm"]``."""
    h = apply_norm(p.ln1, x, cfg.norm)
    parts = []
    if spec.attn != "none":
        parts.append(_prefill_attn(p, h, cache, cfg, spec, rt, s_len,
                                   kv_offset, true_len, bt_rows, cached_len))
    if spec.ssm is not None:
        parts.append(_prefill_ssm_rows(p, h, cache, cfg, spec, rt, kv_offset,
                                       true_len, bt_rows is not None,
                                       slot_ids))
    x = _residual(p, x, parts, cfg)
    return _mlp_block(p, x, cfg, spec), cache


def _prefill_ssm_rows(p: Layer, h: torch.Tensor, cache: dict,
                      cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                      kv_offset: int, true_len, paged: bool,
                      slot_ids) -> torch.Tensor:
    """The SSM branch of :func:`_prefill_layer`: its output; its state
    handed off into the cache."""
    with torch.profiler.record_function(SSM_RANGE):
        if paged:
            full = cache["ssm"]
            if kv_offset == 0:
                dtype = full["conv"].dtype if "conv" in full \
                    else torch.float32
                state = ssm_mod.INIT_STATE[spec.ssm](cfg, h.shape[0], dtype,
                                                     h.device)
            else:
                state = {k: v[slot_ids] for k, v in full.items()}
            y, st = _prefill_ssm(p.ssm, h, state, cfg, spec, rt, true_len,
                                 kv_offset)
            for k, v in full.items():
                v.index_copy_(0, slot_ids, st[k].to(v.dtype))
        else:
            y, cache["ssm"] = _prefill_ssm(p.ssm, h, cache["ssm"], cfg,
                                           spec, rt, true_len, kv_offset)
    return y


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Model, batch: dict, caches: list,
            rt: Runtime = Runtime(), kv_offset: int = 0,
            true_len: Optional[torch.Tensor] = None,
            block_tables: Optional[dict] = None,
            slot_ids: Optional[torch.Tensor] = None,
            cached_len: Optional[torch.Tensor] = None):
    """Process a prompt (or prompt chunk), filling caches in place.
    Returns (logits_last, caches).

    ``kv_offset`` enables chunked prefill: positions [0, kv_offset) must
    already be cached.  ``true_len`` ([B], length-bucketed batches): each
    row's real prompt length inside the padded bucket; the logits are
    gathered at each row's last real token within this chunk (rows whose
    last token lies in another chunk return garbage — the caller
    selects).  Padded tail positions are causal-masked out of every real
    row and overwritten by decode before they are read.

    ``block_tables`` + ``slot_ids`` switch to the paged layout: K/V
    scatter into the page pools through ``block_tables[...][slot_ids]``
    (no mini-cache), masked past each row's ``true_len`` and below its
    ``cached_len`` ([B]: the shared-prefix pages it maps read-only).

    SSM layers step their state past each row's real tokens frozen
    (masked stepping, :func:`_prefill_ssm`).  ``batch["inputs"]`` holds
    token ids [B, S], or [B, S, d] embeddings on a frame / patch front
    end."""
    x = _embed_inputs(cfg, model, batch["inputs"], rt)
    s_len = x.shape[1]
    bt_rows = idx = None
    if slot_ids is not None:
        if true_len is None:
            true_len = torch.full((x.shape[0],), kv_offset + s_len,
                                  dtype=torch.int32, device=x.device)
        idx = slot_ids.to(device=x.device, dtype=torch.long)
        bt_rows = {k: t[idx] for k, t in block_tables.items()}
    for spec, p, c in zip(cfg.layer_specs(), model.layers, caches):
        x, _ = _prefill_layer(p, x, c, cfg, spec, rt, s_len, kv_offset,
                              true_len, bt_rows, cached_len, idx)
    if true_len is None:
        last = x[:, -1]
    else:
        idx = torch.clamp(true_len.long() - 1 - kv_offset, 0, s_len - 1)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
    return _logits(cfg, model, last), caches


def scatter_cache_slots(cfg: ModelConfig, caches: list, sub: list,
                        slot_ids: torch.Tensor) -> list:
    """Write ``sub`` (a batch = N cache list from :func:`init_cache`,
    possibly shorter than the slots' rows) into batch rows ``slot_ids``
    ([N]) of ``caches``, in place: positions past ``sub``'s length are
    zeroed, so each slot row ends exactly as the reference's full-row
    scatter of a ``max_len`` mini-cache leaves it.  Every cache tensor
    (GQA ``k`` / ``v`` with the sequence on axis 2, MLA ``ckv`` /
    ``krope`` with it on axis 1) lands in the leading corner of its slot
    row; SSM state (no sequence axis) replaces the slot's row whole, so
    admission starts the slot from the prefill's state.  Returns
    ``caches``."""
    idx = slot_ids.to(dtype=torch.long)
    for c, s in zip(caches, sub):
        for name, dst in c.get("ssm", {}).items():
            dst.index_copy_(0, idx.to(dst.device),
                            s["ssm"][name].to(dst.dtype))
        for name, dst in c.get("attn", {}).items():
            src = s["attn"][name]
            row = torch.zeros((idx.numel(), *dst.shape[1:]), dtype=dst.dtype,
                              device=dst.device)
            row[tuple(slice(0, n) for n in src.shape)] = src
            dst.index_copy_(0, idx.to(dst.device), row)
    return caches


@dataclasses.dataclass
class DecodeState:
    """The decode loop's static buffers, all on one device: ``kv_len``
    and ``remaining`` [B] int32, ``last_logits`` [B, vocab], ``tok`` [B]
    int32 (the token the last step fed), ``tables`` (paged layout: one
    [B, W] int32 block table per class; None on the dense one).  Every
    step writes them in place, so a captured step
    (:class:`repro_torch.model.decode_graph.DecodeGraph`) can replay on
    them."""
    kv_len: torch.Tensor
    remaining: torch.Tensor
    last_logits: torch.Tensor
    tok: torch.Tensor
    tables: Optional[dict] = None

    @classmethod
    def for_logits(cls, last_logits: torch.Tensor,
                   tables: Optional[dict] = None) -> "DecodeState":
        """Buffers around ``last_logits`` (kept, not copied), with block
        tables shaped like ``tables``' where given."""
        b, dev = last_logits.shape[0], last_logits.device
        i32 = dict(dtype=torch.int32, device=dev)
        return cls(kv_len=torch.zeros((b,), **i32),
                   remaining=torch.zeros((b,), **i32),
                   last_logits=last_logits, tok=torch.zeros((b,), **i32),
                   tables=None if tables is None else
                   {k: torch.empty(tuple(t.shape), **i32)
                    for k, t in tables.items()})

    def load(self, kv_len, remaining, tables: Optional[dict] = None) -> None:
        """Copy a chunk's inputs in: host arrays (or tensors) of kv_len and
        remaining, and the pool's block tables."""
        for buf, src in ((self.kv_len, kv_len), (self.remaining, remaining)):
            buf.copy_(torch.from_numpy(np.asarray(src, np.int32))
                      if isinstance(src, np.ndarray) else src)
        if (tables is None) != (self.tables is None):
            raise ValueError("block tables given to a dense decode state, or "
                             "none to a paged one")
        for k, t in (tables or {}).items():
            self.tables[k].copy_(t)

    def buffers(self) -> list:
        return [self.kv_len, self.remaining, self.last_logits, self.tok,
                *(self.tables or {}).values()]


def sample_next(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The next token of every row [B] int32: the argmax, or at
    ``temperature > 0`` a draw from ``softmax(logits / temperature)`` —
    ``torch.multinomial``'s one-sample draw, ``argmax(p / q)`` with ``q ~
    Exp(1)`` from ``generator``, which gives the same token from the same
    generator state, without multinomial's host-side check of the
    probabilities (a host sync, which a graph cannot capture)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


@torch.no_grad()
def step_in_place(cfg: ModelConfig, model: Model, caches: list,
                  st: DecodeState, rt: Runtime = Runtime(),
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> None:
    """One step of :func:`decode_loop` on ``st``'s buffers, in place:
    sample the next token, mask the slots with ``remaining <= 0``, advance
    ``kv_len`` for the active ones, run :func:`decode_step`, keep the
    masked slots' logits, spend ``remaining``."""
    active = st.remaining > 0
    nxt = sample_next(st.last_logits, temperature, generator)
    st.tok.copy_(torch.where(active, nxt, torch.zeros_like(nxt)))
    step = active.to(torch.int32)
    st.kv_len.add_(step)
    logits, _ = decode_step(cfg, model, st.tok[:, None], caches, st.kv_len,
                            rt, st.tables)
    st.last_logits.copy_(torch.where(
        active[:, None], logits.to(st.last_logits.dtype), st.last_logits))
    st.remaining.sub_(step)


@torch.no_grad()
def decode_loop(cfg: ModelConfig, model: Model, caches: list,
                kv_len, last_logits: torch.Tensor, remaining, *,
                n_steps: int, rt: Runtime = Runtime(),
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                host_remaining=None, block_tables: Optional[dict] = None,
                state: Optional[DecodeState] = None,
                step: Optional[Callable[[], None]] = None):
    """Fused multi-step decode: advance every slot by up to ``n_steps``
    tokens, sampling on the device.

    Each step is :func:`step_in_place`.  Slots with ``remaining <= 0`` are
    masked — their kv_len, logits and token stream freeze.  The loop exits
    early once every budget is spent, as the reference's
    ``lax.while_loop`` does: the step count is ``min(n_steps,
    max(remaining))``, which the caller's host mirror ``host_remaining``
    gives without waiting for the device (read from ``remaining``
    otherwise).  ``kv_len`` and ``remaining`` are [B] tensors or host
    arrays.

    ``block_tables`` (paged layout) is loop-invariant: the engine grows
    every slot's pages for the whole chunk before the dispatch.

    The steps run on ``state`` (fresh buffers around a copy of
    ``last_logits`` when None; ``last_logits`` is copied into a given
    state's unless it is that state's own), loaded from ``kv_len``,
    ``remaining`` and ``block_tables``.  ``step``, where given, takes the
    place of :func:`step_in_place` on ``state``: a callable that advances
    the same buffers and caches by one step, as
    :meth:`repro_torch.model.decode_graph.DecodeGraph.step` does by
    replaying the captured step.

    Returns ``(tokens [n_steps, B], caches, kv_len, last_logits,
    remaining, steps)``, the middle three ``state``'s buffers.  Greedy
    streams equal per-token :func:`decode_step` calls; sampled ones draw
    from ``generator``."""
    if host_remaining is None:
        host_remaining = remaining.cpu() if torch.is_tensor(remaining) \
            else remaining
    steps = int(min(n_steps, max(0, int(max(host_remaining, default=0)))))
    if state is None:
        state = DecodeState.for_logits(last_logits.clone(), block_tables)
    elif last_logits is not state.last_logits:
        state.last_logits.copy_(last_logits)
    state.load(kv_len, remaining, block_tables)
    if step is None:
        def step():
            step_in_place(cfg, model, caches, state, rt, temperature,
                          generator)
    toks = torch.zeros((n_steps, state.tok.shape[0]), dtype=torch.int32,
                       device=state.tok.device)
    for i in range(steps):
        step()
        toks[i] = state.tok
    return (toks, caches, state.kv_len, state.last_logits, state.remaining,
            steps)
