"""Decoder model: per-layer modules, forward, serving prefill and decode.

Port of ``repro.model.transformer`` for the slices the port carries:
GQA attention, global or sliding-window (ring caches), or DeepSeek's MLA,
on the dense or the paged layout — with a dense MLP,
attention and final logit softcaps, token front end.
The reference stacks the parameters of equal layers and ``lax.scan``s
them; the port keeps one module per layer (the weight bridge unstacks)
and loops in Python, and its caches are a flat per-layer list.

Entry points:
  ``init``             → :class:`Model` with seeded random weights
  ``forward``          → logits [B, S, vocab]
  ``init_cache``       → per-layer dense caches
  ``init_paged_cache`` → per-layer page pools (paged layout)
  ``prefill``          → (last-token logits, caches)
  ``decode_step``      → (logits, caches)
  ``decode_loop``      → fused multi-step greedy / sampled decode
  ``layer_verify``     → one layer of a P-token speculative verify
  ``verify_step``      → (logits [B, P, vocab], caches) of a draft chain
  ``speculative_step`` → fused speculate→verify→accept step (greedy)
  ``scatter_cache_slots`` → land a batched prefill in its slot rows
  ``copy_cache_pages`` → copy-on-write of shared prefix pages

``block_tables`` (``{"full": [slots, W] int32}`` on the device) selects
the paged layout in ``prefill`` / ``decode_step`` / ``decode_loop`` /
``verify_step`` / ``speculative_step``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.model import attention as attn_mod
from repro_torch.model.layers import (
    MLP, Embedding, Norm, Runtime, apply_norm, embed, mlp, resolve_device,
    softcap, unembed,
)

#: where each unported feature stands in ROADMAP.md
_ROADMAP = {
    "moe": "ROADMAP §1 item 5b, MoE",
    "ssm": "ROADMAP §1 item 6, SSM, hybrid and the remaining front ends",
    "frontend": "ROADMAP §1 item 6, SSM, hybrid and the remaining front ends",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for any part of ``cfg`` outside the
    ported slices: GQA (global or sliding-window) or MLA attention + dense
    MLP, token front end, on either cache layout."""
    def no(what: str, detail: str):
        raise NotImplementedError(
            f"{cfg.name}: {detail} is not ported yet ({_ROADMAP[what]})")

    if cfg.frontend != "tokens":
        no("frontend", f"the {cfg.frontend!r} front end")
    for spec in cfg.layer_specs():
        if spec.ssm is not None or spec.parallel_ssm:
            no("ssm", f"{spec.ssm} layers")
        if spec.attn not in ("gqa", "mla"):
            no("ssm", f"attention kind {spec.attn!r}")
        if spec.mlp == "moe":
            no("moe", "MoE layers")
        if spec.mlp != "dense":
            no("moe", f"mlp kind {spec.mlp!r}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer: ln1, attn, [post1], ln2, mlp, [post2]."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        nk = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **nk)
        init_attn = attn_mod.mla_init if spec.attn == "mla" \
            else attn_mod.gqa_init
        self.attn = init_attn(cfg, gen=gen, **nk)
        if cfg.post_norm:
            self.post1 = Norm(cfg.d_model, cfg.norm, **nk)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **nk)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen=gen, **nk)
        if cfg.post_norm:
            self.post2 = Norm(cfg.d_model, cfg.norm, **nk)


class Model(nn.Module):
    """All parameters: ``embed``, [``unembed``], ``layers`` (one module per
    layer, in depth order), ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        nk = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, gen=gen, **nk)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.vocab, cfg.d_model, gen=gen, **nk)
        self.layers = nn.ModuleList(
            Layer(cfg, spec, gen=gen, **nk) for spec in cfg.layer_specs())
        self.final_norm = Norm(cfg.d_model, cfg.norm, **nk)

    @property
    def head(self) -> Embedding:
        return self.unembed if hasattr(self, "unembed") else self.embed


def init(cfg: ModelConfig, seed: int = 0, rt: Runtime = Runtime(),
         device="cuda") -> Model:
    """A model with N(0, fan-in) random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the same
    distributions as the reference's init, not the same numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, dtype=rt.param_dtype, device=dev, gen=gen)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _mlp_block(p: Layer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h2 = apply_norm(p.ln2, x, cfg.norm)
    y2 = mlp(p.mlp, h2, cfg.mlp_act)
    if cfg.post_norm:
        y2 = apply_norm(p.post2, y2, cfg.norm)
    return x + y2


def _residual(p: Layer, x: torch.Tensor, y: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.post_norm:
        y = apply_norm(p.post1, y, cfg.norm)
    return x + y


def layer_forward(p: Layer, x: torch.Tensor, cfg: ModelConfig,
                  spec: LayerSpec, rt: Runtime) -> torch.Tensor:
    """Training / prefill-shape layer. x: [B, S, d]."""
    h = apply_norm(p.ln1, x, cfg.norm)
    attend = attn_mod.mla_forward if spec.attn == "mla" \
        else attn_mod.gqa_forward
    x = _residual(p, x, attend(p.attn, h, cfg, spec, rt), cfg)
    return _mlp_block(p, x, cfg)


def layer_decode(p: Layer, x: torch.Tensor, cache: dict,
                 kv_len: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                 rt: Runtime, block_tables: Optional[dict] = None,
                 slots: Optional[dict] = None):
    """One-token decode. x: [B, 1, d]; kv_len includes the current token.
    With ``block_tables`` the layer reads and writes its page pool through
    its class's table (``slots``: the step's write positions per class,
    shared by the class's layers; computed here when absent)."""
    h = apply_norm(p.ln1, x, cfg.norm)
    if block_tables is not None:
        key = attn_mod.paged_cache_key(spec)
        decode_paged = attn_mod.mla_decode_paged if spec.attn == "mla" \
            else attn_mod.gqa_decode_paged
        y, cache["attn"] = decode_paged(
            p.attn, h, cache["attn"], block_tables[key], kv_len, cfg, spec,
            rt, slots=None if slots is None else slots.get(key))
    else:
        decode = attn_mod.mla_decode if spec.attn == "mla" \
            else attn_mod.gqa_decode
        y, cache["attn"] = decode(p.attn, h, cache["attn"], kv_len, cfg,
                                  spec, rt)
    x = _residual(p, x, y, cfg)
    return _mlp_block(p, x, cfg), cache


def layer_verify(p: Layer, x: torch.Tensor, cache: dict,
                 kv_len: torch.Tensor, span: torch.Tensor, cfg: ModelConfig,
                 spec: LayerSpec, rt: Runtime,
                 block_tables: Optional[dict] = None):
    """P-position speculative verify through one layer (the chain analogue
    of :func:`layer_decode`; x: [B, P, d]).  Global attention only: a ring
    holds a trailing window, which a partly rejected chain would leave
    with phantom writes, so the engine never speculates on one."""
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
    x = _residual(p, x, y, cfg)
    return _mlp_block(p, x, cfg), cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    x = embed(model.embed, tokens, rt.activation_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(model.final_norm, x, cfg.norm)
    return softcap(unembed(model.head, x), cfg.final_softcap)


@torch.no_grad()
def forward(cfg: ModelConfig, model: Model, batch: dict,
            rt: Runtime = Runtime()) -> torch.Tensor:
    """Training-shape forward. Returns logits [B, S, vocab]."""
    x = _embed_inputs(cfg, model, batch["inputs"], rt)
    for spec, p in zip(cfg.layer_specs(), model.layers):
        x = layer_forward(p, x, cfg, spec, rt)
    return _logits(cfg, model, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> list:
    """Per-layer dense caches ``[{"attn": {"k", "v"}}, ...]`` (MLA layers:
    ``{"ckv", "krope"}``)."""
    def cache(spec):
        if spec.attn == "mla":
            return attn_mod.mla_init_cache(cfg, batch, max_len, dtype,
                                           device)
        return attn_mod.gqa_init_cache(cfg, spec, batch, max_len, dtype,
                                       device)

    return [{"attn": cache(spec)} for spec in cfg.layer_specs()]


def init_paged_cache(cfg: ModelConfig, slots: int, num_pages: dict,
                     page_size: int, dtype, device,
                     kv_dtype: Optional[str] = None) -> list:
    """Per-layer page pools ``[{"attn": {"k_pages", "v_pages"}}, ...]``
    (MLA layers: ``{"ckv_pages", "krope_pages"}`` in the "full" class),
    ``num_pages`` keyed like the block tables ("full" / "w<window>").
    Every layer owns its pages; the tables (one per class, shared by the
    class's layers) are managed by
    :class:`repro_torch.serving.kv_cache.PagedKVCache`.  ``slots`` would
    size per-slot SSM state, which this slice does not port."""
    def pool(spec):
        init_pool = attn_mod.mla_init_paged_cache if spec.attn == "mla" \
            else attn_mod.gqa_init_paged_cache
        return init_pool(cfg, num_pages[attn_mod.paged_cache_key(spec)],
                         page_size, dtype, device, kv_dtype=kv_dtype)

    return [{"attn": pool(spec)} for spec in cfg.layer_specs()]


def copy_cache_pages(cfg: ModelConfig, caches: list, key: str,
                     src: torch.Tensor, dst: torch.Tensor) -> list:
    """``pages[dst] = pages[src]`` in every layer of capacity class
    ``key`` (MLA layers: the "full" class, both latent pools) — one
    indexed copy per pool and layer for all pairs at once (copy-on-write
    of shared prefix pages).  Returns ``caches``."""
    for spec, c in zip(cfg.layer_specs(), caches):
        if attn_mod.paged_cache_key(spec) != key:
            continue
        for a in c["attn"].values():
            a[dst] = a[src]
    return caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                caches: list, kv_len: torch.Tensor, rt: Runtime = Runtime(),
                block_tables: Optional[dict] = None):
    """One decode step for the whole batch.  tokens: [B, 1] int; kv_len:
    [B] sequence length *including* the current token.  ``block_tables``
    selects the paged layout.  Caches update in place.  Returns (logits
    [B, vocab], caches)."""
    x = _embed_inputs(cfg, model, tokens, rt)
    slots: dict = {}
    for spec, p, c in zip(cfg.layer_specs(), model.layers, caches):
        if block_tables is not None:
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


def _prefill_layer(p: Layer, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                   spec: LayerSpec, rt: Runtime, s_len: int,
                   kv_offset: int = 0, true_len=None, bt_rows=None,
                   cached_len=None):
    """Layer forward that also fills the cache: positions [kv_offset,
    kv_offset + S).  With ``kv_offset > 0`` (chunked-prefill or prefix-hit
    continuation) queries attend the cached history.  ``bt_rows`` (the
    rows' block tables by class) selects the paged layout."""
    h = apply_norm(p.ln1, x, cfg.norm)
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
        positions = torch.arange(s_len, device=x.device).expand(
            h.shape[0], s_len)
        latent = attn_mod._mla_qkv_latent(p.attn, h, cfg, positions)
        y = attn_mod.mla_forward(p.attn, h, cfg, spec, rt, latent=latent)
        ac["ckv"][:, :s_len] = latent[2]
        ac["krope"][:, :s_len] = latent[3]
    elif kv_offset:
        y, cache["attn"] = attn_mod.gqa_prefill_chunk(
            p.attn, h, ac, kv_offset, cfg, spec, rt, true_len)
    else:
        positions = torch.arange(s_len, device=x.device).expand(
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
    x = _residual(p, x, y, cfg)
    return _mlp_block(p, x, cfg), cache


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
    ``cached_len`` ([B]: the shared-prefix pages it maps read-only)."""
    x = _embed_inputs(cfg, model, batch["inputs"], rt)
    s_len = x.shape[1]
    bt_rows = None
    if slot_ids is not None:
        if true_len is None:
            true_len = torch.full((x.shape[0],), kv_offset + s_len,
                                  dtype=torch.int32, device=x.device)
        idx = slot_ids.to(device=x.device, dtype=torch.long)
        bt_rows = {k: t[idx] for k, t in block_tables.items()}
    for spec, p, c in zip(cfg.layer_specs(), model.layers, caches):
        x, _ = _prefill_layer(p, x, c, cfg, spec, rt, s_len, kv_offset,
                              true_len, bt_rows, cached_len)
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
    row.  Returns ``caches``."""
    idx = None
    for c, s in zip(caches, sub):
        for name, dst in c["attn"].items():
            src = s["attn"][name]
            if idx is None:
                idx = slot_ids.to(device=dst.device, dtype=torch.long)
            row = torch.zeros((idx.numel(), *dst.shape[1:]), dtype=dst.dtype,
                              device=dst.device)
            row[tuple(slice(0, n) for n in src.shape)] = src
            dst.index_copy_(0, idx, row)
    return caches


@torch.no_grad()
def decode_loop(cfg: ModelConfig, model: Model, caches: list,
                kv_len: torch.Tensor, last_logits: torch.Tensor,
                remaining: torch.Tensor, *, n_steps: int,
                rt: Runtime = Runtime(), temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                host_remaining=None, block_tables: Optional[dict] = None):
    """Fused multi-step decode: advance every slot by up to ``n_steps``
    tokens, sampling on the device.

    Per step: sample the next token from ``last_logits``, advance
    ``kv_len`` for active slots, run :func:`decode_step`, decrement
    ``remaining``.  Slots with ``remaining <= 0`` are masked — their
    kv_len, logits and token stream freeze.  The loop exits early once
    every budget is spent, as the reference's ``lax.while_loop`` does: the
    step count is ``min(n_steps, max(remaining))``, which the caller's host
    mirror ``host_remaining`` gives without waiting for the device (read
    from ``remaining`` otherwise).

    ``block_tables`` (paged layout) is loop-invariant: the engine grows
    every slot's pages for the whole chunk before the dispatch.

    Returns ``(tokens [n_steps, B], caches, kv_len, last_logits,
    remaining, steps)``.  Greedy streams equal per-token
    :func:`decode_step` calls; sampled ones draw from ``generator``."""
    b = kv_len.shape[0]
    dev = last_logits.device
    rem_host = remaining.cpu() if host_remaining is None else host_remaining
    steps = int(min(n_steps, max(0, int(max(rem_host, default=0)))))
    toks = torch.zeros((n_steps, b), dtype=torch.int32, device=dev)
    kv_len = kv_len.to(device=dev, dtype=torch.int32)
    remaining = remaining.to(device=dev, dtype=torch.int32)
    for i in range(steps):
        active = remaining > 0
        if temperature <= 0.0:
            nxt = torch.argmax(last_logits, dim=-1).to(torch.int32)
        else:
            probs = torch.softmax(last_logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].to(
                torch.int32)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        toks[i] = nxt
        kv_len = kv_len + active.to(torch.int32)
        new_logits, caches = decode_step(cfg, model, nxt[:, None], caches,
                                         kv_len, rt, block_tables)
        last_logits = torch.where(active[:, None],
                                  new_logits.to(last_logits.dtype),
                                  last_logits)
        remaining = remaining - active.to(torch.int32)
    return toks, caches, kv_len, last_logits, remaining, steps
