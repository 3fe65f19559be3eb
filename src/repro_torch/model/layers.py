"""Primitive layers: parameter-holding modules and plain functions.

Port of ``repro.model.layers``.  Each ``nn.Module`` here only *holds*
parameters, under the JAX package's names and layouts (a dense weight is
``w [in, *out]``, an embedding ``table [vocab, d]``, a norm ``scale`` with
gemma-style ``1 + scale``), so a function reads like its reference
counterpart and the weight bridge maps leaves one to one.  The
computation lives in plain functions on tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs threaded through forward passes (not config)."""

    #: "auto" (the CUDA kernels on CUDA tensors, the plain versions on the
    #: CPU) | "cuda" | "torch" | "ref" — see repro_torch.kernels.ops
    attn_impl: str = "auto"
    exp_impl: str = "native"    # "native" | "maccs"
    #: kernel tile sizes; None → repro_torch.kernels.autotune
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    param_dtype: torch.dtype = torch.float32
    activation_dtype: torch.dtype = torch.bfloat16
    #: split-K factor for decode; None → autotuned
    decode_splits: Optional[int] = None
    #: the paged pool's device sharding
    #: (:class:`repro_torch.distributed.sharding.KVShard`); None: one pool
    kv_shard: Optional[object] = None
    #: activation hook ``(x, logical_axes) → x`` of the sharding rules
    #: (:func:`repro_torch.distributed.sharding.act_sharder`); the identity
    #: by default, as the reference's
    shard_activation: Callable = staticmethod(lambda x, axes: x)
    #: the devices of a data shard's model-axis positions (a sharded train
    #: step sets them): with more than one, GQA attention runs per kv-head
    #: shard on them, the dense MLP per column shard and the unembedding
    #: per vocab shard, where the shard count divides the axis; partial
    #: sums reduce in shard order.  None: one shard
    tp_devices: Optional[tuple] = None


def strict_fp32() -> None:
    """Make fp32 matrix products true fp32 on the card (no TF32), as the
    reference computes them: set at every entry point that runs on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names the CPU,
    and never a silent fall back — asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain torch path")
        strict_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def normal_(t: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    """In-place N(0, scale²) init from ``gen`` (drawn in fp32)."""
    with torch.no_grad():
        if t.dtype == torch.float32:
            t.normal_(0.0, scale, generator=gen)
        else:
            t.copy_(torch.empty(t.shape, dtype=torch.float32,
                                device=t.device).normal_(0.0, scale,
                                                         generator=gen))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """Weight ``w [in_dim, *out_shape]``, fan-in init."""

    def __init__(self, in_dim: int, out_shape: Sequence[int], *, dtype,
                 device, gen: Optional[torch.Generator] = None,
                 scale: Optional[float] = None):
        super().__init__()
        self.w = _param((in_dim, *out_shape), dtype, device)
        if gen is not None:
            normal_(self.w, scale if scale is not None
                    else 1.0 / math.sqrt(in_dim), gen)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, *out] → [..., *out], contracting one axis."""
    w = p.w.to(x.dtype)
    if w.ndim == 2:
        return x @ w
    return torch.tensordot(x, w, dims=([x.ndim - 1], [0]))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.table = _param((vocab, dim), dtype, device)
        if gen is not None:
            normal_(self.table, 1.0, gen)


def embed(p: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p.table.to(dtype)[tokens.long()]


def unembed(p: Embedding, x: torch.Tensor,
            rows: slice = slice(None)) -> torch.Tensor:
    """Tied LM head: logits = x @ table.T, over the vocab ``rows``."""
    return torch.einsum("...d,vd->...v", x, p.table[rows, :].to(x.dtype))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """Gemma-style ``(1 + scale)`` norm parameters (zeros at init)."""

    def __init__(self, dim: int, kind: str = "rmsnorm", *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind == "layernorm":
            self.bias = nn.Parameter(
                torch.zeros(dim, dtype=dtype, device=device),
                requires_grad=False)
        else:
            self.bias = None


def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    return norm(x, p.scale, p.bias, kind, eps)


def norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
         kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm / layernorm in fp32 with ``(1 + scale)`` and an optional
    bias (the reference's ``apply_norm`` on ``{"scale", "bias"}``)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rope_dim: Optional[int] = None) -> torch.Tensor:
    """Apply RoPE to the last dim of x [..., T, D] at ``positions`` [..., T].

    If ``rope_dim`` < D, only the leading ``rope_dim`` features rotate.
    cos/sin are rounded to the activation dtype, as in the reference."""
    d = x.shape[-1]
    rd = d if rope_dim is None else rope_dim
    if rd == 0:
        return x
    rot, rest = x[..., :rd], x[..., rd:]
    half = rd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [..., T, half]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, rest], dim=-1) if rd < d else rotated


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU / ReLU²)
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.wi_gate = _param((d_model, d_ff), dtype, device)
        self.wi_up = _param((d_model, d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)
        if gen is not None:
            normal_(self.wi_gate, 1.0 / math.sqrt(d_model), gen)
            normal_(self.wi_up, 1.0 / math.sqrt(d_model), gen)
            normal_(self.wo, 1.0 / math.sqrt(d_ff), gen)


def mlp(p: MLP, x: torch.Tensor, act: str = "silu",
        shards: int = 1) -> torch.Tensor:
    """The gated MLP over ``shards`` column shards of the up / gate
    weights and row shards of the down weights (tensor parallelism over
    "mlp"; a count that does not divide d_ff is one shard, as
    :func:`~repro_torch.distributed.sharding._divisible` drops the axis);
    the partial outputs sum in shard order."""
    d_ff = p.wo.shape[0]
    if d_ff % shards:
        shards = 1
    n = d_ff // shards
    out = None
    for j in range(shards):
        sl = slice(j * n, (j + 1) * n)
        h = _ACTS[act](x @ p.wi_gate[:, sl].to(x.dtype))
        h = h * (x @ p.wi_up[:, sl].to(x.dtype))
        part = h @ p.wo[sl, :].to(x.dtype)
        out = part if out is None else out + part
    return out


def tp_count(rt: Runtime) -> int:
    """The model-axis shard count of ``rt`` (1 without a sharded step)."""
    return len(rt.tp_devices) if rt.tp_devices else 1


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)
