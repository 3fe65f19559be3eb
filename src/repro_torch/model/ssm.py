"""Recurrent sequence mixers: Mamba (selective SSM), mLSTM, sLSTM.

Port of ``repro.model.ssm``: the attention-free halves of hymba-1.5b (a
Mamba branch beside attention in every layer) and xlstm-125m (mLSTM blocks
with sLSTM at two positions).  The reference writes them in jnp, with no
Pallas kernel, so they are torch ops here.  Parameters keep the
reference's names and shapes (the weight bridge maps them one to one);
the mLSTM / sLSTM gate weights are fp32 whatever the parameter dtype, as
in the reference.  The exponential-gate stabilizers keep the finite
``-1e30`` seed, never ``-inf``.

Three forms of each mixer:

* ``*_forward`` — training / forward shape: Mamba's chunked scan (an
  associative scan within a chunk of 64, the carry across chunks),
  mLSTM's stabilized chunkwise form, sLSTM's step loop;
* ``*_step`` — one decode token against O(1) state (``*_init_state``);
* ``*_ref`` — sequential oracles (Mamba, mLSTM) for the tests;

and, for serving prefill, ``*_prefill``: the step recurrence over a
chunk with every product that does not depend on the state computed for
the whole chunk at once (the projections, the causal conv, the gates and
Mamba's discretization), so only the recurrence itself runs per token.
They step exactly as ``repro_torch.model.transformer._prefill_ssm`` (the
reference's ``_prefill_ssm``, token by token through ``*_step``) does,
masked stepping included: a row whose real prompt ended keeps its state
frozen (``torch.where``) through the bucket padding, and its padded
positions' outputs come from that frozen state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.model.layers import Runtime, _param, norm, normal_

#: the exponential-gate stabilizer's seed (finite, as in the reference)
NEG_INF = -1e30


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (no large-x threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _rmsnorm(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The mixers' output norm: ``apply_norm({"scale": ...}, y)``."""
    return norm(y, scale, None, "rmsnorm")


def _causal_conv(hist: torch.Tensor, kw: torch.Tensor, b: torch.Tensor,
                 index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of the last T = len(hist) - K + 1 positions
    of ``hist`` [B, T + K - 1, di] with taps ``kw`` [K, di], summed tap by
    tap in the reference's order, plus the bias.  ``index`` [B, T, K]
    (masked prefill): the ``hist`` row each tap of each position reads,
    in place of the window ``t .. t + K - 1``."""
    k = kw.shape[0]
    t = hist.shape[1] - k + 1

    def tap(i):
        if index is None:
            return hist[:, i:i + t]
        return torch.gather(hist, 1, index[:, :, i, None].expand(
            -1, -1, hist.shape[2]))

    acc = tap(0) * kw[0]
    for i in range(1, k):
        acc = acc + tap(i) * kw[i]
    return acc + b


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def _lstm_inner(cfg: ModelConfig) -> int:
    return (cfg.ssm.expand if cfg.ssm else 2) * cfg.d_model


# ---------------------------------------------------------------------------
# Modules (parameters only, under the reference's names)
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        c, d = cfg.ssm, cfg.d_model
        di, n, r = c.expand * d, c.state_dim, _dt_rank(cfg)
        self.w_in = _param((d, 2 * di), dtype, device)
        self.conv_w = _param((c.conv_dim, di), dtype, device)
        self.conv_b = _param((di,), dtype, device)
        self.w_xproj = _param((di, r + 2 * n), dtype, device)
        self.w_dt = _param((r, di), dtype, device)
        self.dt_bias = _param((di,), dtype, device)
        self.a_log = _param((di, n), dtype, device)
        self.d_skip = _param((di,), dtype, device)
        self.w_out = _param((di, d), dtype, device)
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.fill_(-4.6)                  # softplus ≈ 0.01
            self.a_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=torch.float32)).expand(di, n))
            self.d_skip.fill_(1.0)
        if gen is not None:
            normal_(self.w_in, 1 / math.sqrt(d), gen)
            normal_(self.conv_w, 0.5, gen)
            normal_(self.w_xproj, 1 / math.sqrt(di), gen)
            normal_(self.w_dt, 1 / math.sqrt(r), gen)
            normal_(self.w_out, 1 / math.sqrt(di), gen)


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        di = _lstm_inner(cfg)
        f32 = torch.float32
        self.w_in = _param((d, 2 * di), dtype, device)
        self.conv_w = _param((4, di), dtype, device)
        self.conv_b = _param((di,), dtype, device)
        self.wq = _param((di, di), dtype, device)
        self.wk = _param((di, di), dtype, device)
        self.wv = _param((di, di), dtype, device)
        self.w_gates = _param((di, 2 * h), f32, device)
        self.b_gates = _param((2 * h,), f32, device)
        self.norm_scale = _param((di,), dtype, device)
        self.w_out = _param((di, d), dtype, device)
        with torch.no_grad():
            self.conv_b.zero_()
            self.b_gates[:h] = 0.0
            self.b_gates[h:] = 3.0
            self.norm_scale.zero_()
        if gen is not None:
            si = 1 / math.sqrt(di)
            normal_(self.w_in, 1 / math.sqrt(d), gen)
            normal_(self.conv_w, 0.5, gen)
            for w in (self.wq, self.wk, self.wv, self.w_gates):
                normal_(w, si, gen)
            normal_(self.w_out, si, gen)


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        f32 = torch.float32
        self.w_gates = _param((d, 4 * d), f32, device)
        self.r_gates = _param((h, dh, 4 * dh), f32, device)
        self.b_gates = _param((4 * d,), f32, device)
        self.norm_scale = _param((d,), dtype, device)
        self.w_out = _param((d, d), dtype, device)
        with torch.no_grad():
            self.b_gates.zero_()
            self.norm_scale.zero_()
        if gen is not None:
            normal_(self.w_gates, 1 / math.sqrt(d), gen)
            normal_(self.r_gates, 1 / math.sqrt(dh), gen)
            normal_(self.w_out, 1 / math.sqrt(d), gen)


_MODULES = {"mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


def ssm_init(cfg: ModelConfig, kind: str, *, dtype, device,
             gen: Optional[torch.Generator] = None) -> nn.Module:
    return _MODULES[kind](cfg, dtype=dtype, device=device, gen=gen)


# ---------------------------------------------------------------------------
# Mamba (selective state-space model)
# ---------------------------------------------------------------------------

def _mamba_inputs(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                  conv_state: Optional[torch.Tensor] = None,
                  conv_index: Optional[torch.Tensor] = None):
    """Shared projections: (u, z, dt, B, C, A) for the scan, and the conv
    history [B, T + K - 1, di] (``conv_state``, zeros by default, then the
    chunk's pre-conv inputs; ``conv_index`` as in :func:`_causal_conv`)."""
    dtp = x.dtype
    xz = x @ p.w_in.to(dtp)                                # [B,T,2di]
    u, z = xz.chunk(2, dim=-1)
    kw = p.conv_w.to(dtp)
    if conv_state is None:
        conv_state = u.new_zeros((u.shape[0], kw.shape[0] - 1, u.shape[2]))
    hist = torch.cat([conv_state.to(dtp), u], dim=1)
    u = F.silu(_causal_conv(hist, kw, p.conv_b.to(dtp), conv_index))
    proj = u @ p.w_xproj.to(dtp)                           # [B,T,R+2n]
    r, n = _dt_rank(cfg), cfg.ssm.state_dim
    dt_in, b_in, c_in = proj.split([r, n, n], dim=-1)
    dt = _softplus(dt_in @ p.w_dt.to(dtp) + p.dt_bias.to(dtp))
    a = -torch.exp(p.a_log.float())                        # [di, n]
    return (u, z, dt.float(), b_in.float(), c_in.float(), a), hist


def _mamba_out(p: Mamba, y: torch.Tensor, u: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    dtp = u.dtype
    y = y.to(dtp) + u * p.d_skip.to(dtp)
    y = y * F.silu(z)
    return y @ p.w_out.to(dtp)


def mamba_forward(p: Mamba, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  chunk: int = 64) -> torch.Tensor:
    """Training / forward Mamba: chunked scan (an associative scan within
    each chunk, the carry across chunks)."""
    b, t, _ = x.shape
    (u, z, dt, bb, cc, a), _ = _mamba_inputs(p, x, cfg)
    di, n = a.shape
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, t, chunk):
        u_c, dt_c = u[:, s:s + chunk], dt[:, s:s + chunk]
        b_c, c_c = bb[:, s:s + chunk], cc[:, s:s + chunk]
        abar = torch.exp(dt_c[..., None] * a)                 # [B,L,di,n]
        bx = (dt_c * u_c.float())[..., None] * b_c[:, :, None, :]
        # inclusive scan of (a, b) pairs under (l, r) -> (l0·r0, r0·l1 + r1)
        a_sc, h_sc = abar, bx
        off = 1
        while off < a_sc.shape[1]:
            h_sc = torch.cat([h_sc[:, :off],
                              a_sc[:, off:] * h_sc[:, :-off] + h_sc[:, off:]],
                             dim=1)
            a_sc = torch.cat([a_sc[:, :off], a_sc[:, off:] * a_sc[:, :-off]],
                             dim=1)
            off *= 2
        h_all = a_sc * h[:, None] + h_sc                       # carry in
        ys.append(torch.einsum("blds,bls->bld", h_all, c_c))
        h = h_all[:, -1]
    return _mamba_out(p, torch.cat(ys, dim=1), u, z)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> dict:
    c = cfg.ssm
    di = c.expand * cfg.d_model
    return {"h": torch.zeros((batch, di, c.state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, c.conv_dim - 1, di), dtype=dtype,
                                device=device)}


def mamba_step(p: Mamba, x: torch.Tensor, state: dict, cfg: ModelConfig,
               rt: Runtime):
    """Single-token decode: O(1) state update.  x: [B, 1, d]."""
    (u, z, dt, b_in, c_in, a), hist = _mamba_inputs(p, x, cfg,
                                                    state["conv"])
    u, z, dt, b_in, c_in = (v[:, 0] for v in (u, z, dt, b_in, c_in))
    abar = torch.exp(dt[..., None] * a)                   # [B,di,n]
    bx = (dt * u.float())[..., None] * b_in[:, None, :]
    h = abar * state["h"] + bx
    y = torch.einsum("bds,bs->bd", h, c_in)
    out = _mamba_out(p, y, u, z)[:, None]
    return out, {"h": h, "conv": hist[:, 1:]}


def mamba_ref(p: Mamba, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential oracle (per-timestep recurrence)."""
    b, t, _ = x.shape
    (u, z, dt, bb, cc, a), _ = _mamba_inputs(p, x, cfg)
    h = torch.zeros((b,) + tuple(a.shape), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(t):
        abar = torch.exp(dt[:, i, :, None] * a)
        h = abar * h + (dt[:, i] * u[:, i].float())[..., None] \
            * bb[:, i, None]
        ys.append(torch.einsum("bds,bs->bd", h, cc[:, i]))
    return _mamba_out(p, torch.stack(ys, dim=1), u, z)


# ---------------------------------------------------------------------------
# Masked prefill stepping (shared)
# ---------------------------------------------------------------------------

class _Keep:
    """Which rows advance their state at each of a chunk's T tokens: row b
    keeps stepping while t < ``n_real[b]`` (its real prompt inside the
    chunk), and past it its state stays frozen.  ``lo`` / ``hi`` are the
    least and most real tokens of any row (read once on the host), so a
    token where every row steps, or none does, needs no ``torch.where``.

    A frozen row's state includes its conv history: at a padded position
    the step convolves its last K - 1 *real* inputs and the padded input
    itself (:meth:`conv_index`)."""

    def __init__(self, n_real: Optional[torch.Tensor], t: int, device):
        if n_real is None:
            self.lo = self.hi = t
            self.mask = None
            return
        n_real = n_real.to(device=device, dtype=torch.long).clamp(0, t)
        self.lo, self.hi = (int(v) for v in torch.stack(
            [n_real.min(), n_real.max()]).tolist())
        self.mask = torch.arange(t, device=device)[:, None] < n_real[None]
        self.n_real = n_real

    def conv_index(self, k: int) -> Optional[torch.Tensor]:
        """[B, T, K] rows of the conv history [B, K - 1 + T, di] that each
        tap reads: the window ``t .. t + K - 1`` at a real position; at a
        padded one the row's last K - 1 real inputs (``n_real ..
        n_real + K - 2``), then its own input (``t + K - 1``).  None when
        every position is real."""
        if self.mask is None or self.lo == self.mask.shape[0]:
            return None
        t = self.mask.shape[0]
        dev = self.mask.device
        taps = torch.arange(k, device=dev)
        window = torch.arange(t, device=dev)[:, None] + taps      # [T,K]
        frozen = torch.where(taps == k - 1, window,
                             self.n_real[:, None, None] + taps)   # [B,T,K]
        return torch.where(self.mask.T[:, :, None], window, frozen)

    def update(self, i: int, new: torch.Tensor,
               old: torch.Tensor) -> torch.Tensor:
        """The state after token ``i``: ``new`` where the row steps."""
        if i < self.lo:
            return new
        if i >= self.hi:
            return old
        keep = self.mask[i].reshape((-1,) + (1,) * (new.ndim - 1))
        return torch.where(keep, new, old)

    def conv_tail(self, hist: torch.Tensor, k1: int) -> torch.Tensor:
        """The conv state to hand off: each row's last ``k1`` real inputs
        in ``hist`` [B, k1 + T, di] (the old state, then the chunk's)."""
        t = hist.shape[1] - k1
        if self.mask is None or self.lo == t:
            return hist[:, t:]
        idx = self.n_real[:, None] + torch.arange(k1, device=hist.device)
        return torch.gather(hist, 1, idx[..., None].expand(
            -1, -1, hist.shape[2]))


def mamba_prefill(p: Mamba, x: torch.Tensor, state: dict,
                  cfg: ModelConfig, n_real: Optional[torch.Tensor] = None,
                  block: int = 128):
    """``mamba_step`` over the chunk x [B, T, d], hoisted: the projections,
    the conv over the input history, ``dt`` and the discretization
    (``exp(dt·A)``, ``dt·u·B``) for every token at once (the latter in
    blocks of ``block`` tokens, which bounds the [B, L, di, n] buffers);
    per token only ``h = ā·h + b̄x`` and ``y = h·C``.  ``n_real`` [B]:
    each row's real tokens in the chunk (None: all), past which its state
    stays frozen.  Returns (y [B, T, d], state)."""
    b, t, _ = x.shape
    k1 = cfg.ssm.conv_dim - 1
    keep = _Keep(n_real, t, x.device)
    (u, z, dt, bb, cc, a), hist = _mamba_inputs(
        p, x, cfg, state["conv"], keep.conv_index(k1 + 1))
    h = state["h"]
    ys = torch.empty((t, b, a.shape[0], 1), dtype=torch.float32,
                     device=x.device)
    # token-major, so each token's [B, di, n] slice is contiguous
    dt_t = dt.transpose(0, 1).contiguous()                   # [T,B,di]
    du_t = (dt * u.float()).transpose(0, 1).contiguous()
    b_t = bb.transpose(0, 1).contiguous()                    # [T,B,n]
    c_t = cc.transpose(0, 1)[..., None].contiguous()         # [T,B,n,1]
    for s in range(0, t, block):
        abar = torch.exp(dt_t[s:s + block, ..., None] * a)   # [L,B,di,n]
        bx = du_t[s:s + block, ..., None] * b_t[s:s + block, :, None, :]
        for j, (a_j, bx_j, c_j, y_j) in enumerate(zip(
                abar.unbind(0), bx.unbind(0), c_t[s:s + block].unbind(0),
                ys[s:s + block].unbind(0))):
            h_new = torch.addcmul(bx_j, a_j, h)               # ā·h + b̄x
            torch.bmm(h_new, c_j, out=y_j)
            h = keep.update(s + j, h_new, h)
    y = ys[..., 0].transpose(0, 1)
    return _mamba_out(p, y, u, z), {"h": h, "conv": keep.conv_tail(hist, k1)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------

def _mlstm_inputs(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                  conv_state: Optional[torch.Tensor] = None,
                  conv_index: Optional[torch.Tensor] = None):
    """(q, k, v [B,T,H,dh], log_i, log_f [B,T,H], z) and the conv
    history, as :func:`_mamba_inputs`."""
    h = cfg.n_heads
    dtp = x.dtype
    xz = x @ p.w_in.to(dtp)
    u, z = xz.chunk(2, dim=-1)
    kw = p.conv_w.to(dtp)
    if conv_state is None:
        conv_state = u.new_zeros((u.shape[0], kw.shape[0] - 1, u.shape[2]))
    hist = torch.cat([conv_state.to(dtp), u], dim=1)
    c = F.silu(_causal_conv(hist, kw, p.conv_b.to(dtp), conv_index))
    b, t, di = u.shape
    dh = di // h
    q = (c @ p.wq.to(dtp)).reshape(b, t, h, dh)
    k = (c @ p.wk.to(dtp)).reshape(b, t, h, dh) / math.sqrt(dh)
    v = (u @ p.wv.to(dtp)).reshape(b, t, h, dh)
    gates = c.float() @ p.w_gates + p.b_gates
    log_i = gates[..., :h]                                # exp input gate
    log_f = -_softplus(-gates[..., h:])                   # log σ(f) ≤ 0
    return (q, k, v, log_i, log_f, z), hist


def _mlstm_chunk(q, k, v, log_i, log_f, carry, eps: float = 1e-6):
    """One chunk of the stabilized chunkwise mLSTM (the reference's
    ``_mlstm_chunk``).  q, k, v: [B,H,L,dh]; log_i / log_f: [B,H,L];
    carry = (C [B,H,dh,dh], n [B,H,dh], m [B,H])."""
    c_prev, n_prev, m_prev = carry
    fcum = torch.cumsum(log_f, dim=-1)                    # F_t (inclusive)
    u = log_i - fcum
    mtilde = torch.maximum(torch.cummax(u, dim=-1).values, m_prev[..., None])
    m_t = fcum + mtilde                                   # running stabilizer
    ln = q.shape[-2]
    dmat = torch.exp(u[..., None, :] - mtilde[..., :, None])
    tri = torch.tril(torch.ones((ln, ln), dtype=torch.bool,
                                device=q.device))
    dmat = torch.where(tri, dmat, torch.zeros((), device=q.device))
    s = torch.einsum("bhld,bhmd->bhlm", q, k).float()
    w = s * dmat
    h_intra = torch.einsum("bhlm,bhmd->bhld", w.to(q.dtype), v)
    cf = torch.exp(m_prev[..., None] + fcum - m_t)
    h_carry = torch.einsum("bhld,bhde->bhle", q, c_prev.to(q.dtype))
    h_all = h_intra.float() + cf[..., None] * h_carry.float()
    n_dot = w.sum(dim=-1) + cf * torch.einsum("bhld,bhd->bhl", q.float(),
                                              n_prev)
    denom = torch.maximum(n_dot.abs(), torch.exp(-m_t)) + eps
    h_out = h_all / denom[..., None]
    f_last = fcum[..., -1:]
    m_new = fcum[..., -1] + mtilde[..., -1]
    upd = torch.exp(u + f_last - m_new[..., None])
    decay = torch.exp(m_prev + f_last[..., 0] - m_new)
    c_new = decay[..., None, None] * c_prev + torch.einsum(
        "bhl,bhld,bhle->bhde", upd, k.float(), v.float())
    n_new = decay[..., None] * n_prev + torch.einsum(
        "bhl,bhld->bhd", upd, k.float())
    return h_out.to(q.dtype), (c_new, n_new, m_new)


def _mlstm_out(p: MLSTM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = _rmsnorm(y, p.norm_scale)
    y = y * F.silu(z)
    return y @ p.w_out.to(y.dtype)


def mlstm_forward(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  chunk: int = 64) -> torch.Tensor:
    b, t, _ = x.shape
    h = cfg.n_heads
    (q, k, v, log_i, log_f, z), _ = _mlstm_inputs(p, x, cfg)
    di = z.shape[-1]
    dh = di // h
    t_pad = (-t) % chunk
    if t_pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, t_pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, t_pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, 0, 0, t_pad))
    tt = t + t_pad
    nc = tt // chunk
    qh, kh, vh = (a.transpose(1, 2).reshape(b, h, nc, chunk, dh)
                  for a in (q, k, v))
    gi = log_i.transpose(1, 2).reshape(b, h, nc, chunk)
    gf = log_f.transpose(1, 2).reshape(b, h, nc, chunk)
    carry = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=x.device),
             torch.zeros((b, h, dh), dtype=torch.float32, device=x.device),
             torch.full((b, h), NEG_INF, dtype=torch.float32,
                        device=x.device))
    outs = []
    for i in range(nc):
        out, carry = _mlstm_chunk(qh[:, :, i], kh[:, :, i], vh[:, :, i],
                                  gi[:, :, i], gf[:, :, i], carry)
        outs.append(out)
    y = torch.stack(outs, dim=2).reshape(b, h, tt, dh)[:, :, :t]
    y = y.transpose(1, 2).reshape(b, t, di)
    return _mlstm_out(p, y, z[:, :t])


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    h = cfg.n_heads
    di = _lstm_inner(cfg)
    dh = di // h
    f32 = torch.float32
    return {"c": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), NEG_INF, dtype=f32, device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


def mlstm_step(p: MLSTM, x: torch.Tensor, state: dict, cfg: ModelConfig,
               rt: Runtime):
    """O(1) decode step.  x: [B, 1, d]."""
    (q, k, v, log_i, log_f, z), hist = _mlstm_inputs(p, x, cfg,
                                                     state["conv"])
    q, k, v, log_i, log_f, z = (a[:, 0] for a in (q, k, v, log_i, log_f, z))
    b, h, dh = q.shape
    m_new = torch.maximum(log_f + state["m"], log_i)
    f_eff = torch.exp(log_f + state["m"] - m_new)
    i_eff = torch.exp(log_i - m_new)
    kf, vf = k.float(), v.float()
    c_new = f_eff[..., None, None] * state["c"] + \
        i_eff[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n_new = f_eff[..., None] * state["n"] + i_eff[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhde,bhd->bhe", c_new, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, qf).abs(),
                        torch.exp(-m_new)) + 1e-6
    y = (num / den[..., None]).reshape(b, h * dh).to(x.dtype)
    out = _mlstm_out(p, y, z)[:, None]
    return out, {"c": c_new, "n": n_new, "m": m_new, "conv": hist[:, 1:]}


def mlstm_ref(p: MLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential oracle: one :func:`mlstm_step` per token."""
    state = mlstm_init_state(cfg, x.shape[0], x.dtype, x.device)
    ys = []
    for i in range(x.shape[1]):
        y, state = mlstm_step(p, x[:, i:i + 1], state, cfg, Runtime())
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)


def mlstm_prefill(p: MLSTM, x: torch.Tensor, state: dict,
                  cfg: ModelConfig, n_real: Optional[torch.Tensor] = None):
    """``mlstm_step`` over the chunk x [B, T, d], hoisted: the conv, q / k
    / v and the gates for every token at once; then the stabilizer's own
    recurrence (``m``, [B, H] a token), after which the effective gates
    ``f_eff`` / ``i_eff`` and ``i_eff·k`` are computed for the whole chunk;
    per token only ``C = f·C + (i·k)⊗v``, ``n = f·n + i·k`` and the two
    read-out products ``q·C`` and ``q·n``; the normalizer and everything
    after it run on the whole chunk again.  ``n_real`` as in
    :func:`mamba_prefill`."""
    b, t, _ = x.shape
    keep = _Keep(n_real, t, x.device)
    (q, k, v, log_i, log_f, z), hist = _mlstm_inputs(
        p, x, cfg, state["conv"], keep.conv_index(4))
    _, _, nh, dh = q.shape
    # the stabilizer: m_new_t = max(log_f_t + m, log_i_t) from the frozen m
    lf_m = torch.empty((t, b, nh), dtype=torch.float32, device=x.device)
    m_new = torch.empty_like(lf_m)
    log_f_t = log_f.transpose(0, 1).contiguous()
    log_i_t = log_i.transpose(0, 1).contiguous()
    m = state["m"]
    for i, (lf, li, lfm, mn) in enumerate(zip(
            log_f_t.unbind(0), log_i_t.unbind(0), lf_m.unbind(0),
            m_new.unbind(0))):
        torch.add(lf, m, out=lfm)
        torch.maximum(lfm, li, out=mn)
        m = keep.update(i, mn, m)
    f_eff = torch.exp(lf_m - m_new)                        # [T,B,H]
    i_eff = torch.exp(log_i_t - m_new)
    kf = k.float().transpose(0, 1)                         # [T,B,H,dh]
    vf = v.float().transpose(0, 1).reshape(t, b * nh, 1, dh)
    qf = q.float().transpose(0, 1).reshape(t, b * nh, 1, dh)
    ik = (i_eff[..., None] * kf).reshape(t, b * nh, dh, 1)
    ik_row = ik.reshape(t, b * nh, dh)
    f_c = f_eff.reshape(t, b * nh, 1, 1)
    f_n = f_eff.reshape(t, b * nh, 1)
    c = state["c"].reshape(b * nh, dh, dh)
    n = state["n"].reshape(b * nh, dh)
    num = torch.empty((t, b * nh, 1, dh), dtype=torch.float32,
                      device=x.device)
    nq = torch.empty((t, b * nh, 1, 1), dtype=torch.float32,
                     device=x.device)
    for i, (f_ci, f_ni, ik_i, ikr_i, v_i, q_i, num_i, nq_i) in enumerate(
            zip(f_c.unbind(0), f_n.unbind(0), ik.unbind(0),
                ik_row.unbind(0), vf.unbind(0), qf.unbind(0),
                num.unbind(0), nq.unbind(0))):
        c_new = torch.addcmul(ik_i * v_i, f_ci, c)       # f·C + (i·k)⊗v
        n_new = torch.addcmul(ikr_i, f_ni, n)            # f·n + i·k
        torch.bmm(q_i, c_new, out=num_i)
        torch.bmm(n_new[:, None, :], q_i.transpose(1, 2), out=nq_i)
        c = keep.update(i, c_new.view(b, nh, dh, dh),
                        c.view(b, nh, dh, dh)).view(b * nh, dh, dh)
        n = keep.update(i, n_new.view(b, nh, dh),
                        n.view(b, nh, dh)).view(b * nh, dh)
    den = torch.maximum(nq.reshape(t, b, nh).abs(), torch.exp(-m_new)) + 1e-6
    y = num.reshape(t, b, nh, dh) / den[..., None]
    y = y.transpose(0, 1).reshape(b, t, nh * dh).to(x.dtype)
    st = {"c": c.view(b, nh, dh, dh), "n": n.view(b, nh, dh), "m": m,
          "conv": keep.conv_tail(hist, 3)}
    return _mlstm_out(p, y, z), st


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory cell with exponential gating + block recurrence)
# ---------------------------------------------------------------------------

def slstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {"c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.ones((batch, d), dtype=f32, device=device),
            "m": torch.zeros((batch, d), dtype=f32, device=device),
            "h": torch.zeros((batch, d), dtype=f32, device=device)}


def _slstm_gates_rec(p: SLSTM, hprev: torch.Tensor,
                     n_heads: int) -> torch.Tensor:
    """The recurrent gate input ``einsum("bhe,hef->bhf", h, R)`` as
    [B, 4d]."""
    b, d = hprev.shape
    return torch.einsum("bhe,hef->bhf", hprev.reshape(b, n_heads, -1),
                        p.r_gates).reshape(b, 4 * d)


def _slstm_update(gates: torch.Tensor, st: dict) -> dict:
    zi, fi, ii, oi = gates.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_f = -_softplus(-fi)
    m_new = torch.maximum(log_f + st["m"], ii)
    i_eff = torch.exp(ii - m_new)
    f_eff = torch.exp(log_f + st["m"] - m_new)
    c_new = f_eff * st["c"] + i_eff * zt
    n_new = f_eff * st["n"] + i_eff
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _slstm_cell(p: SLSTM, xt: torch.Tensor, st: dict,
                n_heads: int) -> dict:
    """xt: [B, d] fp32.  One stabilized sLSTM step."""
    gates = xt @ p.w_gates + _slstm_gates_rec(p, st["h"], n_heads) \
        + p.b_gates
    return _slstm_update(gates, st)


def _slstm_out(p: SLSTM, y: torch.Tensor) -> torch.Tensor:
    return _rmsnorm(y, p.norm_scale) @ p.w_out.to(y.dtype)


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                  rt: Runtime) -> torch.Tensor:
    b, t, d = x.shape
    st = slstm_init_state(cfg, b, x.dtype, x.device)
    hs = []
    for i in range(t):
        st = _slstm_cell(p, x[:, i].float(), st, cfg.n_heads)
        hs.append(st["h"])
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype))


def slstm_step(p: SLSTM, x: torch.Tensor, state: dict, cfg: ModelConfig,
               rt: Runtime):
    st = _slstm_cell(p, x[:, 0].float(), state, cfg.n_heads)
    return _slstm_out(p, st["h"].to(x.dtype))[:, None], st


def slstm_prefill(p: SLSTM, x: torch.Tensor, state: dict,
                  cfg: ModelConfig, n_real: Optional[torch.Tensor] = None):
    """``slstm_step`` over the chunk x [B, T, d], hoisted: ``x @ W`` for
    every token at once; per token the recurrent product ``h·R`` and the
    cell.  ``n_real`` as in :func:`mamba_prefill`."""
    b, t, d = x.shape
    keep = _Keep(n_real, t, x.device)
    xw = (x.float() @ p.w_gates).transpose(0, 1)           # [T,B,4d]
    st = dict(state)
    hs = torch.empty((t, b, d), dtype=torch.float32, device=x.device)
    for i in range(t):
        gates = xw[i] + _slstm_gates_rec(p, st["h"], cfg.n_heads) \
            + p.b_gates
        new = _slstm_update(gates, st)
        hs[i] = new["h"]
        st = {key: keep.update(i, new[key], st[key]) for key in st}
    y = hs.transpose(0, 1).to(x.dtype)
    return _slstm_out(p, y), st


# ---------------------------------------------------------------------------
# By kind
# ---------------------------------------------------------------------------

FORWARD = {"mamba": mamba_forward, "mlstm": mlstm_forward,
           "slstm": slstm_forward}
STEP = {"mamba": mamba_step, "mlstm": mlstm_step, "slstm": slstm_step}
PREFILL = {"mamba": mamba_prefill, "mlstm": mlstm_prefill,
           "slstm": slstm_prefill}
INIT_STATE = {"mamba": mamba_init_state, "mlstm": mlstm_init_state,
              "slstm": slstm_init_state}


def step_into(kind: str, p: nn.Module, x: torch.Tensor, state: dict,
              cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """``STEP[kind]`` with the new state written into ``state``'s own
    tensors (cast to their dtypes, as prefill hands state off), so every
    leaf keeps its storage across decode steps — a captured decode step
    replays the addresses it captured.  Returns the output [B, 1, d]."""
    y, new = STEP[kind](p, x, state, cfg, rt)
    for name, value in new.items():
        state[name].copy_(value)
    return y
