"""Serving engine: batched bucketed prefill + fused multi-step decode on the
dense cache layout.

Port of the dense layout of ``repro.serving.ServeEngine``.  A fixed set
of slots holds requests (continuous batching); each slot has its own
``kv_len``; decode advances the whole batch through
:func:`transformer.decode_loop`, whose split-K decode kernel handles the
ragged lengths itself.  Finished slots refill from the queue.

* **Batched bucketed prefill** — admitted prompts pad to power-of-two
  length buckets and each bucket group runs as ONE prefill over a fresh
  per-group cache of the bucket's length, which then lands in the slot
  rows (:func:`transformer.scatter_cache_slots`).  Padded tails are
  causal-masked; each row's logits come from its real last token
  (``true_len``).  Prompts longer than ``prefill_chunk`` run in pieces
  inside the same dispatch.
* **Fused multi-step decode** — one dispatch advances every slot by up to
  ``decode_chunk`` tokens with on-device sampling and the reference's
  early exit; the first dispatch after an admission runs a single step
  so the reported TTFT is a first-token latency.

The reference donates its cache buffers to each jit'd call; the port
updates the caches in place instead.  ``stats`` counts dispatches and
steps exactly as the reference does, so the two engines can be held to
the same counters on the same trace.

Not ported yet (each raises ``NotImplementedError``, see ROADMAP.md):
``cache_layout="paged"`` (paged layout + K3), ``speculate``, ``kv_dtype``
/ ``pool_bytes`` / ``host_swap_bytes`` (quantized pages / swap) and
``mesh`` (sharded pool).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.autotune import next_pow2
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    ttft: Optional[float] = None       # seconds, submit → first token known


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class ServeEngine:
    """Continuous-batching engine over a fixed slot count (dense layout).

    ``stats`` counts device dispatches and decode steps like the
    reference; ``memory_stats`` reports the dense cache's bytes."""

    def __init__(self, cfg: ModelConfig, model: tf.Model, *, slots: int,
                 max_len: int, rt: Runtime = Runtime(),
                 temperature: float = 0.0, dtype=torch.float32,
                 decode_chunk: int = 16,
                 prefill_chunk: Optional[int] = None,
                 cache_layout: str = "dense",
                 speculate: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 pool_bytes: Optional[int] = None,
                 host_swap_bytes: int = 0,
                 mesh=None,
                 device="cuda",
                 seed: int = 0):
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout: {cache_layout!r}")
        if cache_layout == "paged":
            raise _not_ported("cache_layout='paged'",
                              "§1 item 1, paged layout and prefix cache "
                              "with K3")
        if speculate is not None:
            raise _not_ported("speculative decoding", "§1 item 3, speculation")
        if kv_dtype is not None or pool_bytes is not None or host_swap_bytes:
            raise _not_ported("kv_dtype / pool_bytes / host_swap_bytes",
                              "§1 item 4, quantized pages and host swap")
        if mesh is not None:
            raise _not_ported("the device-sharded pool (mesh=)",
                              "§1 item 8, device-sharded pool")
        self.device = resolve_device(device)
        param_dev = model.embed.table.device
        if param_dev.type != self.device.type:
            raise ValueError(f"model on {param_dev}, engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.rt = rt
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = None if prefill_chunk is None \
            else max(1, prefill_chunk)
        self.cache_dtype = dtype
        self.cache_layout = cache_layout
        self.caches = tf.init_cache(cfg, slots, max_len, dtype, self.device)
        # host mirrors of per-slot state
        self.kv_len = np.zeros((slots,), np.int32)
        self.remaining = np.zeros((slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._last_logits = torch.zeros((slots, cfg.vocab),
                                        dtype=torch.float32,
                                        device=self.device)
        # device-side flag: every logits block a dispatch produced was
        # finite (checked without a host sync; read by logits_finite())
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                      "decode_steps": 0, "tokens_decoded": 0,
                      "preemptions": 0, "peak_live_tokens": 0,
                      "prefix_hits": 0, "tokens_reused": 0,
                      "cow_copies": 0, "tokens_prefilled": 0,
                      "spec_dispatches": 0, "spec_proposed": 0,
                      "spec_accepted": 0}

    # -- prefill ------------------------------------------------------------

    def _bucket(self, s: int) -> int:
        """Pad prompt lengths to power-of-two buckets (capped at max_len)."""
        return min(next_pow2(s), self.max_len)

    def _prefill_pieces(self, s: int) -> list[tuple[int, int]]:
        chunk = self.prefill_chunk
        if chunk is None or s <= chunk:
            return [(0, s)]
        pieces, off = [], 0
        while off < s:
            c = min(chunk, s - off)
            pieces.append((off, c))
            off += c
        return pieces

    def _prefill_into_slots(self, tokens: torch.Tensor,
                            slot_ids: torch.Tensor,
                            true_len: torch.Tensor) -> None:
        """One prefill dispatch: ``tokens [n, s]`` padded to bucket ``s``
        into a fresh [n, s] cache, then into slot rows ``slot_ids``; each
        row's last-token logits land in ``_last_logits``."""
        n, s = tokens.shape
        cfg, rt = self.cfg, self.rt
        mini = tf.init_cache(cfg, n, s, self.cache_dtype, self.device)
        logits = torch.zeros((n, cfg.vocab), dtype=torch.float32,
                             device=self.device)
        for off, c in self._prefill_pieces(s):
            lg, mini = tf.prefill(cfg, self.model,
                                  {"inputs": tokens[:, off:off + c]}, mini,
                                  rt, kv_offset=off, true_len=true_len)
            sel = (true_len - 1 >= off) & (true_len - 1 < off + c)
            logits = torch.where(sel[:, None], lg.to(logits.dtype), logits)
        tf.scatter_cache_slots(cfg, self.caches, mini, slot_ids)
        self._last_logits.index_copy_(0, slot_ids.long(), logits)
        self._finite &= torch.isfinite(logits).all()

    # -- request flow -------------------------------------------------------

    def warmup(self, prompt_len: Union[int, Iterable[int]]) -> float:
        """Deploy-time warmup: serve throwaway full-slot traces for every
        (admission-width power of two, length bucket) these prompt lengths
        produce, plus the decode loops, then reset the counters.  In the
        port this builds the CUDA kernels and brings the library handles
        (cuBLAS) up before the timed traffic.  Returns the seconds spent."""
        t0 = time.perf_counter()
        lens = (prompt_len,) if isinstance(prompt_len, int) else prompt_len
        buckets = sorted({self._bucket(max(1, min(p, self.max_len - 1)))
                          for p in lens})
        counts = {self.slots} | {
            1 << i for i in range((self.slots - 1).bit_length())}
        for b in buckets:
            plen = min(b, self.max_len - 1)
            for count in sorted(counts, reverse=True):
                for i in range(count):
                    self.submit(Request(rid=-1 - i,
                                        prompt=np.zeros((plen,), np.int32),
                                        max_new_tokens=self.decode_chunk))
                self.run()
        for k in self.stats:
            self.stats[k] = 0
        return time.perf_counter() - t0

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} needs at least one free "
                f"cache slot for decode (max_len={self.max_len})")
        req._t_submit = time.perf_counter()
        self.queue.append(req)

    @staticmethod
    def _resume_tokens(req: Request) -> np.ndarray:
        if req.generated:
            return np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated, np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _admit(self) -> None:
        """Fill free slots from the queue; one batched prefill dispatch per
        length bucket, in ascending bucket order."""
        admitted: list[tuple[int, Request, np.ndarray]] = []
        for i in range(self.slots):
            if self.active[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.active[i] = req
            admitted.append((i, req, self._resume_tokens(req)))
        if not admitted:
            return
        by_group: dict[tuple[int, int], list] = {}
        for slot, req, tokens in admitted:
            key = (0, self._bucket(len(tokens)))
            by_group.setdefault(key, []).append((slot, req, tokens))
        for (_, sb), group in sorted(by_group.items()):
            # pad the group to the next power of two (duplicate rows write
            # the same data twice): bounded shapes per bucket
            width = next_pow2(len(group))
            padded = group + [group[-1]] * (width - len(group))
            slot_ids = np.array([g[0] for g in padded], np.int32)
            true_len = np.array([len(g[2]) for g in padded], np.int32)
            toks = np.zeros((len(padded), sb), np.int32)
            for r, (_, _, t) in enumerate(padded):
                toks[r, :len(t)] = t
            self._prefill_into_slots(
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(slot_ids).to(self.device),
                torch.from_numpy(true_len).to(self.device))
            self.stats["prefill_dispatches"] += 1
            for slot, req, tokens in group:
                s = len(tokens)
                self.stats["tokens_prefilled"] += s
                self.kv_len[slot] = s
                budget = req.max_new_tokens - len(req.generated)
                # ≥1 token always, bounded by the request and the cache
                self.remaining[slot] = min(
                    budget, max(1, self.max_len - 1 - s))
        self._sync_live_peak()

    def _sync_live_peak(self) -> None:
        self.stats["peak_live_tokens"] = max(
            self.stats["peak_live_tokens"], int(self.kv_len.sum()))

    def _decode_chunk(self) -> None:
        """One fused dispatch: up to ``decode_chunk`` tokens for every
        active slot, then harvest + retire finished requests."""
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return
        if any(not self.active[i].generated for i in act):
            # freshly admitted slot: one step first, so its first token
            # reaches the host at once (TTFT is a first-token latency)
            n = 1
        else:
            n = self.decode_chunk
        rem_before = self.remaining.copy()
        toks, self.caches, kv_len, self._last_logits, remaining, steps = \
            tf.decode_loop(
                self.cfg, self.model, self.caches,
                torch.from_numpy(self.kv_len).to(self.device),
                self._last_logits,
                torch.from_numpy(self.remaining).to(self.device),
                n_steps=n, rt=self.rt, temperature=self.temperature,
                generator=self.generator, host_remaining=self.remaining)
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += int(steps)
        self._finite &= torch.isfinite(self._last_logits).all()

        toks = toks.cpu().numpy()                     # [n, slots]; one sync
        now = time.perf_counter()
        self.kv_len = kv_len.cpu().numpy().astype(np.int32)
        self.remaining = remaining.cpu().numpy().astype(np.int32)
        self._sync_live_peak()
        for i in act:
            req = self.active[i]
            take = int(min(n, rem_before[i]))
            if take > 0:
                if not req.generated and req.ttft is None:
                    req.ttft = now - getattr(req, "_t_submit", now)
                req.generated.extend(int(t) for t in toks[:take, i])
                self.stats["tokens_decoded"] += take
            if self.remaining[i] <= 0:
                req.done = True
                self.active[i] = None
                self.kv_len[i] = 0

    def step(self) -> None:
        """Admit waiting requests, then run one fused decode dispatch."""
        self._admit()
        self._decode_chunk()

    def run(self, max_steps: int = 1000) -> None:
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1

    # -- accounting ---------------------------------------------------------

    def logits_finite(self) -> bool:
        """True while every prefill's logits and every decode dispatch's
        final logits have been finite (one host sync)."""
        return bool(self._finite.item())

    def memory_stats(self) -> dict:
        """Dense-layout cache accounting (the whole allocation is
        resident)."""
        peak_live = max(1, self.stats["peak_live_tokens"])
        attn = sum(t.numel() * t.element_size()
                   for c in self.caches for t in c["attn"].values())
        return {
            "layout": "dense",
            "resident_cache_bytes": attn,
            "peak_resident_cache_bytes": attn,
            "physical_cache_bytes": attn,
            "ssm_state_bytes": 0,
            "bytes_per_live_token": round(attn / peak_live, 1),
        }
