"""Serving engine: batched bucketed prefill + fused multi-step decode on the
dense or the paged cache layout.

Port of ``repro.serving.ServeEngine`` (both layouts, GQA and MLA models,
MoE, the SSM and hybrid models, speculative decoding).  A fixed set of slots holds requests (continuous
batching); each slot has its own ``kv_len``; decode advances the whole
batch through :func:`transformer.decode_loop`, whose split-K decode
kernels handle the ragged lengths themselves.  Finished slots refill from the queue.

* **Layouts** — ``"dense"``: per-slot ``[slots, max_len]`` rows, admission
  needs a free slot.  ``"paged"``: a page pool with per-slot block tables
  (:mod:`repro_torch.serving.kv_cache`); admission needs a free slot AND
  the prompt's pages, slots grow page by page, and on pool exhaustion the
  youngest slot is preempted back to the queue (recompute: its prompt +
  generated tokens re-prefill on re-admission, which reproduces the
  greedy stream).  With ``prefix_caching`` a completed request's full
  pages enter a token-hash prefix index; later prompts sharing the prefix
  map them at admission and prefill only the tail (``stats``:
  ``prefix_hits`` / ``tokens_reused`` / ``cow_copies``), and greedy
  streams stay identical with the cache on or off.  The paged layout also
  takes ``kv_dtype`` (pages of fp8 e4m3 or int8 codes with fp16 scales),
  ``pool_bytes`` (the full pool sized from a byte budget) and
  ``host_swap_bytes`` (evicted prefix chains demote to host memory and
  promote back on a hit, the copies staged before any COW copy or
  prefill of the admission batch).
* **Batched bucketed prefill** — admitted prompts pad to power-of-two
  length buckets and each (shared-prefix offset, bucket) group runs as
  ONE prefill — dense: over a fresh per-group cache of the bucket's
  length, which then lands in the slot rows
  (:func:`transformer.scatter_cache_slots`); paged: straight into the
  pool through the block tables.  Padded tails are causal-masked; each
  row's logits come from its real last token (``true_len``).  Prompts
  longer than ``prefill_chunk`` run in pieces inside the same dispatch.
* **Fused multi-step decode** — one dispatch advances every slot by up to
  ``decode_chunk`` tokens with on-device sampling and the reference's
  early exit; the first dispatch after an admission runs a single step
  so the reported TTFT is a first-token latency.  On the paged layout
  every slot's pages for the whole chunk are grown before the dispatch,
  so the block tables go to the device once per dispatch.
* **Speculative decoding** (``speculate=k``, greedy only, on models whose
  every layer is global GQA or MLA attention with a dense MLP —
  :func:`speculation_supported`) — an n-gram proposer
  (:mod:`repro_torch.serving.speculate`) drafts up to k tokens per slot
  from the slot's own history and from completed streams, and ONE verify
  dispatch (:func:`transformer.speculative_step`) scores the k + 1 chain
  positions of every slot and commits the accepted prefix, with one host
  sync.  On the paged layout the chain's K/V land in scratch tail pages
  that commit or roll back by block-table surgery.  Greedy streams equal
  the non-speculative engine's.

* **Device-sharded pool** (``mesh=``, a one-axis
  :class:`repro_torch.distributed.sharding.Mesh`, e.g. from
  :func:`repro_torch.launch.mesh.make_mesh`) — the paged pool's page
  arrays split over the mesh's devices along the kv-head / latent-rank
  axis (``shard_axis``), and the paged attention runs per shard; the
  model, the tables and the per-step state stay on ``device``, and greedy
  streams equal the unsharded pool's.  Paged layout only, no speculation,
  and on an MLA model a table width the mesh divides (the reference's
  gates).

The reference donates its cache buffers to each jit'd call; the port
updates the caches in place instead.  ``stats`` counts dispatches and
steps exactly as the reference does, so the two engines can be held to
the same counters on the same trace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.autotune import next_pow2
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime, resolve_device
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.speculate import NGramProposer


def speculation_supported(cfg: ModelConfig) -> bool:
    """True when every layer is global GQA/MLA attention + dense MLP (the
    reference's gate).  A verify dispatch scores the chain against state
    addressed by absolute position: a windowed ring holds only a trailing
    window (a partly rejected chain would leave phantom ring writes), SSM
    state cannot roll back, and MoE expert capacity depends on the chunk
    length, so a P-token verify would route differently than P single
    steps."""
    return all(s.attn in ("gqa", "mla") and s.window is None
               and s.mlp == "dense" and s.ssm is None
               and not s.parallel_ssm
               for s in cfg.layer_specs())


def speculation_refusal(cfg: ModelConfig, k: int, *, temperature: float,
                        sharded: bool = False) -> Optional[str]:
    """Why ``speculate=k`` cannot serve ``cfg`` (on a device-sharded pool
    when ``sharded``), or None: the reference's gates — k >= 1, greedy
    only, an unsharded pool, :func:`speculation_supported`.  The CUDA
    kernels take a verify chain of any length (K2 and K3 up to
    ``CUDA_MAX_ROWS`` folded rows a fiber, 2**31 - 8)."""
    if k < 1:
        return f"need speculate >= 1, got {k}"
    if temperature > 0.0:
        return ("speculative decoding is greedy-only: the accept rule "
                "commits a draft token iff it equals the model's own "
                "argmax, which reproduces the non-speculative stream only "
                "at temperature=0")
    if sharded:
        return ("speculative decoding does not support the device-sharded "
                "pool (mesh=) — the verify kernels run unsharded; drop "
                "mesh= or --speculate")
    if not speculation_supported(cfg):
        return ("speculative decoding needs every layer to be global "
                "GQA/MLA attention with a dense MLP (no sliding windows, "
                "SSM state, or MoE routing — see speculation_supported)")
    return None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    ttft: Optional[float] = None       # seconds, submit → first token known
    preemptions: int = 0               # times bounced back to the queue


class ServeEngine:
    """Continuous-batching engine over a fixed slot count.

    ``stats`` counts device dispatches, decode steps and the paged
    layout's preemptions and prefix reuse like the reference;
    ``memory_stats`` reports cache residency for the layout A/B."""

    def __init__(self, cfg: ModelConfig, model: tf.Model, *, slots: int,
                 max_len: int, rt: Runtime = Runtime(),
                 temperature: float = 0.0, dtype=torch.float32,
                 decode_chunk: int = 16,
                 prefill_chunk: Optional[int] = None,
                 cache_layout: str = "dense",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_caching: bool = True,
                 speculate: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 pool_bytes: Optional[int] = None,
                 host_swap_bytes: int = 0,
                 mesh=None, shard_axis: str = "model",
                 device="cuda",
                 seed: int = 0):
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout: {cache_layout!r}")
        if cache_layout != "paged" and (kv_dtype is not None
                                        or pool_bytes is not None
                                        or host_swap_bytes):
            raise ValueError(
                "kv_dtype / pool_bytes / host_swap_bytes quantize and swap "
                "*pages* — they require cache_layout='paged'")
        shard = None
        if mesh is not None and shard_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh axes {tuple(mesh.axis_names)} have no "
                f"{shard_axis!r} axis to shard the paged pool over — "
                f"pass shard_axis= or build the mesh with a "
                f"{shard_axis!r} axis")
        if mesh is not None and int(mesh.shape[shard_axis]) > 1:
            if cache_layout != "paged":
                raise ValueError(
                    "pool sharding (mesh=) requires cache_layout='paged' — "
                    "the dense layout reserves worst-case rows per slot "
                    "and is not device-sharded")
            shd.validate_kv_shard(cfg, int(mesh.shape[shard_axis]))
            shard = shd.KVShard(devices=mesh.devices, axis=shard_axis)
            # page pools shard; the model and per-step state stay on the
            # engine's device, so every non-paged op is the 1-device one
            rt = dataclasses.replace(rt, kv_shard=shard)
        if cfg.frontend != "tokens":
            raise ValueError(
                f"{cfg.name}: the {cfg.frontend!r} front end takes [B, S, d] "
                f"embeddings; the engine serves token prompts only")
        self.device = resolve_device(device)
        self.spec_k = None
        self.proposer = None
        if speculate is not None:
            k = int(speculate)
            why = speculation_refusal(cfg, k, temperature=temperature,
                                      sharded=shard is not None)
            if why is not None:
                raise ValueError(why)
            self.spec_k = k
            # proposal position 0 guesses the model's *next* token, which
            # the chain takes from the model itself, so k drafts need k + 1
            # proposed positions (propose(...)[1:] is the chain)
            self.proposer = NGramProposer(k=k + 1)
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
        if cache_layout == "paged":
            self.kv = PagedKVCache(cfg, slots, max_len, dtype,
                                   page_size=page_size, num_pages=num_pages,
                                   prefix_caching=prefix_caching,
                                   kv_dtype=kv_dtype, pool_bytes=pool_bytes,
                                   host_swap_bytes=host_swap_bytes,
                                   shard=shard, device=self.device)
            self.caches = self.kv.caches
            # the swap tier copies page contents out at demotion time: hand
            # it the engine's live cache list
            self.kv.cache_source = lambda: self.caches
            if shard is not None and any(
                    s.attn == "mla" for s in cfg.layer_specs()):
                w = self.kv.classes["full"].table_width
                if w % shard.size:
                    raise ValueError(
                        f"MLA rank-sharded decode sweeps the block table "
                        f"in contiguous per-device page strips, so the "
                        f"table width {w} (= ceil(max_len/page_size)) "
                        f"must divide by tp={shard.size} — adjust "
                        f"max_len or page_size")
        else:
            self.kv = None
            self.caches = tf.init_cache(cfg, slots, max_len, dtype,
                                        self.device)
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
        self._admit_seq = 0
        self._order = [0] * slots          # admission sequence per slot
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
                            slot_ids: torch.Tensor, true_len: torch.Tensor,
                            off0: int = 0,
                            cached_len: Optional[torch.Tensor] = None
                            ) -> None:
        """One prefill dispatch of ``tokens [n, s]`` (prompt tails padded
        to bucket ``s``) into slot rows ``slot_ids``; each row's last-token
        logits land in ``_last_logits``.  Dense: through a fresh [n, s]
        cache scattered into the rows.  Paged: straight into the pool,
        positions from the group's shared-prefix offset ``off0``, with
        writes below each row's ``cached_len`` dropped."""
        n, s = tokens.shape
        cfg, rt = self.cfg, self.rt
        if self.kv is not None:
            caches = self.caches
            kw = dict(block_tables=self.kv.tables(), slot_ids=slot_ids,
                      cached_len=cached_len)
        else:
            caches = tf.init_cache(cfg, n, s, self.cache_dtype, self.device)
            kw = {}
        logits = torch.zeros((n, cfg.vocab), dtype=torch.float32,
                             device=self.device)
        for piece, c in self._prefill_pieces(s):
            off = off0 + piece
            lg, caches = tf.prefill(cfg, self.model,
                                    {"inputs": tokens[:, piece:piece + c]},
                                    caches, rt, kv_offset=off,
                                    true_len=true_len, **kw)
            sel = (true_len - 1 >= off) & (true_len - 1 < off + c)
            logits = torch.where(sel[:, None], lg.to(logits.dtype), logits)
        if self.kv is None:
            tf.scatter_cache_slots(cfg, self.caches, caches, slot_ids)
        self._last_logits.index_copy_(0, slot_ids.long(), logits)
        self._finite &= torch.isfinite(logits).all()

    # -- request flow -------------------------------------------------------

    def warmup(self, prompt_len: Union[int, Iterable[int]]) -> float:
        """Deploy-time warmup: serve throwaway full-slot traces for every
        (admission-width power of two, length bucket) these prompt lengths
        produce, plus the decode loops, then reset the counters.  In the
        port this builds the CUDA kernels and brings the library handles
        (cuBLAS) up before the timed traffic.  With prefix caching a
        second phase replays identical prompts against a live index, so
        the tail-offset prefill shapes a hit produces (COW resends
        included) run here too; the index is dropped at the end.  Returns
        the seconds spent."""
        t0 = time.perf_counter()
        prefix_was = False
        if self.kv is not None:
            # phase 1 must run the *cold* prefills: with the index live the
            # identical dummy prompts would hit each other
            prefix_was = self.kv.prefix_enabled
            self.kv.prefix_enabled = False
        try:
            lens = (prompt_len,) if isinstance(prompt_len, int) \
                else prompt_len
            buckets = sorted({self._bucket(max(1, min(p, self.max_len - 1)))
                              for p in lens})
            counts = {self.slots} | {
                1 << i for i in range((self.slots - 1).bit_length())}

            def trace(count, plen):
                for i in range(count):
                    self.submit(Request(rid=-1 - i,
                                        prompt=np.zeros((plen,), np.int32),
                                        max_new_tokens=self.decode_chunk))
                self.run()

            for b in buckets:
                plen = min(b, self.max_len - 1)
                for count in sorted(counts, reverse=True):
                    trace(count, plen)
            if prefix_was:
                # phase 2 — tail offsets: two waves per (bucket, width)
                # with the index live (wave 1 registers, wave 2 resends)
                self.kv.prefix_enabled = True
                for b in buckets:
                    plen = min(b, self.max_len - 1)
                    for count in sorted(counts, reverse=True):
                        for _ in range(2):
                            trace(count, plen)
            for k in self.stats:
                self.stats[k] = 0
            if self.kv is not None:
                self.kv.clear_prefix()
                self.kv.reset_peaks()
            if self.proposer is not None:
                # real traffic must not draft from (or get fake acceptance
                # on) the all-zero warmup streams
                self.proposer.clear()
        finally:
            if self.kv is not None:
                self.kv.prefix_enabled = prefix_was
        return time.perf_counter() - t0

    def clear_prefix_cache(self) -> int:
        """Drop every reusable-prefix entry so the pool can drain fully.
        Returns the entries dropped."""
        if self.kv is None:
            return 0
        return self.kv.clear_prefix()

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} needs at least one free "
                f"cache slot for decode (max_len={self.max_len})")
        if self.kv is not None:
            self.kv.validate_request(len(req.prompt) + req.max_new_tokens)
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
        """Fill free slots from the queue.  Dense: admission = a free slot.
        Paged: a free slot AND the prompt's pages (+1 decode token) fit the
        pool; the prompt is first matched against the prefix index and
        only the uncached tail is prefilled.  One batched prefill dispatch
        per (shared-prefix length, tail bucket) group, cold groups first
        so a group that writes fresh prefix pages runs before one that
        reads them."""
        admitted: list = []
        staged_promotes: list = []
        for i in range(self.slots):
            if self.active[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            tokens = self._resume_tokens(req)
            cached, cow_pairs = 0, []
            if self.kv is not None:
                info = self.kv.admit(i, tokens, len(tokens) + 1)
                if info is None:
                    break                # head-of-line waits for pages
                if info["promotes"]:
                    # host→device copies of the matched demoted pages: issue
                    # them now, so they overlap the rest of the admission;
                    # they land before any COW copy or prefill below
                    staged_promotes.extend(
                        self.kv.start_promote(info["promotes"]))
                cached = info["cached_len"]
                cow_pairs = info["cow_pairs"]
                if info["reused"]:
                    self.stats["prefix_hits"] += 1
                    self.stats["tokens_reused"] += info["reused"]
                self.stats["cow_copies"] += len(cow_pairs)
            self.queue.pop(0)
            self.active[i] = req
            self._admit_seq += 1
            self._order[i] = self._admit_seq
            admitted.append((i, req, tokens, cached, cow_pairs))
            if self.proposer is not None:
                # (re-)open the request's draft history with the full
                # resume stream: a preemption replay starts clean
                self.proposer.begin(req.rid, tokens)
        if staged_promotes:
            self.caches = self.kv.apply_promote(self.caches, staged_promotes)
        if not admitted:
            return
        by_group: dict = {}
        for slot, req, tokens, cached, cow_pairs in admitted:
            key = (cached, self._bucket(len(tokens) - cached))
            by_group.setdefault(key, []).append(
                (slot, req, tokens, cached, cow_pairs))
        for (off0, sb), group in sorted(by_group.items()):
            # deferred COW copies land after their source page's writer
            # (an earlier, colder group) and before this group's prefill
            pairs = [p for g in group for p in g[4]]
            if pairs:
                self.caches = self.kv.apply_cow(self.caches, pairs)
            # pad the group to the next power of two (duplicate rows write
            # the same data twice): bounded shapes per bucket
            width = next_pow2(len(group))
            padded = group + [group[-1]] * (width - len(group))
            slot_ids = np.array([g[0] for g in padded], np.int32)
            true_len = np.array([len(g[2]) for g in padded], np.int32)
            cached_len = np.array([g[3] for g in padded], np.int32)
            toks = np.zeros((len(padded), sb), np.int32)
            for r, (_, _, t, co, _cp) in enumerate(padded):
                toks[r, :len(t) - co] = t[co:]
            dev = self.device
            self._prefill_into_slots(
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(slot_ids).to(dev),
                torch.from_numpy(true_len).to(dev), off0,
                torch.from_numpy(cached_len).to(dev)
                if self.kv is not None else None)
            self.stats["prefill_dispatches"] += 1
            for slot, req, tokens, co, _cp in group:
                s = len(tokens)
                self.stats["tokens_prefilled"] += s - co
                self.kv_len[slot] = s
                budget = req.max_new_tokens - len(req.generated)
                # ≥1 token always, bounded by the request and the cache
                self.remaining[slot] = min(
                    budget, max(1, self.max_len - 1 - s))
        self._sync_live_peak()

    def _preempt(self, slot: int) -> None:
        """Bounce a slot back to the head of the queue, releasing its
        pages (recompute preemption — see :meth:`_resume_tokens`)."""
        req = self.active[slot]
        self.kv.release(slot)
        self.active[slot] = None
        self.kv_len[slot] = 0
        self.remaining[slot] = 0
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.insert(0, req)

    def _preempt_candidates(self) -> list:
        """Slots eligible as preemption victims."""
        return [j for j, r in enumerate(self.active) if r is not None]

    def _ensure_pages(self, n: int) -> None:
        """Grow every active slot's pages for an ``n``-step decode chunk,
        oldest slot first; on pool exhaustion the *youngest* active slot is
        preempted (so the oldest always makes progress)."""
        if self.kv is None:
            return
        order = sorted((i for i, r in enumerate(self.active)
                        if r is not None), key=lambda i: self._order[i])
        for i in order:
            while self.active[i] is not None:
                target = int(self.kv_len[i]) + \
                    int(min(n, self.remaining[i]))
                if self.kv.grow(i, target):
                    break
                victim = max(self._preempt_candidates(),
                             key=lambda j: self._order[j])
                self._preempt(victim)

    def _sync_live_peak(self) -> None:
        self.stats["peak_live_tokens"] = max(
            self.stats["peak_live_tokens"], int(self.kv_len.sum()))

    def _decode_chunk(self) -> None:
        """One fused dispatch: up to ``decode_chunk`` tokens for every
        active slot, then harvest + retire finished requests."""
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return
        if self.spec_k is not None and \
                all(self.active[i].generated for i in act):
            # one verify dispatch commits up to k + 1 tokens a slot; when
            # the pool cannot back every slot's draft span, the base loop
            # runs and _ensure_pages applies the usual back-pressure
            if self._spec_step(act):
                return
        if any(not self.active[i].generated for i in act):
            # freshly admitted slot: one step first, so its first token
            # reaches the host at once (TTFT is a first-token latency)
            n = 1
        else:
            n = self.decode_chunk
        self._ensure_pages(n)          # may preempt → recompute the batch
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return
        rem_before = self.remaining.copy()
        toks, self.caches, kv_len, self._last_logits, remaining, steps = \
            tf.decode_loop(
                self.cfg, self.model, self.caches,
                torch.from_numpy(self.kv_len).to(self.device),
                self._last_logits,
                torch.from_numpy(self.remaining).to(self.device),
                n_steps=n, rt=self.rt, temperature=self.temperature,
                generator=self.generator, host_remaining=self.remaining,
                block_tables=None if self.kv is None else self.kv.tables())
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
                got = [int(t) for t in toks[:take, i]]
                req.generated.extend(got)
                self.stats["tokens_decoded"] += take
                if self.proposer is not None:
                    self.proposer.extend(req.rid, got)
            if self.remaining[i] <= 0:
                self._retire(i)

    def _retire(self, i: int) -> None:
        """A slot's request is complete: close its draft history (indexed
        for later requests) and free the slot — its full pages go to the
        prefix index instead of the free list."""
        req = self.active[i]
        req.done = True
        self.active[i] = None
        self.kv_len[i] = 0
        if self.proposer is not None:
            self.proposer.finish(req.rid)
        if self.kv is not None:
            self.kv.release(i, tokens=self._resume_tokens(req))

    def _spec_step(self, act: list) -> bool:
        """One fused speculate→verify→accept dispatch: score a (k + 1)-
        token chain (the model's own next token + the proposer's k drafts)
        per active slot and commit the accepted prefix.

        On the paged layout the chain's K/V land in scratch tail pages
        reserved first (:meth:`PagedKVCache.reserve_draft`); accepting is
        block-table surgery (``commit_draft``), with no K/V copies or
        recompute.  One host sync, on the committed tokens and advances.
        Returns False — nothing dispatched, nothing left staged — when the
        pool cannot back every active slot's draft span even after prefix
        eviction."""
        k = self.spec_k
        p_total = k + 1
        drafts = np.zeros((self.slots, k), np.int32)
        proposed = np.zeros((self.slots,), np.int64)
        for i in act:
            # proposal position 0 guesses the model's next token, which the
            # chain takes from the model: the drafts are the tail; unfilled
            # positions stay 0 (a wrong draft just fails the accept rule)
            d = self.proposer.propose(self.active[i].rid)[1:]
            n = min(len(d), k)
            drafts[i, :n] = d[:n]
            proposed[i] = n
        if self.kv is not None:
            staged, pairs, short = [], [], False
            for i in act:
                span = int(min(p_total, self.remaining[i]))
                res = self.kv.reserve_draft(
                    i, int(self.kv_len[i]), int(self.kv_len[i]) + span)
                if res is None:
                    short = True
                    break
                staged.append(i)
                pairs.extend(res)
            if pairs:
                # a COW pair stands on its own (the slot's reference already
                # moved to the copy), so it applies even when a later slot's
                # reservation fails and the dispatch is abandoned
                self.caches = self.kv.apply_cow(self.caches, pairs)
                self.stats["cow_copies"] += len(pairs)
            if short:
                for i in staged:
                    self.kv.drop_draft(i)
                return False
        dev = self.device
        toks, advance, _, _, self._last_logits, self.caches = \
            tf.speculative_step(
                self.cfg, self.model, self._last_logits,
                torch.from_numpy(drafts).to(dev), self.caches,
                torch.from_numpy(self.kv_len).to(dev),
                torch.from_numpy(self.remaining).to(dev), self.rt,
                block_tables=None if self.kv is None else self.kv.tables())
        self.stats["decode_dispatches"] += 1
        self.stats["spec_dispatches"] += 1
        self.stats["decode_steps"] += 1          # one model evaluation
        self._finite &= torch.isfinite(self._last_logits).all()

        # one sync: the committed chains [P, slots] and their lengths
        host = torch.cat([toks, advance[None]]).cpu().numpy()
        toks, advance = host[:-1], host[-1].astype(np.int32)
        self.kv_len = self.kv_len + advance
        self.remaining = self.remaining - advance
        self._sync_live_peak()
        for i in act:
            req = self.active[i]
            adv = int(advance[i])
            self.stats["spec_proposed"] += int(proposed[i])
            self.stats["spec_accepted"] += max(0, adv - 1)
            if self.kv is not None:
                self.kv.commit_draft(i, int(self.kv_len[i]))
            if adv > 0:
                got = [int(t) for t in toks[:adv, i]]
                req.generated.extend(got)
                self.stats["tokens_decoded"] += adv
                self.proposer.extend(req.rid, got)
            if self.remaining[i] <= 0:
                self._retire(i)
        return True

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
        """Cache accounting for the layout A/B: ``resident_cache_bytes``
        is the whole allocation for the dense layout, the pages live slots
        reference for the paged one."""
        peak_live = max(1, self.stats["peak_live_tokens"])
        if self.kv is not None:
            m = self.kv.memory_stats()
            m["layout"] = "paged"
            m["bytes_per_live_token"] = round(
                m["peak_resident_cache_bytes"] / peak_live, 1)
            m["prefix_cache"].update(
                hits=self.stats["prefix_hits"],
                tokens_reused=self.stats["tokens_reused"],
                cow_copies=self.stats["cow_copies"])
            return m
        # as the paged accounting: attention caches apart from the O(slots)
        # SSM state, so the layout A/B compares like with like
        attn, ssm = (sum(t.numel() * t.element_size()
                         for c in self.caches
                         for t in c.get(part, {}).values())
                     for part in ("attn", "ssm"))
        return {
            "layout": "dense",
            "resident_cache_bytes": attn,
            "peak_resident_cache_bytes": attn,
            "physical_cache_bytes": attn,
            "ssm_state_bytes": ssm,
            "bytes_per_live_token": round(attn / peak_live, 1),
        }
