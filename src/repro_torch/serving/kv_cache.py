"""Paged KV cache: page pool + per-slot block tables + automatic prefix
cache.

Port of ``repro.serving.kv_cache`` for the unsharded pool, quantized
pages and the host swap tier included.
The host side (free lists, refcounts, block tables, the prefix index) is
Python and numpy as in the reference, line for line where it can be, so
the same admit / grow / release sequence gives the same tables and
counters; the page arrays are torch tensors on the engine's device.

    layer storage (device, one per layer)     block table (host numpy,
    [P + 1, page_size, Hkv, dh]               one per capacity class,
                                              shared by all its layers)
    page p holds tokens of whichever slot     slot 0: [ 3, 7, 1, P]
    maps it; page P is the sink that takes    slot 1: [ 0, 4, P, P]
    masked writes (never read)

  An MLA layer stores latents instead — ``[P + 1, page_size, r]`` and
  ``[P + 1, page_size, rd]`` — in the "full" class, as the reference
  does.

* A slot's table grows a page at a time (:meth:`PagedKVCache.grow`);
  unbacked entries hold the sentinel id ``P`` (reads clamp to ``P - 1``
  and are masked by kv_len; writes go to the sink page).
* Prefix caching: pages are refcounted, and a chained hash over each full
  page of tokens indexes them.  :meth:`PagedKVCache.admit` maps the
  longest indexed prefix of a prompt into the slot's table and only the
  tail is prefilled; a completed slot's full pages are registered into
  the index instead of freed, and index-only pages are dropped LRU when
  the pool runs short.  A shared page is never written: the one page a
  tail prefill could touch (a prompt exactly covered by its hit) is
  copied first (:meth:`PagedKVCache.apply_cow`).
* Quantized pages (``kv_dtype`` "fp8_e4m3" / "int8"): every layer's pages
  hold codes with fp16 scale pools beside them
  (:func:`repro_torch.model.attention.gqa_init_paged_cache`), and a page
  costs its honest bytes, codes plus scales; ``pool_bytes`` sizes the
  full class from a byte budget, so a quantized pool gets about 3.9x the
  pages of an fp32 one.
* The host swap tier (``host_swap_bytes``): under pool pressure the
  prefix index *demotes* an evicted chain to host memory instead of
  dropping it — each page's contents across every full-class layer (codes
  and scales as they are) copied into one pinned host buffer of its bytes,
  one device→host copy per page after one gather on the device — up to the
  byte cap, dropping LRU demoted chains to make room (HBM → host → drop).
  A later prefix hit on a demoted chain promotes it back into fresh pool
  pages with non-blocking host→device copies on the current stream (a
  copy instead of a recompute): :meth:`PagedKVCache.start_promote` issues
  them during admission, :meth:`PagedKVCache.apply_promote` keeps the host
  buffers alive until the copies complete.  The engine wires
  ``cache_source`` to its live caches.
* Speculative drafts: a verify dispatch writes its chain's K/V into
  *scratch* tail pages mapped after the slot's owned pages
  (:meth:`PagedKVCache.reserve_draft`, copy-on-write of a shared boundary
  page included); :meth:`PagedKVCache.commit_draft` promotes the scratch
  pages the accepted tokens cover into the owned set and drops the rest,
  :meth:`PagedKVCache.drop_draft` drops them all — block-table surgery,
  no K/V copies.  Scratch pages never enter the prefix index and are
  drained by ``release`` (preemption).

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
the device-sharded pool (``shard``) — item 8.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.model import transformer as tf
from repro_torch.model.attention import kv_quant_dtype, paged_cache_key
from repro_torch.model.layers import resolve_device


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


_SHARD = "§1 item 8, device-sharded pool"


class PagePool:
    """Host-side refcounting free-list allocator over a fixed page count.

    Freed pages are recycled LIFO.  Every allocated page carries a
    reference count (1 at ``alloc``); ``ref``/``unref`` let several owners
    (table rows of different slots, the prefix index) share one page, and
    the page returns to the free list when the last reference drops.
    Freeing a page that is not allocated (double free) or still shared
    raises."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refcount: Dict[int, int] = {}
        self.peak_in_use = 0

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1), or None (and no change) if the
        pool can't."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._refcount[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return got

    def free(self, pages: List[int]) -> None:
        """Return pages to the free list.  Raises on a double free or on
        freeing a still-shared page."""
        for p in pages:
            rc = self._refcount.get(p)
            if rc is None:
                raise RuntimeError(
                    f"double free: page {p} is not allocated")
            if rc > 1:
                raise RuntimeError(
                    f"freeing shared page {p} (refcount {rc}); "
                    f"drop references with unref() instead")
            del self._refcount[p]
            self._free.append(p)

    def ref(self, page: int) -> None:
        """Add a reference to an allocated page."""
        if page not in self._refcount:
            raise RuntimeError(f"ref of unallocated page {page}")
        self._refcount[page] += 1

    def unref(self, page: int) -> bool:
        """Drop one reference; the page is freed when the count reaches
        zero.  Returns True if the page was freed."""
        rc = self._refcount.get(page)
        if rc is None:
            raise RuntimeError(f"unref of unallocated page {page}")
        if rc <= 1:
            self.free([page])
            return True
        self._refcount[page] = rc - 1
        return False

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)


@dataclasses.dataclass
class _CacheClass:
    """One capacity class: its pool, block table, and accounting."""
    capacity: int                    # logical tokens before wrap
    table_width: int                 # pages per slot
    pool: PagePool
    table: np.ndarray                # [slots, table_width] int32 page ids
    owned: List[List[int]]           # per-slot pages, logical order
    bytes_per_page: int              # across every layer of the class
    peak_live_pages: int = 0         # distinct pages referenced by slots
    # per-slot speculative scratch tail pages: mapped into the table rows
    # after ``owned`` while a draft is in flight, promoted into ``owned``
    # by commit_draft or unref'd by drop_draft / release — never registered
    # in the prefix index, never counted as resident
    scratch: List[List[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PrefixEntry:
    """One full page of the prefix index.  ``key`` (its dict key) is the
    chained hash of every token up to and including this page;
    ``parent`` is the previous page's chain hash (None at depth 0).  The
    index holds its own pool reference on ``page``.

    With the host swap tier an entry may be *demoted*: ``page == -1`` and
    ``host`` holds the page's contents in host memory (one flat byte
    buffer of the page's ``bytes_per_page``: every full-class layer leaf's
    page in :meth:`PagedKVCache._full_leaves` order).  A demoted entry
    stays matchable; a prefix hit promotes it back into a fresh pool
    page."""
    page: int
    parent: Optional[int]
    last_used: int
    host: Optional[list] = None


class PagedKVCache:
    """Page-pool KV cache for the serving engine (``cache_layout="paged"``).

    ``caches`` is the per-layer list of page pools the model threads
    through prefill and decode (built by ``transformer.init_paged_cache``
    on ``device``: CUDA unless the caller passes "cpu"), and ``tables()``
    uploads the block tables for one
    dispatch.  ``num_pages`` sizes the *full* class pool; the default
    equals the dense layout's capacity (``slots × max_len / page_size``
    pages) — shrink it to serve in less memory, at the cost of admission
    back-pressure and (worst case) preemption.  ``kv_dtype`` stores the
    pages quantized, ``pool_bytes`` sizes the full class from a byte
    budget instead, and ``host_swap_bytes`` turns on the host swap tier
    (it needs the prefix cache)."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, dtype,
                 *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_caching: bool = True,
                 shard=None,
                 kv_dtype: Optional[str] = None,
                 pool_bytes: Optional[int] = None,
                 host_swap_bytes: int = 0,
                 device="cuda"):
        if shard is not None:
            raise _not_ported("the device-sharded pool (shard=)", _SHARD)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"page_size={page_size}")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.device = resolve_device(device)

        # capacity classes; the scale elems are a quantized pool's fp16
        # scale-pool entries (one per token and kv head for GQA, one per
        # latent and one per rope vector for MLA)
        caps: Dict[str, int] = {}
        per_layer_page_elems: Dict[str, int] = {}
        per_layer_scale_elems: Dict[str, int] = {}
        has_ssm = has_moe = False
        for spec in cfg.layer_specs():
            if spec.mlp == "moe":
                has_moe = True
            if spec.attn == "gqa":
                key = paged_cache_key(spec)
                caps[key] = spec.window if spec.window is not None \
                    else max_len
                per_layer_page_elems[key] = per_layer_page_elems.get(key, 0) \
                    + 2 * page_size * cfg.n_kv_heads * cfg.dh
                per_layer_scale_elems[key] = \
                    per_layer_scale_elems.get(key, 0) \
                    + 2 * page_size * cfg.n_kv_heads
            elif spec.attn == "mla":
                # one latent [r] and one shared rope key [rd] per token
                caps["full"] = max_len
                per_layer_page_elems["full"] = \
                    per_layer_page_elems.get("full", 0) + page_size * (
                        cfg.mla.kv_lora_rank + cfg.mla.rope_dim)
                per_layer_scale_elems["full"] = \
                    per_layer_scale_elems.get("full", 0) + 2 * page_size
            if spec.ssm is not None:
                has_ssm = True

        qdt = kv_quant_dtype(kv_dtype)
        self.kv_dtype = kv_dtype
        itemsize = torch.empty((), dtype=dtype if qdt is None
                               else qdt).element_size()
        self.classes: Dict[str, _CacheClass] = {}
        pool_sizes: Dict[str, int] = {}
        for key, cap in caps.items():
            width = _ceil_div(cap, page_size)
            # honest per-page bytes: the codes plus their fp16 scales
            bpp = per_layer_page_elems[key] * itemsize
            if qdt is not None:
                bpp += per_layer_scale_elems[key] * 2
            if key == "full" and pool_bytes is not None:
                # byte-budget sizing: a quantized pool gets ~3.9x the pages
                # of an fp32 one from the same budget
                n = max(1, pool_bytes // bpp)
            elif key == "full" and num_pages is not None:
                n = num_pages
            else:
                n = slots * width            # dense-equivalent capacity
            pool_sizes[key] = n
            self.classes[key] = _CacheClass(
                capacity=cap,
                table_width=width,
                pool=PagePool(n),
                # sentinel-filled: an out-of-range id on every row that is
                # not backed by an owned page
                table=np.full((slots, width), n, np.int32),
                owned=[[] for _ in range(slots)],
                bytes_per_page=bpp,
                scratch=[[] for _ in range(slots)],
            )

        # prefix reuse needs every class addressed from position zero and
        # every layer position-local (see the reference module)
        self.prefix_supported = (not has_ssm) and (not has_moe) \
            and set(caps) <= {"full"}
        self.prefix_enabled = bool(prefix_caching) and self.prefix_supported
        self._prefix: Dict[int, _PrefixEntry] = {}
        self._prefix_tick = 0
        self.stats = {"prefix_evictions": 0, "demotions": 0,
                      "promotions": 0, "host_drops": 0, "reregistered": 0}

        # host swap tier: index-only prefix pages demote to host memory (up
        # to host_swap_bytes) instead of dropping, and promote back on a
        # hit.  ``cache_source`` (the owner's live cache list) must be wired
        # before demotion can copy page contents; without it eviction is
        # the plain LRU drop.  ``swap_ms`` accumulates the host time of
        # demotions and promotions.
        self.host_swap_bytes = int(host_swap_bytes)
        self.swap_enabled = self.host_swap_bytes > 0 and self.prefix_enabled
        self._host_bytes = 0
        self.cache_source = None
        self._inflight: list = []          # (event, host buffers) of copies
        self.swap_ms = {"demote": 0.0, "promote": 0.0}

        self.caches = tf.init_paged_cache(cfg, slots, pool_sizes, page_size,
                                          dtype, self.device, kv_dtype)
        # the pools as the reference sizes them: the sink pages are the
        # port's drop target, not pool capacity
        self._physical_page_bytes = sum(
            c.pool.num_pages * c.bytes_per_page
            for c in self.classes.values())
        self._state_bytes = 0               # SSM slot state: not ported

    # -- allocation ---------------------------------------------------------

    def _sentinel(self, c: _CacheClass) -> int:
        return c.pool.num_pages

    def pages_needed(self, key: str, kv_target: int) -> int:
        c = self.classes[key]
        return _ceil_div(min(kv_target, c.capacity), self.page_size)

    def validate_request(self, total_tokens: int) -> None:
        """Reject a request no pool could ever hold alone — the engine's
        progress guarantee (preempt-youngest) needs any single request to
        fit an otherwise-empty pool."""
        for key, c in self.classes.items():
            need = self.pages_needed(key, min(total_tokens, self.max_len))
            if need > c.pool.num_pages:
                raise ValueError(
                    f"request needs {need} '{key}' pages but the pool has "
                    f"only {c.pool.num_pages}; raise num_pages or shorten "
                    f"the request")

    def _evictable_pages(self, key: str, c: _CacheClass) -> int:
        if key != "full" or not self.prefix_enabled:
            return 0
        return sum(1 for e in self._prefix.values()
                   if e.page >= 0 and c.pool.refcount(e.page) == 1)

    def can_grow(self, slot: int, kv_target: int) -> bool:
        return all(
            self.pages_needed(k, kv_target) - len(c.owned[slot])
            <= c.pool.free_pages + self._evictable_pages(k, c)
            for k, c in self.classes.items())

    def grow(self, slot: int, kv_target: int) -> bool:
        """Extend ``slot``'s tables to cover ``kv_target`` tokens in every
        class.  All-or-nothing: returns False (state unchanged) when any
        pool is short even after evicting reusable-prefix pages."""
        if any(c.scratch[slot] for c in self.classes.values()):
            raise RuntimeError(
                f"grow of slot {slot} with a staged draft: commit or drop "
                f"the draft first (its table rows overlap the growth)")
        if not self.can_grow(slot, kv_target):
            return False
        for key, c in self.classes.items():
            need = self.pages_needed(key, kv_target)
            have = len(c.owned[slot])
            if need > have:
                if need - have > c.pool.free_pages:
                    self._evict_prefix(c, need - have)
                got = c.pool.alloc(need - have)
                c.table[slot, have:need] = got
                c.owned[slot].extend(got)
        self._touch_peaks()
        return True

    def release(self, slot: int,
                tokens: Optional[np.ndarray] = None) -> None:
        """Drop every page reference the slot owns and reset its table
        rows to the sentinel.  With ``tokens`` (the slot's full token
        stream, completion path) the slot's full pages are first
        registered into the prefix index, which takes its own reference.
        A staged draft is drained first (the preemption contract: in-flight
        scratch pages are unref'd before the request requeues, and never
        reach the prefix index)."""
        self.drop_draft(slot)
        if tokens is not None and self.prefix_enabled:
            c = self.classes["full"]
            if c.owned[slot]:
                hashes = self._chain_hashes(tokens)
                if len(tokens) % self.page_size == 0 and hashes:
                    # a page-aligned stream ends in its last full page, and
                    # the fused decode loop's masked steps for a finished
                    # slot rewrite that position with the dummy token's
                    # K/V: never index that page
                    hashes = hashes[:-1]
                self._register(hashes[:len(c.owned[slot])], c.owned[slot])
        for c in self.classes.values():
            for p in c.owned[slot]:
                c.pool.unref(p)
            c.owned[slot] = []
            c.table[slot] = self._sentinel(c)

    def tables(self) -> Dict[str, torch.Tensor]:
        """Device block tables for one dispatch (one small int32 upload
        per class).  Asserts the sentinel invariant: a live table row
        (owned page or staged draft scratch) never holds the sentinel —
        only unbacked rows do."""
        for k, c in self.classes.items():
            for slot, owned in enumerate(c.owned):
                live = len(owned) + len(c.scratch[slot])
                if live and int(c.table[slot, :live].max()) \
                        >= c.pool.num_pages:
                    raise AssertionError(
                        f"class '{k}' slot {slot}: live block-table row "
                        f"holds the sentinel page")
        # a copy, also on the CPU: the dispatch must not see later edits
        return {k: torch.tensor(c.table, device=self.device)
                for k, c in self.classes.items()}

    # -- speculative drafts -------------------------------------------------

    def reserve_draft(self, slot: int, kv_len: int, kv_target: int
                      ) -> Optional[List[Tuple[str, int, int]]]:
        """Stage scratch pages so chain positions ``[kv_len, kv_target)``
        are writable: the draft's K/V lands in tail pages mapped into the
        slot's table rows *after* its owned pages, so a rejected draft
        rolls back by dropping references — no K/V copies.

        Owned boundary pages the draft would write (the partly filled last
        page, when shared with the prefix index or another slot) are
        copied on write as in :meth:`admit`: the returned pairs go through
        :meth:`apply_cow` before the verify dispatch.  All-or-nothing:
        returns None (state unchanged) when any pool is short even after
        LRU prefix eviction (which demotes to the host swap tier where it
        has room).  Scratch pages never enter the prefix index until
        :meth:`commit_draft` promotes them into ``owned``."""
        if any(c.scratch[slot] for c in self.classes.values()):
            raise RuntimeError(f"slot {slot} already has a staged draft")
        ps = self.page_size
        plan: Dict[str, Tuple[int, List[int]]] = {}
        for key, c in self.classes.items():
            need = self.pages_needed(key, kv_target)
            have = len(c.owned[slot])
            n_scratch = max(0, need - have)
            first = min(kv_len, c.capacity) // ps
            cow_idx = [i for i in range(first, have)
                       if c.pool.refcount(c.owned[slot][i]) > 1]
            plan[key] = (n_scratch, cow_idx)
            fresh = n_scratch + len(cow_idx)
            if fresh > c.pool.free_pages + self._evictable_pages(key, c):
                return None
        pairs: List[Tuple[str, int, int]] = []
        for key, c in self.classes.items():
            n_scratch, cow_idx = plan[key]
            fresh = n_scratch + len(cow_idx)
            if fresh > c.pool.free_pages:
                self._evict_prefix(c, fresh)
            for i in cow_idx:
                src = c.owned[slot][i]
                dst = c.pool.alloc(1)[0]
                # the slot's reference on src moves to the pair (apply_cow
                # unrefs it); the slot owns the copy target
                pairs.append((key, src, dst))
                c.owned[slot][i] = dst
                c.table[slot, i] = dst
            got = c.pool.alloc(n_scratch)
            have = len(c.owned[slot])
            c.table[slot, have:have + n_scratch] = got
            c.scratch[slot] = got
        return pairs

    def commit_draft(self, slot: int, kv_len_new: int) -> None:
        """Accept a draft prefix by block-table surgery: the scratch pages
        covering ``kv_len_new`` tokens are promoted into ``owned`` (their
        single reference moves — no copy), the rejected tail's pages drop
        their references, and rows past the new extent reset to the
        sentinel."""
        for c in self.classes.values():
            need = _ceil_div(min(kv_len_new, c.capacity), self.page_size)
            keep = max(0, need - len(c.owned[slot]))
            if keep > len(c.scratch[slot]):
                raise RuntimeError(
                    f"commit of {kv_len_new} tokens needs {keep} scratch "
                    f"pages but slot {slot} staged "
                    f"{len(c.scratch[slot])}")
            kept, dropped = c.scratch[slot][:keep], c.scratch[slot][keep:]
            c.owned[slot].extend(kept)
            for p in dropped:
                c.pool.unref(p)
            c.scratch[slot] = []
            c.table[slot, len(c.owned[slot]):] = self._sentinel(c)
        self._touch_peaks()

    def drop_draft(self, slot: int) -> None:
        """Roll back a staged draft entirely: unref every scratch page and
        reset its table rows (the preemption path through
        :meth:`release`).  Idempotent."""
        for c in self.classes.values():
            if not c.scratch[slot]:
                continue
            for p in c.scratch[slot]:
                c.pool.unref(p)
            c.scratch[slot] = []
            c.table[slot, len(c.owned[slot]):] = self._sentinel(c)

    # -- prefix cache -------------------------------------------------------

    def _tick(self) -> int:
        self._prefix_tick += 1
        return self._prefix_tick

    def _chain_hashes(self, tokens) -> List[int]:
        """Chained hashes over the *full* pages of a token stream: entry i
        hashes (parent chain, page i's tokens), so equal chain hash ⇒
        equal token prefix (modulo 64-bit hash collisions, the standard
        prefix-cache trade)."""
        ps = self.page_size
        hashes: List[int] = []
        parent: Optional[int] = None
        for i in range(len(tokens) // ps):
            h = hash((parent,
                      tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])))
            hashes.append(h)
            parent = h
        return hashes

    def _register(self, hashes: List[int], row: List[int]) -> None:
        """Insert chain entries for pages not yet indexed; the index takes
        a reference on each inserted page.  Existing entries win (their
        content is hash-equal), so duplicate prefills dedupe here."""
        for i, h in enumerate(hashes):
            e = self._prefix.get(h)
            if e is not None:
                if e.page < 0 and i < len(row):
                    # a fresh prefill just rebuilt this demoted page on the
                    # device: point the entry at the resident copy and drop
                    # the host copy (no transfer; the recompute happened)
                    self.classes["full"].pool.ref(row[i])
                    e.page = row[i]
                    e.host = None
                    self._host_bytes -= self.classes["full"].bytes_per_page
                    self.stats["reregistered"] += 1
                e.last_used = self._tick()
                continue
            self.classes["full"].pool.ref(row[i])
            self._prefix[h] = _PrefixEntry(
                page=row[i], parent=hashes[i - 1] if i else None,
                last_used=self._tick())

    def _full_leaves(self, caches: list) -> List[torch.Tensor]:
        """Every full-class layer leaf of ``caches`` (data pools and, when
        quantized, scale pools), in the order host copies keep: layer
        order, then sorted leaf names."""
        return [c["attn"][name]
                for spec, c in zip(self.cfg.layer_specs(), caches)
                if paged_cache_key(spec) == "full"
                for name in sorted(c["attn"])]

    def _page_blobs(self, pages: List[int]) -> List[torch.Tensor]:
        """Copy pages to host memory: per page one flat byte buffer of its
        ``bytes_per_page`` (pinned on a CUDA pool) holding every
        full-class leaf's page in :meth:`_full_leaves` order.  One indexed
        read per leaf and one ``torch.cat`` lay the pages out on the
        device, then one non-blocking device→host copy per page on the
        current stream.  No host code reads the buffers: the stream orders
        the copies before any later write of the freed pages and before
        the promotion that copies them back."""
        leaves = self._full_leaves(self.cache_source())
        pinned = self.device.type == "cuda"
        idx = torch.tensor(pages, device=self.device)
        n = len(pages)
        flat = torch.cat([a[idx].reshape(n, -1).view(torch.uint8)
                          for a in leaves], dim=1)
        return [torch.empty(row.shape, dtype=torch.uint8,
                            pin_memory=pinned).copy_(row, non_blocking=pinned)
                for row in flat]

    def _drop_subtree(self, c: _CacheClass, root: int) -> None:
        """Drop an index entry and every descendant (they are matchable
        only through it): resident pages drop the index's reference, host
        copies release their swap-tier bytes."""
        stack = [root]
        while stack:
            h = stack.pop()
            e = self._prefix.pop(h, None)
            if e is None:
                continue
            stack.extend(h2 for h2, e2 in self._prefix.items()
                         if e2.parent == h)
            if e.page >= 0:
                c.pool.unref(e.page)
                self.stats["prefix_evictions"] += 1
            else:
                self._host_bytes -= c.bytes_per_page
                self.stats["host_drops"] += 1

    def _host_make_room(self, c: _CacheClass, bytes_needed: int,
                        exclude: frozenset) -> bool:
        """The last rung of HBM → host → drop: drop LRU demoted chains
        until ``bytes_needed`` more bytes fit under the host byte cap."""
        while self._host_bytes + bytes_needed > self.host_swap_bytes:
            victim = None
            for h, e in self._prefix.items():
                if h in exclude or e.page >= 0:
                    continue
                if victim is None or \
                        e.last_used < self._prefix[victim].last_used:
                    victim = h
            if victim is None:
                return False
            self._drop_subtree(c, victim)
        return True

    def _evict_prefix(self, c: _CacheClass, need: int,
                      protect: frozenset = frozenset()) -> bool:
        """Free index-only pages (LRU) until ``need`` pages are free.
        Evicting an entry takes its whole subtree along; entries in
        ``protect`` (the chain an in-flight admission just matched) are
        never chosen as victims.  With the host swap tier the subtree's
        resident pages are *demoted* (copied to host memory, entries kept
        with ``page = -1``) when they fit under the host cap after
        dropping LRU demoted chains, and dropped otherwise."""
        while c.pool.free_pages < need:
            victim = None
            for h, e in self._prefix.items():
                if h in protect or e.page < 0:
                    continue
                if c.pool.refcount(e.page) == 1 and (
                        victim is None
                        or e.last_used < self._prefix[victim].last_used):
                    victim = h
            if victim is None:
                return False
            stack, subtree = [victim], []
            while stack:
                h = stack.pop()
                if h not in self._prefix or h in subtree:
                    continue
                subtree.append(h)
                stack.extend(h2 for h2, e2 in self._prefix.items()
                             if e2.parent == h)
            resident = [h for h in subtree if self._prefix[h].page >= 0]
            demote = (self.swap_enabled and self.cache_source is not None
                      and self._host_make_room(
                          c, len(resident) * c.bytes_per_page,
                          exclude=protect | frozenset(subtree)))
            if demote:
                t0 = time.perf_counter()
                blobs = self._page_blobs(
                    [self._prefix[h].page for h in resident])
                for h, host in zip(resident, blobs):
                    e = self._prefix[h]
                    e.host = host
                    c.pool.unref(e.page)
                    e.page = -1
                    self._host_bytes += c.bytes_per_page
                    self.stats["demotions"] += 1
                self.swap_ms["demote"] += (time.perf_counter() - t0) * 1e3
            else:
                self._drop_subtree(c, victim)
        return True

    def clear_prefix(self) -> int:
        """Drop every index entry (e.g. after engine warmup, or to drain
        the pool), the host swap tier's demoted entries too.  Returns the
        number of entries dropped."""
        n = len(self._prefix)
        c = self.classes.get("full")
        for e in self._prefix.values():
            if e.page >= 0:
                c.pool.unref(e.page)
        self._prefix.clear()
        self._host_bytes = 0
        return n

    def _match(self, hashes: List[int]) -> int:
        m = 0
        for h in hashes:
            if h not in self._prefix:
                break
            m += 1
        return m

    def match_prefix(self, tokens) -> int:
        """Longest indexed prefix of ``tokens``, in full pages."""
        return self._match(self._chain_hashes(tokens))

    def register_progress(self, slot: int, tokens, upto: int) -> None:
        """Index the slot's prompt pages that are fully *written* —
        positions [0, upto) have been prefilled.  Idempotent."""
        if not self.prefix_enabled:
            return
        c = self.classes["full"]
        n = min(int(upto), len(tokens)) // self.page_size
        if n <= 0 or n > len(c.owned[slot]):
            return
        hashes = self._chain_hashes(tokens[:n * self.page_size])
        self._register(hashes, c.owned[slot][:n])

    def admit(self, slot: int, tokens, kv_target: int,
              register: bool = True) -> Optional[dict]:
        """Build ``slot``'s block table for a request: map the longest
        indexed prefix (shared pages, one reference each), schedule a COW
        copy of the single page a tail prefill could write into (only when
        the prompt is exactly page-aligned with the hit — at least one
        token is always re-prefilled so decode has last-token logits),
        allocate fresh pages for the rest, and pre-register the prompt's
        full pages so admissions later in the same batch can share them
        (the engine dispatches cold groups first, so writers precede
        readers).

        The COW copy is *deferred*: the engine calls :meth:`apply_cow` with
        the returned ``cow_pairs`` after every earlier group has
        dispatched and before this slot's own prefill.

        All-or-nothing: returns None (state unchanged) when the pool is
        short even after LRU eviction; otherwise ``{"cached_len",
        "reused", "cow_pairs", "promotes"}``.

        When the matched chain ends in demoted entries (host swap tier),
        each gets a fresh pool page and ``promotes`` lists ``(dst_page,
        host copy)``: the engine passes them to :meth:`start_promote` and
        :meth:`apply_promote` before any COW copy or prefill reads them.
        If the pool cannot hold the promotions even after eviction, the
        match falls back to the resident prefix."""
        if not self.prefix_enabled:
            if not self.grow(slot, kv_target):
                return None
            return {"cached_len": 0, "reused": 0, "cow_pairs": [],
                    "promotes": []}

        c = self.classes["full"]
        if c.owned[slot] or c.scratch[slot]:
            raise RuntimeError(f"admit into non-empty slot {slot}")
        n_tok = len(tokens)
        hashes = self._chain_hashes(tokens)
        m = self._match(hashes)
        # demotion is subtree-wise, so the demoted part of the matched
        # chain is a contiguous tail after the resident prefix
        n_res = 0
        while n_res < m and self._prefix[hashes[n_res]].page >= 0:
            n_res += 1
        n_dem = 0
        while n_res + n_dem < m and \
                self._prefix[hashes[n_res + n_dem]].page < 0:
            n_dem += 1
        m = n_res + n_dem
        need_width = self.pages_needed("full", kv_target)
        while True:
            cow = m > 0 and m * self.page_size == n_tok
            cached_len = n_tok - 1 if cow else m * self.page_size
            fresh = need_width - m + (1 if cow else 0)
            if fresh + n_dem <= c.pool.free_pages or self._evict_prefix(
                    c, fresh + n_dem, protect=frozenset(hashes[:m])):
                break
            if n_dem:
                # no room to promote the demoted tail: fall back to the
                # resident prefix (the tail stays on the host tier)
                m, n_dem = n_res, 0
                continue
            return None
        prom = c.pool.alloc(n_dem) if n_dem else []
        got = c.pool.alloc(fresh)
        if got is None or prom is None:      # pragma: no cover - guarded
            return None
        promotes = []
        for j, h in enumerate(hashes[n_res:m]):
            e = self._prefix[h]
            e.page = prom[j]                 # alloc's reference becomes
            promotes.append((prom[j], e.host))   # the index's own
            e.host = None
            self._host_bytes -= c.bytes_per_page
            self.stats["promotions"] += 1
        shared = []
        for h in hashes[:m]:
            e = self._prefix[h]
            e.last_used = self._tick()
            c.pool.ref(e.page)
            shared.append(e.page)
        cow_pairs = []
        if cow:
            # the slot owns the copy target; the matched source page keeps
            # the reference taken above until apply_cow() releases it
            cow_pairs.append(("full", shared[-1], got[0]))
            shared[-1] = got[0]
            row = shared + got[1:]
        else:
            row = shared + got
        c.table[slot, :len(row)] = row
        c.table[slot, len(row):] = self._sentinel(c)
        c.owned[slot] = list(row)
        if register:
            self._register(hashes, row)
        self._touch_peaks()
        return {"cached_len": cached_len,
                "reused": cached_len if m else 0,
                "cow_pairs": cow_pairs,
                "promotes": promotes}

    def apply_cow(self, caches: list,
                  cow_pairs: List[Tuple[str, int, int]]) -> list:
        """Materialize deferred COW copies (``pages[dst] = pages[src]``)
        with one indexed copy per layer and class for all pairs, then
        release the source-page references :meth:`admit` held for them.
        Returns ``caches`` (updated in place)."""
        by_key: Dict[str, Tuple[List[int], List[int]]] = {}
        for key, src, dst in cow_pairs:
            s, d = by_key.setdefault(key, ([], []))
            s.append(src)
            d.append(dst)
        for key, (src, dst) in by_key.items():
            tf.copy_cache_pages(
                self.cfg, caches, key,
                torch.tensor(src, dtype=torch.long, device=self.device),
                torch.tensor(dst, dtype=torch.long, device=self.device))
        for key, src, _ in cow_pairs:
            self.classes[key].pool.unref(src)
        return caches

    def start_promote(self, promotes: List[Tuple[int, list]]
                      ) -> List[Tuple[int, list]]:
        """Issue the host→device copies of promotions from :meth:`admit`:
        ``pages[dst] = host copy`` for every full-class leaf, each a
        non-blocking host→device copy per page into a staging buffer on
        the current stream, then one indexed write per leaf into the pool
        pages, so they overlap the rest of the admission on the host and
        land before any later kernel on the stream reads the pages.
        Returns ``promotes`` for :meth:`apply_promote`."""
        t0 = time.perf_counter()
        leaves = self._full_leaves(self.cache_source())
        cuda = self.device.type == "cuda"
        n = len(promotes)
        staging = torch.empty((n, self.classes["full"].bytes_per_page),
                              dtype=torch.uint8, device=self.device)
        for row, (_, host) in zip(staging, promotes):
            row.copy_(host, non_blocking=cuda)
        dst = torch.tensor([d for d, _ in promotes], device=self.device)
        at = 0
        for a in leaves:                # one indexed write per leaf
            nb = a[0].numel() * a.element_size()
            a[dst] = staging[:, at:at + nb].view(a.dtype).view(
                n, *a.shape[1:])
            at += nb
        self.swap_ms["promote"] += (time.perf_counter() - t0) * 1e3
        return promotes

    def apply_promote(self, caches: list,
                      promotes: List[Tuple[int, list]]) -> list:
        """Complete promotions issued by :meth:`start_promote`, before any
        COW copy or prefill of the admission batch: the copies wrote the
        pool pages directly and the stream orders them first, so what is
        left is the host copies' lifetime — on a CUDA pool they are kept
        until an event recorded after the copies has completed (buffers of
        earlier promotions whose event has are released here).  Returns
        ``caches`` (updated in place)."""
        if self.device.type == "cuda":
            self._inflight = [(ev, bufs) for ev, bufs in self._inflight
                              if not ev.query()]
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._inflight.append((ev, [host for _, host in promotes]))
        return caches

    # -- invariants ---------------------------------------------------------

    def check_invariants(self) -> None:
        """Full-state consistency audit; raises AssertionError on the
        first violation.  For tests, at quiescent points (an admission
        batch with deferred COW pairs in flight holds transient source
        references that fail the exact-refcount check):

        * free list: in range, duplicate-free, disjoint from the
          refcounted set, and together they account for every page;
        * refcounts: every page's count equals its multiplicity across
          slot ``owned`` rows + staged draft ``scratch`` rows + (full
          class) one per prefix-index entry;
        * block tables: row ``[: live]`` mirrors ``owned + scratch`` in
          order, no live row holds the sentinel, every row past the live
          extent *is* the sentinel;
        * prefix index: entries point at in-range pages, parent chains
          are closed under the index, resident entries hold no host copy
          and demoted ones hold one;
        * host tier: the accounted bytes equal demoted pages × page bytes;
        * quantized pools: every code pool holds the pool's code dtype and
          its fp16 scale pool covers the same pages, slots and heads.
        """
        for key, c in self.classes.items():
            pool = c.pool
            free = pool._free
            assert len(set(free)) == len(free), \
                f"class '{key}': duplicate pages in the free list"
            assert all(0 <= p < pool.num_pages for p in free), \
                f"class '{key}': free-list page out of range"
            refed = set(pool._refcount)
            assert not (set(free) & refed), \
                f"class '{key}': page both free and allocated"
            assert len(free) + len(refed) == pool.num_pages, \
                f"class '{key}': {pool.num_pages - len(free) - len(refed)}" \
                f" page(s) leaked (neither free nor allocated)"
            assert all(rc > 0 for rc in pool._refcount.values()), \
                f"class '{key}': allocated page with refcount <= 0"

            expected: Dict[int, int] = {}
            for rows in (c.owned, c.scratch):
                for row in rows:
                    for p in row:
                        expected[p] = expected.get(p, 0) + 1
            if key == "full":
                for e in self._prefix.values():
                    if e.page >= 0:
                        expected[e.page] = expected.get(e.page, 0) + 1
            assert expected == pool._refcount, \
                f"class '{key}': refcounts {pool._refcount} != expected " \
                f"{expected} from slot rows + prefix index"

            sent = self._sentinel(c)
            for slot in range(self.slots):
                live = c.owned[slot] + c.scratch[slot]
                row = c.table[slot]
                assert all(p < sent for p in live), \
                    f"class '{key}' slot {slot}: live row holds sentinel"
                assert list(row[:len(live)]) == live, \
                    f"class '{key}' slot {slot}: table row " \
                    f"{list(row[:len(live)])} != owned+scratch {live}"
                assert all(int(p) == sent for p in row[len(live):]), \
                    f"class '{key}' slot {slot}: unbacked row not sentinel"

        full = self.classes.get("full")
        demoted = 0
        for h, e in self._prefix.items():
            assert e.page < full.pool.num_pages, \
                f"prefix entry {h}: page {e.page} out of range"
            assert e.parent is None or e.parent in self._prefix, \
                f"prefix entry {h}: orphaned (parent evicted from index)"
            if e.page >= 0:
                assert e.host is None, \
                    f"prefix entry {h}: resident but still holds a host copy"
            else:
                demoted += 1
                assert e.host is not None, \
                    f"prefix entry {h}: demoted without a host copy"
        host_bytes = 0 if full is None else demoted * full.bytes_per_page
        assert self._host_bytes == host_bytes, \
            f"host tier accounts {self._host_bytes} bytes, {demoted} " \
            f"demoted page(s) imply {host_bytes}"

        qdt = kv_quant_dtype(self.kv_dtype)
        if qdt is not None:
            for c in self.caches:
                a = c["attn"]
                for data, scale in (("k_pages", "k_scale"),
                                    ("v_pages", "v_scale"),
                                    ("ckv_pages", "ckv_scale"),
                                    ("krope_pages", "krope_scale")):
                    if data not in a:
                        continue
                    assert a[data].dtype == qdt, \
                        f"'{data}' holds {a[data].dtype}, not {qdt}"
                    assert scale in a and a[scale].dtype == torch.float16 \
                        and a[scale].shape == a[data].shape[:-1], \
                        f"'{scale}' does not cover '{data}' " \
                        f"{tuple(a[data].shape[:-1])}"

    # -- accounting ---------------------------------------------------------

    def _live_pages(self, c: _CacheClass) -> int:
        live = set()
        for owned in c.owned:
            live.update(owned)
        return len(live)

    def _touch_peaks(self) -> None:
        for c in self.classes.values():
            c.peak_live_pages = max(c.peak_live_pages, self._live_pages(c))

    def reset_peaks(self) -> None:
        for c in self.classes.values():
            c.pool.peak_in_use = 0
            c.peak_live_pages = 0

    @property
    def pages_in_use(self) -> Dict[str, int]:
        return {k: c.pool.pages_in_use for k, c in self.classes.items()}

    def memory_stats(self) -> dict:
        """Resident = distinct pages referenced by live slots (shared
        prefix pages count once); reusable-prefix pages held only by the
        index are reported separately.  Physical = the whole pool, in the
        reference's schema (the sink page each layer keeps is not pool
        capacity and is not counted).  In-flight speculative scratch pages
        are not resident (they are promoted or dropped within the step, and
        counting them would count the accepted ones twice): they report as
        ``draft_pages``."""
        live = {k: self._live_pages(c) for k, c in self.classes.items()}
        resident = sum(live[k] * c.bytes_per_page
                       for k, c in self.classes.items())
        peak = sum(c.peak_live_pages * c.bytes_per_page
                   for c in self.classes.values())
        full = self.classes.get("full")
        prefix_only = 0 if full is None else \
            self._evictable_pages("full", full)
        demoted = sum(1 for e in self._prefix.values() if e.page < 0)
        return {
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "num_pages": {k: c.pool.num_pages
                          for k, c in self.classes.items()},
            "pages_in_use": self.pages_in_use,
            "live_pages": live,
            "peak_pages_in_use": {k: c.pool.peak_in_use
                                  for k, c in self.classes.items()},
            "peak_live_pages": {k: c.peak_live_pages
                                for k, c in self.classes.items()},
            "resident_cache_bytes": resident,
            "peak_resident_cache_bytes": peak,
            "draft_pages": {k: sum(len(s) for s in c.scratch)
                            for k, c in self.classes.items()},
            "physical_cache_bytes": self._physical_page_bytes,
            "ssm_state_bytes": self._state_bytes,
            "sharding": None,
            "prefix_cache": {
                "enabled": self.prefix_enabled,
                "entries": len(self._prefix),
                "evictable_pages": prefix_only,
                "reusable_prefix_bytes": 0 if full is None else
                    prefix_only * full.bytes_per_page,
                "evictions": self.stats["prefix_evictions"],
            },
            "host_tier": {
                "enabled": self.swap_enabled,
                "capacity_bytes": self.host_swap_bytes,
                "demoted_pages": demoted,
                "demoted_bytes": self._host_bytes,
                "demotions": self.stats["demotions"],
                "promotions": self.stats["promotions"],
                "host_drops": self.stats["host_drops"],
                "reregistered": self.stats["reregistered"],
                "promote_hit_rate": self.stats["promotions"]
                    / max(1, self.stats["demotions"]),
            },
        }
