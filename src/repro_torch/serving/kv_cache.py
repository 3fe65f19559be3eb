"""Paged KV cache: page pool + per-slot block tables + automatic prefix
cache.

Port of ``repro.serving.kv_cache`` for the unquantized, unsharded pool.
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

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): quantized pools, byte-budget sizing and the host swap tier
(``kv_dtype``, ``pool_bytes``, ``host_swap_bytes``, ``start_promote``,
``apply_promote``) — item 4; speculative draft pages (``reserve_draft``,
``commit_draft``, ``drop_draft``) — item 3; the device-sharded pool
(``shard``) — item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.model import transformer as tf
from repro_torch.model.attention import paged_cache_key
from repro_torch.model.layers import resolve_device


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


_QUANT = "§1 item 4, quantized pages and host swap"
_SPEC = "§1 item 3, speculation"
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


@dataclasses.dataclass
class _PrefixEntry:
    """One full page of the prefix index.  ``key`` (its dict key) is the
    chained hash of every token up to and including this page;
    ``parent`` is the previous page's chain hash (None at depth 0).  The
    index holds its own pool reference on ``page``."""
    page: int
    parent: Optional[int]
    last_used: int


class PagedKVCache:
    """Page-pool KV cache for the serving engine (``cache_layout="paged"``).

    ``caches`` is the per-layer list of page pools the model threads
    through prefill and decode (built by ``transformer.init_paged_cache``
    on ``device``: CUDA unless the caller passes "cpu"), and ``tables()``
    uploads the block tables for one
    dispatch.  ``num_pages`` sizes the *full* class pool; the default
    equals the dense layout's capacity (``slots × max_len / page_size``
    pages) — shrink it to serve in less memory, at the cost of admission
    back-pressure and (worst case) preemption."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, dtype,
                 *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_caching: bool = True,
                 shard=None,
                 kv_dtype: Optional[str] = None,
                 pool_bytes: Optional[int] = None,
                 host_swap_bytes: int = 0,
                 device="cuda"):
        if kv_dtype is not None or pool_bytes is not None or host_swap_bytes:
            raise _not_ported("kv_dtype / pool_bytes / host_swap_bytes",
                              _QUANT)
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
        self.kv_dtype = None
        self.device = resolve_device(device)

        caps: Dict[str, int] = {}
        per_layer_page_elems: Dict[str, int] = {}
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
            elif spec.attn == "mla":
                # one latent [r] and one shared rope key [rd] per token
                caps["full"] = max_len
                per_layer_page_elems["full"] = \
                    per_layer_page_elems.get("full", 0) + page_size * (
                        cfg.mla.kv_lora_rank + cfg.mla.rope_dim)
            if spec.ssm is not None:
                has_ssm = True

        itemsize = torch.empty((), dtype=dtype).element_size()
        self.classes: Dict[str, _CacheClass] = {}
        pool_sizes: Dict[str, int] = {}
        for key, cap in caps.items():
            width = _ceil_div(cap, page_size)
            if key == "full" and num_pages is not None:
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
                bytes_per_page=per_layer_page_elems[key] * itemsize,
            )

        # prefix reuse needs every class addressed from position zero and
        # every layer position-local (see the reference module)
        self.prefix_supported = (not has_ssm) and (not has_moe) \
            and set(caps) <= {"full"}
        self.prefix_enabled = bool(prefix_caching) and self.prefix_supported
        self._prefix: Dict[int, _PrefixEntry] = {}
        self._prefix_tick = 0
        self.stats = {"prefix_evictions": 0}

        self.caches = tf.init_paged_cache(cfg, slots, pool_sizes, page_size,
                                          dtype, self.device)
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
                   if c.pool.refcount(e.page) == 1)

    def can_grow(self, slot: int, kv_target: int) -> bool:
        return all(
            self.pages_needed(k, kv_target) - len(c.owned[slot])
            <= c.pool.free_pages + self._evictable_pages(k, c)
            for k, c in self.classes.items())

    def grow(self, slot: int, kv_target: int) -> bool:
        """Extend ``slot``'s tables to cover ``kv_target`` tokens in every
        class.  All-or-nothing: returns False (state unchanged) when any
        pool is short even after evicting reusable-prefix pages."""
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
        registered into the prefix index, which takes its own reference."""
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
        never holds the sentinel — only unbacked rows do."""
        for k, c in self.classes.items():
            for slot, owned in enumerate(c.owned):
                live = len(owned)
                if live and int(c.table[slot, :live].max()) \
                        >= c.pool.num_pages:
                    raise AssertionError(
                        f"class '{k}' slot {slot}: live block-table row "
                        f"holds the sentinel page")
        # a copy, also on the CPU: the dispatch must not see later edits
        return {k: torch.tensor(c.table, device=self.device)
                for k, c in self.classes.items()}

    # -- speculative drafts -------------------------------------------------

    def reserve_draft(self, slot: int, kv_len: int, kv_target: int):
        raise _not_ported("speculative draft pages (reserve_draft)", _SPEC)

    def commit_draft(self, slot: int, kv_len_new: int) -> None:
        raise _not_ported("speculative draft pages (commit_draft)", _SPEC)

    def drop_draft(self, slot: int) -> None:
        raise _not_ported("speculative draft pages (drop_draft)", _SPEC)

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
                e.last_used = self._tick()
                continue
            self.classes["full"].pool.ref(row[i])
            self._prefix[h] = _PrefixEntry(
                page=row[i], parent=hashes[i - 1] if i else None,
                last_used=self._tick())

    def _drop_subtree(self, c: _CacheClass, root: int) -> None:
        """Drop an index entry and every descendant (they are matchable
        only through it); their pages drop the index's reference."""
        stack = [root]
        while stack:
            h = stack.pop()
            e = self._prefix.pop(h, None)
            if e is None:
                continue
            stack.extend(h2 for h2, e2 in self._prefix.items()
                         if e2.parent == h)
            c.pool.unref(e.page)
            self.stats["prefix_evictions"] += 1

    def _evict_prefix(self, c: _CacheClass, need: int,
                      protect: frozenset = frozenset()) -> bool:
        """Free index-only pages (LRU) until ``need`` pages are free.
        Evicting an entry takes its whole subtree along; entries in
        ``protect`` (the chain an in-flight admission just matched) are
        never chosen as victims."""
        while c.pool.free_pages < need:
            victim = None
            for h, e in self._prefix.items():
                if h in protect:
                    continue
                if c.pool.refcount(e.page) == 1 and (
                        victim is None
                        or e.last_used < self._prefix[victim].last_used):
                    victim = h
            if victim is None:
                return False
            self._drop_subtree(c, victim)
        return True

    def clear_prefix(self) -> int:
        """Drop every index entry (e.g. after engine warmup, or to drain
        the pool).  Returns the number of entries dropped."""
        n = len(self._prefix)
        c = self.classes.get("full")
        for e in self._prefix.values():
            c.pool.unref(e.page)
        self._prefix.clear()
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
        "reused", "cow_pairs", "promotes"}`` (``promotes`` is always empty:
        no host tier)."""
        if not self.prefix_enabled:
            if not self.grow(slot, kv_target):
                return None
            return {"cached_len": 0, "reused": 0, "cow_pairs": [],
                    "promotes": []}

        c = self.classes["full"]
        if c.owned[slot]:
            raise RuntimeError(f"admit into non-empty slot {slot}")
        n_tok = len(tokens)
        hashes = self._chain_hashes(tokens)
        m = self._match(hashes)
        need_width = self.pages_needed("full", kv_target)
        cow = m > 0 and m * self.page_size == n_tok
        cached_len = n_tok - 1 if cow else m * self.page_size
        fresh = need_width - m + (1 if cow else 0)
        if not (fresh <= c.pool.free_pages or self._evict_prefix(
                c, fresh, protect=frozenset(hashes[:m]))):
            return None
        got = c.pool.alloc(fresh)
        if got is None:                      # pragma: no cover - guarded
            return None
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
                "promotes": []}

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

    def start_promote(self, promotes):
        raise _not_ported("the host swap tier (start_promote)", _QUANT)

    def apply_promote(self, caches, promotes):
        raise _not_ported("the host swap tier (apply_promote)", _QUANT)

    # -- invariants ---------------------------------------------------------

    def check_invariants(self) -> None:
        """Full-state consistency audit; raises AssertionError on the
        first violation.  For tests, at quiescent points (an admission
        batch with deferred COW pairs in flight holds transient source
        references that fail the exact-refcount check):

        * free list: in range, duplicate-free, disjoint from the
          refcounted set, and together they account for every page;
        * refcounts: every page's count equals its multiplicity across
          slot ``owned`` rows + (full class) one per prefix-index entry;
        * block tables: row ``[: live]`` mirrors ``owned`` in order, no
          live row holds the sentinel, every row past the live extent
          *is* the sentinel;
        * prefix index: entries point at in-range pages and parent chains
          are closed under the index.
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
            for row in c.owned:
                for p in row:
                    expected[p] = expected.get(p, 0) + 1
            if key == "full":
                for e in self._prefix.values():
                    expected[e.page] = expected.get(e.page, 0) + 1
            assert expected == pool._refcount, \
                f"class '{key}': refcounts {pool._refcount} != expected " \
                f"{expected} from slot rows + prefix index"

            sent = self._sentinel(c)
            for slot in range(self.slots):
                live = c.owned[slot]
                row = c.table[slot]
                assert all(p < sent for p in live), \
                    f"class '{key}' slot {slot}: live row holds sentinel"
                assert list(row[:len(live)]) == live, \
                    f"class '{key}' slot {slot}: table row " \
                    f"{list(row[:len(live)])} != owned {live}"
                assert all(int(p) == sent for p in row[len(live):]), \
                    f"class '{key}' slot {slot}: unbacked row not sentinel"

        full = self.classes.get("full")
        for h, e in self._prefix.items():
            assert 0 <= e.page < full.pool.num_pages, \
                f"prefix entry {h}: page {e.page} out of range"
            assert e.parent is None or e.parent in self._prefix, \
                f"prefix entry {h}: orphaned (parent evicted from index)"

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
        capacity and is not counted)."""
        live = {k: self._live_pages(c) for k, c in self.classes.items()}
        resident = sum(live[k] * c.bytes_per_page
                       for k, c in self.classes.items())
        peak = sum(c.peak_live_pages * c.bytes_per_page
                   for c in self.classes.values())
        full = self.classes.get("full")
        prefix_only = 0 if full is None else \
            self._evictable_pages("full", full)
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
            "draft_pages": {k: 0 for k in self.classes},
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
                "enabled": False,
                "capacity_bytes": 0,
                "demoted_pages": 0,
                "demoted_bytes": 0,
                "demotions": 0,
                "promotions": 0,
                "host_drops": 0,
                "reregistered": 0,
                "promote_hit_rate": 0.0,
            },
        }
