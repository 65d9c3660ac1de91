"""Paged KV cache — the decode engine's preallocated page pool (port of
``paddle_tpu/serving/kv_cache.py``).

One pool of fixed-size pages per layer, allocated once on the engine's
device; a request gets just the pages its worst case needs at admission
and frees them at retirement, so continuous batching churns requests
through the same tensors with no device alloc/free. Page 0 is a
reserved scratch page: the ops route padded prompt positions and empty
decode slots there, so a masked write never touches a live request's
page. The pool's bytes are the ``mem.serving.kv_pool_bytes``,
``kv_used_bytes`` and ``kv_high_water_bytes`` gauges, and the pool is a
resident part of the memory ledger (``costmodel.ledger``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch

from ..core import costmodel, faults, telemetry
from .admission import KVCacheExhaustedError


class KVPagePool:
    """Free-list allocator over the per-layer page tensors. The tensors
    (kv_k_<l>/kv_v_<l> -> [num_pages, page_size, kv_dim]) belong to the
    engine; this object owns the page ids and the accounting. Page 0 is
    never handed out."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 kv_dim: int):
        if num_pages < 2:
            raise ValueError(f"KV pool needs >= 2 pages (page 0 is the "
                             f"reserved scratch page), got {num_pages}")
        self.n_layers = int(n_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.kv_dim = int(kv_dim)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(1, self.num_pages))
        self._lent: set = set()   # pages handed out and not yet freed
        self._high_water_pages = 0
        # fp32 keys + values, every layer
        self.pool_bytes = (2 * self.n_layers * self.num_pages *
                           self.page_size * self.kv_dim * 4)
        self._page_bytes = self.pool_bytes // self.num_pages
        telemetry.gauge_set("mem.serving.kv_pool_bytes", self.pool_bytes)
        telemetry.gauge_set("mem.serving.kv_used_bytes", 0)
        telemetry.gauge_set("mem.serving.kv_high_water_bytes", 0)
        costmodel.refresh_ledger()

    def make_arrays(self, device) -> Dict[str, Any]:
        """Zeroed fp32 pool tensors on ``device``, keyed by the programs'
        feed names."""
        shape = (self.num_pages, self.page_size, self.kv_dim)
        return {f"kv_{kv}_{i}": torch.zeros(shape, device=device)
                for i in range(self.n_layers) for kv in "kv"}

    @property
    def capacity_pages(self) -> int:
        """Allocatable pages (page 0 excluded)."""
        return self.num_pages - 1

    def pages_for_tokens(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def check_fits(self, tokens: int) -> int:
        """Typed admission-time refusal of a request whose worst-case
        page need exceeds the whole pool."""
        need = self.pages_for_tokens(tokens)
        if need > self.capacity_pages:
            telemetry.counter_add("decode.kv_refusals", 1)
            raise KVCacheExhaustedError(
                f"request needs {need} KV pages ({tokens} tokens at "
                f"{self.page_size}/page) but the pool holds "
                f"{self.capacity_pages}; raise kv_pages or shorten the "
                f"request")
        return need

    def try_alloc(self, n: int) -> List[int]:
        """Pop n pages, or [] when the pool cannot seat them right now.
        ``decode.kv_alloc`` faults inject here."""
        faults.maybe_fail("decode.kv_alloc", pages=n)
        with self._lock:
            if n > len(self._free):
                return []
            pages = self._free[:n]
            del self._free[:n]
            self._lent.update(pages)
            used = self.capacity_pages - len(self._free)
            self._high_water_pages = max(self._high_water_pages, used)
            hw = self._high_water_pages
        telemetry.counter_add("decode.kv_pages_allocated", n)
        telemetry.gauge_set("mem.serving.kv_used_bytes",
                            used * self._page_bytes)
        telemetry.gauge_set("mem.serving.kv_high_water_bytes",
                            hw * self._page_bytes)
        return pages

    def free(self, pages: List[int]):
        if not pages:
            return
        with self._lock:
            dup = set(pages) & set(self._free)
            if dup or 0 in pages:
                raise AssertionError(
                    f"KV pool corruption: freeing pages {sorted(dup)} "
                    f"already free (or the reserved page 0)")
            self._free.extend(pages)
            self._lent.difference_update(pages)
            used = self.capacity_pages - len(self._free)
        telemetry.counter_add("decode.kv_pages_freed", len(pages))
        telemetry.gauge_set("mem.serving.kv_used_bytes",
                            used * self._page_bytes)

    def audit(self, owned: List[int] = None) -> List[str]:
        """Invariant check: the free list and the lent set must partition
        pages 1..num_pages-1 (disjoint, no duplicates, page 0 never handed
        out). With ``owned`` (every page id the callers believe they hold:
        request-private pages and prefix-store pages), also lent == owned:
        no leaked and no over-freed page. Returns the violations (empty =
        clean) and counts a failing call as ``kv.audit_failures``."""
        problems: List[str] = []
        with self._lock:
            free = list(self._free)
            lent = set(self._lent)
        if len(free) != len(set(free)):
            problems.append("duplicate pages on the free list")
        if 0 in free or 0 in lent:
            problems.append("reserved page 0 entered circulation")
        overlap = set(free) & lent
        if overlap:
            problems.append(f"pages both free and lent: {sorted(overlap)}")
        universe = set(range(1, self.num_pages))
        missing = universe - set(free) - lent
        if missing:
            problems.append(f"pages vanished from the pool: "
                            f"{sorted(missing)}")
        extra = (set(free) | lent) - universe
        if extra:
            problems.append(f"pages outside the pool: {sorted(extra)}")
        if owned is not None:
            owned_set = set(owned)
            if len(owned) != len(owned_set):
                problems.append("a page is owned twice")
            leaked = lent - owned_set
            if leaked:
                problems.append(f"leaked pages (lent but unowned): "
                                f"{sorted(leaked)}")
            stale = owned_set - lent
            if stale:
                problems.append(f"over-freed pages (owned but not "
                                f"lent): {sorted(stale)}")
        if problems:
            telemetry.counter_add("kv.audit_failures", 1)
        return problems

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            free = len(self._free)
            hw = self._high_water_pages
        used = self.capacity_pages - free
        return {"page_size": self.page_size,
                "pages_total": self.capacity_pages,
                "pages_free": free, "pages_used": used,
                "high_water_pages": hw, "pool_bytes": self.pool_bytes,
                "used_bytes": used * self._page_bytes,
                "high_water_bytes": hw * self._page_bytes}
