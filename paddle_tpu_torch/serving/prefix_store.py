"""Content-addressed prefix store — cross-request KV page sharing (port of
``paddle_tpu/serving/prefix_store.py``).

Prompts are split into page-sized token blocks and each block is keyed
by ``(parent_hash, token_block)``: a hash CHAIN, so a block's identity
pins the whole token prefix in front of it. Two requests that share a
system prompt resolve to the same chain of blocks and so to the same
physical KV pages; the second skips prefill for the shared chunks and
recomputes only its suffix through the chunked prefill program
(``models/decoder_lm.build_chunk_prefill_program``).

Sharing is bitwise-safe because shared pages are read-only to every
program. A chunk's writes land only in the request's own pages (a lookup
matches at most ``floor((L-1)/P)`` blocks, so the final chunk, the one
that yields the first-token logits, is always recomputed), and decode
writes land past the prompt, again in private pages. The attention ops
mask invalid positions to -1e9 before the softmax, which underflows to
exactly 0.0, so neither page ids nor a recycled page's old contents
move an output bit.

Lifecycle:

- ``lookup(tokens)`` walks the chain, bumps each matched block's
  refcount and returns the shared pages to splice into the page table
  (``kv.prefix_hits`` / ``kv.prefix_misses``, ``kv.bytes_saved``).
- ``insert(tokens, pages, ...)`` runs after a prefill: the store adopts
  the request's full prompt pages as shared blocks (refcount 1, held by
  the inserting request). A second child under a parent that already
  has one is a copy-on-write fork of the chain (``kv.cow_forks``): the
  diverging request computed its own pages, so no page is copied.
- ``release(blocks)`` at retirement drops refcounts; refcount-zero
  chains stay cached until ``reclaim`` evicts them LRU leaf-first under
  pool pressure (``kv.reclaims``).

The hashing is the reference's byte for byte (blake2b, 16-byte digest,
over the parent hash, ``|`` and the comma-joined decimal tokens), so
``prefix_chain_hash`` gives the same affinity key in either package.
``kv.prefix_lookup`` faults inject at ``lookup`` (core/faults.py). The
saved bytes are the ``mem.serving.kv_prefix_saved_bytes`` gauge, which
the memory ledger reports (``costmodel.ledger``). The reference takes
its lock through the lock-order checker; the port has none yet (ROADMAP
A10b) and uses a plain lock.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Sequence, Tuple

from ..core import faults, telemetry
from .kv_cache import KVPagePool

ROOT_HASH = "root"


def _chain_hash(parent_hash: str, tokens: Sequence[int]) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_hash.encode("utf-8"))
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode("utf-8"))
    return h.hexdigest()


def prefix_chain_hash(tokens: Sequence[int], page_size: int) -> str:
    """Hash of the FULL-page prefix chain of a prompt: equal shared
    prefixes give equal keys (the router's affinity key, and the
    ``prefix_hash`` of a session's journal record)."""
    h = ROOT_HASH
    for b in range(len(tokens) // int(page_size)):
        h = _chain_hash(h, tokens[b * page_size:(b + 1) * page_size])
    return h


class _Block:
    __slots__ = ("hash", "parent", "tokens", "page", "refs", "children",
                 "last_used")

    def __init__(self, hash_: str, parent: str, tokens: Tuple[int, ...],
                 page: int):
        self.hash = hash_
        self.parent = parent
        self.tokens = tokens
        self.page = page
        self.refs = 0
        self.children: set = set()
        self.last_used = 0


class PrefixStore:
    """Hash-chained, refcounted block index over a KVPagePool.

    Owns the physical pages of every resident block (lent from the pool
    and returned only at eviction): ``owned_pages()`` feeds
    ``pool.audit`` to prove nothing leaked."""

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._lock = threading.Lock()
        self._blocks: Dict[str, _Block] = {}
        self._clock = 0
        self._bytes_saved = 0

    # -- introspection -------------------------------------------------------
    def owned_pages(self) -> List[int]:
        with self._lock:
            return [b.page for b in self._blocks.values()]

    def num_blocks(self) -> int:
        with self._lock:
            return len(self._blocks)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            blocks = list(self._blocks.values())
            saved = self._bytes_saved
        return {"blocks": len(blocks),
                "blocks_shared": sum(1 for b in blocks if b.refs > 1),
                "blocks_idle": sum(1 for b in blocks if b.refs == 0),
                "bytes_saved": saved, "block_bytes": self.pool._page_bytes}

    def _gauges(self):
        telemetry.gauge_set("kv.prefix_blocks", len(self._blocks))
        telemetry.gauge_set("mem.serving.kv_prefix_saved_bytes",
                            self._bytes_saved)

    # -- lookup --------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> Tuple[List[str], List[int]]:
        """Longest cached prefix of ``tokens``: (block hashes, physical
        pages), refcounts bumped; the caller must ``release`` the hashes
        at retirement. Matches at most ``floor((L-1)/P)`` blocks, so the
        final prompt chunk is always recomputed (it yields the
        first-token logits). ``kv.prefix_lookup`` faults inject here: a
        failure is a per-request error, no refcount moves."""
        faults.maybe_fail("kv.prefix_lookup", tokens=len(tokens))
        P = self.page_size
        max_blocks = max(0, (len(tokens) - 1) // P)
        hashes: List[str] = []
        pages: List[int] = []
        with self._lock:
            self._clock += 1
            parent = ROOT_HASH
            for b in range(max_blocks):
                h = _chain_hash(parent, tuple(int(t) for t in
                                              tokens[b * P:(b + 1) * P]))
                blk = self._blocks.get(h)
                if blk is None:
                    break
                blk.refs += 1
                blk.last_used = self._clock
                hashes.append(h)
                pages.append(blk.page)
                parent = h
            saved_now = len(hashes) * self.pool._page_bytes
            self._bytes_saved += saved_now
            self._gauges()
        if hashes:
            telemetry.counter_add("kv.prefix_hits", 1)
            telemetry.counter_add("kv.bytes_saved", saved_now)
        else:
            telemetry.counter_add("kv.prefix_misses", 1)
        return hashes, pages

    # -- insert --------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               start_block: int = 0) -> Tuple[List[str], List[int]]:
        """Adopt a freshly prefilled prompt's FULL pages as shared blocks.
        ``pages[i]`` holds global tokens [i*P, (i+1)*P); blocks before
        ``start_block`` were already acquired by lookup and are skipped.
        Only pages strictly before the page receiving decode writes are
        adoptable: ``floor(L/P)`` blocks in all.

        Returns (hashes newly held by this request, the CANONICAL page of
        each inserted block). The caller repoints its page table at the
        canonical pages and drops them from its private list. On a
        duplicate insert (two cold requests with the same prompt) the
        resident block wins and the redundant page goes back to the
        pool."""
        P = self.page_size
        held: List[str] = []
        canonical: List[int] = []
        to_free: List[int] = []
        cow = 0
        with self._lock:
            self._clock += 1
            parent = ROOT_HASH
            for b in range(len(tokens) // P):
                blk_tokens = tuple(int(t) for t in tokens[b * P:(b + 1) * P])
                h = _chain_hash(parent, blk_tokens)
                if b >= start_block:
                    blk = self._blocks.get(h)
                    if blk is None:
                        blk = _Block(h, parent, blk_tokens, int(pages[b]))
                        self._blocks[h] = blk
                        par = self._blocks.get(parent)
                        if par is not None:
                            if par.children:
                                cow += 1
                            par.children.add(h)
                    elif blk.page != int(pages[b]):
                        to_free.append(int(pages[b]))
                    blk.refs += 1
                    blk.last_used = self._clock
                    held.append(h)
                    canonical.append(blk.page)
                parent = h
            self._gauges()
        if to_free:
            self.pool.free(to_free)
        if cow:
            telemetry.counter_add("kv.cow_forks", cow)
        return held, canonical

    # -- release / reclaim ---------------------------------------------------
    def release(self, hashes: Sequence[str]):
        """Drop one reference per hash (request retirement). Blocks at
        refcount zero stay resident; eviction is reclaim's job."""
        with self._lock:
            for h in hashes:
                blk = self._blocks.get(h)
                if blk is None:
                    raise AssertionError(
                        f"prefix store corruption: releasing unknown "
                        f"block {h}")
                if blk.refs <= 0:
                    raise AssertionError(
                        f"prefix store corruption: double release of "
                        f"block {h}")
                blk.refs -= 1

    def reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` pages of refcount-zero LEAF blocks, LRU
        first, returning their pages to the pool. Leaf-only keeps every
        resident chain reachable from the root: an interior block with a
        cached child outlives it. Returns the pages freed."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < n_pages:
                victims = [b for b in self._blocks.values()
                           if b.refs == 0 and not b.children]
                if not victims:
                    break
                blk = min(victims, key=lambda b: b.last_used)
                del self._blocks[blk.hash]
                par = self._blocks.get(blk.parent)
                if par is not None:
                    par.children.discard(blk.hash)
                freed.append(blk.page)
            self._gauges()
        if freed:
            self.pool.free(freed)
            telemetry.counter_add("kv.reclaims", 1)
        return len(freed)
