"""Content-addressed store of full KV pages — shared-prefix reuse.

The port's copy of ``paddle_tpu/inference/prefix_cache.py`` (that module
imports no JAX, but the port imports nothing of the JAX package). A KV
page is an immutable value once written (positions only ever grow), so
identical token prefixes produce identical pages, and one physical page
can sit in many block tables at once (``PageAllocator.share``).

Addressing is a CHAINED hash over page-aligned token chunks:

    h_0 = H(tokens[0:ps])          h_i = H(h_{i-1} || tokens[i*ps:...])

so an entry hit at depth i implies the ENTIRE prefix up to and including
chunk i matches — a lookup walks the chain from the root and stops at
the first miss, and a page is never reused under a different left
context. Only FULL pages are cached, and the engine caps a hit so that
at least one real token is left for the tail prefill: the page a
request appends into stays private (the copy-on-write fork).

Hashes are blake2b over the raw token bytes (the same bytes as the JAX
package's), and every entry also keeps its exact chunk tokens: a digest
collision degrades to a cache MISS, never to serving another prompt's
KV.

Lifecycle: the cache holds ONE allocator reference per entry, so a
cached page survives its writer finishing; requests mapping it take
their own reference. Entries whose page refcount is 1 (cache-only) are
evictable, leaves first in LRU order, so a chain never loses an interior
page while a descendant could still be hit. The engine evicts idle
entries before it refuses an admission or preempts a live sequence.
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _chunk_hash(parent: Optional[bytes], tokens) -> bytes:
    """Chained digest of one page-aligned chunk under its prefix."""
    h = hashlib.blake2b(digest_size=16)
    if parent is not None:
        h.update(parent)
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


@dataclass
class _Entry:
    key: bytes                     # chained digest (identity in store)
    page: int                      # pool page backing this chunk
    chunk: Tuple[int, ...]         # exact tokens (collision guard)
    parent: Optional[bytes]        # previous chunk's key (chain link)
    depth: int                     # chunk index in its prefix
    children: set = field(default_factory=set)
    last_use: int = 0              # LRU tick


class PrefixCache:
    """Hash-chained page store over a ``PageAllocator``.

    The engine drives four operations per request lifecycle: ``acquire``
    at admission (map the longest cached prefix into the block table,
    one reference per page), ``insert`` after the final prefill slice
    (register the request's freshly written full-prompt pages),
    ``PageAllocator.free`` of the request's pages at finish or
    preemption (shared pages just drop a reference), and ``evict`` under
    pool pressure. ``hash_fn`` is injectable so tests can force digest
    collisions; ``force_collision`` and ``corrupt_entry`` are the fault
    points the engine's injector drives.
    """

    #: digest every forced collision resolves to (fault injection: a
    #: constant key makes ANY two root chunks collide)
    COLLIDED = b"\x00" * 16

    def __init__(self, allocator, page_size: int, hash_fn=_chunk_hash):
        self._alloc = allocator
        self.page_size = int(page_size)
        self._store: Dict[bytes, _Entry] = {}
        self._tick = 0
        self._hash_fn = hash_fn
        # the prefix.hash_collision fault point: each armed count forces
        # the NEXT root-chunk digest to COLLIDED
        self._collide_next = 0
        self.hits = 0
        self.lookups = 0

    def _hash(self, parent, tokens) -> bytes:
        if self._collide_next > 0 and parent is None:
            self._collide_next -= 1
            return self.COLLIDED
        return self._hash_fn(parent, tokens)

    def force_collision(self, n: int = 1) -> None:
        """Arm ``n`` forced digest collisions (the
        ``prefix.hash_collision`` fault point): the next ``n`` root-chunk
        hashes all return one constant digest. The exact-token compare
        turns the collision into a miss, never into serving another
        prompt's KV."""
        self._collide_next += int(n)

    def corrupt_entry(self, rng) -> Optional[bytes]:
        """Make one cached entry STALE (the ``prefix.stale_entry`` fault
        point): its chunk tokens become out-of-vocab sentinels, index
        metadata that no longer matches the page. It can never be hit
        again (the token compare fails) and ``check_integrity`` reclaims
        it. The victim is drawn from ``rng`` (the injector's numpy
        Generator) over the sorted keys. Returns its key (None when the
        cache is empty)."""
        if not self._store:
            return None
        keys = sorted(self._store)
        key = keys[int(rng.integers(0, len(keys)))]
        ent = self._store[key]
        ent.chunk = tuple([-1] * len(ent.chunk))
        return key

    def check_integrity(self, repair: bool = False) -> List[str]:
        """Verify every entry's key still equals the chained digest of
        (parent, chunk), the invariant ``insert`` establishes. With
        ``repair=True`` stale entries and their (unreachable) subtrees
        are dropped, returning their pages to the pool. Forced-collision
        roots (key == COLLIDED) are exempt: they were inserted under the
        forced digest and still pass the exact-token compare."""
        findings: List[str] = []
        stale = []
        for key, ent in self._store.items():
            if key == self.COLLIDED:
                continue
            if self._hash_fn(ent.parent, ent.chunk) != key:
                findings.append(
                    f"stale prefix-cache entry depth {ent.depth} "
                    f"(key {key.hex()[:12]}…): stored chunk no longer "
                    f"matches its digest")
                stale.append(key)
        if repair:
            for key in stale:
                self._drop_subtree(key)
        return findings

    def _drop_subtree(self, key: bytes) -> int:
        """Drop an entry and every descendant (unreachable once an
        ancestor is gone). Returns pages freed."""
        ent = self._store.get(key)
        if ent is None:
            return 0
        freed = 0
        for child in list(ent.children):
            freed += self._drop_subtree(child)
        self._drop(ent)
        return freed + 1

    def __len__(self) -> int:
        return len(self._store)

    # -- chain walk ----------------------------------------------------------

    def _walk(self, tokens, max_chunks: int) -> List[_Entry]:
        """Longest chain of cached entries matching ``tokens``' leading
        full-page chunks (at most ``max_chunks``). The exact-token
        compare turns any digest collision into a miss."""
        ps = self.page_size
        out: List[_Entry] = []
        parent: Optional[bytes] = None
        for i in range(min(len(tokens) // ps, max_chunks)):
            chunk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            key = self._hash(parent, chunk)
            ent = self._store.get(key)
            if ent is None or ent.chunk != chunk:
                break
            out.append(ent)
            parent = key
        return out

    def lookup(self, tokens, max_chunks: Optional[int] = None) -> int:
        """Number of leading tokens covered by cached pages (a multiple
        of page_size), WITHOUT taking references."""
        if max_chunks is None:
            max_chunks = len(tokens) // self.page_size
        return len(self._walk(tokens, max_chunks)) * self.page_size

    def acquire(self, tokens, max_chunks: Optional[int] = None
                ) -> Tuple[List[int], int]:
        """Map the longest cached prefix of ``tokens``: returns the
        shared page ids (one reference taken on each; the caller frees
        them) and the number of tokens they cover. ``max_chunks`` caps
        the depth (the engine passes (len - 1) // page_size so that one
        real token is left for the tail prefill)."""
        if max_chunks is None:
            max_chunks = len(tokens) // self.page_size
        chain = self._walk(tokens, max_chunks)
        self.lookups += 1
        if chain:
            self.hits += 1
        self._tick += 1
        pages = []
        for ent in chain:
            self._alloc.share(ent.page)
            ent.last_use = self._tick     # the whole matched chain is hot
            pages.append(ent.page)
        return pages, len(pages) * self.page_size

    def insert(self, tokens, pages: List[int], n_tokens: int) -> int:
        """Register the full-page chunks of ``tokens[:n_tokens]`` whose
        backing pages (``pages[i]`` = chunk i's page) are not cached yet.
        The cache takes its own reference on each newly registered page;
        chunks already cached (under any page) are skipped — first writer
        wins. Returns the number of pages newly registered."""
        ps = self.page_size
        self._tick += 1
        parent: Optional[bytes] = None
        added = 0
        for i in range(n_tokens // ps):
            chunk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            key = self._hash(parent, chunk)
            ent = self._store.get(key)
            if ent is not None and ent.chunk != chunk:
                # digest collision with a different chunk: the incumbent
                # stays, this prefix (and its descendants) stays uncached
                break
            if ent is None:
                ent = _Entry(key=key, page=self._alloc.share(pages[i]),
                             chunk=chunk, parent=parent, depth=i)
                self._store[key] = ent
                if parent is not None:
                    self._store[parent].children.add(key)
                added += 1
            ent.last_use = self._tick
            parent = key
        return added

    # -- eviction ------------------------------------------------------------

    def _idle(self, ent: _Entry) -> bool:
        """Evictable: the cache's own reference is the page's last one.
        A request holding a descendant also holds every ancestor page, so
        an idle entry's whole subtree is idle too."""
        return self._alloc.refcount(ent.page) == 1

    @property
    def evictable_pages(self) -> int:
        return sum(1 for e in self._store.values() if self._idle(e))

    def evict(self, n: int) -> int:
        """Free up to ``n`` idle pages back to the pool, LEAVES first in
        LRU order (an interior chunk never goes while a descendant stays
        hittable). One scan seeds a heap of idle leaves; dropping a leaf
        pushes its parent when that just became an idle leaf. Returns
        the number of pages freed."""
        freed = 0
        heap = [(e.last_use, e.depth, e.key)
                for e in self._store.values()
                if not e.children and self._idle(e)]
        heapq.heapify(heap)
        while freed < int(n) and heap:
            _, _, key = heapq.heappop(heap)
            ent = self._store.get(key)
            if ent is None or ent.children or not self._idle(ent):
                continue
            parent = ent.parent
            self._drop(ent)
            freed += 1
            if parent is not None:
                par = self._store.get(parent)
                if par is not None and not par.children \
                        and self._idle(par):
                    heapq.heappush(heap, (par.last_use, par.depth,
                                          par.key))
        return freed

    def _drop(self, ent: _Entry) -> None:
        del self._store[ent.key]
        if ent.parent is not None:
            par = self._store.get(ent.parent)
            if par is not None:
                par.children.discard(ent.key)
        self._alloc.free([ent.page])

    def clear(self) -> int:
        """Drop every idle entry; in-use pages stay registered. Returns
        pages freed."""
        return self.evict(len(self._store))

    @property
    def hit_rate(self) -> float:
        """Share of ``acquire`` lookups that mapped at least one page."""
        return (self.hits / self.lookups) if self.lookups else 0.0

    def stats(self) -> Dict[str, object]:
        return {
            "entries": len(self._store),
            "evictable": self.evictable_pages,
            "hits": self.hits,
            "lookups": self.lookups,
            "hit_rate": self.hit_rate,
        }

    def __repr__(self):
        return (f"PrefixCache({len(self._store)} entries, "
                f"{self.evictable_pages} evictable, "
                f"{self.hits}/{self.lookups} hits)")
