"""Paged-KV block allocator — the free list under the serving engine.

The port's own copy of ``paddle_tpu/inference/allocator.py`` (that
module imports no JAX, but the port imports nothing of the JAX
package). KV memory is a global pool of fixed-size pages; each
sequence owns an ordered list of page ids recorded in its block-table
row, pages are handed out as sequences grow and returned the moment a
sequence finishes (EOS or budget) — not at the end of the serving call.

Pages are REFCOUNTED (``share``) so a later prefix cache can map one
physical page into many block tables; ``free`` only returns a page to
the free list when its last reference drops.

This is pure host-side bookkeeping (python ints in a deque); the pool
tensors themselves live in kernels/paged_attention.py's head-major
layout and are updated in place by the engine's steps. Pool exhaustion
is ONE loud RuntimeError naming the pool geometry and the requesting
sequence — never a clipped page index silently overwriting another
sequence's tokens.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional


class PageAllocator:
    """FIFO free list over ``num_pages`` page ids starting at ``base``.

    ``base=1`` is the serving engine's convention: page 0 is the shared
    scratch page every inactive slot's block-table row points at, so
    masked lanes of the fixed-shape decode step write garbage somewhere
    harmless instead of into a live sequence.
    """

    def __init__(self, num_pages: int, base: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.base = int(base)
        self._free = deque(range(self.base, self.base + self.num_pages))
        self._owner: Dict[int, Optional[object]] = {}
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages held by MORE than one reference (prefix-cache sharing).
        Each shared page occupies exactly one pool slot however many
        block tables map it — the admission watermark reads the free
        list, so a would-be-shared prefix never inflates apparent
        pool pressure."""
        return sum(1 for r in self._refs.values() if r > 1)

    def can_alloc(self, n: int, watermark: int = 0) -> bool:
        """True when ``n`` pages fit while leaving ``watermark`` pages
        free — the admission-control check: headroom for RUNNING
        sequences to grow before a new one is let in."""
        return len(self._free) - int(watermark) >= int(n)

    def alloc(self, n: int, seq=None) -> List[int]:
        """Hand out ``n`` page ids (oldest-freed first) with refcount 1,
        owned by ``seq``. Raises RuntimeError naming the pool geometry
        when the pool can't cover the request — the caller either
        preempts a sequence (or evicts idle prefix-cache pages) and
        retries, or surfaces the error."""
        n = int(n)
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: sequence {seq!r} requested "
                f"{n} page(s) but only {len(self._free)} of "
                f"{self.num_pages} are free ({self.live_pages} live) — "
                f"grow pool_pages, lower max_slots, or let the "
                f"scheduler preempt")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._owner[p] = seq
            self._refs[p] = 1
        return pages

    def share(self, page: int) -> int:
        """Take one more reference on a live page (prefix-cache hit:
        the page is mapped into another block table without a copy).
        Returns the page id; sharing a dead page fails loudly."""
        page = int(page)
        if page not in self._refs:
            raise RuntimeError(
                f"sharing page {page} that is not live — the prefix "
                f"cache may only map allocated pages")
        self._refs[page] += 1
        return page

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def free(self, pages) -> None:
        """Drop one reference per page; a page returns to the free list
        (EOS/finish/preemption/eviction time — not end-of-call) only
        when its LAST reference drops. Over-frees and foreign ids fail
        loudly: both corrupt the pool silently if let through."""
        for p in pages:
            p = int(p)
            if p not in self._refs:
                lo, hi = self.base, self.base + self.num_pages
                raise RuntimeError(
                    f"freeing page {p} that is not live (pool ids "
                    f"[{lo}, {hi}), {self.live_pages} live) — "
                    f"double-free or foreign page id")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                del self._owner[p]
                self._free.append(p)

    def owner(self, page: int):
        return self._owner.get(int(page))

    def check_invariants(self,
                         expected: Optional[Dict[int, int]] = None,
                         repair: bool = False) -> List[str]:
        """Free-list / live / refcount consistency audit. Returns one
        human-readable finding per violation (empty list = healthy);
        with ``repair=True`` each finding is also FIXED in place (the
        chaos-recovery path: after injected refcount skew the pool must
        converge back to balanced, not wedge).

        Internal invariants (always checked): every page id is either
        on the free list or refcounted, never both and never neither;
        free ids are unique and in range; the owner map tracks exactly
        the live pages; no live refcount is below 1.

        ``expected`` adds the CALLER's cross-check: a map of page id →
        the number of references the caller can account for (the
        engine builds it from live requests' block-table pages plus
        one per prefix-cache entry). A live page nobody accounts for
        is a LEAK; a refcount above/below the accounted holders is
        REFCOUNT SKEW — the failure modes a lost ``free`` or a stray
        ``share`` produce, invisible to the internal checks because
        the allocator's own books still balance.
        """
        findings: List[str] = []
        lo, hi = self.base, self.base + self.num_pages
        free_list = list(self._free)
        free_set = set(free_list)
        if len(free_list) != len(free_set):
            findings.append(
                f"free list holds duplicate ids "
                f"({len(free_list)} entries, {len(free_set)} unique) — "
                f"double-free let through")
            if repair:
                self._free = deque(dict.fromkeys(free_list))
                free_list = list(self._free)
        bad_range = [p for p in free_set if not lo <= p < hi]
        if bad_range:
            findings.append(
                f"free list holds out-of-range ids {sorted(bad_range)} "
                f"(pool ids [{lo}, {hi}))")
            if repair:
                self._free = deque(p for p in self._free
                                   if lo <= p < hi)
        both = free_set & set(self._refs)
        if both:
            findings.append(
                f"pages {sorted(both)} are BOTH free and refcounted — "
                f"the next alloc would alias a live sequence")
            if repair:
                self._free = deque(p for p in self._free
                                   if p not in both)
        if set(self._owner) != set(self._refs):
            extra = sorted(set(self._owner) - set(self._refs))
            missing = sorted(set(self._refs) - set(self._owner))
            findings.append(
                f"owner/refcount maps diverge (owner-only {extra}, "
                f"refs-only {missing})")
            if repair:
                for p in extra:
                    del self._owner[p]
                for p in missing:
                    self._owner[p] = None
        nonpos = {p: r for p, r in self._refs.items() if r < 1}
        if nonpos:
            findings.append(
                f"live pages with refcount < 1: {nonpos}")
            if repair:
                for p in nonpos:
                    del self._refs[p]
                    self._owner.pop(p, None)
                    self._free.append(p)
        free_now = set(self._free)      # repairs above may have
        lost = [p for p in range(lo, hi)  # mutated the free list
                if p not in self._refs and p not in free_now]
        if lost:
            findings.append(
                f"pages {lost} vanished from both the free list and "
                f"the refcount map")
            if repair:
                self._free.extend(lost)
        if expected is not None:
            for p, refs in sorted(self._refs.items()):
                want = int(expected.get(p, 0))
                if want == 0:
                    findings.append(
                        f"leaked page {p}: refcount {refs} but no "
                        f"request or cache entry holds it")
                    if repair:
                        self.free([p] * refs)
                elif refs != want:
                    findings.append(
                        f"refcount skew on page {p}: allocator has "
                        f"{refs}, holders account for {want}")
                    if repair:
                        if refs > want:
                            self.free([p] * (refs - want))
                        else:
                            for _ in range(want - refs):
                                self.share(p)
            orphans = sorted(p for p, n in expected.items()
                             if n > 0 and p not in self._refs)
            if orphans:
                findings.append(
                    f"pages {orphans} are mapped by a request or "
                    f"cache entry but not live in the allocator — "
                    f"their next reuse aliases foreign KV")
                if repair:
                    free_now = set(self._free)
                    for p in orphans:
                        if p in free_now:
                            self._free.remove(p)
                            free_now.discard(p)
                        self._owner[p] = None
                        self._refs[p] = int(expected[p])
        return findings

    def stats(self) -> Dict[str, object]:
        """Pool state snapshot for admission decisions and the
        ``serving.prefix_pages_shared`` gauge: free/live/shared page
        counts plus a refcount histogram ({refcount: pages}) — a
        healthy prefix-heavy pool shows a tall bucket at the hot
        system prompt's share count."""
        hist: Dict[int, int] = {}
        for r in self._refs.values():
            hist[r] = hist.get(r, 0) + 1
        return {
            "num_pages": self.num_pages,
            "free": self.free_pages,
            "live": self.live_pages,
            "shared": self.shared_pages,
            "refcount_hist": dict(sorted(hist.items())),
        }

    def __repr__(self):
        return (f"PageAllocator({self.live_pages} live / "
                f"{self.num_pages} pages, {self.shared_pages} shared, "
                f"base={self.base})")
