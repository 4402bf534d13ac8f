"""The port's prefix cache (``paddle_tpu_torch.inference.prefix_cache``)
held to the JAX one, and the Engine with ``prefix_cache=True`` on the CPU
held to the engine without it and to the JAX Engine with the same
weights: the same chained hashes, hits, evictions and stats over one op
sequence; a hit prefills only the uncached tail; the page a request
appends into stays private (copy-on-write); idle cached pages are
evicted before admission is refused or a sequence preempted; greedy
tokens, prefix counters and free-page trajectories equal the JAX
engine's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.inference import allocator as jalloc
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference import Engine, PageAllocator, SamplingParams
from paddle_tpu_torch.inference import prefix_cache as tpc

from test_torch_engine import _drive, _prompts, _tiny, torch_one_thread
from test_torch_llama import make_pair

PREFIX = ["serving.prefix_lookups", "serving.prefix_hits",
          "serving.prefix_tokens_reused", "serving.prefill_slices",
          "serving.prefill_tokens", "serving.preemptions"]

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _reset():
    for n in PREFIX:
        jmon.counter(n).reset()
        monitor.counter(n).reset()


def _counts(mon):
    return {n: mon.counter(n).get() for n in PREFIX}


def _cache_state(cache, alloc):
    return (cache.stats(), list(alloc._free), dict(alloc._refs),
            sorted((e.key, e.page, e.depth, e.last_use)
                   for e in cache._store.values()))


def test_prefix_cache_unit_parity_with_jax():
    """One op sequence — allocate, insert, acquire (hit, partial hit,
    miss, capped), free, evict, clear, integrity — on both caches over
    their own allocators: the same return values, digests, stats,
    free lists and refcounts after every op."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, (26,)).tolist()
    b = a[:12] + rng.integers(0, 50, (9,)).tolist()
    c = rng.integers(0, 50, (13,)).tolist()
    assert tpc._chunk_hash(None, a[:4]) == jpc._chunk_hash(None, a[:4])
    assert tpc._chunk_hash(b"p" * 16, a[4:8]) == \
        jpc._chunk_hash(b"p" * 16, a[4:8])
    sides = []
    for pc, al in ((jpc, jalloc), (tpc, None)):
        alloc = (al.PageAllocator(24, base=1) if al is not None
                 else PageAllocator(24, base=1))
        sides.append((pc.PrefixCache(alloc, 4), alloc))

    def both(op):
        outs = [op(cache, alloc) for cache, alloc in sides]
        assert outs[0] == outs[1]
        assert _cache_state(*sides[0]) == _cache_state(*sides[1])
        return outs[1]

    pa = both(lambda c_, al: al.alloc(7, seq="a"))
    assert both(lambda c_, al: c_.insert(a, pa, 26)) == 6
    assert both(lambda c_, al: c_.lookup(b)) == 12
    got = both(lambda c_, al: c_.acquire(b, max_chunks=(len(b) - 1) // 4))
    assert got[1] == 12
    pb = both(lambda c_, al: al.alloc(3, seq="b"))
    both(lambda c_, al: c_.insert(b, got[0] + pb, 21))
    assert both(lambda c_, al: c_.acquire(c)) == ([], 0)
    # capped: the exact 8-token prompt maps one page, not two
    assert both(lambda c_, al: c_.acquire(a[:8], max_chunks=1))[1] == 4
    both(lambda c_, al: al.free(pa))
    assert both(lambda c_, al: c_.evict(2)) == 2
    both(lambda c_, al: al.free(got[0] + pb))
    both(lambda c_, al: c_.check_integrity())
    assert both(lambda c_, al: c_.clear()) > 0
    assert both(lambda c_, al: (c_.hits, c_.lookups, c_.hit_rate))[:2] \
        == (2, 3)


def test_forced_collision_degrades_to_a_miss():
    """A digest collision (every chunk hashes alike) never serves another
    prompt's pages: the exact-token compare turns it into a miss, and
    the colliding prefix stays uncached."""
    alloc = PageAllocator(8, base=1)
    cache = tpc.PrefixCache(alloc, 4, hash_fn=lambda parent, t: b"x" * 16)
    pages = alloc.alloc(2)
    assert cache.insert([1, 2, 3, 4, 5, 6, 7, 8], pages, 8) == 1
    assert cache.acquire([9, 9, 9, 9, 1, 1, 1, 1]) == ([], 0)
    assert cache.insert([9, 9, 9, 9], alloc.alloc(1), 4) == 0
    assert cache.acquire([1, 2, 3, 4, 0]) == ([pages[0]], 4)


def _shared_prefix_trace(rng, sys_len=19, tails=(5, 9, 3, 7, 12)):
    sysp = rng.integers(0, 64, (sys_len,)).astype(np.int32)
    p = [np.concatenate([sysp, x]) for x in _prompts(rng, tails)]
    return {0: [(p[0], 8)], 2: [(p[1], 6), (p[2], 8)], 4: [(p[3], 5)],
            6: [(p[4], 9)]}


def test_prefix_cache_tokens_and_counters_match_jax():
    """A shared 19-token system prompt across 5 staggered requests: the
    JAX engine's greedy tokens, prefix counters, prefill counts and
    free-page trajectory; the tokens of the engine without the cache."""
    jnet, tnet, _ = make_pair()
    sched = _shared_prefix_trace(np.random.default_rng(0))
    kw = dict(max_slots=3, page_size=8, pool_pages=64, max_context=64,
              prefill_bucket=8)
    _reset()
    jeng = JaxEngine(jnet, prefix_cache=True, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tnet, device="cpu", prefix_cache=True, **kw)
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert _counts(monitor) == _counts(jmon)
    assert monitor.counter("serving.prefix_hits").get() == 4
    plain, _ = _drive(Engine(tnet, device="cpu", **kw), SamplingParams,
                      sched)
    assert tdone == jdone == plain
    assert tfree == jfree
    assert teng.prefix_hit_rate == jeng.prefix_hit_rate == 0.8
    assert teng.leaked_pages() == 0 == jeng.leaked_pages()
    jeng.close()


def test_hit_prefills_only_the_tail():
    """The second request maps the first's two full system-prompt pages
    and prefills one bucket of its tail at the page-aligned start 16."""
    net = _tiny()
    rng = np.random.default_rng(1)
    sysp = rng.integers(0, 64, (18,)).astype(np.int32)
    a, b = (np.concatenate([sysp, x]) for x in _prompts(rng, (4, 5)))
    eng = Engine(net, device="cpu", max_slots=2, page_size=8,
                 max_context=64, prefill_bucket=8, prefix_cache=True)
    first = eng.run([(a, SamplingParams(max_new_tokens=4))])
    _reset()
    second = eng.run([(b, SamplingParams(max_new_tokens=4))])
    assert monitor.counter("serving.prefix_tokens_reused").get() == 16
    assert monitor.counter("serving.prefill_tokens").get() == 8
    plain = Engine(net, device="cpu", max_slots=2, page_size=8,
                   max_context=64, prefill_bucket=8).run(
        [(a, SamplingParams(max_new_tokens=4)),
         (b, SamplingParams(max_new_tokens=4))])
    assert [first[0].token_ids, second[0].token_ids] == \
        [o.token_ids for o in plain]


def test_copy_on_write_divergence():
    """Two requests with the same page-aligned 16-token prompt: the
    second maps only the first page (one real token must be left), its
    append page is private, the shared page's K/V never change while
    both decode, and both emit the cache-free tokens."""
    net = _tiny(seed=2)
    prompt = np.random.default_rng(2).integers(0, 64, (16,)).astype(
        np.int32)
    eng = Engine(net, device="cpu", max_slots=2, page_size=8,
                 max_context=64, prefill_bucket=8, prefix_cache=True)
    eng.add_request(prompt, SamplingParams(max_new_tokens=10))
    eng.step()                                    # prefill + insert
    a = next(r for r in eng._slots if r is not None)
    eng.add_request(prompt, SamplingParams(max_new_tokens=10))
    eng.step()
    b = next(r for r in eng._slots if r is not None and r is not a)
    assert b.pages[0] == a.pages[0] and b.pages[1] != a.pages[1]
    shared = a.pages[0]
    assert eng._alloc.refcount(shared) == 3      # a, b and the cache
    before = [t[shared].clone() for c in eng._pools for t in c[:2]]
    outs = {}
    while len(outs) < 2:
        outs.update((o.req_id, o.token_ids) for o in eng.step())
    after = [t[shared] for c in eng._pools for t in c[:2]]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    alone = Engine(net, device="cpu", max_slots=2, page_size=8,
                   max_context=64, prefill_bucket=8).run(
        [(prompt, SamplingParams(max_new_tokens=10))])[0].token_ids
    assert outs == {0: alone, 1: alone}
    assert eng.leaked_pages() == 0


def test_eviction_with_a_preempted_holder_matches_jax(monkeypatch):
    """A pool too small for the trace: the first request's cached system
    prompt outlives it; growth preempts the youngest sequence, a prefix
    holder whose shared references drop with its pages; idle cached
    pages are evicted before admission is refused or another sequence
    preempted — the JAX engine's tokens, preemptions, prefix counters and
    free-page trajectory, and nothing leaked."""
    freed = []
    evict = tpc.PrefixCache.evict
    monkeypatch.setattr(tpc.PrefixCache, "evict", lambda self, n: (
        freed.append(evict(self, n)) or freed[-1]))
    jnet, tnet, _ = make_pair(seed=3)
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, 64, (8,)).astype(np.int32)
    p = [np.concatenate([sysp, x]) for x in _prompts(rng, (3, 5, 2, 6))]
    q = _prompts(rng, (9,))[0]
    sched = {0: [(p[0], 3)], 2: [(p[1], 12), (q, 12)], 3: [(p[2], 10)],
             6: [(p[3], 9)]}
    kw = dict(max_slots=3, page_size=4, pool_pages=13, max_context=32,
              prefill_bucket=4, watermark_pages=0)
    _reset()
    jeng = JaxEngine(jnet, prefix_cache=True, **kw)
    jdone, jfree = _drive(jeng, JaxParams, sched)
    teng = Engine(tnet, device="cpu", prefix_cache=True, **kw)
    tdone, tfree = _drive(teng, SamplingParams, sched)
    assert sum(freed) > 0
    assert monitor.counter("serving.preemptions").get() > 0
    assert _counts(monitor) == _counts(jmon)
    assert tdone == jdone
    assert tfree == jfree
    assert teng.leaked_pages() == 0 == jeng.leaked_pages()
    jeng.close()
