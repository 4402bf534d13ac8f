"""Request migration in the port's Engine (``Engine.extract_request``) on
the CPU: a live request leaves one engine whole and is re-admitted on a
second Engine over the same weights (``Engine.readmit``: appended to its
waiting queue and request table, as the JAX serving fleet does), and its token stream
continues bit for bit — greedy and sampled, mid-decode and mid-prefill,
single- and multi-tick. Greedy streams also equal the JAX engine's
extract / re-admit on the same weights (``bridge.py``). The MIGRATING
span, the pages of both engines and the None returns are checked too.

Tolerance: exact tokens.
"""
import numpy as np
import pytest

from paddle_tpu.inference.engine import Engine as JaxEngine
from paddle_tpu.inference.engine import SamplingParams as JaxParams
from paddle_tpu_torch.inference import Engine, SamplingParams, tracing

from test_torch_engine import _prompts, _tiny, torch_one_thread  # noqa: F401
from test_torch_llama import make_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KW = dict(max_slots=3, page_size=4, max_context=48, prefill_bucket=4)


def _requests(sampled, seed=0):
    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, (5, 11, 3, 14))
    out = []
    for i, p in enumerate(prompts):
        temp = 0.9 if sampled and i % 2 == 0 else 0.0
        out.append((p, dict(max_new_tokens=9 + i, temperature=temp,
                            top_k=8 if temp else 0, seed=40 + i)))
    return out


def _readmit(dst, req):
    """``Engine.readmit``; the JAX engine has none, so for it what its
    serving fleet does with an extracted request (``fleet.py``
    ``_assign``)."""
    if isinstance(dst, JaxEngine):
        req.queued_step = dst._steps
        dst._waiting.append(req)
        dst.requests[req.req_id] = req
    else:
        dst.readmit(req)


def _migrated(make, params_cls, requests, at_step, pick):
    """Run ``requests`` on engine A; after ``at_step`` steps extract the
    ids ``pick(A)`` chooses and re-admit them on engine B; drain both.
    Returns ({req_id: tokens}, the extracted requests, A, B)."""
    a, b = make(), make()
    for p, kw in requests:
        a.add_request(p, params_cls(**kw))
    done = {}
    for _ in range(at_step):
        for o in a.step():
            done[o.req_id] = o
    moved = [a.extract_request(rid) for rid in pick(a)]
    assert all(r is not None for r in moved)
    for r in moved:
        _readmit(b, r)
    for _ in range(400):
        for eng in (a, b):
            for o in eng.step():
                done[o.req_id] = o
        if len(done) == len(requests):
            break
    assert len(done) == len(requests)
    assert all(o.ok for o in done.values())
    return {rid: o.token_ids for rid, o in done.items()}, moved, a, b


def _decoding(eng):
    return [rid for rid, r in eng.requests.items()
            if r.generated and r.slot is not None]


def _prefilling(eng):
    return [rid for rid, r in eng.requests.items()
            if r.slot is not None and not r.generated]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("multi_tick", [1, 4])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_migrated_stream_continues_bit_for_bit(sampled, multi_tick, phase):
    net = _tiny()
    kw = dict(KW, multi_tick=multi_tick)
    if phase == "prefill":
        kw["max_prefill_tokens_per_step"] = 4   # prompts span steps
    requests = _requests(sampled)

    def make():
        return Engine(net, device="cpu", **kw)
    ref = {o.req_id: o.token_ids for o in make().run(
        [(p, SamplingParams(**k)) for p, k in requests])}
    pick = _decoding if phase == "decode" else _prefilling
    at = 4 if phase == "decode" else 2
    got, moved, a, b = _migrated(make, SamplingParams, requests, at, pick)
    assert moved, "nothing was live to migrate"
    if phase == "decode":
        assert all(r.state == "PREEMPTED" or r.generated for r in moved)
    assert got == ref
    assert a.leaked_pages() == 0 and b.leaked_pages() == 0
    assert a.pages_free == a.pool_pages and b.pages_free == b.pool_pages


def test_greedy_migration_matches_the_jax_engine():
    jnet, tnet, _ = make_pair(hidden=32, heads=4)
    requests = _requests(False, seed=3)

    def pick(eng):
        return sorted(_decoding(eng))[:2]
    jgot, _, ja, jb = _migrated(lambda: JaxEngine(jnet, **KW), JaxParams,
                                requests, 4, pick)
    tgot, _, _, _ = _migrated(lambda: Engine(tnet, device="cpu", **KW),
                              SamplingParams, requests, 4, pick)
    assert tgot == jgot
    ja.close()
    jb.close()


def test_extract_states_span_and_refusals():
    net = _tiny()
    eng = Engine(net, device="cpu", label="src", **KW)
    rng = np.random.default_rng(5)
    p = _prompts(rng, (6, 7, 5, 4))
    ids = [eng.add_request(q, SamplingParams(max_new_tokens=12))
           for q in p]
    eng.step()
    eng.step()
    queued = [rid for rid in ids if eng.requests[rid].slot is None]
    live = _decoding(eng)
    assert queued and live
    free0 = eng.pages_free
    r = eng.extract_request(live[0])
    assert r.state == "PREEMPTED" and r.slot is None and not r.pages
    assert live[0] not in eng.requests and eng.pages_free > free0
    assert tracing.current_phase(r.spans) == tracing.MIGRATING
    assert r.spans[-1]["origin"] == "src"
    q = eng.extract_request(queued[0])
    assert q.state == "WAITING" and q not in eng._waiting
    assert eng.extract_request(live[0]) is None       # already gone
    assert eng.extract_request(999) is None           # unknown
    with pytest.raises(ValueError, match="device_key"):
        eng.extract_request(live[1], device_key=True)
    done = set()
    while not eng.idle:
        done |= {o.req_id for o in eng.step()}
    retired = min(done)
    assert eng.extract_request(retired) is None        # retired
    assert eng.leaked_pages() == 0
    # the migrated request's timeline closes MIGRATING on the new engine
    dst = Engine(net, device="cpu", label="dst", **KW)
    dst.readmit(r)
    with pytest.raises(ValueError, match="already live"):
        dst.readmit(r)
    assert list(dst._waiting).count(r) == 1
    outs = []
    while not dst.idle:
        outs += dst.step()
    (out,) = [o for o in outs if o.req_id == r.req_id]
    phases = [s["phase"] for s in out.spans]
    assert "MIGRATING" in phases
    m = phases.index("MIGRATING")
    assert out.spans[m]["origin"] == "src"
    assert out.spans[m + 1]["origin"] == "dst"
    assert tracing.validate_timeline(out.spans, tol_ms=0.01) == []
