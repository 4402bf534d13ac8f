"""The port's ``BatchEncoder`` held to the JAX package's on the CPU, and to
the JAX service's own contract (``tests/test_serving_embed.py``): a
request embedded in any batch, bucket and pooling mix equals the same
request encoded alone; the oldest request sets the bucket; a flooding
tenant does not starve another; deadlines, queue timeouts and cancel on
an injectable clock; pointed validation errors; the attention route
counters; ``steady_state_recompiles() == 0``; and the log2 histogram the
service records into.

Tolerances. Port against JAX, same weights and trace: 1e-5 absolute on
embeddings of magnitude ~1 (f32, sums in other orders). Batched against
b=1: 2e-5, the JAX test's bar (pads are key-masked and left out of the
mean, so only the summation order of the padded batch differs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import BatchEncoder as JaxBatchEncoder
from paddle_tpu.inference import EmbedParams as JaxEmbedParams
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertModel as JaxBertModel
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import bert_state_from_numpy
from paddle_tpu_torch.inference import BatchEncoder, EmbedParams, Engine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.text.models import (BertConfig, BertModel,
                                          LlamaConfig, LlamaForCausalLM)


def _tiny_bert(seed=0, vocab=64, hidden=32, layers=2, heads=2):
    cfg = BertConfig.tiny(vocab=vocab, hidden=hidden, layers=layers,
                          heads=heads)
    net = BertModel(cfg, device="cpu", seed=seed)
    net.eval()
    return net


def _seqs(rng, lens, vocab=64):
    return [rng.integers(1, vocab, (n,)).astype(np.int64).tolist()
            for n in lens]


def _ref_embed(net, tokens, pooling):
    """The b=1 reference: encode alone, no mask, pool on the host."""
    with torch.no_grad():
        x, pooled = net(torch.tensor([tokens]))
    if pooling == "cls":
        return pooled[0].numpy()
    return x[0].mean(dim=0).numpy()


def test_embeddings_match_the_jax_service(rng):
    """One trace through both services, same weights: every request
    finishes in the same batch and its embedding agrees."""
    paddle.seed(3)
    jcfg = JaxBertConfig.tiny(vocab=64, hidden=32, layers=2, heads=2)
    jnet = JaxBertModel(jcfg)
    jnet.eval()
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(jnet).items()}
    tnet = BertModel(BertConfig(**dataclasses.asdict(jcfg)), device="cpu")
    tnet.load_state_dict(bert_state_from_numpy(params))
    seqs = _seqs(rng, (5, 17, 33, 9, 12, 40, 3))
    pools = ["cls" if i % 3 == 0 else "mean" for i in range(len(seqs))]
    tenants = ["a", "b", "a", "c", "b", "a", "c"]
    jsvc = JaxBatchEncoder(jnet, max_batch=3, bucket=16, max_seq=64)
    tsvc = BatchEncoder(tnet, max_batch=3, bucket=16, max_seq=64,
                        device="cpu")
    for s, p, t in zip(seqs, pools, tenants):
        jsvc.add_request(s, JaxEmbedParams(pooling=p), tenant=t)
        tsvc.add_request(s, EmbedParams(pooling=p), tenant=t)
    while not jsvc.idle:
        jo, to = jsvc.step(), tsvc.step()
        assert [o.req_id for o in to] == [o.req_id for o in jo]
        for a, b in zip(to, jo):
            assert a.tokens == b.tokens and a.pooling == b.pooling
            np.testing.assert_allclose(a.embedding, b.embedding, rtol=0,
                                       atol=1e-5)
    assert tsvc.idle
    jsvc.close()


def test_batched_equals_b1_mixed_pooling(rng):
    net = _tiny_bert()
    seqs = _seqs(rng, (5, 17, 33, 9, 12))
    svc = BatchEncoder(net, max_batch=4, bucket=16, max_seq=64,
                       device="cpu")
    items = [(s, EmbedParams(pooling="cls" if i % 3 == 0 else "mean"))
             for i, s in enumerate(seqs)]
    outs = svc.run(items)
    assert [o.req_id for o in outs] == sorted(o.req_id for o in outs)
    for (s, p), out in zip(items, outs):
        assert out.ok and out.finish_reason == "done"
        assert out.tokens == len(s) and out.pooling == p.pooling
        assert out.embedding.dtype == np.float32
        ref = _ref_embed(net, s, p.pooling)
        assert np.abs(out.embedding - ref).max() < 2e-5


def test_oldest_head_sets_bucket(rng):
    net = _tiny_bert(seed=3)
    svc = BatchEncoder(net, max_batch=3, bucket=16, max_seq=64,
                       device="cpu")
    long_head = svc.add_request(_seqs(rng, (40,))[0])     # bucket 48
    short = svc.add_request(_seqs(rng, (6,))[0])
    longer = svc.add_request(_seqs(rng, (60,))[0])        # > bucket
    pad0 = monitor.counter("serving.embed.pad_tokens").get()
    got = {o.req_id for o in svc.step()}
    assert long_head in got and short in got and longer not in got
    # the batch is pinned at 3 rows of the 48 bucket: 2 live, 1 dead
    assert monitor.counter("serving.embed.pad_tokens").get() - pad0 == \
        3 * 48 - 46
    assert {o.req_id for o in svc.step()} == {longer}


def test_tenant_fairness_no_starvation(rng):
    net = _tiny_bert(seed=2)
    svc = BatchEncoder(net, max_batch=2, bucket=16, max_seq=32,
                       device="cpu")
    for s in _seqs(rng, [9] * 12):
        svc.add_request(s, tenant="flooder")
    quiet = svc.add_request(_seqs(rng, (8,))[0], tenant="quiet")
    got = {o.req_id for o in svc.step()} | {o.req_id for o in svc.step()}
    assert quiet in got
    assert svc.num_waiting >= 8


def test_deadline_queue_timeout_cancel(rng):
    """max_batch 1, so each tick takes the oldest request: the deadline
    expires at tick 0, the request with max_queue_steps 1 waits behind
    two others and ages out at tick 2, a cancelled one retires at once."""
    net = _tiny_bert(seed=4)
    clock = {"t": 0.0}
    svc = BatchEncoder(net, max_batch=1, bucket=16, max_seq=32,
                       clock=lambda: clock["t"], device="cpu")
    t0 = monitor.counter("serving.embed.timeouts").get()
    c0 = monitor.counter("serving.embed.cancelled").get()
    head = svc.add_request(_seqs(rng, (4,))[0])
    dead = svc.add_request(_seqs(rng, (5,))[0], EmbedParams(deadline_ms=10))
    second = svc.add_request(_seqs(rng, (3,))[0])
    stale = svc.add_request(_seqs(rng, (6,))[0],
                            EmbedParams(max_queue_steps=1))
    gone = svc.add_request(_seqs(rng, (7,))[0])
    out = svc.cancel(gone)
    assert out.req_id == gone and out.finish_reason == "cancelled"
    assert not out.ok and out.embedding is None
    assert svc.cancel(gone) is None          # already retired
    clock["t"] = 0.05                        # 50 ms: past the deadline
    outs = {o.req_id: o for o in svc.step()}
    assert set(outs) == {head, dead}
    assert outs[dead].finish_reason == "deadline" and not outs[dead].ok
    assert outs[head].ok and outs[head].finish_reason == "done"
    assert [o.req_id for o in svc.step()] == [second]
    outs = svc.step()
    assert [(o.req_id, o.finish_reason) for o in outs] == [
        (stale, "queue_timeout")]
    assert svc.idle
    assert monitor.counter("serving.embed.timeouts").get() == t0 + 2
    assert monitor.counter("serving.embed.cancelled").get() == c0 + 1


def test_validation_errors(rng):
    net = _tiny_bert(seed=5)
    llama = LlamaForCausalLM(LlamaConfig.tiny(vocab=32, hidden=32, layers=1,
                                              heads=2), device="cpu")
    with pytest.raises(ValueError, match="DECODER"):
        BatchEncoder(llama, device="cpu")
    with pytest.raises(ValueError, match="ENCODER"):
        Engine(net, max_slots=2, page_size=8, pool_pages=8, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        BatchEncoder(net, max_batch=0, device="cpu")
    svc = BatchEncoder(net, max_batch=2, bucket=16, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="pooling"):
        svc.add_request(_seqs(rng, (5,))[0], EmbedParams(pooling="max"))
    with pytest.raises(ValueError, match="max_seq"):
        svc.add_request(_seqs(rng, (33,))[0])
    with pytest.raises(ValueError, match="deadline_ms"):
        EmbedParams(deadline_ms=-1).validate()
    with pytest.raises(NotImplementedError, match="analysis slice"):
        svc.inspect_hotpath()


def test_route_counters_and_tick_gauges(rng):
    """The padded batch takes the masked flash route (its plain version on
    the CPU) in every layer, never the dense core; each tick publishes
    the host/device split and the latency histogram."""
    net = _tiny_bert(seed=6)
    before = dict(monitor.snapshot())
    hist = monitor.histogram("serving.hist.embed_latency_ms")
    n0 = hist.count
    svc = BatchEncoder(net, max_batch=2, bucket=16, max_seq=32,
                       device="cpu")
    outs = svc.run(_seqs(rng, (5, 12, 20)))
    assert all(o.ok for o in outs)
    after = monitor.snapshot()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("kernels.flash.sdpa.")
             and after[k] != before.get(k, 0)}
    batches = after["serving.embed.batches"] - before.get(
        "serving.embed.batches", 0)
    assert moved == {"kernels.flash.sdpa.plain_mask": batches * 2}
    assert hist.count == n0 + 3
    assert monitor.gauge("serving.embed.device_ms_per_tick").get() > 0
    assert monitor.gauge("serving.embed.host_ms_per_tick").get() >= 0


def test_steady_state_recompiles_counts_builds_inside_steps(rng,
                                                            monkeypatch):
    net = _tiny_bert(seed=1)
    svc = BatchEncoder(net, max_batch=3, bucket=16, max_seq=64,
                       device="cpu")
    svc.run(_seqs(rng, (5, 17, 33, 12, 30)))
    svc.run(_seqs(rng, (2, 45, 25, 16, 7, 31)))
    assert svc.steady_state_recompiles() == 0
    # a kernel library built inside a later step counts
    real = svc._embed

    def building(*a):
        _build.build.libraries_built += 1
        return real(*a)
    monkeypatch.setattr(svc, "_embed", building)
    monkeypatch.setattr(_build.build, "libraries_built",
                        _build.build.libraries_built)
    svc.run(_seqs(rng, (9,)))
    assert svc.steady_state_recompiles() == 1


def test_histogram_percentiles():
    h = monitor.Histogram("t")
    vals = np.random.default_rng(0).lognormal(1.0, 1.0, 5000)
    for v in vals:
        h.record(v)
    h.record(0.0)
    assert h.count == 5001
    for q in (50, 90, 99):
        want = np.percentile(np.append(vals, 0.0), q, method="inverted_cdf")
        assert abs(h.percentile(q) - want) <= 0.05 * want
    assert h.percentile(0) == 0.0                 # the zero bucket
    assert vals.max() * 0.95 <= h.percentile(100) <= vals.max()
    h.reset()
    assert h.count == 0 and h.percentile(50) == 0.0
