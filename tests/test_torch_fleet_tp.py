"""The port's tensor parallelism at mp=2 held to the JAX package's
layers and models on its CPU mesh (mp=2), with the same global weights:
the JAX package's global parameters, sliced to each rank's shard by
``bridge`` (BERT's qkv permuted by head). One 2-rank gloo world (the
port's ``spawn``, a ``FileStore``; ranks in ``torch_dist_worker.py``)
runs every case; the ranks' gradients are merged back to global arrays
(``bridge.tp_merge``) and compared here.

Tolerances:

- the Column -> Row MLP, ``VocabParallelEmbedding`` and
  ``ParallelCrossEntropy``: outputs and gradients rtol 1e-5, atol 1e-5
  (``test_tp_matches_single_device`` and
  ``test_vocab_parallel_embedding_and_ce``);
- a 2-layer LLaMA with and without the vocabulary-parallel fused loss,
  and a tiny BERT with its per-rank qkv (dense and fused MLM loss): the
  loss rtol 1e-5, atol 1e-6, every gradient within closeness's f32 gate
  (|got - want| <= 1e-4 max(1, max |want|): the two sum in other
  orders);
- a clipped step (``ClipGradByGlobalNorm(0.1)``, active: the global norm
  is above it): 3 AdamW steps' losses rtol 1e-5 and the parameters as
  ``test_torch_trainstep`` holds them (99.9 % of elements within 1e-6,
  every one within 1e-4, a tenth of one step's lr);
- the RNG tracker by its properties (the ranks' dropout masks differ
  under ``model_parallel_rng`` and agree outside it).

In process: ``force_tp_layers`` builds LLaMA of the parallel classes at
mp=1, equal to the plain model bit for bit.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertForPretraining as JaxBertPT
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.bridge import bert_state_to_numpy, tp_merge

import torch_dist_worker as W


class _mesh:
    def __enter__(self):
        self.prev = jmesh.get_mesh()
        jmesh.set_mesh(jmesh.build_mesh({"mp": 2}))

    def __exit__(self, *exc):
        jmesh._global_mesh = self.prev


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _gate(got, want):
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _tp_inputs(rng):
    f = np.float32
    return dict(
        w1=rng.standard_normal((16, 32)).astype(f) * 0.3,
        b1=rng.standard_normal(32).astype(f) * 0.1,
        w2=rng.standard_normal((32, 16)).astype(f) * 0.3,
        b2=rng.standard_normal(16).astype(f) * 0.1,
        x=rng.standard_normal((4, 16)).astype(f),
        cot=rng.standard_normal((4, 16)).astype(f),
        emb=rng.standard_normal((32, 8)).astype(f),
        ids=np.array([[1, 5, 31], [0, 2, 17]], np.int64),
        ecot=rng.standard_normal((2, 3, 8)).astype(f),
        logits=rng.standard_normal((2, 3, 32)).astype(f),
        labels=np.array([[1, 5, 31], [0, 20, 7]], np.int64))


def _jax_layers(t):
    with _mesh():
        col = ColumnParallelLinear(16, 32, gather_output=False)
        row = RowParallelLinear(32, 16, input_is_parallel=True)
        for p, v in ((col.weight, t["w1"]), (col.bias, t["b1"]),
                     (row.weight, t["w2"]), (row.bias, t["b2"])):
            p.set_value(v)
        x = paddle.to_tensor(t["x"], stop_gradient=False)
        out = row(jF.relu(col(x)))
        (out * paddle.to_tensor(t["cot"])).sum().backward()
        res = dict(mlp_out=_np(out), mlp_dx=_np(x.grad),
                   mlp_dw1=_np(col.weight.grad), mlp_db1=_np(col.bias.grad),
                   mlp_dw2=_np(row.weight.grad), mlp_db2=_np(row.bias.grad))
        emb = VocabParallelEmbedding(32, 8)
        emb.weight.set_value(t["emb"])
        e = emb(paddle.to_tensor(t["ids"]))
        (e * paddle.to_tensor(t["ecot"])).sum().backward()
        ce = ParallelCrossEntropy()(paddle.to_tensor(t["logits"]),
                                    paddle.to_tensor(t["labels"]))
        # the JAX ParallelCrossEntropy's eager result carries no tape
        # (its body is raw jnp): its gradient is the plain CE's, which
        # test_vocab_parallel_embedding_and_ce holds it equal to
        logits = paddle.to_tensor(t["logits"], stop_gradient=False)
        jF.cross_entropy(logits.reshape([-1, 32]),
                         paddle.to_tensor(t["labels"]).reshape([-1]),
                         reduction="sum").backward()
        res.update(emb_out=_np(e), emb_dw=_np(emb.weight.grad), ce=_np(ce),
                   ce_dlogits=_np(logits.grad))
    return res


def _jax_llama(seed):
    paddle.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=W.VOCAB, hidden=64, layers=2, heads=4)
    jc.fused_ce_chunks = 2
    with _mesh():
        net = JaxLlama(jc)
    return jc, {k: np.asarray(v, np.float32)
                for k, v in get_params(net).items()}


def _jax_llama_grads(jc, params, batch, fused):
    with _mesh():
        net = JaxLlama(dataclasses.replace(jc, fused_linear_ce=fused))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        ids = paddle.to_tensor(batch)
        if fused:
            loss = net(ids, labels=ids)
        else:
            logits = net(ids)
            loss = jF.cross_entropy(logits.reshape([-1, jc.vocab_size]),
                                    ids.reshape([-1]))
        loss.backward()
        return float(loss.numpy()), {n: _np(p.grad)
                                     for n, p in net.named_parameters()}


def _jax_bert(seed):
    paddle.seed(seed)
    jc = JaxBertConfig.tiny(vocab=64, hidden=64, layers=2, heads=4)
    jc.hidden_dropout_prob = jc.attention_probs_dropout_prob = 0.0
    jc.fused_ce_chunks = 2
    with _mesh():
        net = JaxBertPT(jc)
    return jc, {k: np.asarray(v, np.float32)
                for k, v in get_params(net).items()}


def _bert_batch(rng):
    ids = rng.integers(0, 64, (2, 10))
    labels = np.where(rng.random((2, 10)) < 0.4, ids, -100)
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    return dict(ids=ids, types=rng.integers(0, 2, (2, 10)), labels=labels,
                mask=mask)


def _jax_bert_grads(jc, params, b, fused):
    with _mesh():
        net = JaxBertPT(dataclasses.replace(jc, fused_mlm_ce=fused))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        loss, _ = net(paddle.to_tensor(b["ids"]),
                      paddle.to_tensor(b["types"]),
                      labels=paddle.to_tensor(b["labels"]),
                      attention_mask=paddle.to_tensor(b["mask"]))
        loss.backward()
        # the NSP head and the pooler are off the MLM loss: no gradient
        return float(loss.numpy()), {
            n: np.zeros(p.shape, np.float32) if p.grad is None
            else _np(p.grad) for n, p in net.named_parameters()}


def _jax_clipped(jc, params, batch):
    with _mesh():
        net = JaxLlama(dataclasses.replace(jc, fused_linear_ce=True))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        opt = paddle.optimizer.AdamW(
            W.LR, parameters=net.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(W.CLIP))
        step = paddle.jit.TrainStep(net, lambda out, lab: out, opt)
        x = paddle.to_tensor(batch)
        losses = [float(step((x, x), x).numpy()) for _ in range(W.STEPS)]
        return losses, {k: np.asarray(v, np.float32)
                        for k, v in get_params(net).items()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(7)
    jc, params = _jax_llama(3)
    bc, bparams = _jax_bert(4)
    inputs = dict(tp=_tp_inputs(rng),
                  llama_cfg=dict(dataclasses.asdict(jc),
                                 fused_linear_ce=True),
                  llama_params=params,
                  batch=rng.integers(0, W.VOCAB, (W.B, W.S)),
                  bert_cfg=dataclasses.asdict(bc), bert_params=bparams,
                  bert_batch=_bert_batch(rng))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = W.start_world(2, "world2", tmp)
    want = dict(
        layers=_jax_layers(inputs["tp"]),
        llama={f: _jax_llama_grads(jc, params, inputs["batch"], f)
               for f in (False, True)},
        bert={f: _jax_bert_grads(bc, bparams, inputs["bert_batch"], f)
              for f in (False, True)},
        clipped=_jax_clipped(jc, params, inputs["batch"]))
    return W.join_world(ctx, str(tmp)), want


def _merge(ranks, get, family, name, jax_layout=None):
    full = tp_merge([get(r) for r in ranks], family, name)
    if jax_layout:
        full = bert_state_to_numpy({name: torch.from_numpy(full)})[name]
    return full


_MLP_MERGE = {"mlp_dw1": 1, "mlp_db1": 0, "mlp_dw2": 0}


@pytest.mark.parametrize("key", ["mlp_out", "mlp_dx", "mlp_dw1", "mlp_db1",
                                 "mlp_dw2", "mlp_db2", "emb_out", "emb_dw",
                                 "ce", "ce_dlogits"])
def test_tp_layers_match_jax(world2, key):
    ranks, want = world2
    parts = [r["layers"][key] for r in ranks]
    if key in _MLP_MERGE:
        got = np.concatenate(parts, axis=_MLP_MERGE[key])
    elif key in ("emb_dw",):
        got = np.concatenate(parts, axis=0)
    elif key == "ce_dlogits":
        got = np.concatenate(parts, axis=-1)
    else:
        got = parts[0]
        np.testing.assert_allclose(parts[1], parts[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want["layers"][key], rtol=1e-5,
                               atol=1e-5)


def test_tp_layers_mark_their_shards(world2):
    ranks, _ = world2
    for r in ranks:
        assert r["layers"]["distributed"] == (True, True, False)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_llama_mp2_matches_jax(world2, fused):
    ranks, want = world2
    loss, grads = want["llama"][fused]
    for r in ranks:
        np.testing.assert_allclose(r["llama"][fused]["loss"], loss,
                                   rtol=1e-5, atol=1e-6)
    from paddle_tpu_torch.bridge import llama_state_to_numpy
    for name, w in grads.items():
        full = tp_merge([r["llama"][fused]["grads"][name] for r in ranks],
                        "llama", name)
        got = llama_state_to_numpy({name: torch.from_numpy(full)})[name]
        _gate(got, w)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_bert_mp2_per_rank_qkv_matches_jax(world2, fused):
    ranks, want = world2
    loss, grads = want["bert"][fused]
    for r in ranks:
        np.testing.assert_allclose(r["bert"][fused]["loss"], loss,
                                   rtol=1e-5, atol=1e-6)
    assert sorted(ranks[0]["bert"][fused]["grads"]) == sorted(grads)
    for name, w in grads.items():
        full = tp_merge([r["bert"][fused]["grads"][name] for r in ranks],
                        "bert", name)
        got = bert_state_to_numpy({name: torch.from_numpy(full)})[name]
        _gate(got, w)


def test_clipped_step_matches_jax(world2):
    ranks, want = world2
    losses, params = want["clipped"]
    from paddle_tpu_torch.bridge import llama_state_to_numpy
    for r in ranks:
        np.testing.assert_allclose(r["clipped"]["losses"], losses,
                                   rtol=1e-5)
    for name, w in params.items():
        full = tp_merge([r["clipped"]["params"][name] for r in ranks],
                        "llama", name)
        got = llama_state_to_numpy({name: torch.from_numpy(full)})[name]
        err = np.abs(got - w)
        assert np.quantile(err, 0.999) <= 1e-6 and err.max() <= 1e-4, name


def test_bert_mp_degree_must_match_topology():
    from paddle_tpu_torch.text.models import BertConfig, BertModel
    with pytest.raises(ValueError, match="hybrid topology's mp degree"):
        BertModel(BertConfig.tiny(), device="cpu", mp_degree=2)


def test_rng_tracker_draws_per_mp_rank(world2):
    """Dropout under the tracker's model_parallel_rng differs between the
    mp ranks; outside it the ranks draw the same mask (the global seed)."""
    ranks, _ = world2
    a, b = ranks[0]["rng"], ranks[1]["rng"]
    np.testing.assert_array_equal(a["outside"], b["outside"])
    assert not np.array_equal(a["inside"], b["inside"])
    for r in (a, b):
        for m in (r["inside"], r["outside"]):
            assert set(np.unique(m)) <= {0.0, 2.0}
            assert 0.4 < (m > 0).mean() < 0.6
    assert a["seed"] != b["seed"]


def test_force_tp_layers_builds_the_parallel_tree_at_mp1():
    """Under ``force_tp_layers`` with no topology, LLaMA is built of the
    parallel module classes and computes what the plain model from the
    same seed computes (the JAX package's single-device alignment
    knob)."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinearModule, RowParallelLinearModule,
        VocabParallelEmbeddingModule)
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.text.models.llama import force_tp_layers
    cfg = LlamaConfig.tiny(vocab=W.VOCAB)
    cfg.fused_linear_ce = True
    plain = LlamaForCausalLM(cfg, device="cpu", seed=2)
    with force_tp_layers():
        tp = LlamaForCausalLM(cfg, device="cpu", seed=2)
    attn = tp.llama.layers[0].self_attn
    assert isinstance(attn.q_proj, ColumnParallelLinearModule)
    assert isinstance(attn.o_proj, RowParallelLinearModule)
    assert isinstance(tp.llama.embed_tokens, VocabParallelEmbeddingModule)
    assert isinstance(tp.lm_head, ColumnParallelLinearModule)
    assert not attn.q_proj.weight.is_distributed
    for (n, a), (_, b) in zip(plain.named_parameters(),
                              tp.named_parameters()):
        assert torch.equal(a, b), n
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, W.VOCAB,
                                                             (2, 8)))
    assert torch.equal(plain(ids), tp(ids))
    assert torch.equal(plain(ids, labels=ids), tp(ids, labels=ids))
