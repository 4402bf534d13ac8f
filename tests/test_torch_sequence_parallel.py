"""The port's sequence parallelism held to the JAX package on the CPU.

Context parallelism over ``sep``: each rank holds a chunk of the
sequence, attention is the ring over the sep group, the loss is the
sequence's, and gradients are summed over sep and averaged over dp x
sharding. Sequence parallelism over mp
(``sequence_parallel``): activations split along the sequence between
the tensor-parallel products.

A 2-rank gloo world (the port's ``spawn``, a ``FileStore``; ranks in
``torch_dist_worker.py``) runs, in order: two sep ranks each fed its
chunk of the sequence, stepping an AdamW through
``fleet.distributed_optimizer`` (the drift case); a tiny LLaMA at sep=2
for STEPS AdamW steps through ``fleet.distributed_model``
(``SegmentParallel``) and ``DistributedTrainStep``, plain and with GQA
(2 kv heads) and a window of 6 that crosses the 8-token chunks, with
labels ignored unevenly across the chunks, and eagerly through the
wrapper's forward; what a sep mesh refuses; then, re-cut as mp=2, the
sequence-parallel linears (surface Layers) and the scatter / gather round
trip, and the LLaMA with ``sequence_parallel`` (loss and every
gradient). A 4-rank world runs the LLaMA steps at sep=2 x mp=2.

References: the JAX single-device ``TrainStep`` with the same global
weights (the losses, as dryrun phase 8 holds the JAX sep run,
``paddle_tpu/distributed/dryrun.py:1370``); the JAX sequence-parallel
linears and LLaMA on the JAX mp=2 mesh.

Tolerances: losses rtol 1e-4, atol 1e-5 (as
``test_distributed_train_step_matches_jax``); the drift case's
parameters equal across the sep ranks to 1e-6; the linears' outputs and
gradients rtol 1e-5, atol 1e-5 (``test_tp_matches_single_device``); the
LLaMA's loss rtol 1e-5, atol 1e-6 and every gradient within closeness's
f32 gate (|got - want| <= 1e-4 max(1, max |want|), as
``test_torch_fleet_tp``).
"""
import dataclasses
import pickle

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils import (
    ColumnSequenceParallelLinear, GatherOp, RowSequenceParallelLinear,
    ScatterOp)
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.bridge import LINEAR_SUFFIXES

import torch_dist_worker as W


class _jmesh:
    def __init__(self, degrees):
        self.degrees = degrees

    def __enter__(self):
        self.prev = jmesh.get_mesh()
        jmesh.set_mesh(jmesh.build_mesh(self.degrees))

    def __exit__(self, *exc):
        jmesh._global_mesh = self.prev


def _jax_llama(seed=13, **kw):
    paddle.seed(seed)
    jc = JaxLlamaConfig.tiny(vocab=W.VOCAB, hidden=64, layers=2, heads=4)
    jc.fused_linear_ce, jc.fused_ce_chunks = True, 2
    jc = dataclasses.replace(jc, **kw)
    with _jmesh({"dp": 1}):
        net = JaxLlama(jc)
    return jc, {k: np.asarray(v, np.float32)
                for k, v in get_params(net).items()}


def _jax_adamw_steps(jc, params, batch, labels=None, steps=W.STEPS):
    """The JAX single-device TrainStep's losses: AdamW, the fused loss
    (``labels`` the batch when None)."""
    with _jmesh({"dp": 1}):
        net = JaxLlama(jc)
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        opt = paddle.optimizer.AdamW(W.LR, parameters=net.parameters())
        step = paddle.jit.TrainStep(net, lambda out, lab: out, opt)
        x = paddle.to_tensor(batch)
        y = x if labels is None else paddle.to_tensor(labels)
        return [float(step((x, y), y).numpy()) for _ in range(steps)]


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _sp_inputs(rng):
    f = np.float32
    return dict(w1=rng.standard_normal((16, 32)).astype(f) * 0.3,
                b1=rng.standard_normal(32).astype(f) * 0.1,
                w2=rng.standard_normal((32, 16)).astype(f) * 0.3,
                b2=rng.standard_normal(16).astype(f) * 0.1,
                x=rng.standard_normal((2, 8, 16)).astype(f),
                cot=rng.standard_normal((2, 8, 16)).astype(f))


def _jax_sp_layers(t):
    """The JAX sequence-parallel linears on its mp=2 mesh."""
    with _jmesh({"mp": 2}):
        col = ColumnSequenceParallelLinear(16, 32, has_bias=True)
        row = RowSequenceParallelLinear(32, 16, has_bias=True)
        for p, v in ((col.weight, t["w1"]), (col.bias, t["b1"]),
                     (row.weight, t["w2"]), (row.bias, t["b2"])):
            p.set_value(v)
        x = paddle.to_tensor(t["x"], stop_gradient=False)
        out = GatherOp.apply(row(col(ScatterOp.apply(x))))
        (out * paddle.to_tensor(t["cot"])).sum().backward()
        return dict(out=_np(out), dx=_np(x.grad), dw1=_np(col.weight.grad),
                    db1=_np(col.bias.grad), dw2=_np(row.weight.grad),
                    db2=_np(row.bias.grad))


def _jax_llama_sp(jc, params, batch):
    """The JAX LLaMA with sequence_parallel on its mp=2 mesh: the fused
    loss and every gradient."""
    with _jmesh({"mp": 2}):
        net = JaxLlama(dataclasses.replace(jc, sequence_parallel=True))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        ids = paddle.to_tensor(batch)
        loss = net(ids, labels=ids)
        loss.backward()
        return float(loss.numpy()), {n: _np(p.grad)
                                     for n, p in net.named_parameters()}


#: name -> (how the port steps, which weights, which labels): "step"
#: through DistributedTrainStep, "eager" through the wrapper's forward;
#: "padded" labels ignore the last 6 positions of every row, all in the
#: second sep rank's chunk (its loss and gradient then cover 2 of its 8
#: positions)
SEP_RUNS = {"step": ("step", "llama", "batch"),
            "gqa_window": ("step", "gqa", "batch"),
            "eager": ("eager", "llama", "batch"),
            "padded": ("step", "llama", "padded")}


def _inputs():
    jc, params = _jax_llama()
    gc, gparams = _jax_llama(seed=14, num_key_value_heads=2,
                             sliding_window=6)
    rng = np.random.default_rng(25)
    batch = rng.integers(0, W.VOCAB, (2, 16))
    padded = batch.copy()
    padded[:, -6:] = -100
    return dict(llama_cfg=dataclasses.asdict(jc), llama_params=params,
                gqa_cfg=dataclasses.asdict(gc), gqa_params=gparams,
                batch=batch, padded=padded, sep_runs=SEP_RUNS,
                sp=_sp_inputs(rng)), (jc, gc)


def _want_steps(inputs, cfgs):
    jc, gc = cfgs
    cfg = {"llama": jc, "gqa": gc}
    runs = {(key, labels) for _, key, labels in SEP_RUNS.values()}
    losses = {(key, labels): _jax_adamw_steps(
        cfg[key], inputs[f"{key}_params"], inputs["batch"], inputs[labels])
        for key, labels in runs}
    return {name: losses[(key, labels)]
            for name, (_, key, labels) in SEP_RUNS.items()}


@pytest.fixture(scope="module")
def sep2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sep2")
    inputs, cfgs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = W.start_world(2, "sep_world2", tmp)
    want = dict(drift=_jax_adamw_steps(cfgs[0], inputs["llama_params"],
                                       inputs["batch"]),
                steps=_want_steps(inputs, cfgs),
                sp_layers=_jax_sp_layers(inputs["sp"]),
                llama_sp=_jax_llama_sp(cfgs[0], inputs["llama_params"],
                                       inputs["batch"]))
    return W.join_world(ctx, str(tmp)), want


@pytest.fixture(scope="module")
def sep4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sep4")
    inputs, cfgs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = W.start_world(4, "sep_world4", tmp)
    want = _want_steps(inputs, cfgs)
    return W.join_world(ctx, str(tmp)), want


def test_sep_ranks_fed_chunks_match_one_device(sep2):
    """Two sep ranks, each fed its half of the sequence, step together as
    one device on the whole sequence: the ring attends across the chunks
    and the step reduces over sep (else each rank attends within its own
    chunk and the two ranks' weights drift apart)."""
    ranks, want = sep2
    for out in ranks:
        np.testing.assert_allclose(out["drift"]["losses"], want["drift"],
                                   rtol=1e-4, atol=1e-5)
    a, b = (o["drift"]["params"] for o in ranks)
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SEP_RUNS))
def test_llama_sep2_steps_match_one_device(sep2, name):
    """LLaMA at sep=2 through fleet: ``SegmentParallel`` and
    ``DistributedTrainStep`` (or the wrapper's forward and the hybrid
    optimizer), the losses of STEPS AdamW steps against one device's;
    "gqa_window": 2 kv heads and a window of 6 across the chunks."""
    ranks, want = sep2
    for out in ranks:
        run = out["steps"][name]
        assert run["wrapper"] == "SegmentParallel"
        np.testing.assert_allclose(run["losses"], want["steps"][name],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SEP_RUNS))
def test_llama_sep2_mp2_steps_match_one_device(sep4, name):
    ranks, want = sep4
    assert sorted(o["coord"] for o in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    for out in ranks:
        np.testing.assert_allclose(out["steps"][name]["losses"], want[name],
                                   rtol=1e-4, atol=1e-5)


def test_sequence_parallel_linears_match_jax(sep2):
    ranks, want = sep2
    w = want["sp_layers"]
    for r, out in enumerate(ranks):
        got = out["sp_layers"]
        assert got["bias_marked"]
        for name in ("out", "dx", "db2"):
            np.testing.assert_allclose(got[name], w[name], rtol=1e-5,
                                       atol=1e-5)
        cols = slice(r * 16, (r + 1) * 16)
        np.testing.assert_allclose(got["dw1"], w["dw1"][:, cols], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["db1"], w["db1"][cols], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dw2"], w["dw2"][cols], rtol=1e-5,
                                   atol=1e-5)


def test_scatter_gather_round_trip(sep2):
    ranks, _ = sep2
    y = np.arange(64, dtype=np.float32).reshape(2, 8, 4)
    for r, out in enumerate(ranks):
        got = out["sp_layers"]
        np.testing.assert_array_equal(got["round_trip"], y)
        np.testing.assert_array_equal(got["scattered"],
                                      y[:, r * 4:(r + 1) * 4])
        # both ranks hold y: the reduce-scatter sums them
        np.testing.assert_array_equal(got["reduce_scattered"],
                                      2 * y[:, r * 4:(r + 1) * 4])


def test_llama_sequence_parallel_mp2_matches_jax(sep2):
    ranks, want = sep2
    wloss, wgrads = want["llama_sp"]
    for out in ranks:
        got = out["llama_sp"]
        assert got["sp_modules"]
        np.testing.assert_allclose(got["loss"], wloss, rtol=1e-5, atol=1e-6)
        assert sorted(got["grads"]) == sorted(wgrads)
        for n, g in got["grads"].items():
            # the port's Linear weights are [out, in], the JAX ones [in, out]
            ref = wgrads[n].T if n.endswith(LINEAR_SUFFIXES) else wgrads[n]
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            assert float(np.abs(g - ref).max()) <= tol, n


def test_sep_mesh_refuses_what_has_no_ring(sep2):
    """On a sep=2 mesh nothing attends within a rank's chunk silently: a
    pipeline and an MoE layer refuse to be built there; SegmentParallel
    and DistributedTrainStep refuse a model built without the split (a
    whole LLaMA, BERT's encoder); the LLaMA built there takes the ring and
    refuses a KV-cache forward, and its chunk's logits with gradients on
    (a loss on them would not be the sequence's), giving them under
    no_grad."""
    ranks, _ = sep2
    want = {"pipeline": ("NotImplementedError", "sep"),
            "moe": ("NotImplementedError", "sep"),
            "segment_whole_llama": ("ValueError", "not built for a "
                                    "sequence split"),
            "segment_bert": ("ValueError", "not built for a sequence split"),
            "step_whole_llama": ("ValueError", "not built for a sequence "
                                 "split"),
            "kv_cache": ("ValueError", "KV-cache"),
            "chunk_logits": ("ValueError", "fused loss")}
    for out in ranks:
        r = out["refusals"]
        for case, (kind, words) in want.items():
            assert r[case] is not None, case
            assert r[case].startswith(kind) and words in r[case], r[case]
        assert r["takes_ring"]
        assert r["logits_shape"] == (1, 4, 64)


def test_fleet_utils_match_jax(tmp_path):
    """``fleet.utils``' LocalFS does what the JAX package's does on the
    same tree; HDFSClient raises without a hadoop binary;
    DistributedInfer puts the layer in eval mode."""
    import shutil

    import torch

    from paddle_tpu.distributed.fleet import utils as jutils
    from paddle_tpu_torch.distributed.fleet import utils as tutils

    def drive(fs, root):
        root.mkdir()
        fs.mkdirs(str(root / "a" / "b"))
        fs.touch(str(root / "f.txt"))
        fs.mv(str(root / "f.txt"), str(root / "g.txt"))
        fs.upload(str(root / "g.txt"), str(root / "h.txt"))
        out = [fs.ls_dir(str(root)), fs.list_dirs(str(root)),
               fs.is_dir(str(root / "a")), fs.is_file(str(root / "g.txt")),
               fs.is_exist(str(root / "f.txt"))]
        with pytest.raises(FileExistsError):
            fs.touch(str(root / "g.txt"), exist_ok=False)
        fs.delete(str(root / "a"))
        fs.delete(str(root / "h.txt"))
        out.append(fs.ls_dir(str(root)))
        return out

    assert drive(tutils.LocalFS(), tmp_path / "t") == \
        drive(jutils.LocalFS(), tmp_path / "j")
    if shutil.which("hadoop") is None:
        for mod in (tutils, jutils):
            with pytest.raises(RuntimeError, match="hadoop"):
                mod.HDFSClient()
    layer = torch.nn.Linear(2, 2)
    assert tutils.DistributedInfer(layer).get_dist_infer_program() is layer
    assert not layer.training
    assert tutils.recompute is not None and tutils.recompute_sequential
