"""The port's pipeline parallelism on gloo ranks, held to the JAX
package's ``PipelineParallel`` on the 8-device CPU mesh.

Two worlds (the port's ``spawn``, ranks in ``torch_dist_worker.py``)
run while the parent computes the JAX references:

- pp=2 (2 ranks) and pp=4 (4 ranks): a PipelineLayer of 8 ``_Block``s
  (tanh(Linear)), MSE loss, SGD with ``ClipGradByGlobalNorm``,
  accumulate_steps 4, 2 steps from the JAX weights, in every schedule:
  FThenB, 1F1B (held to the JAX FThenB: the JAX package compiles 1F1B as
  FThenB), VPP and ZBVPP (vpp_degree 2), ZBH1; against the JAX
  ``PipelineParallel`` in the same mode (losses rtol 1e-5, every updated
  parameter rtol 1e-4 / atol 1e-6, gathered over the stages);
- heterogeneous stages at pp=4 (six tanh(Linear) of widths 8-12-8,
  ``seg_method=[1, 2, 2, 1]``) against JAX's het path; pp=2 x dp=2
  (1F1B, each data rank on half the batch) against JAX's pp=2;
- ``build_llama_pipe`` at pp=2, untied (1F1B) and tied (ZBH1, the shared
  embedding's gradient summed over the first and last stage), and untied
  at pp=2 x mp=2 (1F1B, the TP shards merged), each against the JAX
  ``build_llama_pipe`` pipeline (FThenB) from the same weights (losses
  rtol 1e-5, parameters rtol 1e-4 / atol 1e-6).

Each rank keeps only its stage: a rank's parameter names are its
stage's, and the ranks' sets cover the model once (tied: the embedding
on both ends). ``pipeline_apply`` and its VPP, ZBH1 and ZBVPP forms run
over each world against the sequential run of the same blocks (outputs
and gradients within 1e-6).
"""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel)
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models.llama import build_llama_pipe as jax_llama_pipe

import torch_dist_worker as W

D, N_BLOCKS, BATCH = 8, 8, 8
MODES = [("FThenB", 1), ("1F1B", 1), ("VPP", 2), ("ZBH1", 1), ("ZBVPP", 2)]
HET_WIDTHS = [(8, 8), (8, 8), (8, 12), (12, 12), (12, 8), (8, 8)]
HET_SEG = [1, 2, 2, 1]


class _Block(jnn.Layer):
    def __init__(self, din, dout=None):
        super().__init__()
        self.fc = jnn.Linear(din, dout or din)

    def forward(self, x):
        return paddle.tanh(self.fc(x))


def _np(params):
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


class _mesh:
    def __init__(self, degrees):
        self.degrees = degrees

    def __enter__(self):
        self.prev = jmesh.get_mesh()
        self.m = jmesh.build_mesh(self.degrees)
        jmesh.set_mesh(self.m)
        return self.m

    def __exit__(self, *exc):
        jmesh._global_mesh = self.prev


def _jax_train(pl, S, mode, vpp, x, y, accumulate=W.PIPE_M):
    """The JAX PipelineParallel's losses and updated parameters."""
    s = jfleet.DistributedStrategy()
    s.pipeline_configs["accumulate_steps"] = accumulate
    s.pipeline_configs["schedule_mode"] = mode
    s.pipeline_configs["vpp_degree"] = vpp
    with _mesh({"pp": S, "dp": 8 // S}) as m:
        model = JPipelineParallel(pl, strategy=s)
        opt = paddle.optimizer.SGD(
            W.PIPE_LR, parameters=pl.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(W.PIPE_CLIP))
        with jax.set_mesh(m):
            losses = [float(model.train_batch(
                (paddle.to_tensor(x), paddle.to_tensor(y)), opt).numpy())
                for _ in range(W.PIPE_STEPS)]
            params = {n: np.asarray(p._data, np.float32)
                      for n, p in model.named_parameters()}
    return dict(losses=losses, params=params)


def _blocks(seed, widths=None, S=2, seg="uniform"):
    paddle.seed(seed)
    descs = [JLayerDesc(_Block, a, b) for a, b in widths] if widths else \
        [JLayerDesc(_Block, D) for _ in range(N_BLOCKS)]
    return JPipelineLayer(layers=descs, num_stages=S,
                          loss_fn=jnn.MSELoss(), seg_method=seg)


def _llama_cfg(tied):
    jc = JaxLlamaConfig.tiny(vocab=64, hidden=32, layers=4, heads=4)
    jc.tie_word_embeddings = tied
    return jc


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    rng = np.random.default_rng(24)
    inputs = dict(D=D, n_blocks=N_BLOCKS, modes=MODES,
                  het_widths=HET_WIDTHS, het_seg=HET_SEG,
                  blocks_params=_np(get_params(_blocks(7))),
                  blocks_x=rng.standard_normal((BATCH, D)).astype(np.float32),
                  blocks_y=rng.standard_normal((BATCH, D)).astype(np.float32),
                  het_params=_np(get_params(_blocks(8, HET_WIDTHS, 4,
                                                    HET_SEG))),
                  het_x=rng.standard_normal((BATCH, 8)).astype(np.float32),
                  het_y=rng.standard_normal((BATCH, 8)).astype(np.float32),
                  llama_ids=rng.integers(0, 64, (4, 8)),
                  llama_cfg=dataclasses.asdict(_llama_cfg(False)))
    for tied in (False, True):
        paddle.seed(9)
        jp = jax_llama_pipe(_llama_cfg(tied), num_stages=2)
        inputs["llama_tied" if tied else "llama_untied"] = \
            _np(get_params(jp))
    ctxs = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"pipe{world}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        ctxs[world] = (W.start_world(world, "pipe_world", tmp), tmp)
    want = {}
    for S in (2, 4):
        for mode, vpp in MODES:
            jmode = "FThenB" if mode == "1F1B" else mode
            key = (S, jmode, vpp)
            if key not in want:
                pl = _blocks(7, S=S)
                pl.set_state_dict({k: paddle.to_tensor(v) for k, v in
                                   inputs["blocks_params"].items()})
                want[key] = _jax_train(pl, S, jmode, vpp,
                                       inputs["blocks_x"],
                                       inputs["blocks_y"])
    pl = _blocks(8, HET_WIDTHS, 4, HET_SEG)
    want["het"] = _jax_train(pl, 4, "FThenB", 1, inputs["het_x"],
                             inputs["het_y"])
    for tied in (False, True):
        key = "llama_tied" if tied else "llama_untied"
        jp = jax_llama_pipe(_llama_cfg(tied), num_stages=2)
        jp.set_state_dict({k: paddle.to_tensor(v)
                           for k, v in inputs[key].items()})
        ids = inputs["llama_ids"]
        want[key] = _jax_train(jp, 2, "FThenB", 1, ids, ids, accumulate=2)
    want["blocks_xy"] = (inputs["blocks_x"], inputs["blocks_y"])
    got = {w: W.join_world(ctx, str(tmp)) for w, (ctx, tmp) in ctxs.items()}
    return got, want


def _merged(ranks, key):
    out = {}
    for r in ranks:
        run = r[key] if isinstance(key, str) else r["blocks"][key]
        for n, a in run["params"].items():
            out.setdefault(n, []).append(a)
    return out


def _check(ranks, key, want, transpose=()):
    got = _merged(ranks, key)
    assert sorted(got) == sorted(want["params"])
    for n, arrs in got.items():
        for a in arrs:       # a shared weight: equal on every holder
            a = a.T if n.endswith(transpose) else a
            np.testing.assert_allclose(a, want["params"][n], rtol=1e-4,
                                       atol=1e-6, err_msg=n)
    for r in ranks:
        run = r[key] if isinstance(key, str) else r["blocks"][key]
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=1e-5, err_msg=str(key))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mode,vpp", MODES)
def test_pipeline_schedule_matches_jax(worlds, S, mode, vpp):
    got, want = worlds
    ranks = got[S]
    jmode = "FThenB" if mode == "1F1B" else mode
    _check(ranks, (mode, vpp), want[(S, jmode, vpp)],
           transpose=("fc.weight",))
    for r in ranks:
        run = r["blocks"][(mode, vpp)]
        assert run["type"] == "PipelineParallel"
        # each rank holds its stage only: 8 blocks over S*vpp chunks
        assert len(run["params"]) == 2 * N_BLOCKS // S
        assert run["stats"]["fwd"] == W.PIPE_M * vpp * W.PIPE_STEPS
        assert run["stats"].get("w", 0) == \
            (W.PIPE_M * vpp * W.PIPE_STEPS if "ZB" in mode else 0)
    # eval_batch on the updated stages against the sequential run of the
    # updated JAX weights: the loss on every rank, the output on the last
    # stage (None on the others)
    params, (x, y) = want[(S, jmode, vpp)]["params"], want["blocks_xy"]
    h = x
    for i in range(N_BLOCKS):
        h = np.tanh(h @ params[f"{i}.fc.weight"] + params[f"{i}.fc.bias"])
    for r in ranks:
        run = r["blocks"][(mode, vpp)]
        np.testing.assert_allclose(run["eval_loss"],
                                   np.mean((h - y) ** 2), rtol=1e-5)
    outs = [r["blocks"][(mode, vpp)]["eval_out"] for r in ranks]
    assert all(o is None for o in outs[:-1])
    np.testing.assert_allclose(outs[-1], h, rtol=1e-4, atol=1e-6)
    # a boundary's activation and gradient cross each hop once per
    # microbatch (and the wrap of the interleaved schedules once a round)
    hops = 2 * W.PIPE_M * (vpp * S - 1) * W.PIPE_STEPS
    assert sum(r["blocks"][(mode, vpp)]["stats"]["sends"]
               for r in ranks) == hops


def test_heterogeneous_stages_match_jax(worlds):
    got, want = worlds
    _check(got[4], "het", want["het"], transpose=("fc.weight",))
    names = [sorted(r["het"]["params"]) for r in got[4]]
    assert [len(n) for n in names] == [2 * k for k in HET_SEG]


@pytest.mark.parametrize("key", ["llama_untied", "llama_tied"])
def test_llama_pipe_matches_jax(worlds, key):
    got, want = worlds
    _check(got[2], key, want[key],
           transpose=("_proj.weight", f"{4 + 2}.weight"))
    if key == "llama_tied":
        # the embedding lives on both stages, equal after the updates
        assert all("0.weight" in r[key]["params"] for r in got[2])


def test_llama_pipe_pp2_mp2_matches_jax(worlds):
    got, want = worlds
    ranks = [r for r in got[4] if r["llama_mp2"]["mp_rank"] == 0]
    _check(ranks, "llama_mp2", want["llama_untied"],
           transpose=("_proj.weight", f"{4 + 2}.weight"))


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_apply_matches_sequential(worlds, S):
    got, _ = worlds
    for r in got[S]:
        for name, err in r["apply"].items():
            assert err < 1e-6, (name, err)


def test_pipeline_with_data_parallelism_matches_jax(worlds):
    got, want = worlds
    ranks = got[4]
    # the rank grid is (pp, dp): ranks 0, 1 hold stage 0, ranks 2, 3 stage 1
    _check([ranks[0], ranks[2]], "pp2_dp2", want[(2, "FThenB", 1)],
           transpose=("fc.weight",))
    # the data ranks of a stage hold the same parameters
    for a, b in ((0, 1), (2, 3)):
        for n, x in ranks[a]["pp2_dp2"]["params"].items():
            np.testing.assert_array_equal(x, ranks[b]["pp2_dp2"]["params"][n])
