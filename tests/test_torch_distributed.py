"""The port's distributed layer held to the JAX package's on the CPU.

In process (no ranks): the rank mesh's degrees and grid against the JAX
mesh's device grid (``build_mesh``, with and without ``dcn_degrees``),
``CommunicateTopology``'s coordinates and the rank lists of every axis
group of dp2 x sharding2 x mp2 against the JAX topology's (mirroring
``tests/test_distributed.py``), ``DistributedStrategy``'s configuration
tree, and the launcher (its environment, a restart, the flags of later
slices).

One 4-rank gloo world (the port's ``spawn``, a ``FileStore``; ranks in
``torch_dist_worker.py``) runs, in order: every collective and
``ReduceOp`` against numpy under Paddle's contracts, with nothing staged
(CPU tensors); ``DataParallel``'s gradients against one process's on the
whole batch (and ``no_sync``'s local ones); then ``fleet.init`` at
dp2 x mp2, its groups, and 3 ``DistributedTrainStep`` steps of a tiny
LLaMA (2 layers, vocabulary-parallel fused loss, AdamW with
``ClipGradByGlobalNorm``) at sharding stages 0, 1, 2 and 3 (ZeRO-3: the
parameters sliced over the data group, gathered layer by layer), and
through ``group_sharded_parallel(level="p_g_os")``, each against JAX's
``DistributedTrainStep`` on its dp2 x mp2 mesh (losses rtol 1e-4, atol
1e-5, as ``test_distributed_train_step_matches_single``); last,
``group_sharded_parallel`` at "os" and "os_g" on the eager surface, 2
AdamW steps against one process on the whole batch (rtol 1e-5, atol
1e-6).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.parallel_step import \
    DistributedTrainStep as JaxDistributedTrainStep
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import mesh as tmesh

import torch_dist_worker as W

ROOT = Path(__file__).resolve().parent.parent
HYBRID = {"dp": 2, "sharding": 2, "mp": 2}


@pytest.fixture
def jax_mesh():
    prev = jmesh.get_mesh()
    yield
    jmesh._global_mesh = prev


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def test_build_mesh_grid_matches_jax(jax_mesh):
    got = tmesh.build_mesh(HYBRID)
    want = jmesh.build_mesh(HYBRID)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.ranks, _ids(want))


def test_build_mesh_dcn_matches_jax(jax_mesh):
    got = tmesh.build_mesh({"dp": 2, "mp": 2}, dcn_degrees={"dp": 2})
    want = jmesh.build_mesh({"dp": 2, "mp": 2}, dcn_degrees={"dp": 2})
    assert got.shape["dp"] == 4 and got.shape["mp"] == 2
    np.testing.assert_array_equal(got.ranks, _ids(want))
    with pytest.raises(ValueError, match="unknown dcn axes"):
        tmesh.build_mesh({"dp": 2}, dcn_degrees={"nope": 2})
    with pytest.raises(ValueError, match="need 8 ranks"):
        tmesh.build_mesh(HYBRID, world_size=4)


@pytest.mark.parametrize("axes,dims", [(["dp", "mp"], [2, 4]),
                                       (list(tmesh.HYBRID_AXES),
                                        [1, 2, 2, 1, 2])])
def test_topology_coords_match_jax(axes, dims):
    got = tmesh.CommunicateTopology(axes, dims)
    want = jmesh.CommunicateTopology(axes, dims)
    assert got.world_size() == want.world_size()
    for r in range(want.world_size()):
        assert got.get_coord(r) == want.get_coord(r)
        assert got.get_rank(**want.get_coord(r)) == r
    for ax in axes:
        for i in range(want.get_dim(ax)):
            assert got.get_axis_list(ax, i) == want.get_axis_list(ax, i)


@pytest.mark.parametrize("axis", list(tmesh.HYBRID_AXES))
def test_axis_groups_match_jax_topology(axis, jax_mesh):
    """Each rank's group on ``axis`` holds the ranks the JAX topology
    gives the same coordinates but on ``axis``."""
    mesh = tmesh.build_mesh(HYBRID)
    jm = jmesh.build_mesh(HYBRID)
    jmesh.set_mesh(jm)
    topo = jmesh.CommunicateTopology()
    for r in range(8):
        c = topo.get_coord(r)
        want = sorted(topo.get_rank(**{**c, axis: i})
                      for i in range(topo.get_dim(axis)))
        assert mesh.ranks_of(axis, r) == want
        assert mesh.coord(r) == c
    assert len(mesh.slices(axis)) == 8 // topo.get_dim(axis)


def test_strategy_config_tree_matches_jax():
    got, want = tfleet.DistributedStrategy(), jfleet.DistributedStrategy()
    keys = [k for k in vars(want) if not k.startswith("_")]
    assert sorted(k for k in vars(got) if not k.startswith("_")) == \
        sorted(keys)
    for k in keys:
        assert getattr(got, k) == getattr(want, k), k
    for s in (got, want):
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                            "sharding_degree": 2}
    assert got.hybrid_configs == want.hybrid_configs
    assert got.hybrid_degrees() == want.hybrid_degrees()


_RECORD = """import json, os, sys
keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
        "PADDLE_LOCAL_SIZE", "PADDLE_MASTER", "PADDLE_RESTART_COUNT",
        "PADDLE_DISTRI_BACKEND")
env = {k: os.environ.get(k) for k in keys}
out = os.path.join(sys.argv[1], "env.%s.%s" % (env["PADDLE_TRAINER_ID"],
                                              env["PADDLE_RESTART_COUNT"]))
json.dump(env, open(out, "w"))
if env["PADDLE_RESTART_COUNT"] == "0" and env["PADDLE_TRAINER_ID"] == "1":
    sys.exit(3)
"""


def _launch(tmp_path, *flags):
    script = tmp_path / "rec.py"
    script.write_text(_RECORD)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--log_dir", str(tmp_path / "log"), *flags, str(script),
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)


def test_launcher_env_and_restart(tmp_path):
    """Rank 1 fails in the first pod: without restarts the launcher exits
    with its code; with one, the second pod runs, and every rank saw the
    launcher's environment."""
    import json
    run = _launch(tmp_path, "--nproc_per_node", "2")
    assert run.returncode == 3, run.stderr
    run = _launch(tmp_path, "--nproc_per_node", "2", "--max_restarts", "1",
                  "--backend", "gloo")
    assert run.returncode == 0, run.stdout + run.stderr
    for rank in (0, 1):
        env = json.load(open(tmp_path / f"env.{rank}.1"))
        assert env["PADDLE_TRAINER_ID"] == str(rank)
        assert env["PADDLE_TRAINERS_NUM"] == env["PADDLE_LOCAL_SIZE"] == "2"
        assert env["PADDLE_LOCAL_RANK"] == str(rank)
        assert env["PADDLE_MASTER"].startswith("127.0.0.1:")
        assert env["PADDLE_DISTRI_BACKEND"] == "gloo"
    assert (tmp_path / "log" / "workerlog.1.restart1").exists()


@pytest.mark.parametrize("flag", [["--elastic_level", "1"],
                                  ["--heartbeat_timeout", "5"],
                                  ["--run_mode", "ps"]])
def test_launcher_later_slice_flags_raise(tmp_path, flag):
    from paddle_tpu_torch.distributed.launch.main import launch
    with pytest.raises(SystemExit, match="later slice"):
        launch(["--log_dir", str(tmp_path / "log"), *flag, "rec.py"])
    assert not (tmp_path / "log").exists()      # no rank was started


def test_entry_points_refuse_the_cpu_without_asking():
    """Without a visible GPU a rank does not carry on on the CPU: it
    raises unless device='cpu' is asked for."""
    import torch

    from paddle_tpu_torch.distributed import env
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_parallel_env()
    assert not env.is_initialized()
    assert env.choose_backend(torch.device("cpu"), 2) == "gloo"
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        env.choose_backend(torch.device("cpu"), 1, "nccl")
    # the pipeline's entry points: the LLaMA pipe is built on cuda, and
    # the MPMD driver's stages are the visible cards
    from paddle_tpu_torch.distributed.mpmd_runtime import stage_devices
    from paddle_tpu_torch.text.models import LlamaConfig, build_llama_pipe
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_llama_pipe(LlamaConfig.tiny(), num_stages=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_devices(2)
    assert stage_devices(3, [torch.device("cpu")]) == \
        [torch.device("cpu")] * 3


# -- the 4-rank world ---------------------------------------------------------

def _jax_llama():
    paddle.seed(11)
    jc = JaxLlamaConfig.tiny(vocab=W.VOCAB, hidden=64, layers=2, heads=4)
    jc.fused_linear_ce, jc.fused_ce_chunks = True, 2
    with jmesh_scope({"mp": 2}):
        net = JaxLlama(jc)
    return jc, {k: np.asarray(v, np.float32)
                for k, v in get_params(net).items()}


class jmesh_scope:
    def __init__(self, degrees):
        self.degrees = degrees

    def __enter__(self):
        self.prev = jmesh.get_mesh()
        jmesh.set_mesh(jmesh.build_mesh(self.degrees))

    def __exit__(self, *exc):
        jmesh._global_mesh = self.prev


def _jax_steps(jc, params, batch, stage, degrees):
    """JAX DistributedTrainStep losses: the same global weights (loaded
    into a model built on ``degrees``' mesh), AdamW with the clip."""
    with jmesh_scope(degrees):
        net = JaxLlama(jc)
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        opt = paddle.optimizer.AdamW(
            W.LR, parameters=net.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(W.CLIP))
        step = JaxDistributedTrainStep(net, lambda out, lab: out, opt,
                                       sharding_stage=stage)
        x = paddle.to_tensor(batch)
        return [float(step((x, x), x).numpy()) for _ in range(W.STEPS)]


def _jax_linear_steps(params, x, y):
    """JAX ``DistributedTrainStep(sharding_stage=3)`` of two Linears at
    dp2 x mp2: the losses and the parameters after STEPS AdamW steps."""
    with jmesh_scope({"dp": 2, "mp": 2}):
        net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                             jnn.Linear(16, 4))
        net.set_state_dict({k: paddle.to_tensor(v)
                            for k, v in params.items()})
        opt = paddle.optimizer.AdamW(W.LIN_LR, parameters=net.parameters())
        step = JaxDistributedTrainStep(net, W._mse, opt, sharding_stage=3)
        losses = [float(step((paddle.to_tensor(x),),
                             paddle.to_tensor(y)).numpy())
                  for _ in range(W.STEPS)]
        return losses, {k: np.asarray(v, np.float32)
                        for k, v in get_params(net).items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    jc, params = _jax_llama()
    rng = np.random.default_rng(5)
    inputs = dict(llama_cfg=dataclasses.asdict(jc), llama_params=params,
                  batch=rng.integers(0, W.VOCAB, (W.B, W.S)),
                  dp_x=rng.standard_normal((8, 8)).astype(np.float32),
                  dp_y=rng.integers(0, 4, 8),
                  lin_params={
                      "0.weight": rng.standard_normal((8, 16)) * 0.3,
                      "0.bias": rng.standard_normal(16) * 0.1,
                      "2.weight": rng.standard_normal((16, 4)) * 0.3,
                      "2.bias": rng.standard_normal(4) * 0.1},
                  lin_x=rng.standard_normal((8, 8)).astype(np.float32),
                  lin_y=rng.standard_normal((8, 4)).astype(np.float32))
    inputs["lin_params"] = {k: v.astype(np.float32)
                            for k, v in inputs["lin_params"].items()}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = W.start_world(4, "world4", tmp)
    want = {s: _jax_steps(jc, params, inputs["batch"], s,
                          {"dp": 2, "mp": 2}) for s in (0, 1, 2, 3)}
    want["linears"] = _jax_linear_steps(inputs["lin_params"],
                                        inputs["lin_x"], inputs["lin_y"])
    return W.join_world(ctx, str(tmp)), want


def test_collectives_match_numpy(world4):
    ranks, _ = world4
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    stack = np.stack([base * (r + 1) for r in range(4)])
    want = {"SUM": stack.sum(0), "MAX": stack.max(0), "MIN": stack.min(0),
            "PROD": stack.prod(0), "AVG": stack.mean(0)}
    for r, out in enumerate(ranks):
        for name, w in want.items():
            np.testing.assert_allclose(out[f"all_reduce_{name}"], w,
                                       rtol=1e-6)
        np.testing.assert_array_equal(out["all_reduce_int"], [10] * 3)
        np.testing.assert_array_equal(out["all_reduce_tensor"], [10.0] * 2)
        np.testing.assert_array_equal(out["all_gather"],
                                      np.repeat(np.arange(4.0)[:, None], 2, 1))
        np.testing.assert_array_equal(
            out["all_gather_into"], np.repeat(np.arange(0, 40.0, 10)[:, None],
                                              2, 1))
        assert out["all_gather_object"] == [{"rank": i} for i in range(4)]
        np.testing.assert_array_equal(out["broadcast"], [2.0] * 3)
        np.testing.assert_array_equal(out["scatter"], [100.0 + r] * 2)
        np.testing.assert_array_equal(
            out["reduce_scatter_list"],
            [sum(float(s * 4 + r) for s in range(4))] * 2)
        np.testing.assert_allclose(
            out["reduce_scatter_avg"],
            np.mean([np.arange(8.0) + s for s in range(4)],
                    0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["alltoall"],
                                      [s * 10.0 + r for s in range(4)])
        np.testing.assert_array_equal(out["alltoall_single"],
                                      [s * 10.0 + r for s in range(4)])
        np.testing.assert_array_equal(out["alltoall_single_uneven"],
                                      np.repeat(np.arange(4.0), r + 1))
        np.testing.assert_array_equal(out["send_recv"], [(r - 1) % 4] * 2)
        np.testing.assert_array_equal(out["batch_isend_irecv"],
                                      [(r - 1) % 4] * 2)
        ranks_, grank, t = out["new_group"]
        assert ranks_ == [0, 2]
        assert grank == {0: 0, 2: 1}.get(r, -1)
        np.testing.assert_array_equal(
            t, [4.0] * 2 if r in (0, 2) else [r + 1.0] * 2)
        assert out["backend"] == "GLOO"
        assert out["staged_bytes"] == {}
        assert out["calls"]["distributed.calls.all_reduce"] >= 7
    np.testing.assert_array_equal(ranks[1]["reduce"], stack.sum(0))


def test_data_parallel_matches_one_process(world4):
    ranks, _ = world4
    for r, out in enumerate(ranks):
        assert out["dp_weights_equal"], "DataParallel broadcast rank 0's"
        assert out["dp_buckets"] > 1
        for got, want in zip(out["dp_grads"], out["dp_want"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # no_sync: the gradients stay each rank's own (not equal across ranks)
    assert not all(np.allclose(a, b) for a, b in
                   zip(ranks[0]["no_sync"], ranks[1]["no_sync"]))


def test_hybrid_groups_dp2_mp2(world4):
    ranks, _ = world4
    for r, out in enumerate(ranks):
        g = out["groups"]
        dp, mp = divmod(r, 2)
        assert g["coord"] == (dp, mp)
        assert g["mp"] == [2 * dp, 2 * dp + 1]
        assert g["dp"] == [mp, mp + 2]
        assert g["pp"] == g["sharding"] == g["sep"] == [r]
        assert g["dp_src"] == mp and g["mp_src"] == 2 * dp


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_distributed_train_step_matches_jax(world4, stage):
    ranks, want = world4
    for out in ranks:
        np.testing.assert_allclose(out["steps"][stage]["losses"],
                                   want[stage], rtol=1e-4, atol=1e-5)
    # every rank of a data group ends the step with the same parameters
    # (ZeRO-3: the slices gathered)
    for mp_rank in (0, 1):
        a, b = [o["steps"][stage]["params"] for o in ranks
                if o["steps"][stage]["mp_rank"] == mp_rank]
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    if stage:
        # ZeRO: each data rank holds half the optimizer state (+ padding)
        full = ranks[0]["steps"][0]["state_bytes"]
        assert ranks[0]["steps"][stage]["state_bytes"] <= 0.55 * full
    if stage == 3:
        # ZeRO-3: and half of every parameter (all are dim-0 divisible)
        for out in ranks:
            got, whole = (out["steps"][s]["param_bytes"] for s in (3, 0))
            assert got["whole"] == 0
            assert got["total"] * 2 == whole["total"]


def test_zero3_gathers_each_step_anew(world4):
    """ZeRO-3 on two Linears, whose four gathered weights all fit the
    backward's gather cache, over STEPS AdamW steps: each step's backward
    uses that step's weights. The losses and parameters equal the
    unsharded run's (summation order: rtol 1e-5) and JAX's
    ``DistributedTrainStep(sharding_stage=3)`` (rtol 1e-4)."""
    ranks, want = world4
    jax_losses, jax_params = want["linears"]
    for out in ranks:
        z3, z0 = (out["zero3_linears"][s] for s in (3, 0))
        assert (z3["stage"], z0["stage"]) == (3, 0)
        np.testing.assert_allclose(z3["losses"], z0["losses"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(z3["losses"], jax_losses, rtol=1e-4,
                                   atol=1e-6)
        for n, a in z3["params"].items():
            np.testing.assert_allclose(a, z0["params"][n], rtol=1e-5,
                                       atol=1e-7, err_msg=n)
            np.testing.assert_allclose(a, jax_params[n], rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_group_sharded_p_g_os_matches_jax(world4):
    """``group_sharded_parallel(level="p_g_os")``: ZeRO-3 from the
    optimizer's stage, the same steps as ``sharding_stage=3``."""
    ranks, want = world4
    for out in ranks:
        run = out["steps"]["p_g_os"]
        assert run["stage"] == 3
        np.testing.assert_allclose(run["losses"], want[3], rtol=1e-4,
                                   atol=1e-5)
        for n, a in run["params"].items():
            np.testing.assert_array_equal(a, out["steps"][3]["params"][n])


def test_group_sharded_p_g_os_eager_step_matches_jax(world4):
    """ZeRO-3 in eager code (``loss.backward(); opt.step()`` through
    ``GroupShardedOptimizerStage3``): the gradients averaged by the
    backward's reduce-scatters, the clip's norm over the slices; the same
    losses as JAX's ``sharding_stage=3`` and the same parameters as
    ``DistributedTrainStep(sharding_stage=3)``."""
    ranks, want = world4
    for out in ranks:
        run = out["zero3_eager"]
        assert run["stage"] == 3
        np.testing.assert_allclose(run["losses"], want[3], rtol=1e-4,
                                   atol=1e-5)
        for n, a in run["params"].items():
            np.testing.assert_allclose(a, out["steps"][3]["params"][n],
                                       rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("level,stage", [("os", 1), ("os_g", 2)])
def test_group_sharded_eager_step_matches_one_process(world4, level, stage):
    """``group_sharded_parallel`` on the eager surface: each data rank
    updates its half of the flat parameters (ZeRO-1 all-reduces the
    gradients, ZeRO-2 reduce-scatters them), then gathers them; after 2
    AdamW steps the parameters equal one process's on the whole batch
    (the rule is elementwise; the gradients differ in summation order)."""
    ranks, _ = world4
    for out in ranks:
        z = out["zero_eager"][level]
        assert z["stage"] == stage
        n = sum(w.size for w in z["want"])
        assert z["state"] <= 2 * (n // 2 + 64)       # two moments, a half
        for got, want in zip(z["got"], z["want"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
