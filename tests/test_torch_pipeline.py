"""The port's pipeline schedules, graphs, lint and MPMD driver held to the
JAX package's on the CPU, in one process.

- ``schedule_info`` / ``schedule_stats`` / ``zb_schedule_info`` /
  ``zbvpp_schedule_info`` equal the JAX functions over a grid of (mode,
  S, M, V);
- ``mpmd_graph.schedule_graph``'s ``to_dict()`` equals JAX's for every
  mode of that grid but 1F1B (file / line are not serialized); the
  port's 1F1B graph has the GPipe graph's events and deps in a
  one-forward-one-backward order, stage s holding at most S - s live
  inputs, and is lint-clean;
- ``check_graph`` gives the JAX rules on every seeded defect graph of
  ``tests/fixtures/mpmd_defects.py`` (rebuilt with ``from_dict``), the
  driver refuses each one at construction and a failing stage program is
  named by its event;
- ``PipelineLayer`` segmentation equals JAX's (uniform, "layer:Class",
  explicit sizes) and the constructor of ``PipelineParallel`` refuses
  what JAX's refuses;
- ``split_backward``'s input and weight halves equal one
  ``torch.autograd.grad``, every autograd node running once: the W half
  runs no node of the B half again, and the B half computes no weight
  gradient it leaves to W (a weight used twice, or by a custom
  ``autograd.Function``, is taken in B); the ZBH1 / ZBVPP schedules run
  each node of a chunk's backward once a microbatch;
- ``PipelineParallel`` in the MPMD modes (one process, both stages on
  the CPU) over 2 SGD steps equals the JAX FThenB ``PipelineParallel`` on
  the 8-device mesh (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.analysis.mpmd_lint import check_graph as jax_check_graph
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import mpmd_graph as jmg
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed import zero_bubble as jzb
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel)
from paddle_tpu.jit.functional import get_params
from paddle_tpu_torch.analysis.mpmd_lint import check_graph
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import mpmd_graph as mg
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import zero_bubble as tzb
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel)
from paddle_tpu_torch.distributed.mpmd_runtime import (
    MpmdDispatchError, MpmdDriver, MpmdGraphRejected, SymbolicPrograms)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import mpmd_defects  # noqa: E402

GRID = [(mode, S, M, V) for S in (1, 2, 4) for M in (2, 4, 8)
        for mode, V in (("FThenB", 1), ("1F1B", 1), ("VPP", 2), ("VPP", 3),
                        ("ZBH1", 1), ("ZBVPP", 2))
        if not (V > 1 and M < S)]
GRAPH_MODES = ("FThenB", "VPP", "ZBH1", "ZBVPP", "MPMD", "MPMD-VPP",
               "MPMD-ZBH1", "MPMD-ZBVPP")


@pytest.mark.parametrize("mode,S,M,V", GRID)
def test_schedule_accounting_matches_jax(mode, S, M, V):
    assert tpipe.schedule_info(S, M, V) == jpipe.schedule_info(S, M, V)
    assert tpipe.schedule_stats(mode, S, M, V) == \
        jpipe.schedule_stats(mode, S, M, V)
    assert tzb.zb_schedule_info(S, M) == jzb.zb_schedule_info(S, M)
    assert tzb.zbvpp_schedule_info(S, M, V) == \
        jzb.zbvpp_schedule_info(S, M, V)


def _graph_cases():
    for S in (2, 4):
        for M in (4, 8):
            for mode in GRAPH_MODES:
                V = 2 if "VPP" in mode else 1
                yield mode, S, M, V


@pytest.mark.parametrize("mode,S,M,V", list(_graph_cases()))
def test_graph_to_dict_matches_jax(mode, S, M, V):
    kw = dict(act_shape=(3, 16, 32), act_dtype="bfloat16")
    got = mg.schedule_graph(mode, S, M, V, **kw)
    want = jmg.schedule_graph(mode, S, M, V, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.meta == want.meta
    assert not check_graph(got)
    # a round trip keeps the graph (MpmdDriver's input format)
    again = mg.MpmdGraph.from_dict(got.to_dict())
    assert again.to_dict() == got.to_dict()


@pytest.mark.parametrize("S,M", [(2, 4), (4, 4), (4, 8), (3, 2)])
def test_1f1b_graph_is_gpipe_reordered(S, M):
    got = mg.schedule_graph("1F1B", S, M)
    ref = jmg.gpipe_graph(S, M)
    assert {ev.key for ev in got.events()} == {ev.key for ev in ref.events()}
    assert sorted(got.deps) == sorted(ref.deps)
    assert not check_graph(got)
    for s in range(S):
        phases = [ev.phase for ev in got.programs[s]]
        w = min(S - 1 - s, M)
        k = min(w + 1, M)          # the warm-up, then fwd before bwd
        assert phases[:k] == ["fwd"] * k and phases[k] == "bwd"
        assert got.buffers[(s, "acts")].slots == min(S - s, M)
        live = peak = 0
        for p in phases:
            live += 1 if p == "fwd" else -1
            peak = max(peak, live)
        assert peak == min(S - s, M)
    # the runner posts each message a tick after its producer: a valid
    # lockstep timing
    ev = got.event_index()
    for a, b in got.deps:
        assert ev[a].tick < ev[b].tick


@pytest.mark.parametrize("rule", sorted(mpmd_defects.DEFECT_BUILDERS))
def test_lint_rules_and_driver_refusal_match_jax(rule):
    jg = mpmd_defects.DEFECT_BUILDERS[rule]()
    g = mg.MpmdGraph.from_dict(jg.to_dict())
    want = jax_check_graph(jmg.MpmdGraph.from_dict(jg.to_dict()))
    got = check_graph(g)
    assert got.rules() == want.rules()
    assert [f.message for f in got] == [f.message for f in want]
    assert rule in got.rules()
    with pytest.raises(MpmdGraphRejected) as ei:
        MpmdDriver(g, placements=[None] * g.n_stages)
    assert rule in ei.value.rules and rule in str(ei.value)


def test_clean_graphs_lint_clean():
    for jg in mpmd_defects.clean_graphs():
        g = mg.MpmdGraph.from_dict(jg.to_dict())
        assert not check_graph(g), check_graph(g).format()


class _FailAt(SymbolicPrograms):
    def __init__(self, graph, at):
        super().__init__(graph)
        self.at = at

    def execute(self, ev, inbox, reads):
        if (ev.stage, ev.micro, ev.phase) == self.at:
            raise RuntimeError("injected stage failure")
        return super().execute(ev, inbox, reads)


@pytest.mark.parametrize("mode,vpp", [("FThenB", 1), ("1F1B", 1),
                                      ("VPP", 2), ("ZBH1", 1),
                                      ("ZBVPP", 2)])
def test_driver_walks_every_event_and_names_a_failure(mode, vpp):
    g = mg.schedule_graph(mode, 4, 8, vpp)
    driver = MpmdDriver(g)
    assert driver.run()["executed"] == g.n_events()
    assert 0.0 <= driver.stats()["bubble_fraction"] < 1.0
    with pytest.raises(MpmdDispatchError) as ei:
        MpmdDriver(g, _FailAt(g, (2, 3, "bwd"))).run()
    msg = str(ei.value)
    assert "stage 2" in msg and "micro 3" in msg and "'bwd'" in msg
    assert "injected stage failure" in msg


def test_planner_graphs_wait_for_their_slices():
    with pytest.raises(NotImplementedError, match="planner"):
        mg.plan_graph(None, None)
    # the ring-attention graph (the sequence-parallel slice): R x R
    # forward and backward hops, clean under the lint
    ring = mg.ring_graph(4)
    assert ring.n_events() == 2 * 4 * 4
    assert not check_graph(ring)
    # the disaggregated-serving graph (ported with inference/disagg.py):
    # one prefill and one decode event a request, clean under the lint
    dg = mg.disagg_graph(1, 1, 2)
    assert dg.n_events() == 2 * 2
    assert not check_graph(dg)


# -- segmentation and the constructor --------------------------------------

class _TBlock(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.fc = torch.nn.Linear(d, d)

    def forward(self, x):
        return torch.tanh(self.fc(x))


class Marker(torch.nn.Module):
    def forward(self, x):
        return x


class _JBlock(jnn.Layer):
    def __init__(self, d=8):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        return paddle.tanh(self.fc(x))


class _JMarker(jnn.Layer):
    def forward(self, x):
        return x


_JMarker.__name__ = "Marker"


@pytest.mark.parametrize("n,S,seg", [(8, 4, "uniform"), (7, 3, "uniform"),
                                     (10, 4, "layer:Marker"),
                                     (6, 3, [1, 2, 3]), (6, 2, [5, 1])])
def test_segmentation_matches_jax(n, S, seg):
    def items(block, marker):
        if isinstance(seg, str) and seg.startswith("layer:"):
            return [block(), marker(), block(), marker(), block(),
                    marker(), block(), marker(), block(), block()][:n]
        return [block() for _ in range(n)]

    got = PipelineLayer(items(_TBlock, Marker), num_stages=S, seg_method=seg)
    want = JPipelineLayer(items(_JBlock, _JMarker), num_stages=S,
                          seg_method=seg)
    assert got.segment_parts == want.segment_parts
    assert got.pipelinable_run() == want.pipelinable_run()
    assert [len(got.stage_items(s)) for s in range(S)] == \
        [len(want.stage_items(s)) for s in range(S)]


def test_layer_desc_refuses_surface_layers():
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.core import place as place_mod
    with pytest.raises(TypeError, match="surface Layer"):
        LayerDesc(tnn.Linear, 4, 4)
    prev = place_mod._current_place
    tp.set_device("cpu")
    try:
        lin = [tnn.Linear(4, 4), tnn.Linear(4, 4)]
    finally:
        place_mod._current_place = prev
    with pytest.raises(TypeError, match="surface Layer"):
        PipelineLayer(lin, num_stages=2)


def _strategy(pkg, **cfg):
    s = pkg.DistributedStrategy()
    s.pipeline_configs.update(cfg)
    return s


_REFUSED = [dict(schedule_mode="bogus"),
            dict(schedule_mode="ZBH1", vpp_degree=2),
            dict(schedule_mode="MPMD-ZBH1", vpp_degree=2),
            dict(schedule_mode="ZBVPP"), dict(schedule_mode="MPMD-VPP"),
            dict(schedule_mode="MPMD-ZBVPP")]


@pytest.mark.parametrize("cfg", _REFUSED)
def test_constructor_refusals_match_jax(cfg):
    with pytest.raises(ValueError) as want:
        JPipelineParallel(JPipelineLayer([_JBlock() for _ in range(4)],
                                         num_stages=2),
                          strategy=_strategy(jfleet, **cfg))
    with pytest.raises(ValueError) as got:
        PipelineParallel(PipelineLayer([_TBlock() for _ in range(4)],
                                       num_stages=2),
                         strategy=_strategy(tfleet, **cfg))
    assert str(got.value) == str(want.value)


def test_conflicting_vpp_degrees_refused_like_jax():
    def build(mod, block, pkg):
        return mod([block() for _ in range(4)], num_stages=2,
                   num_virtual_pipeline_stages=2)
    with pytest.raises(ValueError) as want:
        JPipelineParallel(build(JPipelineLayer, _JBlock, jfleet),
                          strategy=_strategy(jfleet, vpp_degree=3))
    with pytest.raises(ValueError) as got:
        PipelineParallel(build(PipelineLayer, _TBlock, tfleet),
                         strategy=_strategy(tfleet, vpp_degree=3))
    assert str(got.value) == str(want.value)


class _Wide(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.fc = torch.nn.Linear(a, b)

    def forward(self, x):
        return torch.tanh(self.fc(x))


class _JWide(jnn.Layer):
    def __init__(self, a, b):
        super().__init__()
        self.fc = jnn.Linear(a, b)

    def forward(self, x):
        return paddle.tanh(self.fc(x))


def test_het_boundary_shapes_match_jax():
    from paddle_tpu.distributed.fleet.meta_parallel import het_pipeline as jh
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        het_pipeline as th
    widths, seg = [(8, 8), (8, 12), (12, 12), (12, 4)], [1, 2, 1]
    got = PipelineLayer([_Wide(a, b) for a, b in widths], num_stages=3,
                        seg_method=seg)
    want = JPipelineLayer([_JWide(a, b) for a, b in widths], num_stages=3,
                          seg_method=seg)
    _, _, meta = jh.build_het_state(want, want.segment_parts)
    assert th.boundary_shapes(got, got.segment_parts, (5, 8)) == \
        jh.boundary_shapes(meta, (5, 8), np.float32)


def test_mpmd_refuses_heterogeneous_bounds():
    pl = PipelineLayer([_TBlock() for _ in range(6)], num_stages=2,
                       seg_method=[1, 5])
    with pytest.raises(ValueError, match="uniform stage bounds"):
        PipelineParallel(pl, strategy=_strategy(tfleet,
                                                schedule_mode="MPMD"))


# -- split_backward -----------------------------------------------------------

def test_split_backward_equals_one_autograd_grad():
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(8, 8, generator=gen, requires_grad=True),
              "b": torch.randn(8, generator=gen, requires_grad=True)}
    x = torch.randn(4, 8, generator=gen)
    dy = torch.randn(4, 8, generator=gen)

    def f(p, x, scale):
        return torch.tanh(x @ p["w"] + p["b"]) * scale

    bwd_x, bwd_w = tzb.split_backward(f, params, x, dy, nondiff=(2.0,))
    dx, stash = bwd_x()
    dp = bwd_w(stash)
    xl = x.clone().requires_grad_()
    want = torch.autograd.grad(f(params, xl, 2.0), [xl, params["w"],
                                                    params["b"]], dy)
    torch.testing.assert_close(dx, want[0], rtol=0, atol=0)
    torch.testing.assert_close(dp["w"], want[1], rtol=0, atol=0)
    torch.testing.assert_close(dp["b"], want[2], rtol=0, atol=0)


class _Spy(torch.autograd.Function):
    """The identity; its backward counts its runs in ``runs``."""
    runs = []

    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Spy.runs.append(ctx.tag)
        return g, None


class _ScaleFn(torch.autograd.Function):
    """x * w in one custom backward (both gradients at once, as the
    fused loss's)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _Spy.runs.append("scale")
        return g * w, (g * x).sum(0)


def _zb_block(p, x, scale=1.0):
    """Two matmul layers (w1's weight side behind a spy), a weight used
    twice (ws) and one of a custom Function (wf); spies on the B half."""
    h = torch.tanh(x @ _Spy.apply(p["w1"], "w1-side") + p["b"])
    h = _Spy.apply(h, "x-path")
    h = h + torch.tanh(h @ p["ws"]) @ p["ws"]
    h = _ScaleFn.apply(h, p["wf"])
    return torch.tanh(h @ p["w2"]) * scale


def _zb_params(gen):
    return {n: (torch.randn(*shape, generator=gen) * 0.5).requires_grad_()
            for n, shape in (("w1", (8, 8)), ("b", (8,)), ("ws", (8, 8)),
                             ("wf", (8,)), ("w2", (8, 8)))}


def test_split_backward_runs_each_node_once():
    gen = torch.Generator().manual_seed(4)
    params = _zb_params(gen)
    x = torch.randn(4, 8, generator=gen)
    dy = torch.randn(4, 8, generator=gen)
    xl = x.clone().requires_grad_()
    names = sorted(params)
    want = torch.autograd.grad(_zb_block(params, xl, 2.0),
                               [xl] + [params[n] for n in names], dy)
    _Spy.runs.clear()
    bwd_x, bwd_w = tzb.split_backward(_zb_block, params, x, dy,
                                      nondiff=(2.0,))
    dx, half = bwd_x()
    # B: the x path once, the custom Function once; w1's side not yet
    assert sorted(_Spy.runs) == ["scale", "x-path"]
    dp = bwd_w(half)
    assert sorted(_Spy.runs) == ["scale", "w1-side", "x-path"]
    torch.testing.assert_close(dx, want[0], rtol=1e-6, atol=1e-6)
    for n, w in zip(names, want[1:]):
        torch.testing.assert_close(dp[n], w, rtol=1e-6, atol=1e-6,
                                   msg=n)


@pytest.mark.parametrize("mode", ["ZBH1", "ZBVPP"])
def test_zero_bubble_schedule_runs_each_node_once(mode):
    """The one-stage ZBH1 / ZBVPP schedules (``pipeline_apply_zb*``) over
    M microbatches: each spy of a chunk's backward runs once a microbatch
    and chunk, and the gradients equal the sequential run's."""
    from paddle_tpu_torch.distributed import pipeline as tpipe
    gen = torch.Generator().manual_seed(5)
    M, V = 3, 2
    xs = torch.randn(M, 4, 8, generator=gen)
    chunks = [_zb_params(gen) for _ in range(V)]

    def block(p, x, m, ci):
        return _zb_block(p, x)

    want = []
    for m in range(M):
        x = xs[m]
        for v in range(V):
            x = _zb_block(chunks[v], x)
        want.append(x)
    want_loss = torch.stack(want).square().sum()
    names = sorted(chunks[0])
    flat = [chunks[v][n] for v in range(V) for n in names]
    want_grads = torch.autograd.grad(want_loss, flat)
    _Spy.runs.clear()
    if mode == "ZBH1":
        ys = []
        for v in range(V):      # V one-chunk pipelines, one after another
            ys = tpipe.pipeline_apply_zb(block, chunks[v],
                                         ys if v else xs)
    else:
        ys = tpipe.pipeline_apply_zbvpp(block, chunks, xs, V)
    got = torch.autograd.grad(ys.square().sum(), flat)
    assert sorted(set(_Spy.runs)) == ["scale", "w1-side", "x-path"]
    for tag in ("scale", "w1-side", "x-path"):
        assert _Spy.runs.count(tag) == M * V, tag
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- the MPMD step against JAX FThenB ----------------------------------------

def _jax_fthenb(params, x, y, steps=2):
    paddle.seed(0)
    pl = JPipelineLayer([JLayerDesc(_JBlock) for _ in range(4)],
                        num_stages=2, loss_fn=jnn.MSELoss())
    pl.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    prev = jmesh.get_mesh()
    m = jmesh.build_mesh({"pp": 2, "dp": 4})
    jmesh.set_mesh(m)
    try:
        model = JPipelineParallel(pl, strategy=_strategy(
            jfleet, accumulate_steps=4, schedule_mode="FThenB"))
        opt = paddle.optimizer.SGD(
            0.1, parameters=pl.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(1.0))
        with jax.set_mesh(m):
            losses = [float(model.train_batch(
                (paddle.to_tensor(x), paddle.to_tensor(y)), opt).numpy())
                for _ in range(steps)]
            out = {n: np.asarray(p._data) for n, p in
                   model.named_parameters()}
    finally:
        jmesh._global_mesh = prev
    return losses, out


@pytest.fixture(scope="module")
def jax_fthenb():
    paddle.seed(5)
    pl = JPipelineLayer([JLayerDesc(_JBlock) for _ in range(4)],
                        num_stages=2, loss_fn=jnn.MSELoss())
    params = {k: np.asarray(v, np.float32)
              for k, v in get_params(pl).items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.standard_normal((8, 8)).astype(np.float32)
    return params, x, y, _jax_fthenb(params, x, y)


@pytest.mark.parametrize("mode", ["MPMD", "MPMD-ZBH1", "MPMD-VPP",
                                  "MPMD-ZBVPP"])
def test_mpmd_step_matches_jax_fthenb(jax_fthenb, mode):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    params, x, y, (want_losses, want_params) = jax_fthenb
    vpp = 2 if "VPP" in mode else 1
    pl = PipelineLayer([LayerDesc(_TBlock) for _ in range(4)], num_stages=2,
                       loss_fn=torch.nn.MSELoss())
    pl.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(
        v.T if k.endswith("fc.weight") else v)) for k, v in params.items()})
    model = PipelineParallel(pl, strategy=_strategy(
        tfleet, accumulate_steps=4, schedule_mode=mode, vpp_degree=vpp))
    opt = topt.SGD(0.1, parameters=model.parameters(),
                   grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    data = (torch.from_numpy(x), torch.from_numpy(y))
    losses = [float(model.train_batch(data, opt)) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        got = got.T if n.endswith("fc.weight") else got
        np.testing.assert_allclose(got, want_params[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    # eval on the updated stages (MPMD: every stage in this process)
    h = x
    for i in range(4):
        h = np.tanh(h @ want_params[f"{i}.fc.weight"]
                    + want_params[f"{i}.fc.bias"])
    np.testing.assert_allclose(float(model.eval_batch(data)),
                               np.mean((h - y) ** 2), rtol=1e-5)
    np.testing.assert_allclose(
        model.eval_batch((data[0], None), compute_loss=False).numpy(), h,
        rtol=1e-4, atol=1e-6)
    driver = model.mpmd_driver
    assert driver.steps == 2
    assert driver.graph.schedule_mode == ("ZBH1" if mode == "MPMD-ZBH1"
                                          else "ZBVPP" if "ZBVPP" in mode
                                          else "VPP" if vpp > 1
                                          else "FThenB")
    assert driver.graph.act_shape == (2, 8)


def test_train_batch_with_scaler_and_lr_scheduler():
    """``train_batch``'s ``scaler`` (the loss scaled by a power of two,
    the gradients unscaled: the same f32 numbers) and ``lr_scheduler``
    (stepped once a batch), on a one-rank pipeline."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as topt
    gen = torch.Generator().manual_seed(2)
    x, y = torch.randn(8, 8, generator=gen), torch.randn(8, 8, generator=gen)

    def run(scaler, sched):
        torch.manual_seed(4)
        pl = PipelineLayer([_TBlock() for _ in range(4)], num_stages=2,
                           loss_fn=torch.nn.MSELoss())
        model = PipelineParallel(pl, strategy=_strategy(
            tfleet, accumulate_steps=4, schedule_mode="1F1B"))
        lr = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5) if sched \
            else 0.1
        opt = topt.SGD(lr, parameters=model.parameters())
        losses = [float(model.train_batch(
            (x, y), opt, lr_scheduler=lr if sched else None,
            scaler=amp.GradScaler(init_loss_scaling=2.0 ** 10)
            if scaler else None)) for _ in range(3)]
        return losses, [p.detach().clone() for p in model.parameters()], lr

    plain, p_plain, _ = run(False, False)
    scaled, p_scaled, _ = run(True, False)
    assert plain == scaled
    assert all(torch.equal(a, b) for a, b in zip(p_plain, p_scaled))
    decayed, _, sched = run(False, True)
    assert decayed[0] == plain[0] and decayed[2] != plain[2]
    assert sched.get_lr() == pytest.approx(0.1 * 0.5 ** 3)
