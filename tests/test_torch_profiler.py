"""The port's profiler (paddle_tpu_torch.profiler) against the JAX
package's on the CPU: scheduler states, the OperatorView of a small
eager program (a 1-layer TransformerEncoder with its weights carried
across by bridge.layer_state_from_jax, f32 and O1 bf16), shape churn of a
growing-shape loop, the chrome-trace round trip and rank tagging under
PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM (the serving trace too), cycles
that do not merge, the summary's units and ordering, the NaN flush at
step and stop; and the port's own pieces: the device view's kernel names
and clock alignment, the raising GPU target without a GPU, the run-time
build counters and the dispatch hooks' removal. Op names and call counts
are compared exactly; no tolerance is involved."""
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.profiler import profiler as jprof
from paddle_tpu_torch import monitor
from paddle_tpu_torch.bridge import layer_state_from_jax
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.profiler import (Profiler, ProfilerState,
                                       ProfilerTarget, RecordEvent,
                                       SummaryView,
                                       export_chrome_tracing,
                                       load_profiler_result, make_scheduler)
from paddle_tpu_torch.profiler import profiler as tprof
from paddle_tpu_torch.profiler import stats as tstats

CPU = [ProfilerTarget.CPU]


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


@pytest.mark.parametrize("closed,ready,record,repeat,skip_first", [
    (1, 1, 2, 1, 1), (0, 0, 1, 0, 0), (2, 1, 3, 0, 0), (1, 0, 2, 2, 0),
    (3, 2, 4, 3, 5), (0, 1, 1, 0, 2), (2, 2, 2, 1, 0)])
def test_scheduler_states_equal_jax(closed, ready, record, repeat,
                                    skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    js, ts = jprof.make_scheduler(**kw), make_scheduler(**kw)
    assert [ts(i).name for i in range(40)] == [js(i).name
                                               for i in range(40)]
    assert [s.name for s in ProfilerState] == [
        s.name for s in jprof.ProfilerState]


# -- the OperatorView of one eager program ----------------------------------

def _model(P):
    nn = P.nn
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu"), 1)
    return nn.Sequential(nn.Embedding(50, 32), enc, nn.Linear(32, 2))


def _program(P, model, amp):
    """~10 surface ops: embedding, attention, FFN, head, loss, backward."""
    rng = np.random.default_rng(0)
    ids = P.to_tensor(rng.integers(0, 50, (2, 8)))
    keep = P.to_tensor(np.ones((2, 1, 1, 8), bool))
    labels = P.to_tensor(rng.integers(0, 2, (2,)))
    with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        with P.profiler.RecordEvent("fwd"):
            h = model[1](model[0](ids), src_mask=keep)
            loss = P.nn.functional.cross_entropy(model[2](h[:, 0]), labels)
    loss.backward()


def _profile(P, model, amp, **kw):
    prof = P.profiler.Profiler(timer_only=True, **kw)
    with prof:
        _program(P, model, amp)
        prof.step()
    return prof


@pytest.fixture(scope="module")
def models():
    jm, tm = _model(jp), _model(tp)
    tm.set_state_dict(layer_state_from_jax(jm))
    return jm, tm


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o1_bf16"])
def test_operator_view_equals_jax(models, amp):
    jm, tm = models
    jpr = _profile(jp, jm, amp)
    tpr = _profile(tp, tm, amp, targets=CPU)
    jops, tops = jpr.statistic_data.op_stats, tpr.statistic_data.op_stats
    assert {n: s.calls for n, s in tops.items()} == \
        {n: s.calls for n, s in jops.items()}
    assert {n: s.out_dtypes for n, s in tops.items()} == \
        {n: s.out_dtypes for n, s in jops.items()}
    assert {n: len(s.signatures) for n, s in tops.items()} == \
        {n: len(s.signatures) for n, s in jops.items()}
    table = tpr.summary(views=SummaryView.OperatorView)
    for name in jops:
        assert name[:35] in table
    assert ("cast" in tops) == amp


def test_input_signatures_equal_jax(models):
    jm, tm = models
    jpr, tpr = _profile(jp, jm, False), _profile(tp, tm, False,
                                                 targets=CPU)
    for name, st in jpr.statistic_data.op_stats.items():
        got = list(tpr.statistic_data.op_stats[name].signatures)
        assert got == list(st.signatures), name


def _growing(P, **kw):
    with P.profiler.Profiler(timer_only=True, **kw) as prof:
        for n in range(10):
            x = P.to_tensor(np.ones(n + 1, np.float32))
            _ = x * 2.0
            prof.step()
    return prof


def test_shape_churn_report_of_a_growing_loop_equals_jax():
    jr = _growing(jp).shape_churn_report(min_signatures=8)
    tr = _growing(tp, targets=CPU).shape_churn_report(min_signatures=8)
    assert tr == jr
    assert tr[0]["op"] == "multiply" and tr[0]["distinct_signatures"] == 10


def test_shape_churn_ignores_signatures_of_the_first_step(models):
    """Divergence by design: an O1 loop casts ten weight shapes, all in
    its first step. The JAX report flags ``cast`` (>= 8 signatures); the
    port's flags only a set that grew after the first step."""
    jm, tm = models
    reports = {}
    for name, P, m, kw in (("jax", jp, jm, {}),
                           ("port", tp, tm, dict(targets=CPU))):
        with P.profiler.Profiler(timer_only=True, **kw) as prof:
            for _ in range(3):
                _program(P, m, True)
                prof.step()
        reports[name] = prof.shape_churn_report()
    assert [r["op"] for r in reports["jax"]] == ["cast"]
    assert reports["port"] == []


def test_steady_state_recompiles_count_run_time_builds():
    with Profiler(timer_only=True, targets=CPU) as prof:
        for i in range(4):
            if i == 2:
                tstats.compile_event("graph_capture", 0.5)
            prof.step()
    tracker = prof.runtime_stats.compiles
    assert tracker.per_step == [0, 0, 1, 0]
    assert tracker.steady_state_recompiles() == 1
    assert tracker.compile_secs == 0.5


# -- the chrome trace -------------------------------------------------------

def _linear_run(P, **kw):
    P.seed(0)
    net = P.nn.Linear(16, 16)
    x = P.to_tensor(np.ones((4, 16), np.float32))
    prof = P.profiler.Profiler(timer_only=True, **kw)
    with prof:
        for _ in range(3):
            with P.profiler.RecordEvent("fwd"):
                net(x)
            prof.step()
    return prof


def test_chrome_trace_round_trip_matches_jax(tmp_path):
    def names(prof):
        trace = load_profiler_result(prof.last_trace_path)
        evs = trace["traceEvents"]
        assert all(e["dur"] >= 0 for e in evs if e.get("ph") == "X")
        return trace, sorted((e["cat"], e["name"]) for e in evs
                             if e.get("ph") == "X")

    jt, jn = names(_linear_run(jp, profile_memory=True,
                               on_trace_ready=jprof.export_chrome_tracing(
                                   str(tmp_path / "jax"))))
    tpr = _linear_run(tp, profile_memory=True, targets=CPU,
                      on_trace_ready=export_chrome_tracing(
                          str(tmp_path / "port")))
    tt, tn = names(tpr)
    assert tn == jn and ("user", "fwd") in tn and ("op", "linear") in tn
    for key in ("rank", "world_size", "step_num"):
        assert tt["metadata"][key] == jt["metadata"][key]
    procs = [e for e in tt["traceEvents"] if e.get("ph") == "M"
             and e["name"] == "process_name"]
    assert procs[0]["pid"] == 0 and "rank0" in procs[0]["args"]["name"]
    mem = [e for e in tt["traceEvents"] if e.get("ph") == "C"]
    assert len(mem) == 3 and mem[0]["name"] == "memory (host_rss)"
    assert os.path.basename(tpr.last_trace_path) == "rank0_step3.json"


def test_rank_tagging_follows_the_env_like_jax(tmp_path, monkeypatch):
    """The port's serving trace and chrome-trace export carry the rank and
    world size of PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM, as the JAX
    package's do (the port's serving trace read only torch.distributed)."""
    from paddle_tpu.inference import tracing as jtracing

    from paddle_tpu_torch.inference import tracing as ttracing
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    timelines = {0: [{"phase": "queued", "t0_ms": 0.0, "t1_ms": 1.5,
                      "origin": "replica0"},
                     {"phase": "decode", "t0_ms": 1.5, "t1_ms": 4.0,
                      "origin": "replica0", "slot": 1}]}
    jst, tst = (m.build_serving_trace(timelines)
                for m in (jtracing, ttracing))
    assert tst["metadata"] == jst["metadata"]
    assert (tst["metadata"]["rank"], tst["metadata"]["world_size"]) == (3, 8)
    assert tst["traceEvents"] == jst["traceEvents"]
    jpath = _linear_run(jp, on_trace_ready=jprof.export_chrome_tracing(
        str(tmp_path / "jax"))).last_trace_path
    tpath = _linear_run(tp, targets=CPU, on_trace_ready=export_chrome_tracing(
        str(tmp_path / "port"))).last_trace_path
    jtr, ttr = load_profiler_result(jpath), load_profiler_result(tpath)
    assert (ttr["metadata"]["rank"], ttr["metadata"]["world_size"]) == \
        (jtr["metadata"]["rank"], jtr["metadata"]["world_size"]) == (3, 8)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert {e["pid"] for e in ttr["traceEvents"]} == \
        {e["pid"] for e in jtr["traceEvents"]} == {3}


def test_cycles_do_not_merge(tmp_path):
    """Each RECORD_AND_RETURN hands on_trace_ready its own window, in both
    packages. Divergence by design: the port's host store takes
    RecordEvent spans while the schedule records (2 a cycle here); the
    JAX store also keeps the cycle's CLOSED step (3)."""
    counts = {}
    for name, P, export, kw in (
            ("jax", jp, jprof.export_chrome_tracing, {}),
            ("port", tp, export_chrome_tracing, dict(targets=CPU))):
        x = P.to_tensor(np.ones((2, 2), np.float32))
        paths = []

        def ready(p, _paths=paths, _out=str(tmp_path / name),
                  _export=export):
            _export(_out)(p)
            _paths.append(p.last_trace_path)
        prof = P.profiler.Profiler(
            timer_only=True, on_trace_ready=ready,
            scheduler=P.profiler.make_scheduler(closed=1, ready=0, record=2,
                                                repeat=2), **kw)
        with prof:
            for _ in range(6):
                with P.profiler.RecordEvent("cyc"):
                    _ = x * 2.0
                prof.step()
        counts[name] = [
            tuple(sum(1 for e in load_profiler_result(p)["traceEvents"]
                      if e.get("ph") == "X" and e["name"] == n)
                  for n in ("cyc", "multiply")) for p in paths]
    assert counts["jax"] == [(3, 2), (3, 2)]
    assert counts["port"] == [(2, 2), (2, 2)]


def test_load_profiler_result_rejects_a_non_trace(tmp_path):
    p = tmp_path / "junk.json"
    p.write_text(json.dumps([1, 2, 3]))
    with pytest.raises(ValueError, match="traceEvents"):
        load_profiler_result(str(p))


# -- the summary ------------------------------------------------------------

def test_summary_views_and_time_unit_like_jax():
    jpr = _linear_run(jp, profile_memory=True)
    tpr = _linear_run(tp, profile_memory=True, targets=CPU)
    for prof, views in ((jpr, jp.profiler.SummaryView),
                        (tpr, SummaryView)):
        s = prof.summary()
        for section in ("Overview", "Operator Summary", "Memory Summary",
                        "UserDefined Summary"):
            assert section in s
        assert "min(ms)" in s and "fwd" in s and "linear" in s
        only = prof.summary(views=views.MemoryView)
        assert "Memory Summary" in only and "Overview" not in only
        t = prof.summary(time_unit="s", views=views.UDFView)
        assert "total(s)" in t and "total(ms)" not in t
        with pytest.raises(ValueError, match="time_unit"):
            prof.summary(time_unit="parsec")
    assert "Device Summary" in tpr.summary()


def test_summary_honors_sorted_by_like_jax():
    from paddle_tpu.profiler.profiler_statistic import \
        sort_items as jsort_items

    from paddle_tpu_torch.profiler.profiler_statistic import sort_items
    orders = {}
    for name, P, kw in (("jax", jp, {}), ("port", tp, dict(targets=CPU))):
        keys, views = P.profiler.SortedKeys, P.profiler.SummaryView
        sort = jsort_items if P is jp else sort_items
        prof = P.profiler.Profiler(timer_only=True, **kw)
        with prof:
            for _ in range(5):
                with P.profiler.RecordEvent("many_cheap"):
                    pass
            with P.profiler.RecordEvent("one_slow"):
                time.sleep(0.01)
            prof.step()
        agg = prof._store.aggregate()
        orders[name] = [[n for n, _ in sort(agg, k)][0]
                        for k in (keys.CPUTotal, keys.CPUMax, keys.CPUMin)]
        s = prof.summary(sorted_by=keys.CPUAvg, views=views.UDFView)
        assert s.index("one_slow") < s.index("many_cheap")
    assert orders["port"] == orders["jax"] == ["one_slow"] * 3


def test_nan_flush_at_step_and_stop():
    tp.set_flags({"check_nan_inf": True, "check_nan_inf_batch": 64})
    try:
        bad = tp.to_tensor(np.array([1.0, 0.0], np.float32))
        with Profiler(timer_only=True, targets=CPU) as prof:
            _ = tp.to_tensor(np.array([1.0, 1.0], np.float32)) / bad
            with pytest.raises(FloatingPointError, match="divide"):
                prof.step()
        assert not dispatch._nan_pending
        prof2 = Profiler(timer_only=True, targets=CPU)
        prof2.start()
        _ = tp.to_tensor(np.array([1.0, 1.0], np.float32)) / bad
        with pytest.raises(FloatingPointError, match="divide"):
            prof2.stop()
        assert not dispatch._nan_pending
    finally:
        tp.set_flags({"check_nan_inf": False, "check_nan_inf_batch": 1})
        dispatch._nan_pending.clear()


# -- the port's own pieces --------------------------------------------------

def test_gpu_target_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for targets in (None, [ProfilerTarget.CPU, ProfilerTarget.GPU]):
        with pytest.raises(RuntimeError,
                           match=r"targets=\[ProfilerTarget.CPU\]"):
            Profiler(targets=targets)
    with pytest.raises(ValueError, match="not supported"):
        Profiler(targets=[ProfilerTarget.TPU])
    Profiler(targets=CPU)


def test_host_trace_records_only_while_recording(tmp_path):
    """A traced window (timer_only off): the torch profiler is prepared at
    READY, records the RECORD steps and writes its own trace under
    log_dir; RecordEvent spans land only for the recorded steps."""
    x = tp.to_tensor(np.ones((4, 4), np.float32))
    prof = Profiler(targets=CPU, log_dir=str(tmp_path / "log"),
                    scheduler=make_scheduler(closed=1, ready=1, record=2,
                                             repeat=1),
                    on_trace_ready=export_chrome_tracing(str(tmp_path)))
    with prof:
        for _ in range(5):
            with RecordEvent("train_step"):
                _ = x @ x
            prof.step()
    trace = load_profiler_result(prof.last_trace_path)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in spans if e["cat"] == "user"] == \
        ["train_step"] * 2
    assert sum(e["cat"] == "op" for e in spans) == 2
    torch_trace = json.load(open(prof.last_device_trace_path))
    names = {e.get("name") for e in torch_trace["traceEvents"]}
    assert "train_step" in names and tprof._ANCHOR in names
    assert trace["metadata"]["device_trace"] == prof.last_device_trace_path


@pytest.mark.parametrize("name,base", [
    ("void flash_fwd_wgmma_kernel<Fwd128, true>(Maps, Args)",
     "flash_fwd_wgmma_kernel"),
    ("void (anonymous namespace)::fused_adam_kernel<float>(Param const*, "
     "Chunk const*, Consts)", "fused_adam_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::AddFunctor<float>, std::array<char*, 3ul> >(int, "
     "at::native::AddFunctor<float>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel"),
    ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("Memset (Device)", "Memset (Device)")])
def test_kernel_base_name(name, base):
    assert tprof.kernel_base_name(name) == base


class _Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_spans_align_on_the_anchor_and_feed_the_device_view():
    from torch.autograd import DeviceType
    t0 = 10**18
    res = _Results([
        _Ev("aten::mm", DeviceType.CPU, t0 + 500, t0 + 900),
        _Ev("void k<1>(int)", DeviceType.CUDA, t0 + 4000, t0 + 6000),
        _Ev(tprof._ANCHOR, DeviceType.CPU, t0 + 1000, t0 + 1001),
        _Ev("train_step", DeviceType.CPU, t0 + 1400, t0 + 6900),
        _Ev("train_step", DeviceType.CUDA, t0 + 1500, t0 + 7000),
        _Ev("void k<2>(int)", DeviceType.CUDA, t0 + 2000, t0 + 3000)])
    spans = tprof.device_spans(res, anchor_perf=5.0)
    # kernels only: the annotation's device range is not device work
    assert [n for n, _, _ in spans] == ["k", "k"]
    assert spans[0][1] == pytest.approx(5.0 + 1e-6)
    assert spans[1][2] - spans[1][1] == pytest.approx(2e-6)
    with pytest.raises(RuntimeError, match="anchor"):
        tprof.device_spans(_Results(res._events[:2]), 0.0)
    prof = Profiler(timer_only=True, targets=CPU)
    prof._device_events = spans
    data = prof.statistic_data
    assert data.kernel_stats["k"]["calls"] == 2
    assert data.kernel_stats["k"]["total_ms"] == pytest.approx(3e-3)
    table = prof.summary(views=SummaryView.DeviceView)
    assert "Device Summary" in table and "launches" in table
    assert "device activities" in prof.summary(views=SummaryView.OverView)


def test_compile_events_feed_the_always_on_counters():
    c0 = monitor.counter("kernels.builds").get()
    s0 = monitor.gauge("kernels.build_secs").get()
    tstats.compile_event("kernel_build", 2.0)
    assert monitor.counter("kernels.builds").get() == c0 + 1
    assert monitor.gauge("kernels.build_secs").get() == s0 + 2.0
    with pytest.raises(KeyError):
        tstats.compile_event("xla_compile", 1.0)


def test_hooks_are_removed_and_cost_nothing_when_empty(models):
    _, tm = models
    assert not dispatch.OP_TIMING_HOOKS and not dispatch.OP_OBSERVERS
    with tstats.OpDispatchTracer() as tr:
        assert len(dispatch.OP_TIMING_HOOKS) == len(dispatch.OP_OBSERVERS) == 1
        _program(tp, tm, False)
    assert not dispatch.OP_TIMING_HOOKS and not dispatch.OP_OBSERVERS
    assert tr.stats["linear"].calls > 0
    assert dispatch.input_signature(
        [tp.to_tensor(np.ones((2, 3), np.float32)), 1.0,
         np.zeros(4, np.int64)]) == ("(2, 3):float32", "(4,):int64")


def test_benchmark_ips():
    b = tp.profiler.benchmark()
    b.enable()
    b._warmup = 0
    for _ in range(3):
        b.begin()
        b.step(num_samples=32)
    assert b.ips > 0 and b.report()["avg_batch_sec"] >= 0
    b.disable()
