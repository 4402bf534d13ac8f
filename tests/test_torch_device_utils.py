"""The port's device, utils, sysconfig, version and monitor gate against
the JAX package's on the CPU: public names; the raises without a GPU
(streams, events, the allocator's numbers); the host monitors; DLPack
from a JAX array without a copy; unique_name's sequences;
cpp_extension's g++ build lifted into a surface op with its backward;
monitor.enabled() and hapi's auto-inserted TelemetryLogger. Values are
compared exactly."""
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core import place as place_mod

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _public(mod):
    imports = {"annotations", "jax", "torch", "contextlib", "os", "Callable",
               "Optional", "Sequence", "subprocess", "tempfile"}
    return {n for n in dir(mod) if not n.startswith("_")} - imports


@pytest.mark.parametrize("path", [
    "device", "device.cuda", "device.xpu", "device.monitor", "utils",
    "utils.dlpack", "utils.unique_name", "utils.cpp_extension",
    "utils.download", "utils.deprecated", "utils.lazy_import", "sysconfig",
    "version", "profiler", "profiler.stats", "profiler.profiler",
    "profiler.profiler_statistic", "profiler.timer", "amp.debugging"])
def test_public_names_equal_jax(path):
    import importlib
    jmod = importlib.import_module("paddle_tpu." + path)
    tmod = importlib.import_module("paddle_tpu_torch." + path)
    missing = _public(jmod) - _public(tmod)
    # the JAX modules' own imports, and the JAX-only compile constants
    missing -= {"np", "jnp", "csrc", "ctypes", "COMPILE_EVENT",
                "install_compile_listener", "defaultdict", "Iterable",
                "Dict", "List", "Tuple", "OrderedDict", "Enum", "enum",
                "time", "unwrap", "wrap", "flags", "importlib", "json",
                "threading", "functools", "warnings", "monitor"}
    assert missing == set()


@pytest.mark.parametrize("call", [
    "Stream()", "Event()", "current_stream()", "synchronize('gpu')",
    "cuda.memory_allocated()", "cuda.max_memory_allocated()",
    "cuda.memory_reserved()", "cuda.max_memory_reserved()",
    "cuda.empty_cache()", "cuda.get_device_properties()",
    "cuda.get_device_name()", "cuda.get_device_capability()",
    "monitor._device_stats(0)"])
def test_cuda_calls_raise_without_a_gpu(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from paddle_tpu_torch import device
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        eval("device." + call, {"device": device})


def test_device_queries_without_a_gpu(monkeypatch):
    from paddle_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert device.device_count() == device.cuda.device_count() == 0
    assert device.get_all_device_type() == ["cpu"]
    assert device.get_available_device() == ["cpu"]
    assert device.get_all_custom_device_type() == []
    device.synchronize()                 # the CPU place has nothing queued
    device.synchronize("cpu")
    with device.stream_guard(None):
        pass
    assert not device.is_compiled_with_tpu()
    assert not device.is_compiled_with_cinn()
    assert device.is_compiled_with_distribute()
    with pytest.raises(RuntimeError):
        device.IPUPlace()
    with pytest.raises(ValueError, match="priority"):
        device.Stream(priority=0)


def test_host_monitors_match_jax():
    from paddle_tpu.device import monitor as jmon

    from paddle_tpu_torch.device import monitor as tmon
    assert tmon.host_memory_rss() > 0
    assert tmon.host_memory_peak() >= tmon.host_memory_rss() // 2
    for mon in (jmon, tmon):
        mon.monitor_reset("t.bytes")
        for v in (5, -3, 12):
            mon.monitor_add("t.bytes", v)
    want = jmon.monitor_get("t.bytes")
    got = tmon.monitor_get("t.bytes")
    assert got == {"sum": 14, "count": 3, "min": -3, "max": 12}
    if want is not None:                 # the JAX reader's native library
        assert got == want
    tmon.monitor_reset("t.bytes")
    assert tmon.monitor_get("t.bytes") is None


def test_read_memory_on_the_cpu_place_is_host_rss():
    from paddle_tpu_torch.profiler.stats import read_memory
    m = read_memory()
    assert m["source"] == "host_rss" and m["bytes_in_use"] > 0
    assert m["peak_bytes_in_use"] >= m["bytes_in_use"] and \
        m["bytes_limit"] == 0


def test_from_dlpack_of_a_jax_array_shares_its_memory():
    import jax.numpy as jnp
    a = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    t = tp.from_dlpack(a)
    assert isinstance(t, tp.Tensor) and t.shape == [3, 4]
    assert t._data.data_ptr() == a.unsafe_buffer_pointer()
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    jt = jp.from_dlpack(a)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt.numpy()))


def test_to_dlpack_round_trip_shares_memory():
    x = tp.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
    carrier = tp.to_dlpack(x)
    y = tp.from_dlpack(carrier)
    z = torch.from_dlpack(tp.to_dlpack(x))
    assert y._data.data_ptr() == x._data.data_ptr() == z.data_ptr()
    assert np.from_dlpack(carrier).ctypes.data == x._data.data_ptr()
    with pytest.raises(TypeError, match="DLPack"):
        tp.from_dlpack(object())


def test_unique_name_sequences_equal_jax():
    from paddle_tpu.utils import unique_name as ju

    from paddle_tpu_torch.utils import unique_name as tu

    def run(u):
        out = []
        with u.guard():
            out += [u.generate("fc"), u.generate("fc"), u.generate("conv")]
            saved = u.switch()
            out.append(u.generate("fc"))
            u.switch(saved)
            out.append(u.generate("fc"))
        with u.guard("pre_"):
            out.append(u.generate("fc"))
        return out
    assert run(tu) == run(ju) == ["fc_0", "fc_1", "conv_0", "fc_0", "fc_2",
                                  "pre_fc_0"]


def test_cpp_extension_builds_and_trains(tmp_path):
    import ctypes

    from paddle_tpu_torch.utils import cpp_extension
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "affine.cc"
    src.write_text('extern "C" void affine(const float* x, float* y, long n,'
                   ' float a) { for (long i = 0; i < n; ++i) '
                   'y[i] = a * x[i] + 1.0f; }\n')
    lib = cpp_extension.load("affine_test", [str(src)],
                             build_directory=str(tmp_path / "build"))
    lib.affine.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                           ctypes.c_float]

    def fwd(x, a=1.0):
        x = x.contiguous()
        y = torch.empty_like(x)
        lib.affine(x.data_ptr(), y.data_ptr(), x.numel(), a)
        return y

    op = cpp_extension.register_op("affine_test", fwd,
                                   backward=lambda x, g, a=1.0: g * a,
                                   tensor_method=True)
    x = tp.to_tensor(np.arange(5, dtype=np.float32), stop_gradient=False)
    y = op(x, a=2.5)
    np.testing.assert_array_equal(y.numpy(), 2.5 * np.arange(5) + 1)
    (y * y).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * y.numpy() * 2.5)
    from paddle_tpu_torch.ops.custom import affine_test
    assert affine_test is op is cpp_extension.get_op("affine_test")
    np.testing.assert_array_equal(x.affine_test(a=1.0).numpy(),
                                  np.arange(5) + 1)
    nograd = cpp_extension.register_op("affine_nograd", fwd)
    assert nograd(x).stop_gradient
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="build failed"):
        cpp_extension.load("bad", [str(bad)],
                           build_directory=str(tmp_path / "b2"))


def test_utils_helpers_match_jax(tmp_path, monkeypatch, capsys):
    from paddle_tpu import utils as ju

    from paddle_tpu_torch import utils as tu
    assert tu.require_version("0.0.1") and tu.require_version("0.1", "9999")
    for mod in (ju, tu):
        with pytest.raises(RuntimeError, match=">= 99"):
            mod.require_version("99.0")
        with pytest.raises(ImportError, match="not_a_module_xyz"):
            mod.try_import("not_a_module_xyz")

    @tu.deprecated(update_to="g", since="0.1")
    def f():
        return 1
    with pytest.warns(DeprecationWarning, match="use g instead"):
        assert f() == 1
    with pytest.raises(RuntimeError, match="not in local cache"):
        tu.download.get_weights_path_from_url("https://x/none.pdparams")
    tu.run_check()
    assert "works on cpu" in capsys.readouterr().out
    assert tp.sysconfig.get_include().endswith("csrc")
    assert os.path.isfile(os.path.join(tp.sysconfig.get_include(),
                                       "flash_fwd.cu"))
    assert tp.sysconfig.get_lib() == str(ROOT / "build")
    v = tp.version
    assert (v.full_version, v.with_gpu, v.tpu()) == ("0.1.0", "ON", False)
    assert v.cuda() == (torch.version.cuda or False)


def test_monitor_gate_and_detail_snapshot(monkeypatch):
    from paddle_tpu import monitor as jmon
    for mon in (jmon, monitor):
        mon._clear_override()
        monkeypatch.delenv("PADDLE_TPU_MONITOR", raising=False)
        assert not mon.enabled()
        monkeypatch.setenv("PADDLE_TPU_MONITOR", "1")
        assert mon.enabled()
        mon.disable()
        assert not mon.enabled()
        mon.enable()
        monkeypatch.delenv("PADDLE_TPU_MONITOR")
        assert mon.enabled()
        mon._clear_override()
        assert not mon.enabled()
        mon.gauge("t.ms").reset()
        mon.gauge("t.ms").set(2.0)
        mon.gauge("t.ms").set(4.0)
        mon.histogram("t.hist").reset()
        for v in (1.0, 2.0, 3.0):
            mon.histogram("t.hist").record(v)
    jd, td = jmon.snapshot(detail=True), monitor.snapshot(detail=True)
    assert td["t.ms"] == jd["t.ms"] == dict(last=4.0, count=2, mean=3.0,
                                            min=2.0, max=4.0)
    assert td["t.hist"] == jd["t.hist"]
    assert monitor.snapshot()["t.ms"] == 4.0


def test_callback_list_inserts_telemetry_when_enabled():
    from paddle_tpu_torch.hapi.callbacks import CallbackList, TelemetryLogger
    monitor.enable()
    try:
        cbks = CallbackList([], model=None, verbose=0)
        assert sum(isinstance(c, TelemetryLogger)
                   for c in cbks.callbacks) == 1
        mine = TelemetryLogger()
        assert CallbackList([mine], model=None, verbose=0).callbacks == [mine]
    finally:
        monitor._clear_override()
    monitor.disable()
    try:
        cbks = CallbackList([], model=None, verbose=0)
        assert not any(isinstance(c, TelemetryLogger) for c in cbks.callbacks)
    finally:
        monitor._clear_override()


def test_fit_emits_the_telemetry_line_with_recompiles(capsys):
    from paddle_tpu_torch.profiler.stats import compile_event
    monitor.enable()
    try:
        tp.seed(0)
        net = tp.nn.Linear(8, 2)
        model = tp.Model(net)
        model.prepare(tp.optimizer.SGD(0.1, parameters=net.parameters()),
                      tp.nn.CrossEntropyLoss())
        xs = np.ones((16, 8), np.float32)
        ys = np.zeros((16, 1), np.int64)

        class Build(tp.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                if step == 1:
                    compile_event("kernel_build", 0.25)

        model.fit(list(zip(xs, ys)), batch_size=4, epochs=1, verbose=0,
                  callbacks=[Build()])
        out = capsys.readouterr().out
        assert "[telemetry] epoch 1: steps 4" in out
        assert "recompiles 1 compile_s 0.25" in out
        assert monitor.gauge("train.epoch_recompiles").get() == 1
    finally:
        monitor._clear_override()

