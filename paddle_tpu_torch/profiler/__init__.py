"""paddle.profiler over torch.profiler (counterpart of
``paddle_tpu/profiler``).

``Profiler`` keeps the reference's scheduler states (CLOSED / READY /
RECORD / RECORD_AND_RETURN), ``RecordEvent`` annotations and host
telemetry (op dispatch spans and signatures, run-time builds, memory
samples); its device tracer is ``torch.profiler`` (CUPTI for the GPU
target), whose CUDA activity lands in the same chrome trace and in a
device view of ``summary()``:

    from paddle_tpu_torch import profiler
    p = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=4,
                                          repeat=1),
        on_trace_ready=profiler.export_chrome_tracing("prof_out"))
    with p:
        for _ in range(6):
            with profiler.RecordEvent("train_step"):
                step()
            p.step()
    print(p.summary())
    # prof_out/rank0_step6.json: chrome://tracing or ui.perfetto.dev

The module is not imported by ``import paddle_tpu_torch``; the first
``paddle.profiler`` attribute access imports it.
"""
from . import chrome_trace, stats
from .profiler import (Profiler, ProfilerState, ProfilerTarget, RecordEvent,
                       export_chrome_tracing, export_protobuf,
                       load_profiler_result, make_scheduler)
from .profiler_statistic import SortedKeys, StatisticData, SummaryView
from .stats import (CompileTracker, MemorySampler, OpDispatchTracer,
                    RuntimeStats)
from .timer import benchmark

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "export_chrome_tracing", "export_protobuf", "load_profiler_result",
           "make_scheduler", "benchmark", "SortedKeys", "StatisticData",
           "SummaryView", "CompileTracker", "MemorySampler",
           "OpDispatchTracer", "RuntimeStats", "chrome_trace", "stats"]
