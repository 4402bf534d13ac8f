"""The port's serving replay tool (``python -m
paddle_tpu_torch.serving_replay``, ``--device cpu``) against the JAX
package's (``tools/serving_replay.py``) on the same fixtures and the same
weights (the JAX tool's models, carried across through the port tool's
``weights`` hook with ``bridge.py``).

Deterministic report fields must be equal: every request's tokens, the
``serving.*`` counters (the MoE decode-path counters aside: the JAX ones
count compiled executables, the port's count calls), the virtual-clock
TTFT / TPOT (or embedding latency) percentiles, prefix hit rate,
failures and the exit code, and under ``--disagg`` / ``--replicas`` the
driver's block and the kill gate's. Also: ``tools/trace_summary.py`` reads
the port's ``--trace-out``; the drivers' misuse checks exit 2 as the JAX
tool's do; every flag of a mode not ported yet exits 2, as do the CUDA
route gates on the CPU.

Tolerance: exact (every compared field is a count or a virtual-clock
time).
"""
import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.inference.engine as jengine
from paddle_tpu.jit.functional import get_params
from paddle_tpu.text.models import BertConfig as JaxBertConfig
from paddle_tpu.text.models import BertModel as JaxBert
from paddle_tpu.text.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models.ernie_moe import ErnieMoEConfig as JaxErnieConfig
from paddle_tpu.text.models.ernie_moe import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu_torch import serving_replay as port_tool
from paddle_tpu_torch.bridge import llama_state_from_numpy

from test_torch_engine import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT / "tools"))
import serving_replay as jax_tool  # noqa: E402
import trace_summary  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def jax_weights(seed):
    """The port tool's weights hook: the JAX tool's model for the same
    config and seed, in the port's layout."""
    builders = {"LlamaConfig": (JaxLlamaConfig, JaxLlama),
                "ErnieMoEConfig": (JaxErnieConfig, JaxErnie),
                "BertConfig": (JaxBertConfig, JaxBert)}

    def hook(role, cfg):
        jcfg_cls, jnet_cls = builders[type(cfg).__name__]
        jp.seed(seed + (1 if role == "draft" else 0))
        net = jnet_cls(jcfg_cls(**dataclasses.asdict(cfg)))
        return llama_state_from_numpy(
            {k: np.asarray(v, np.float32)
             for k, v in get_params(net).items()})
    return hook


def _call(fn, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv, **kw)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def jax_tokens(monkeypatch):
    """Every Output the JAX tool's engines retire, per engine (the last
    engine is the measured run)."""
    runs = []
    orig = jengine.Engine.step

    def step(self):
        outs = orig(self)
        if not runs or runs[-1][0] is not self:
            runs.append((self, {}))
        for o in outs:
            runs[-1][1][str(o.req_id)] = list(map(int, o.token_ids))
        return outs
    monkeypatch.setattr(jengine.Engine, "step", step)
    return runs


CASES = {
    "base": ["serving_trace.jsonl"],
    "prefix": ["serving_trace_prefix.jsonl"],
    "chaos": ["serving_trace_chaos.jsonl", "--chaos"],
    "moe": ["serving_trace_moe.jsonl", "--model", "ernie_moe"],
    "multi_tick": ["serving_trace.jsonl", "--multi-tick", "4"],
    "spec_greedy": ["serving_trace.jsonl", "--spec-k", "2"],
    "chunked": ["serving_trace_prefix.jsonl", "--max-prefill-tokens", "8",
                "--no-prefix-cache"],
}


def _serving(counters):
    return {k: v for k, v in counters.items()
            if k.startswith("serving.") and not k.startswith("serving.moe.")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_report_matches_the_jax_tool(case, jax_tokens):
    args = CASES[case]
    argv = [str(FIX / args[0])] + args[1:] + ["--json"]
    jrc, J, jerr = _call(jax_tool.main, argv)
    trc, T, terr = _call(port_tool.main, argv + ["--device", "cpu"],
                         weights=jax_weights(0))
    assert jrc == trc == 0, (jerr, terr)
    assert T["tokens"] == jax_tokens[-1][1]
    assert _serving(T["counters"]) == _serving(J["counters"])
    for key in ("requests", "steps", "total_tokens", "preemptions",
                "failed", "ttft_ms", "ttft_ms_by_tag", "tpot_ms",
                "prefix_hit_rate", "spec_accept_rate"):
        assert T[key] == J[key], key
    assert T["host_device"]["multi_tick"]["fused_ticks"] == \
        J["host_device"]["multi_tick"]["fused_ticks"]
    if case == "chaos":
        for key in ("injected", "total_injected", "survivors",
                    "survivors_exact", "leaked_pages"):
            assert T["chaos"][key] == J["chaos"][key], key
    assert T["decode_paths"]["plain"] > 0
    assert T["decode_paths"]["cuda_split"] == 0


def test_embedding_report_matches_the_jax_tool():
    argv = [str(FIX / "serving_trace_embed.jsonl"), "--embedding", "--json"]
    jrc, J, _ = _call(jax_tool.main, argv)
    trc, T, _ = _call(port_tool.main, argv + ["--device", "cpu"],
                      weights=jax_weights(0))
    assert jrc == trc == 0
    for key in ("requests", "steps", "batches", "total_tokens", "failed",
                "latency_ms", "batch_fill", "pad_ratio"):
        assert T[key] == J[key], key
    assert _serving(T["counters"]) == _serving(J["counters"])


def test_trace_summary_reads_the_port_export(tmp_path, capsys):
    out = tmp_path / "spans.json"
    argv = [str(FIX / "serving_trace_chaos.jsonl"), "--chaos", "--json",
            "--device", "cpu", "--trace-out", str(out),
            "--expect-complete-timelines"]
    rc, report, _ = _call(port_tool.main, argv)
    assert rc == 0
    trace = trace_summary.load_trace(str(out))
    s = trace_summary.summarize_serving(trace)
    assert s["requests"] == report["requests"]
    assert s["finished"] + s["failed"] == report["requests"]
    assert s["failed"] == sum(report["failed"].values())
    assert {"QUEUED", "PREFILL", "DECODE"} <= set(s["phases"])
    assert trace_summary.main([str(out)]) == 0
    assert "serving timeline" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--expect-hotpath-clean"], ["--expect-zero-recompiles"],
    ["--expect-pallas"], ["--expect-moe-pallas", "--model", "ernie_moe"],
], ids=lambda f: f[0].lstrip("-"))
def test_unported_and_cuda_only_flags_exit_2(flags):
    rc, report, err = _call(port_tool.main, [
        str(FIX / "serving_trace.jsonl"), "--device", "cpu"] + flags)
    assert rc == 2 and report is None
    assert flags[0] in err


@pytest.fixture
def jax_driver_tokens(monkeypatch):
    """Every Output the JAX tool's drivers retire, per driver (the last
    driver is the measured run)."""
    from paddle_tpu.inference import disagg as jdisagg
    from paddle_tpu.inference import fleet as jfleet
    runs = []
    for cls in (jdisagg.DisaggEngine, jfleet.ServingFleet):
        orig = cls.step

        def step(self, _orig=orig):
            outs = _orig(self)
            if not runs or runs[-1][0] is not self:
                runs.append((self, {}))
            for o in outs:
                runs[-1][1][str(o.req_id)] = list(map(int, o.token_ids))
            return outs
        monkeypatch.setattr(cls, "step", step)
    return runs


#: the JAX tool's own driver cases (tests/test_serving_disagg.py,
#: tests/test_serving_fleet.py), held report for report
DRIVER_CASES = {
    "disagg_kill_worker": [
        "serving_trace.jsonl", "--disagg", "--prefill-workers", "2",
        "--decode-workers", "2", "--kill-worker", "decode:1:8",
        "--expect-complete-timelines"],
    "fleet_session": ["serving_trace_fleet.jsonl", "--replicas", "2",
                      "--route", "session"],
    "fleet_kill_replica": [
        "serving_trace_fleet.jsonl", "--replicas", "2", "--kill-replica",
        "1:12", "--expect-prefix-hit-rate", "0.8",
        "--expect-complete-timelines"],
}


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_report_matches_the_jax_tool(case, jax_driver_tokens):
    args = DRIVER_CASES[case]
    argv = [str(FIX / args[0])] + args[1:] + ["--json"]
    jrc, J, jerr = _call(jax_tool.main, argv)
    trc, T, terr = _call(port_tool.main, argv + ["--device", "cpu"],
                         weights=jax_weights(0))
    assert jrc == trc == 0, (jerr, terr)
    assert T["tokens"] == jax_driver_tokens[-1][1]
    assert _serving(T["counters"]) == _serving(J["counters"])
    for key in ("requests", "steps", "total_tokens", "preemptions",
                "failed", "ttft_ms", "tpot_ms", "prefix_hit_rate"):
        assert T[key] == J[key], key
    for block in ("disagg", "fleet", "worker_kill", "replica_kill"):
        assert (block in T) == (block in J), block
        if block in J:
            want = {k: v for k, v in J[block].items()
                    if k != "ttft_by_replica"}
            got = {k: T[block][k] for k in want}
            assert got == want, block
    assert T["decode_paths"]["plain"] > 0
    assert T["decode_paths"]["cuda_split"] == 0


def test_report_launches_count_the_measured_run_alone(monkeypatch):
    """A kill run's report counts the launches of its measured run, not
    those of the clean reference run before it in the same process: each
    worker step stands in for one counted launch here (the CPU runs no
    kernel), and the report's count is the measured driver's steps."""
    from paddle_tpu_torch.inference import disagg
    from paddle_tpu_torch.inference.engine import Engine
    from paddle_tpu_torch.kernels import paged_attention as pa
    monkeypatch.setattr(pa.paged_decode, "launches", 0)
    drivers, stepped = [], []
    init, step = disagg.DisaggEngine.__init__, Engine.step

    def counted_init(self, *a, **kw):
        init(self, *a, **kw)
        drivers.append(list(self.prefill) + list(self.decode))

    def counted_step(self):
        pa.paged_decode.launches += 1
        stepped.append(self)
        return step(self)
    monkeypatch.setattr(disagg.DisaggEngine, "__init__", counted_init)
    monkeypatch.setattr(Engine, "step", counted_step)
    args = DRIVER_CASES["disagg_kill_worker"]
    rc, report, err = _call(port_tool.main, [str(FIX / args[0])] + args[1:]
                            + ["--json", "--device", "cpu"])
    assert rc == 0, err
    assert len(drivers) == 2                 # the reference run, the kill run
    measured = {id(w) for w in drivers[-1]}
    n = sum(1 for w in stepped if id(w) in measured)
    assert 0 < n < len(stepped)
    assert report["launches"]["paged_decode"] == n


@pytest.mark.parametrize("flags", [
    ["--kill-worker", "decode:0:3"],
    ["--disagg", "--kill-worker", "decode-0-3"],
    ["--disagg", "--decode-workers", "2", "--kill-worker", "decode:0:3",
     "--kill-worker", "decode:1:4"],
    ["--route", "session"],
    ["--kill-replica", "0:3"],
    ["--replicas", "2", "--disagg"],
    ["--replicas", "2", "--kill-replica", "2:3"],
    ["--prefill-workers", "2"],
], ids=["kill_worker_needs_disagg", "bad_kill_worker_spec",
        "kill_every_decode_worker", "route_needs_replicas",
        "kill_replica_needs_replicas", "replicas_excludes_disagg",
        "kill_replica_out_of_range", "workers_need_disagg"])
def test_driver_misuse_exits_2_as_the_jax_tool(flags):
    argv = [str(FIX / "serving_trace.jsonl"), "--json"] + flags
    jrc, _, jerr = _call(jax_tool.main, argv)
    trc, report, terr = _call(port_tool.main, argv + ["--device", "cpu"])
    assert jrc == trc == 2 and report is None, (jerr, terr)


def test_exit_codes_of_the_gates_match_the_jax_tool():
    for extra, code in ((["--expect-prefix-hit-rate", "0.99"], 5),
                        (["--expect-p99-ttft-ms", "1"], 7),
                        (["--expect-host-share", "0.0"], 14)):
        argv = [str(FIX / "serving_trace.jsonl"), "--json"] + extra
        jrc, _, _ = _call(jax_tool.main, argv)
        trc, _, _ = _call(port_tool.main, argv + ["--device", "cpu"],
                          weights=jax_weights(0))
        assert jrc == trc == code, extra
    assert _call(port_tool.main, [str(FIX / "missing.jsonl"),
                                  "--device", "cpu"])[0] == 2
