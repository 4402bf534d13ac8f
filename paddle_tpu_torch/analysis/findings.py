"""The Finding / Report data model of the linters (counterpart of
``paddle_tpu/analysis/findings.py``, a copy: stdlib only). The port has
only ``mpmd_lint`` yet; the rule catalog is the JAX package's whole, so
that a rule id means the same in both."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional

# -- rule catalog (docs/ANALYSIS.md documents each one) ----------------------

# AST (trace-safety) rules — what dy2static's transforms reject/rewrite
TENSOR_BOOL_BRANCH = "tensor-bool-branch"
TENSOR_HOST_SYNC = "tensor-host-sync"
TENSOR_PY_CAST = "tensor-py-cast"
TENSOR_INPLACE = "tensor-inplace"
HOST_RNG = "host-rng"

# jaxpr (staged-program) rules — what the abstract trace reveals
GRAPH_BREAK = "graph-break"
TRACE_FAILED = "trace-failed"
DTYPE_PROMOTION = "dtype-promotion"
LARGE_CONSTANT = "large-constant"
DEAD_COMPUTATION = "dead-computation"
UNUSED_INPUT = "unused-input"
CONSTANT_OUTPUT = "constant-output"
UNROLLED_LOOP = "unrolled-loop"
STATIC_ARG_RECOMPILE = "static-arg-recompile"
MOE_SLOW_DISPATCH = "moe-slow-dispatch"

# shard (SPMD/collective) rules — what shard_lint's device-free trace
# under a fake mesh reveals (docs/ANALYSIS.md "shard_lint")
BAD_AXIS_NAME = "bad-axis-name"
UNALIGNED_GROUP = "unaligned-group"
INDIVISIBLE_COLLECTIVE = "indivisible-collective"
UNEVEN_SPLIT = "uneven-split"
TENSOR_LIST_ARITY = "tensor-list-arity"
P2P_IN_TRACE = "p2p-in-trace"
NON_RING_PERMUTE = "non-ring-permute"

# pipeline-schedule rules — static checks over PipelineLayer metadata
STAGE_IMBALANCE = "stage-imbalance"
BUBBLE_FRACTION = "bubble-fraction"
SEGMENT_MISMATCH = "segment-mismatch"
MICROBATCH_ARITY = "microbatch-arity"

# planner rules — the auto-parallel plan search (analysis.planner)
# reuses the shard/pipeline rules above for everything it can express
# with them; HBM is the one gate with no lint analog
HBM_OVER_BUDGET = "hbm-over-budget"

# hot-path (serving tick) rules — what hotpath_lint's executable
# inventory + scheduler-source walk reveals (docs/ANALYSIS.md
# "Hot-path rules"). Prefixed "hotpath." so the per-rule monitor
# counters land under lint.hotpath.* through the shared emit path.
MISSED_DONATION = "hotpath.missed-donation"
FETCH_SET_BLOAT = "hotpath.fetch-set-bloat"
HOST_SYNC_IN_TICK = "hotpath.host-sync-in-tick"
STEADY_TICK_UPLOAD = "hotpath.steady-tick-upload"
RECOMPILE_RISK_KEY = "hotpath.recompile-risk-key"

# MPMD schedule rules — what mpmd_lint's device-free model check over
# a distributed.mpmd_graph event graph reveals (docs/ANALYSIS.md "MPMD
# schedule rules"). Prefixed "mpmd." so the per-rule monitor counters
# land under lint.mpmd.* through the shared emit path.
MPMD_DEADLOCK = "mpmd.deadlock"
MPMD_UNMATCHED_P2P = "mpmd.unmatched-p2p"
MPMD_BUFFER_RACE = "mpmd.buffer-race"
MPMD_HBM_OVER_BUDGET = "mpmd.hbm-over-budget"
MPMD_DATAFLOW_MISMATCH = "mpmd.dataflow-mismatch"
MPMD_STALE_WEIGHT = "mpmd.stale-weight"

AST_RULES = (TENSOR_BOOL_BRANCH, TENSOR_HOST_SYNC, TENSOR_PY_CAST,
             TENSOR_INPLACE, HOST_RNG)
JAXPR_RULES = (GRAPH_BREAK, TRACE_FAILED, DTYPE_PROMOTION,
               LARGE_CONSTANT, DEAD_COMPUTATION, UNUSED_INPUT,
               CONSTANT_OUTPUT, UNROLLED_LOOP, STATIC_ARG_RECOMPILE,
               MOE_SLOW_DISPATCH)
SHARD_RULES = (BAD_AXIS_NAME, UNALIGNED_GROUP, INDIVISIBLE_COLLECTIVE,
               UNEVEN_SPLIT, TENSOR_LIST_ARITY, P2P_IN_TRACE,
               NON_RING_PERMUTE)
PIPELINE_RULES = (STAGE_IMBALANCE, BUBBLE_FRACTION, SEGMENT_MISMATCH,
                  MICROBATCH_ARITY)
PLANNER_RULES = (HBM_OVER_BUDGET,)
HOTPATH_RULES = (MISSED_DONATION, FETCH_SET_BLOAT, HOST_SYNC_IN_TICK,
                 STEADY_TICK_UPLOAD, RECOMPILE_RISK_KEY)
MPMD_RULES = (MPMD_DEADLOCK, MPMD_UNMATCHED_P2P, MPMD_BUFFER_RACE,
              MPMD_HBM_OVER_BUDGET, MPMD_DATAFLOW_MISMATCH,
              MPMD_STALE_WEIGHT)

ERROR = "error"      # will raise at trace time (a _BREAK_ERRORS member)
WARNING = "warning"  # traces, but recompiles / wastes memory / is wrong
INFO = "info"


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    message: str
    file: str = "<unknown>"
    line: int = 0
    # the exact jit.api.StaticFunction._BREAK_ERRORS member this defect
    # raises at trace time ("" for defects that trace but misbehave)
    breaks_with: str = ""
    suggestion: str = ""

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        out = f"{loc}: {self.severity}: [{self.rule}] {self.message}"
        if self.breaks_with:
            out += f" (raises {self.breaks_with} at trace time)"
        if self.suggestion:
            out += f" — {self.suggestion}"
        return out

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class Report:
    """An ordered collection of findings with formatting helpers.

    Truthiness is "has findings", so `if report:` reads naturally in
    both the CLI (exit nonzero) and the first-compile hook."""

    def __init__(self, findings: Optional[List[Finding]] = None,
                 subject: str = ""):
        self.findings: List[Finding] = list(findings or [])
        self.subject = subject
        # optional static cost estimate (analysis.cost_model.CostEstimate
        # duck-typed: .format_table() / .to_dict()) — attached by
        # shard_lint-aware inspect paths, never required. Kept as a bare
        # attribute so this file stays stdlib-only.
        self.cost = None

    def add(self, finding: Finding):
        self.findings.append(finding)

    def extend(self, findings) -> "Report":
        for f in findings:
            self.findings.append(f)
        return self

    def __bool__(self) -> bool:
        return bool(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def rules(self) -> List[str]:
        seen: List[str] = []
        for f in self.findings:
            if f.rule not in seen:
                seen.append(f.rule)
        return seen

    def by_rule(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def format(self, cost: bool = True) -> str:
        if not self.findings:
            head = self.subject or "program"
            out = f"{head}: no findings"
        else:
            lines = []
            if self.subject:
                lines.append(f"== {self.subject}: {len(self.findings)} "
                             f"finding(s) ==")
            lines.extend(f.format() for f in self.findings)
            out = "\n".join(lines)
        if cost and self.cost is not None:
            out += "\n" + self.cost.format_table()
        return out

    def to_json(self) -> str:
        # machine contract (CI / editors): one finding per object, every
        # Finding field present, stable rule ids, plus per-rule counts
        payload = {"subject": self.subject,
                   "findings": [f.to_dict() for f in self.findings],
                   "counts": {r: len(fs)
                              for r, fs in self.by_rule().items()}}
        if self.cost is not None:
            payload["cost"] = self.cost.to_dict()
        return json.dumps(payload, indent=2)

    def __repr__(self):
        return (f"Report(subject={self.subject!r}, "
                f"findings={len(self.findings)})")
