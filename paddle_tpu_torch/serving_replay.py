"""serving_replay — replay a JSONL arrival trace against the port's Engine.

Run: python -m paddle_tpu_torch.serving_replay trace.jsonl
         [--device cuda|cpu] [--max-slots 4] [--page-size 8]
         [--pool-pages 64] [--prefill-bucket 16] [--layers 2]
         [--hidden 64] [--heads 4] [--vocab 64] [--seed 0]
         [--step-ms 5] [--prefill-token-ms 0.1] [--temperature 0]
         [--cache-dtype auto] [--no-prefix-cache] [--spec-k 0]
         [--draft-layers 1] [--max-prefill-tokens N] [--json]
         [--model llama|ernie_moe] [--experts 4] [--top-k 2]
         [--moe-every 2] [--expect-moe-pallas]
         [--embedding --max-batch 8 --bucket 16]
         [--expect-pallas] [--expect-prefix-hit-rate 0.5]
         [--expect-p99-ttft-ms MS] [--ttft-tag small]
         [--chaos] [--fault-seed 0] [--fault-rate 0.05]
         [--trace-out spans.json] [--expect-complete-timelines]
         [--multi-tick K] [--expect-host-share PCT]
         [--disagg --prefill-workers N --decode-workers M]
         [--kill-worker decode:1:40]
         [--replicas N --route session] [--kill-replica 1:40]

The PyTorch/CUDA counterpart of the JAX package's replay tool
(``tools/serving_replay.py``, which stays the JAX tool): the same flags,
trace schema, virtual clock, report and exit codes for the single-engine
decoder mode, the disaggregated (``--disagg``) and fleet (``--replicas``)
modes and the ``--embedding`` mode, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the kernels' plain versions).

``--disagg`` serves the trace with ``inference.DisaggEngine``
(``--prefill-workers`` / ``--decode-workers``; trace lines may carry
``"tenant"``); the report adds a ``disagg`` block (migrations, pages
migrated, re-admissions, per-worker utilization). ``--kill-worker
KIND:INDEX:STEP`` (repeatable) first runs the trace clean for reference
tokens, then with the worker death(s): exit 8 when a survivor's tokens
differ, a page leaks or the invariant audit finds something.
``--replicas N`` serves it with ``inference.ServingFleet`` behind the
``--route`` router (``session``, ``least_loaded`` or ``round_robin``;
lines may carry ``"session"``, each session drawing its own system
block); the report adds a ``fleet`` block. ``--kill-replica INDEX:STEP``
is the fleet's failover gate (exit 9). Under ``--multi-tick`` the decode
workers (or every replica) take K.

The model is a LLaMA of ``LlamaConfig.tiny`` geometry from ``--hidden``,
``--layers``, ``--heads`` and ``--vocab`` (FFN 4 x hidden, 256
positions, grown to the trace's longest context), or ERNIE-MoE under
``--model ernie_moe``, in f32 with random weights from ``--seed``; a
``--spec-k`` draft is a ``--draft-layers``-deep LLaMA from ``--seed``
+ 1; ``--embedding`` serves a BERT of ``BertConfig.tiny`` geometry
behind ``BatchEncoder``. The Engine runs on a virtual clock that
advances ``--step-ms`` per step plus ``--prefill-token-ms`` per prefill
token the step ran, so the same trace always gives the same schedule,
tokens and latency percentiles on any device.

Each decoder trace line is one request, ``{"arrival_ms": 0,
"prompt_len": 7, "new_tokens": 9}``, with optional ``system_len`` (a
shared system prompt), ``deadline_ms``, ``max_queue_steps`` and ``tag``
(per-tag TTFT rows); an embedding line is ``{"arrival_ms": 0,
"seq_len": 17, "pooling": "mean"}`` (optional ``tenant``,
``deadline_ms``, ``max_queue_steps``). Prompt tokens come from a numpy
generator seeded with ``--seed``, in the JAX tool's order.

Exit codes: 0 ok; 2 a refused flag or a bad trace; 3 the engine did not
drain; 4 ``--expect-pallas`` saw a decode step off the CUDA split-K
paged-decode kernel; 5 ``--expect-prefix-hit-rate`` missed; 6 ``--chaos``
found a diverged survivor, a leaked page or an invariant finding; 7
``--expect-p99-ttft-ms`` missed; 10 ``--expect-moe-pallas`` saw an MoE
decode step off the grouped-FFN kernels; 8 ``--kill-worker`` / 9
``--kill-replica`` found a diverged survivor, a leaked page or an
invariant finding; 12 ``--expect-complete-timelines`` found a broken
timeline; 14 ``--expect-host-share`` exceeded.

Not carried yet, refused with exit 2: ``--expect-hotpath-clean`` and
``--expect-zero-recompiles`` (the analysis slice, ROADMAP item 6).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

#: flags of the JAX tool whose modules the port does not have yet, and
#: what each needs
UNPORTED = (
    ("--expect-hotpath-clean", "expect_hotpath_clean", "the hot-path lint "
     "(analysis/hotpath_lint.py)"),
    ("--expect-zero-recompiles", "expect_zero_recompiles", "the "
     "steady-state compile tracker (analysis)"),
)

#: the decode attention paths the report breaks down (kernel counters)
PATH_NAMES = {
    "cuda_split": "kernels.decode.paged_cuda_split",
    "cuda_single": "kernels.decode.paged_cuda_single",
    "plain": "kernels.decode.paged_plain",
    "prefill_gather": "kernels.decode.paged_gather",
}

#: counter prefixes the report's ``counters`` block carries as deltas
COUNTER_PREFIXES = (
    "kernels.decode.", "kernels.flash.", "kernels.moe.", "serving.moe.",
    "serving.preemptions", "serving.prefill_tokens", "serving.prefix_",
    "serving.spec_", "serving.timeouts", "serving.cancelled",
    "serving.failed", "serving.multi_tick.dispatches",
    "serving.multi_tick.ticks", "serving.multi_tick.clamp.",
    "serving.multi_tick.scan_exit.", "serving.nan_quarantines",
    "serving.step_errors", "serving.invariant_repairs",
    "serving.fault_injected.",
    # fleet COUNTERS only: the serving.fleet.* namespace also holds
    # gauges that a delta would misreport
    "serving.fleet.routed_", "serving.fleet.migrations",
    "serving.fleet.replica_deaths", "serving.fleet.readmitted",
    "serving.fleet.scale_events")

EMBED_COUNTER_PREFIXES = (
    "serving.embed.requests", "serving.embed.finished",
    "serving.embed.batches", "serving.embed.tokens",
    "serving.embed.pad_tokens", "serving.embed.timeouts",
    "serving.embed.cancelled", "serving.embed.steps", "kernels.flash.")


def _percentiles(vals):
    """p50 / p90 / p99 of a latency stream through the log-bucket
    histogram, rounded as the JAX tool rounds them."""
    from . import monitor
    if not vals:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
    h = monitor.Histogram()
    for v in vals:
        h.record(float(v))
    return {p: round(h.percentile(q), 2)
            for p, q in (("p50", 50), ("p90", 90), ("p99", 99))}


def _launch_counts():
    """Each CUDA kernel wrapper's launch count in this process since its
    start or the last ``_reset_launch_counts`` (a decoder replay's, just
    before it builds its measured engine); 0 on the CPU, where the
    wrappers run the plain versions."""
    from .kernels import _build
    from .kernels import flash_attention as fa
    from .kernels import paged_attention as pa
    return {"probe": _build.probe.launches,
            "probe_minor64": fa.probe_minor64.launches,
            "paged_decode": pa.paged_decode.launches,
            "flash_fwd": fa.flash_fwd.launches}


def _reset_launch_counts():
    """Set every wrapper's launch count that ``_launch_counts`` reads to
    0, so that a report counts its measured run alone."""
    from .kernels import _build
    from .kernels import flash_attention as fa
    from .kernels import paged_attention as pa
    for fn in (_build.probe, fa.probe_minor64, pa.paged_decode,
               fa.flash_fwd):
        fn.launches = 0


def _deltas(before, after, prefixes):
    return {k: int(after.get(k, 0)) - int(before.get(k, 0))
            for k in after
            if k.startswith(prefixes)
            and k != "serving.multi_tick.ticks_per_dispatch"
            and int(after.get(k, 0)) - int(before.get(k, 0))}


def build_model(args, max_ctx, device, weights=None):
    """(target, draft or None) as the JAX tool builds them. ``weights``
    (a hook for tests that carry another package's weights across) is
    called as ``weights(role, config)`` with role "target" or "draft" and
    returns a state dict for the port's model, or None for weights drawn
    from ``--seed``."""
    from .text.models import LlamaConfig, LlamaForCausalLM
    if args.model == "ernie_moe":
        from .text.models.ernie_moe import (ErnieMoEConfig,
                                            ErnieMoEForCausalLM)
        cfg = ErnieMoEConfig.tiny(vocab=args.vocab, hidden=args.hidden,
                                  layers=args.layers, heads=args.heads,
                                  experts=args.experts)
        cfg.top_k = args.top_k
        cfg.moe_every = args.moe_every
        model_cls = ErnieMoEForCausalLM
    else:
        cfg = LlamaConfig.tiny(vocab=args.vocab, hidden=args.hidden,
                               layers=args.layers, heads=args.heads)
        model_cls = LlamaForCausalLM
    cfg.max_position_embeddings = max(cfg.max_position_embeddings,
                                      max_ctx + max(args.spec_k, 0) + 1)
    cfg.use_flash_attention = False

    def make(cls, c, role, seed):
        state = weights(role, c) if weights is not None else None
        net = cls(c, device=device, seed=seed)
        if state is not None:
            net.load_state_dict(state)
        net.eval()
        return net

    net = make(model_cls, cfg, "target", args.seed)
    draft = None
    if args.spec_k > 0:
        dcfg = LlamaConfig.tiny(vocab=args.vocab, hidden=args.hidden,
                                layers=args.draft_layers, heads=args.heads)
        dcfg.max_position_embeddings = cfg.max_position_embeddings
        dcfg.use_flash_attention = False
        draft = make(LlamaForCausalLM, dcfg, "draft", args.seed + 1)
    return net, draft


def build_encoder(args, max_seq, device, weights=None):
    """The ``--embedding`` BERT; ``weights`` as in ``build_model`` (role
    "encoder")."""
    from .text.models import BertConfig, BertModel
    cfg = BertConfig.tiny(vocab=args.vocab, hidden=args.hidden,
                          layers=args.layers, heads=args.heads)
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, max_seq)
    net = BertModel(cfg, device=device, seed=args.seed)
    state = weights("encoder", cfg) if weights is not None else None
    if state is not None:
        net.load_state_dict(state)
    net.eval()
    return net


def _run_embedding(args, trace, weights) -> int:
    """--embedding: the BatchEncoder service on the virtual clock, which
    advances --step-ms per service step plus --prefill-token-ms per real
    token the step encoded."""
    from . import monitor
    from .inference import BatchEncoder, EmbedParams

    bad_pool = [(i, r["pooling"]) for i, r in enumerate(trace)
                if r.get("pooling") not in (None, "mean", "cls")]
    if bad_pool:
        print(f"serving_replay: bad pooling value(s) {bad_pool[:5]} "
              f"(want \"mean\" or \"cls\")", file=sys.stderr)
        return 2
    max_seq = max(int(r["seq_len"]) for r in trace)
    net = build_encoder(args, max_seq, args.device, weights)
    vt_box = {"vt": 0.0}
    svc = BatchEncoder(net, max_batch=args.max_batch, bucket=args.bucket,
                       clock=lambda: vt_box["vt"] / 1e3, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, args.vocab, (int(r["seq_len"]),))
               .astype(np.int64) for r in trace]

    before = monitor.snapshot()
    tok_key = "serving.embed.tokens"
    tok_before = int(before.get(tok_key, 0))
    finished = {}
    i = steps = 0
    t0 = time.perf_counter()
    while len(finished) < len(trace):
        vt = vt_box["vt"]
        while i < len(trace) and trace[i]["arrival_ms"] <= vt:
            r = trace[i]
            # arrival is stamped at the trace's time, so queue wait
            # behind a long step shows in the latencies
            vt_box["vt"] = float(r["arrival_ms"])
            svc.add_request(
                prompts[i],
                EmbedParams(pooling=r.get("pooling", "mean"),
                            deadline_ms=r.get("deadline_ms"),
                            max_queue_steps=r.get("max_queue_steps")),
                tenant=str(r.get("tenant", "default")))
            vt_box["vt"] = vt
            i += 1
        if i < len(trace) and svc.idle:
            vt_box["vt"] = max(vt, float(trace[i]["arrival_ms"]))
            continue
        for out in svc.step():
            finished[out.req_id] = out
        steps += 1
        tok_now = int(monitor.counter(tok_key).get())
        vt_box["vt"] += args.step_ms \
            + (tok_now - tok_before) * args.prefill_token_ms
        tok_before = tok_now
        if steps > 100_000:
            print("serving_replay: embedding service did not drain",
                  file=sys.stderr)
            return 3
    wall_s = time.perf_counter() - t0
    deltas = _deltas(before, monitor.snapshot(), EMBED_COUNTER_PREFIXES)
    failures = {}
    total_tokens = 0
    lats = []
    for out in finished.values():
        if out.ok:
            total_tokens += out.tokens
            lats.append(out.latency_ms)
        else:
            failures[out.finish_reason] = \
                failures.get(out.finish_reason, 0) + 1
    n_batches = deltas.get("serving.embed.batches", 0)
    real = deltas.get("serving.embed.tokens", 0)
    pad = deltas.get("serving.embed.pad_tokens", 0)
    report = {
        "mode": "embedding",
        "device": str(args.device),
        "requests": len(trace),
        "steps": steps,
        "batches": n_batches,
        "total_tokens": total_tokens,
        "wall_s": round(wall_s, 3),
        "tokens_per_sec": round(total_tokens / max(wall_s, 1e-9), 1),
        "failed": failures,
        "latency_ms": _percentiles(lats),
        "batch_fill": round(len(lats) / max(n_batches * args.max_batch, 1),
                            4),
        "pad_ratio": round(pad / max(real + pad, 1), 4),
        "counters": deltas,
        "launches": _launch_counts(),
    }
    if args.json:
        print(json.dumps(report))
    else:
        print(f"embedded {report['requests']} requests / "
              f"{report['total_tokens']} tokens in {report['steps']} "
              f"steps / {report['batches']} batches "
              f"({report['wall_s']}s wall) — "
              f"{report['tokens_per_sec']} tokens_per_sec")
        ps = report["latency_ms"]
        print(f"  latency_ms p50 {ps['p50']:8.2f}  "
              f"p90 {ps['p90']:8.2f}  p99 {ps['p99']:8.2f}   "
              f"(virtual clock)")
        print(f"  batch_fill {report['batch_fill']}  "
              f"pad_ratio {report['pad_ratio']}")
        if failures:
            print("  failed: " + "  ".join(
                f"{k} x{v}" for k, v in sorted(failures.items())))
        for k in sorted(report["counters"]):
            print(f"  {k} +{report['counters'][k]}")
    return 0


def _parser():
    ap = argparse.ArgumentParser(prog="serving_replay", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="JSONL arrival trace")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda, or cpu for the "
                         "kernels' plain versions)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=64)
    ap.add_argument("--prefill-bucket", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-ms", type=float, default=5.0,
                    help="virtual clock advance per engine step")
    ap.add_argument("--prefill-token-ms", type=float, default=0.1,
                    help="virtual clock advance per prefill token a step "
                         "ran (cached prefixes skip these)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cache-dtype", default="auto")
    ap.add_argument("--model", default="llama",
                    choices=("llama", "ernie_moe"))
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--moe-every", type=int, default=2)
    ap.add_argument("--expect-moe-pallas", action="store_true",
                    help="exit 10 unless every MoE decode step ran the "
                         "grouped-FFN CUDA kernels (--model ernie_moe, "
                         "cuda only)")
    ap.add_argument("--embedding", action="store_true",
                    help="replay an embedding trace against BatchEncoder "
                         "over a BERT")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--bucket", type=int, default=16)
    ap.add_argument("--multi-tick", type=int, default=1, metavar="K",
                    help="fuse up to K greedy decode ticks a step")
    ap.add_argument("--expect-host-share", type=float, default=None,
                    metavar="PCT",
                    help="exit 14 when host time exceeds PCT percent of "
                         "host + device tick time (wall clock)")
    ap.add_argument("--max-prefill-tokens", type=int, default=None,
                    help="chunked prefill: prompt tokens a step at most")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: k draft tokens a tick")
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--json", action="store_true",
                    help="print one JSON report line")
    ap.add_argument("--expect-pallas", action="store_true",
                    help="exit 4 unless every decode tick ran the CUDA "
                         "split-K paged-decode kernel (cuda only)")
    ap.add_argument("--expect-prefix-hit-rate", type=float, default=None,
                    metavar="RATE")
    ap.add_argument("--expect-p99-ttft-ms", type=float, default=None,
                    metavar="MS")
    ap.add_argument("--ttft-tag", default=None, metavar="TAG")
    ap.add_argument("--chaos", action="store_true",
                    help="drive the trace clean, then under a seeded "
                         "FaultInjector; exit 6 on a diverged survivor, "
                         "a leaked page or an invariant finding")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-rate", type=float, default=0.05)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the per-request span timelines as "
                         "chrome-trace JSON (tools/trace_summary.py "
                         "reads it)")
    ap.add_argument("--expect-complete-timelines", action="store_true",
                    help="exit 12 unless every request stitches into one "
                         "contiguous timeline in the export")
    ap.add_argument("--disagg", action="store_true",
                    help="serve with the disaggregated engine: prefill "
                         "and decode workers, KV pages migrating")
    ap.add_argument("--prefill-workers", type=int, default=1)
    ap.add_argument("--decode-workers", type=int, default=1)
    ap.add_argument("--kill-worker", action="append", default=[],
                    metavar="KIND:INDEX:STEP",
                    help="worker death under --disagg (e.g. decode:1:40), "
                         "after a clean reference run; exit 8 on a "
                         "diverged survivor, a leak or a finding")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve with the fleet of this many Engine "
                         "replicas behind the router")
    ap.add_argument("--route", default=None,
                    choices=("session", "least_loaded", "round_robin"),
                    help="the fleet's router under --replicas (default "
                         "session)")
    ap.add_argument("--kill-replica", action="append", default=[],
                    metavar="INDEX:STEP",
                    help="replica death under --replicas (e.g. 1:40), "
                         "after a clean reference run; exit 9 on a "
                         "diverged survivor, a leak or a finding")
    # the JAX tool's flags for modules not ported yet: parsed so that
    # each is refused by name, never ignored
    ap.add_argument("--expect-hotpath-clean", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--expect-zero-recompiles", action="store_true",
                    help=argparse.SUPPRESS)
    return ap


def _load_trace(path):
    trace = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if ln:
                trace.append(json.loads(ln))
    trace.sort(key=lambda r: r["arrival_ms"])
    return trace


def _prompts(args, trace):
    """The JAX tool's prompt draws, in its order: the shared system block
    (only when a line uses it), then one block per session, then each
    request's tail."""
    rng = np.random.default_rng(args.seed)
    max_sys = max((r.get("system_len", 0) for r in trace), default=0)
    system = (rng.integers(0, args.vocab, (max_sys,)) if max_sys
              else np.zeros((0,), np.int64))
    session_blocks = {}
    for r in trace:
        name = r.get("session")
        if name is not None and name not in session_blocks:
            depth = max(int(x.get("system_len", 0)) for x in trace
                        if x.get("session") == name)
            session_blocks[name] = rng.integers(0, args.vocab, (depth,))
    prompts = []
    for r in trace:
        sl = min(int(r.get("system_len", 0)), int(r["prompt_len"]))
        head = (session_blocks[r["session"]] if r.get("session")
                is not None else system)
        tail = rng.integers(0, args.vocab, (r["prompt_len"] - sl,))
        prompts.append(np.concatenate([head[:sl], tail]).astype(np.int64))
    return prompts


def main(argv=None, weights=None) -> int:
    args = _parser().parse_args(argv)
    refused = [(flag, why) for flag, dest, why in UNPORTED
               if getattr(args, dest) not in (None, False, 0, [])]
    if refused:
        print("serving_replay: " + "; ".join(
            f"{flag} needs {why}, not ported yet" for flag, why in refused)
            + " (tools/serving_replay.py runs it on the JAX package)",
            file=sys.stderr)
        return 2
    cuda = str(args.device).startswith("cuda")
    if (args.expect_pallas or args.expect_moe_pallas) and not cuda:
        print(f"serving_replay: --expect-pallas / --expect-moe-pallas "
              f"assert the CUDA kernel routes; --device {args.device} "
              f"runs their plain versions", file=sys.stderr)
        return 2
    if not os.path.exists(args.trace):
        print(f"serving_replay: no such trace: {args.trace}",
              file=sys.stderr)
        return 2
    trace = _load_trace(args.trace)
    if not trace:
        print("serving_replay: empty trace", file=sys.stderr)
        return 2
    if args.embedding:
        bad = [flag for flag, on in (
            ("--disagg", args.disagg),
            ("--replicas", bool(args.replicas)),
            ("--chaos", args.chaos),
            ("--kill-worker", bool(args.kill_worker)),
            ("--kill-replica", bool(args.kill_replica)),
            ("--spec-k", args.spec_k > 0),
            ("--max-prefill-tokens", args.max_prefill_tokens is not None),
            ("--no-prefix-cache", args.no_prefix_cache),
            ("--expect-pallas", args.expect_pallas),
            ("--expect-moe-pallas", args.expect_moe_pallas),
            ("--expect-prefix-hit-rate",
             args.expect_prefix_hit_rate is not None),
            ("--expect-p99-ttft-ms", args.expect_p99_ttft_ms is not None),
            ("--multi-tick", args.multi_tick != 1),
            ("--expect-host-share", args.expect_host_share is not None),
            ("--model ernie_moe", args.model == "ernie_moe"),
            ("--trace-out", args.trace_out is not None),
            ("--expect-complete-timelines",
             args.expect_complete_timelines)) if on]
        if bad:
            print(f"serving_replay: {', '.join(bad)} make(s) no sense "
                  f"under --embedding (the BatchEncoder service has no KV "
                  f"decode surface)", file=sys.stderr)
            return 2
        missing = [i for i, r in enumerate(trace) if "seq_len" not in r]
        if missing:
            print(f"serving_replay: --embedding trace line(s) "
                  f"{missing[:5]} lack \"seq_len\" (is this a decoder "
                  f"trace?)", file=sys.stderr)
            return 2
        return _run_embedding(args, trace, weights)
    if args.expect_moe_pallas and args.model != "ernie_moe":
        print("serving_replay: --expect-moe-pallas needs --model ernie_moe "
              "(a dense replay has no MoE dispatch to gate)",
              file=sys.stderr)
        return 2
    return _run_decoder(args, trace, weights)


def _kills(args):
    """The scheduled worker / replica deaths as (kind, index, step), or an
    exit code: the JAX tool's misuse checks, in its order (2 for each)."""
    kills = []
    for spec in args.kill_worker:
        try:
            kind, idx, step = spec.split(":")
            if kind not in ("prefill", "decode"):
                raise ValueError(kind)
            kills.append((kind, int(idx), int(step)))
        except ValueError:
            print(f"serving_replay: bad --kill-worker spec {spec!r} (want "
                  f"KIND:INDEX:STEP, e.g. decode:1:40)", file=sys.stderr)
            return 2
    if kills and not args.disagg:
        print("serving_replay: --kill-worker needs --disagg",
              file=sys.stderr)
        return 2
    for spec in args.kill_replica:
        try:
            idx, step = spec.split(":")
            kills.append(("replica", int(idx), int(step)))
        except ValueError:
            print(f"serving_replay: bad --kill-replica spec {spec!r} (want "
                  f"INDEX:STEP, e.g. 1:40)", file=sys.stderr)
            return 2
    if args.kill_replica and not args.replicas:
        print("serving_replay: --kill-replica needs --replicas",
              file=sys.stderr)
        return 2
    if args.route is not None and not args.replicas:
        print("serving_replay: --route needs --replicas (without it the "
              "replay drives the single-loop engine and the routing policy "
              "would be silently ignored)", file=sys.stderr)
        return 2
    if args.route is None:
        args.route = "session"
    if args.replicas and args.disagg:
        print("serving_replay: --replicas and --disagg are exclusive (the "
              "fleet multiplexes whole engines; disagg splits one engine "
              "into prefill/decode workers)", file=sys.stderr)
        return 2
    fleets = [("replica", args.replicas)] if args.replicas else []
    if not args.disagg and (args.prefill_workers != 1
                            or args.decode_workers != 1):
        print("serving_replay: --prefill-workers/--decode-workers need "
              "--disagg (without it the replay drives the single-loop "
              "engine and the worker counts would be silently ignored)",
              file=sys.stderr)
        return 2
    fleets += [("prefill", args.prefill_workers),
               ("decode", args.decode_workers)]
    for kind, n in fleets:
        idxs = {i for k, i, _ in kills if k == kind}
        bad = sorted(i for i in idxs if not 0 <= i < n)
        flag = "--kill-replica" if kind == "replica" else "--kill-worker"
        what = "" if kind == "replica" else f" {kind}"
        if bad:
            print(f"serving_replay: {flag}{what} index(es) {bad} out of "
                  f"range (fleet size {n})", file=sys.stderr)
            return 2
        if idxs and len(idxs) >= n:
            print(f"serving_replay: {flag} would kill every {kind} "
                  f"({sorted(idxs)} of {n}): the fleet must keep serving; "
                  f"leave at least one alive", file=sys.stderr)
            return 2
    return kills


def _run_decoder(args, trace, weights) -> int:
    from . import monitor
    from .inference import (DisaggEngine, Engine, FaultInjector,
                            SamplingParams, ServingFleet, tracing)
    from .inference.reliability import FAULT_SITES

    kills = _kills(args)
    if isinstance(kills, int):
        return kills
    max_ctx = max(r["prompt_len"] + r["new_tokens"] for r in trace)
    net, draft = build_model(args, max_ctx, args.device, weights)
    vt_box = {"vt": 0.0}

    def make_engine(injector=False):
        kw = dict(page_size=args.page_size,
                  prefill_bucket=args.prefill_bucket,
                  cache_dtype=args.cache_dtype, max_context=max_ctx,
                  prefix_cache=not args.no_prefix_cache,
                  draft_model=draft, spec_k=max(args.spec_k, 1),
                  clock=lambda: vt_box["vt"] / 1e3,
                  fault_injector=injector,
                  max_prefill_tokens_per_step=args.max_prefill_tokens,
                  multi_tick=args.multi_tick, device=args.device)
        if args.disagg:
            return DisaggEngine(net, prefill_workers=args.prefill_workers,
                                decode_workers=args.decode_workers,
                                max_slots=args.max_slots,
                                pool_pages=args.pool_pages, **kw)
        if args.replicas:
            return ServingFleet(net, replicas=args.replicas,
                                max_slots=args.max_slots,
                                pool_pages=args.pool_pages,
                                router=args.route, **kw)
        return Engine(net, max_slots=args.max_slots,
                      pool_pages=args.pool_pages, **kw)

    prompts = _prompts(args, trace)
    driver = bool(args.disagg or args.replicas)

    def drive(eng, kills=()):
        """One full replay on the virtual clock; None when the engine did
        not drain. ``kills`` are (kind, index, step) deaths fired as the
        step count passes them."""
        before = monitor.snapshot()
        vt_box["vt"] = 0.0
        arrival_vt, first_vt, finish, tags = {}, {}, {}, {}
        pending = sorted(kills, key=lambda k: k[2])
        i = steps = 0
        t0 = time.perf_counter()
        pf_key = "serving.prefill_tokens"
        pf_before = int(before.get(pf_key, 0))
        while len(finish) < len(trace):
            vt = vt_box["vt"]
            while i < len(trace) and trace[i]["arrival_ms"] <= vt:
                r = trace[i]
                rid = eng.add_request(
                    prompts[i],
                    SamplingParams(
                        max_new_tokens=r["new_tokens"],
                        temperature=args.temperature, seed=args.seed + i,
                        deadline_ms=r.get("deadline_ms"),
                        max_queue_steps=r.get("max_queue_steps")),
                    **({"tenant": str(r["tenant"])}
                       if driver and r.get("tenant") else {}))
                arrival_vt[rid] = r["arrival_ms"]
                if r.get("tag"):
                    tags[rid] = str(r["tag"])
                i += 1
            while pending and steps >= pending[0][2]:
                kind, idx, _ = pending.pop(0)
                n = (eng.kill_replica(idx) if kind == "replica"
                     else eng.kill_worker(kind, idx))
                print(f"serving_replay: killed {kind}{idx} at step {steps} "
                      f"({n} request(s) re-admitted)", file=sys.stderr)
            if i < len(trace) and eng.idle:
                # idle gap: fast-forward to the next arrival
                vt_box["vt"] = max(vt, float(trace[i]["arrival_ms"]))
                continue
            outs = eng.step()
            steps += 1
            pf_now = int(monitor.counter(pf_key).get())
            vt_box["vt"] += args.step_ms \
                + (pf_now - pf_before) * args.prefill_token_ms
            pf_before = pf_now
            vt = vt_box["vt"]
            for out in outs:
                finish[out.req_id] = (out, vt)
                if out.token_ids:
                    first_vt.setdefault(out.req_id, vt)
            for rid, req in eng.requests.items():
                if rid not in first_vt and req.generated:
                    first_vt[rid] = vt
            if steps > 100_000:
                return None
        return {"finish": finish, "first_vt": first_vt,
                "arrival_vt": arrival_vt, "tags": tags, "steps": steps,
                "wall_s": time.perf_counter() - t0, "before": before,
                "after": monitor.snapshot(), "unfired_kills": pending}

    baseline = None
    # False: injection forced off (the clean contract even when the
    # process is flag-armed); only --chaos builds an injector, so a kill
    # run diverges from its baseline through the kill alone
    injector = False
    if args.chaos or kills:
        clean = make_engine()
        baseline = drive(clean)
        if baseline is None:
            print("serving_replay: clean engine did not drain",
                  file=sys.stderr)
            return 3
        clean.close()
        del clean
    if args.chaos:
        # with scheduled kills the injector's own death sites stay off: a
        # chaos kill first would make a scheduled one hit the last worker
        sites = (tuple(x for x in FAULT_SITES
                       if not x.startswith(("worker.", "replica.")))
                 if kills else None)
        injector = FaultInjector(seed=args.fault_seed, rate=args.fault_rate,
                                 sites=sites)
    # a fresh registry and launch counts for the measured run: the
    # histograms cannot be subtracted, so the baseline run must not leak
    # into them, and the report's launches are the measured run's own
    monitor.reset()
    _reset_launch_counts()
    eng = make_engine(injector)
    run = drive(eng, kills)
    if run is None:
        print("serving_replay: engine did not drain", file=sys.stderr)
        return 3
    if run["unfired_kills"]:
        # a kill past the drain point never fired: the failover gate
        # would pass vacuously
        print(f"serving_replay: --kill-worker never fired for "
              f"{[f'{k}:{i}:{st}' for k, i, st in run['unfired_kills']]}: "
              f"the trace drained in {run['steps']} step(s); schedule the "
              f"kill earlier", file=sys.stderr)
        return 2
    finish, first_vt, tags = run["finish"], run["first_vt"], run["tags"]
    arrival_vt = run["arrival_vt"]
    ttft = [first_vt[r] - arrival_vt[r] for r in sorted(first_vt)]
    ttft_by_tag = {}
    for r in sorted(first_vt):
        if r in tags:
            ttft_by_tag.setdefault(tags[r], []).append(
                first_vt[r] - arrival_vt[r])
    tpot, failures = [], {}
    total_tokens = preempts = 0
    for rid, (out, end_vt) in sorted(finish.items()):
        n = len(out.token_ids)
        total_tokens += n
        preempts += out.preemptions
        if not out.ok:
            failures[out.finish_reason] = \
                failures.get(out.finish_reason, 0) + 1
        if n > 1 and rid in first_vt:
            tpot.append((end_vt - first_vt[rid]) / (n - 1))
    deltas = _deltas(run["before"], run["after"], COUNTER_PREFIXES)
    decode_paths = {name: deltas.get(key, 0)
                    for name, key in PATH_NAMES.items()}
    hists = monitor.histograms()
    hh = hists.get("serving.hist.host_ms_per_tick", {})
    dh = hists.get("serving.hist.device_ms_per_tick", {})
    oh = hists.get("serving.hist.overlap_ms_per_tick", {})
    host_sum = hh.get("mean", 0.0) * hh.get("count", 0)
    dev_sum = dh.get("mean", 0.0) * dh.get("count", 0)
    host_share = (host_sum / (host_sum + dev_sum)
                  if host_sum + dev_sum > 0 else 0.0)
    fused_d = deltas.get("serving.multi_tick.dispatches", 0)
    fused_t = deltas.get("serving.multi_tick.ticks", 0)

    def tick(name, h):
        return {"last": monitor.gauge(name).get(), "mean": h.get("mean", 0.0)}

    report = {
        "device": str(args.device),
        "requests": len(trace),
        "steps": run["steps"],
        "total_tokens": total_tokens,
        "wall_s": round(run["wall_s"], 3),
        "tokens_per_sec": round(total_tokens / max(run["wall_s"], 1e-9), 1),
        "preemptions": preempts,
        "failed": failures,
        "ttft_ms": _percentiles(ttft),
        "ttft_ms_by_tag": {t: _percentiles(v)
                           for t, v in sorted(ttft_by_tag.items())},
        "tpot_ms": _percentiles(tpot),
        "prefix_hit_rate": round(eng.prefix_hit_rate, 4),
        "spec_accept_rate": round(eng.spec_accept_rate, 4),
        "decode_paths": decode_paths,
        "counters": deltas,
        "launches": _launch_counts(),
        "histograms": {k: v for k, v in hists.items()
                       if k.startswith("serving.hist.")},
        "host_device": {
            "host_ms_per_tick": tick("serving.host_ms_per_tick", hh),
            "device_ms_per_tick": tick("serving.device_ms_per_tick", dh),
            "overlap_ms_per_tick": tick("serving.overlap_ms_per_tick", oh),
            "host_share": round(host_share, 4),
            "multi_tick": {
                "k": int(args.multi_tick),
                "fused_dispatches": fused_d,
                "fused_ticks": fused_t,
                "ticks_per_dispatch": round(fused_t / fused_d, 2)
                if fused_d else 1.0,
            },
        },
        # every request's token stream, in request order
        "tokens": {str(rid): list(map(int, out.token_ids))
                   for rid, (out, _) in sorted(finish.items())},
    }
    timelines = {rid: out.spans for rid, (out, _) in finish.items()
                 if getattr(out, "spans", None)}
    moe_paths = {}
    if args.model == "ernie_moe":
        if driver:
            # the drivers' workers republish their MoE paths into the
            # serving.moe.decode_path.* counters
            pfx = "serving.moe.decode_path."
            moe_paths = {k[len(pfx):]: v for k, v in deltas.items()
                         if k.startswith(pfx)}
        else:
            moe_paths = eng.moe_decode_path()
        report["moe"] = {
            "experts": args.experts, "top_k": args.top_k,
            "pallas_eligible": getattr(eng, "moe_pallas_eligible", None),
            "fallback_reason": getattr(eng, "moe_fallback_reason", None),
            "decode_paths": moe_paths,
        }
    if args.replicas:
        report["fleet"] = {
            "replicas": args.replicas,
            "route": args.route,
            "routed_warm": deltas.get("serving.fleet.routed_warm", 0),
            "routed_cold": deltas.get("serving.fleet.routed_cold", 0),
            "migrations": deltas.get("serving.fleet.migrations", 0),
            "replica_deaths": deltas.get("serving.fleet.replica_deaths", 0),
            "readmitted": deltas.get("serving.fleet.readmitted", 0),
            "scale_events": deltas.get("serving.fleet.scale_events", 0),
            "replica_kills": [f"{i}:{st}" for k, i, st in kills
                              if k == "replica"],
            "replicas_table": eng.utilization(),
            # each replica's own labeled TTFT histogram
            "ttft_by_replica": {
                k.split(".")[1]: v for k, v in sorted(hists.items())
                if k.startswith("serving.replica")
                and k.endswith(".hist.ttft_ms")},
        }
    if args.disagg:
        after, before = run["after"], run["before"]

        def cdelta(key):
            return int(after.get(key, 0)) - int(before.get(key, 0))
        report["disagg"] = {
            "prefill_workers": args.prefill_workers,
            "decode_workers": args.decode_workers,
            "migrations": cdelta("serving.disagg.migrations"),
            "migrated_pages": cdelta("serving.migrated_pages"),
            "worker_kills": [f"{k}:{i}:{st}" for k, i, st in kills],
            "readmitted": cdelta("serving.disagg.readmitted"),
            "workers": eng.utilization(),
        }
    findings = eng.check_invariants()
    # after the audit: counting leaks releases the prefix cache's pages
    report["leaked_pages"] = leaked = eng.leaked_pages()

    def diverged():
        out = []
        for rid, (o, _) in sorted(finish.items()):
            ref_out, _ = baseline["finish"][rid]
            if o.ok and ref_out.ok and o.token_ids != ref_out.token_ids:
                out.append(rid)
        return out

    kill_failed = False
    if kills:
        # a death may slow requests, never change a survivor's tokens,
        # leak a page or leave the audit dirty
        mismatched = diverged()
        report["replica_kill" if args.replicas else "worker_kill"] = {
            "kills": [f"{k}:{i}:{st}" for k, i, st in kills],
            "survivors_exact": not mismatched,
            "mismatched_request_ids": mismatched,
            "leaked_pages": leaked,
            "invariant_findings": findings,
        }
        kill_failed = bool(mismatched or leaked or findings)
    chaos_failed = False
    if args.chaos:
        mismatched = diverged()
        report["chaos"] = {
            "fault_seed": args.fault_seed,
            "fault_rate": args.fault_rate,
            "injected": dict(sorted(injector.counts.items())),
            "total_injected": injector.total_injected,
            "survivors": sum(1 for out, _ in finish.values() if out.ok),
            "survivors_exact": not mismatched,
            "mismatched_request_ids": mismatched,
            "leaked_pages": leaked,
            "invariant_findings": findings,
        }
        chaos_failed = bool(mismatched or leaked or findings)
    if args.json:
        print(json.dumps(report))
    else:
        _print_report(report, args)
    if args.trace_out:
        tracing.export_serving_trace(timelines, args.trace_out)
        print(f"serving_replay: wrote {len(timelines)} timeline(s) to "
              f"{args.trace_out}", file=sys.stderr)
    return _gates(args, report, eng, finish, ttft, ttft_by_tag, tags,
                  timelines, chaos_failed, kill_failed, trace, decode_paths,
                  moe_paths)


def _gates(args, report, eng, finish, ttft, ttft_by_tag, tags, timelines,
           chaos_failed, kill_failed, trace, decode_paths, moe_paths) -> int:
    """The JAX tool's gates, in its order, with its exit codes."""
    from .inference import tracing
    if args.expect_pallas and (
            decode_paths["cuda_split"] == 0
            or any(v for k, v in decode_paths.items()
                   if k not in ("cuda_split", "prefill_gather"))):
        print(f"serving_replay: --expect-pallas FAILED — decode paths "
              f"{decode_paths}; every decode tick must launch "
              f"kernels.decode.paged_cuda_split", file=sys.stderr)
        return 4
    if args.expect_moe_pallas and (
            moe_paths.get("pallas", 0) == 0
            or any(k.startswith("fallback.") and v
                   for k, v in moe_paths.items())):
        print(f"serving_replay: --expect-moe-pallas FAILED — moe dispatch "
              f"paths {moe_paths} ({eng.moe_fallback_reason}); every MoE "
              f"decode step must run the grouped-FFN kernels",
              file=sys.stderr)
        return 10
    if args.expect_prefix_hit_rate is not None and \
            report["prefix_hit_rate"] < args.expect_prefix_hit_rate:
        why = ("prefix cache DISABLED" if args.no_prefix_cache
               else "shared prefixes are not being reused")
        print(f"serving_replay: --expect-prefix-hit-rate FAILED — "
              f"{report['prefix_hit_rate']} < {args.expect_prefix_hit_rate}"
              f" ({why})", file=sys.stderr)
        return 5
    if args.expect_p99_ttft_ms is not None:
        if args.ttft_tag is not None:
            gated = report["ttft_ms_by_tag"].get(args.ttft_tag)
            n_tagged = sum(1 for t in tags.values() if t == args.ttft_tag)
            n_first = len(ttft_by_tag.get(args.ttft_tag, []))
            scope = f"tag {args.ttft_tag!r}"
        else:
            gated, n_tagged, n_first = report["ttft_ms"], len(trace), \
                len(ttft)
            scope = "all requests"
        if args.ttft_tag is not None and n_tagged == 0:
            print(f"serving_replay: --expect-p99-ttft-ms FAILED — no trace "
                  f"request carries \"tag\": {args.ttft_tag!r}",
                  file=sys.stderr)
            return 7
        p99 = gated["p99"] if gated else float("inf")
        if gated is None or n_first < n_tagged \
                or p99 > args.expect_p99_ttft_ms:
            print(f"serving_replay: --expect-p99-ttft-ms FAILED — {scope}: "
                  f"p99 {p99} > {args.expect_p99_ttft_ms} or first tokens "
                  f"missing ({n_first}/{n_tagged})", file=sys.stderr)
            return 7
    if chaos_failed:
        ch = report["chaos"]
        print(f"serving_replay: --chaos FAILED — mismatched survivors "
              f"{ch['mismatched_request_ids']}, leaked_pages "
              f"{ch['leaked_pages']}, invariant findings "
              f"{ch['invariant_findings']} (seed {args.fault_seed} replays "
              f"this schedule)", file=sys.stderr)
        return 6
    if kill_failed:
        flag = "--kill-replica" if args.replicas else "--kill-worker"
        wk = report["replica_kill" if args.replicas else "worker_kill"]
        print(f"serving_replay: {flag} FAILED — mismatched survivors "
              f"{wk['mismatched_request_ids']}, leaked_pages "
              f"{wk['leaked_pages']}, invariant findings "
              f"{wk['invariant_findings']}: a "
              f"{'replica' if args.replicas else 'worker'} death may slow "
              f"requests, never change a survivor's tokens",
              file=sys.stderr)
        return 9 if args.replicas else 8
    if args.expect_complete_timelines:
        # checked on the stitched export, the artifact --trace-out writes
        rebuilt = tracing.timelines_from_trace(
            tracing.build_serving_trace(timelines))
        problems = {}
        for rid, (out, _) in sorted(finish.items()):
            spans = rebuilt.get(rid)
            if not spans:
                problems[rid] = ["no timeline in the stitched export"]
                continue
            ps = tracing.validate_timeline(spans, tol_ms=0.01)
            want = "FINISHED" if out.ok else "FAILED"
            if spans[-1].get("phase") != want:
                ps = ps + [f"request {'finished' if out.ok else 'failed'} "
                           f"but timeline ends {spans[-1].get('phase')!r}"]
            if ps:
                problems[rid] = ps
        if problems:
            shown = {r: problems[r] for r in sorted(problems)[:5]}
            print(f"serving_replay: --expect-complete-timelines FAILED — "
                  f"{len(problems)}/{len(finish)} request(s) with broken "
                  f"timelines, e.g. {shown}", file=sys.stderr)
            return 12
    if args.expect_host_share is not None:
        hd = report["host_device"]
        if hd["host_share"] * 100.0 > args.expect_host_share:
            print(f"serving_replay: --expect-host-share FAILED — host share "
                  f"{hd['host_share'] * 100.0:.2f}% of (host+device) tick "
                  f"time exceeds the {args.expect_host_share:.2f}% budget",
                  file=sys.stderr)
            return 14
    return 0


def _print_report(report, args):
    print(f"replayed {report['requests']} requests / "
          f"{report['total_tokens']} tokens in {report['steps']} steps "
          f"({report['wall_s']}s wall, {report['device']}) — "
          f"{report['tokens_per_sec']} tokens_per_sec")
    for name in ("ttft_ms", "tpot_ms"):
        ps = report[name]
        print(f"  {name:8s} p50 {ps['p50']:8.2f}  p90 {ps['p90']:8.2f}  "
              f"p99 {ps['p99']:8.2f}   (virtual clock)")
    for tag, ps in report["ttft_ms_by_tag"].items():
        print(f"  ttft[{tag}] p50 {ps['p50']:8.2f}  p90 {ps['p90']:8.2f}  "
              f"p99 {ps['p99']:8.2f}")
    hd = report["host_device"]
    print(f"  host_ms_per_tick {hd['host_ms_per_tick']['mean']:.3f}  "
          f"device_ms_per_tick {hd['device_ms_per_tick']['mean']:.3f}  "
          f"overlap_ms_per_tick {hd['overlap_ms_per_tick']['mean']:.3f}   "
          f"(wall clock, mean/tick)")
    print(f"  host_share {hd['host_share']:.4f}  ticks_per_dispatch "
          f"{hd['multi_tick']['ticks_per_dispatch']:.2f}  "
          f"(k={hd['multi_tick']['k']}, "
          f"{hd['multi_tick']['fused_dispatches']} fused dispatches)")
    for name, st in report["histograms"].items():
        print(f"  {name:32s} n {st['count']:5d}  p50 {st['p50']:8.2f}  "
              f"p90 {st['p90']:8.2f}  p99 {st['p99']:8.2f}")
    print(f"  preemptions {report['preemptions']}")
    if report["failed"]:
        print("  failed: " + "  ".join(
            f"{k} x{v}" for k, v in sorted(report["failed"].items())))
    print(f"  prefix_hit_rate {report['prefix_hit_rate']}  "
          f"spec_accept_rate {report['spec_accept_rate']}")
    if "fleet" in report:
        fl = report["fleet"]
        print(f"  fleet: {fl['replicas']} replicas (route={fl['route']}), "
              f"routed warm/cold {fl['routed_warm']}/{fl['routed_cold']}, "
              f"{fl['migrations']} migrations, {fl['replica_deaths']} "
              f"deaths / {fl['readmitted']} re-admitted, "
              f"{fl['scale_events']} scale events")
        for name, st in sorted(fl["replicas_table"].items()):
            hr = st["prefix_hit_rate"]
            print(f"    {name:10s} util {st['utilization']:6.2%}  warm "
                  f"{st['routed_warm']:3d}  cold {st['routed_cold']:3d}  "
                  f"hit_rate {hr if hr is not None else '-':>6}  finished "
                  f"{st['finished']:3d}{'' if st['alive'] else '  [DEAD]'}")
    if "disagg" in report:
        dg = report["disagg"]
        print(f"  disagg: {dg['prefill_workers']}p+{dg['decode_workers']}d "
              f"workers, {dg['migrations']} migrations / "
              f"{dg['migrated_pages']} pages migrated, {dg['readmitted']} "
              f"re-admitted")
        for name, st in sorted(dg["workers"].items()):
            print(f"    {name:10s} util {st['utilization']:6.2%}  "
                  f"migrations {st['migrations']:3d}  pages_migrated "
                  f"{st['pages_migrated']:4d}"
                  f"{'' if st['alive'] else '  [DEAD]'}")
    for key in ("worker_kill", "replica_kill"):
        if key in report:
            wk = report[key]
            print(f"  kill: {', '.join(wk['kills'])} — exact="
                  f"{wk['survivors_exact']} leaked_pages="
                  f"{wk['leaked_pages']}")
    if args.chaos:
        ch = report["chaos"]
        print(f"  chaos: {ch['total_injected']} faults injected (seed "
              f"{ch['fault_seed']}), {ch['survivors']}/{report['requests']}"
              f" survivors, exact={ch['survivors_exact']}, "
              f"leaked_pages={ch['leaked_pages']}")
        for site, n in sorted(ch["injected"].items()):
            print(f"    {site} x{n}")
    print("  decode paths: " + "  ".join(
        f"{k} +{v}" for k, v in report["decode_paths"].items()))
    if "moe" in report:
        shown = "  ".join(f"{k} +{v}" for k, v in sorted(
            report["moe"]["decode_paths"].items())) or "(none)"
        print(f"  moe dispatch paths: {shown}")
    for k in sorted(report["counters"]):
        print(f"  {k} +{report['counters'][k]}")


if __name__ == "__main__":
    sys.exit(main())
