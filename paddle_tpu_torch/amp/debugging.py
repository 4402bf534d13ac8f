"""Numerical debugging (counterpart of ``paddle_tpu/amp/debugging.py``).

``check_numerics`` counts a tensor's NaN, Inf and zero elements;
``TensorCheckerConfig`` + ``enable_tensor_checker`` turn on the per-op
output scan of ``core/dispatch.py`` (``FLAGS_check_nan_inf``);
``collect_operator_stats`` counts the ops run per (op, output dtype) and
``dump_tensor_stats`` writes per-op output statistics that
``compare_accuracy`` aligns across two runs. Both ride on
``dispatch.OP_OBSERVERS``. A dump's lines are the JAX package's, so each
package's ``compare_accuracy`` reads the other's dumps.
"""
from __future__ import annotations

import contextlib
from enum import Enum

import torch

from ..core import flags
from ..core.dispatch import dtype_name, unwrap, wrap


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def enable_tensor_checker(config: TensorCheckerConfig):
    """Scan every op's floating outputs: CHECK_NAN_INF_AND_ABORT raises
    ``FloatingPointError`` naming the op, the other modes print."""
    flags.set_flags({
        "check_nan_inf": config.enable,
        "check_nan_inf_level":
            0 if config.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT else 1,
    })


def disable_tensor_checker():
    flags.set_flags({"check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """(num_nan, num_inf, num_zero) of ``tensor`` as int64 Tensors; raises
    FloatingPointError on a NaN or Inf unless ``debug_mode`` says print."""
    a = unwrap(tensor)
    counts = torch.stack([torch.isnan(a).sum(), torch.isinf(a).sum(),
                          (a == 0).sum()]).to(torch.int64)
    num_nan, num_inf, _ = counts.tolist()
    if num_nan or num_inf:
        msg = (f"[check_numerics] op={op_type} var={var_name}: "
               f"{num_nan} nan, {num_inf} inf")
        if debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT):
            raise FloatingPointError(msg)
        print("WARNING:", msg)
    return tuple(wrap(c) for c in counts.unbind())


_op_stats = {}


def _stats_observer(name, leaves):
    for a in leaves:
        key = (name, dtype_name(a.dtype))
        _op_stats[key] = _op_stats.get(key, 0) + 1


def enable_operator_stats_collection():
    """Start counting ops by (op, output dtype); pair with
    disable_operator_stats_collection, which prints the table."""
    from ..core import dispatch
    _op_stats.clear()
    if _stats_observer not in dispatch.OP_OBSERVERS:
        dispatch.OP_OBSERVERS.append(_stats_observer)


def disable_operator_stats_collection():
    from ..core import dispatch
    if _stats_observer in dispatch.OP_OBSERVERS:
        dispatch.OP_OBSERVERS.remove(_stats_observer)
    by_dtype = {}
    for (name, dt), cnt in sorted(_op_stats.items()):
        by_dtype.setdefault(dt, []).append((name, cnt))
    print("<------------------- op list ------------------->")
    for dt, entries in by_dtype.items():
        print(f"dtype: {dt}")
        for name, cnt in entries:
            print(f"  {name}: {cnt}")


def operator_stats():
    """{(op, output dtype): count} of the last (or running) collection."""
    return dict(_op_stats)


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def _is_traced(a) -> bool:
    """A tensor with no concrete values (fake or meta, under
    ``torch.export`` / ``torch.compile``)."""
    return a.device.type == "meta" or type(a).__name__ == "FakeTensor"


@contextlib.contextmanager
def dump_tensor_stats(path):
    """Record per-op output statistics to a JSONL dump for
    compare_accuracy: one line per floating output, ``{"seq", "op",
    "out", "dtype", "shape", "mean", "absmax", "nan", "inf"}``."""
    import json

    from ..core import dispatch

    f = open(path, "w")
    seq = {"i": 0}

    def obs(name, leaves):
        for k, a in enumerate(leaves):
            if not a.is_floating_point() or _is_traced(a):
                continue
            with torch.no_grad():
                a32 = a.detach().float()
                mean, absmax, nan, inf = torch.stack([
                    a32.mean(), a32.abs().max(),
                    torch.isnan(a32).sum().float(),
                    torch.isinf(a32).sum().float()]).tolist()
            rec = {
                "seq": seq["i"], "op": name, "out": k,
                "dtype": dtype_name(a.dtype), "shape": list(a.shape),
                "mean": mean, "absmax": absmax,
                "nan": int(nan), "inf": int(inf),
            }
            f.write(json.dumps(rec) + "\n")
            seq["i"] += 1

    dispatch.OP_OBSERVERS.append(obs)
    try:
        yield
    finally:
        dispatch.OP_OBSERVERS.remove(obs)
        f.close()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Cross-run numerical comparison over two dump_tensor_stats files
    (e.g. an f32 run and an AMP run, from either package): aligns records
    by (op, output index, occurrence), writes a CSV of mean / absmax
    relative differences and nan / inf counts, and returns the rows,
    worst first."""
    import csv
    import json

    def load(p):
        recs = {}
        with open(p) as f:
            for line in f:
                r = json.loads(line)
                key = (r["op"], r["out"])
                recs.setdefault(key, []).append(r)
        return recs

    a, b = load(dump_path), load(another_dump_path)
    rows = []
    inv_scale = 1.0 / loss_scale
    for key in sorted(set(a) & set(b)):
        for occ, (ra, rb) in enumerate(zip(a[key], b[key])):
            # run b was recorded with loss scaling: unscale its stats
            b_mean = rb["mean"] * inv_scale
            b_absmax = rb["absmax"] * inv_scale
            denom = max(abs(ra["mean"]), abs(b_mean), 1e-10)
            mean_rel = abs(ra["mean"] - b_mean) / denom
            dmax = max(ra["absmax"], b_absmax, 1e-10)
            max_rel = abs(ra["absmax"] - b_absmax) / dmax
            rows.append({
                "op": key[0], "out": key[1], "occurrence": occ,
                "dtype_a": ra["dtype"], "dtype_b": rb["dtype"],
                "mean_a": ra["mean"], "mean_b": b_mean,
                "mean_rel_diff": mean_rel, "absmax_rel_diff": max_rel,
                "nan_a": ra["nan"], "nan_b": rb["nan"],
                "inf_a": ra["inf"], "inf_b": rb["inf"],
            })
    rows.sort(key=lambda r: -(r["mean_rel_diff"] + r["absmax_rel_diff"]
                              + 10 * (r["nan_b"] + r["inf_b"])))
    if rows:
        with open(output_filename, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def check_layer_numerics(func):
    """Decorator for Layer.forward: raise if a Tensor input or output holds
    a NaN or Inf."""
    import functools

    from ..core.tensor import Tensor

    def finite(t):
        return bool(torch.isfinite(unwrap(t)).all())

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        named = list(enumerate(args)) + list(kwargs.items())
        for i, a in named:
            if isinstance(a, Tensor) and not finite(a):
                raise RuntimeError(
                    f"check_layer_numerics: input {i} of "
                    f"{type(self).__name__} has nan/inf")
        out = func(self, *args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs):
            if isinstance(o, Tensor) and not finite(o):
                raise RuntimeError(
                    f"check_layer_numerics: output {i} of "
                    f"{type(self).__name__} has nan/inf")
        return out
    return wrapper
