"""Two repaired faults of the eager surface, held to the JAX package:

- negative-step slices: ``x[:, ::-1]``, ``x[::-1, 1]``, a stepped
  reverse, ``x[..., ::-1] = v`` (outside and inside a graph) and
  ``strided_slice`` with a negative stride give the JAX values and
  gradients;
- the top-level subpackages (``jit``, ``inference``, ``text``,
  ``incubate``, ``regularizer``, ``quantization``, ``distributed``) and
  ``linalg`` resolve as attributes after a bare ``import
  paddle_tpu_torch`` in a fresh interpreter.

Tolerance: exact (slicing moves values, it computes none).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

EXACT = dict(rtol=0, atol=0)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


GET = {
    "cols_reversed": (slice(None), slice(None, None, -1)),
    "rows_reversed_int": (slice(None, None, -1), 1),
    "stepped": (slice(4, 0, -2), slice(None, None, 2)),
    "ellipsis": (Ellipsis, slice(None, None, -1)),
    "newaxis": (None, slice(None, None, -3), slice(1, None)),
    "empty": (slice(0, 3, -1),),
    "mixed_index": (slice(None, None, -1), [0, 2, 3]),
}


@pytest.mark.parametrize("case", sorted(GET))
def test_negative_step_getitem_matches_jax(case):
    idx = GET[case]
    run_both(lambda a: a[idx], lambda a: a[idx], [arr(5, 6, seed=1)],
             tol=EXACT)


@pytest.mark.parametrize("idx", [
    (slice(None), slice(None, None, -1)), (slice(None, None, -2),),
    (Ellipsis, slice(3, None, -1))], ids=["cols", "rows_step2", "tail"])
@pytest.mark.parametrize("in_graph", [False, True])
def test_negative_step_setitem_matches_jax(idx, in_graph):
    x = arr(5, 6, seed=2)
    shape = np.empty((5, 6))[idx].shape
    v = arr(*shape, seed=3)

    def setter(pkg):
        def fn(a, b):
            y = a * 1.0 if in_graph else pkg.to_tensor(a.numpy())
            y[idx] = b
            return y
        return fn
    run_both(setter(jp), setter(tp), [x, v], grad=in_graph, tol=EXACT)


@pytest.mark.parametrize("axes,starts,ends,strides", [
    ([1], [2], [0], [-1]), ([0, 1], [4, 5], [-6, 0], [-2, -2]),
    ([1], [-1], [-7], [-1]), ([0], [0], [5], [2])],
    ids=["one_axis", "two_axes", "negative_bounds", "positive"])
def test_strided_slice_matches_jax(axes, starts, ends, strides):
    def fn(pkg):
        return lambda a: pkg.strided_slice(a, axes, starts, ends, strides)
    run_both(fn(jp), fn(tp), [arr(5, 6, seed=4)], tol=EXACT)


SUBPACKAGES = ("jit", "inference", "text", "incubate", "regularizer",
               "quantization", "distributed", "linalg")


def test_subpackages_resolve_after_a_bare_import():
    code = ("import paddle_tpu_torch as paddle\n"
            f"names = {SUBPACKAGES!r}\n"
            "print([n for n in names if not hasattr(paddle, n)])\n"
            "print(all(getattr(paddle, n).__name__ == "
            "'paddle_tpu_torch.' + n for n in names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_unknown_attribute_still_raises():
    with pytest.raises(AttributeError):
        tp.no_such_subpackage
