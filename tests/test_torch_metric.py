"""The port's metrics (``paddle_tpu_torch.metric``) against the JAX
package's on the same seeded arrays, on the CPU: ``Accuracy`` (top-k,
index and one-hot labels) compute / update / accumulate, ``Precision``,
``Recall``, ``Auc`` and the functional ``accuracy``. Every value is
compared exactly (rtol 1e-7 for the float accumulators): both sum the
same 0/1 hits in the same order."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod

TOL = dict(rtol=1e-7, atol=0)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _batches(seed, n_batches=3, n=17, classes=6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, classes)).astype(np.float32),
             rng.integers(0, classes, (n, 1)).astype(np.int64))
            for _ in range(n_batches)]


@pytest.mark.parametrize("topk", [1, (1, 3), (2, 5)])
@pytest.mark.parametrize("one_hot", [False, True])
def test_accuracy_matches_jax(topk, one_hot):
    ms = [P.metric.Accuracy(topk=topk) for P in (jp, tp)]
    for pred, lab in _batches(1):
        if one_hot:
            lab = np.eye(pred.shape[1], dtype=np.float32)[lab[:, 0]]
        outs = []
        for P, m in zip((jp, tp), ms):
            c = m.compute(P.to_tensor(pred), P.to_tensor(lab))
            outs.append((np.asarray(c.numpy()), m.update(c)))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)
    np.testing.assert_allclose(ms[0].accumulate(), ms[1].accumulate(), **TOL)
    assert ms[0].name() == ms[1].name()
    ms[1].reset()
    assert ms[1].accumulate() == (0.0 if isinstance(topk, int)
                                  else [0.0] * len(topk))


def test_accuracy_compute_takes_raw_torch_tensors():
    import torch
    pred, lab = _batches(2)[0]
    m = tp.metric.Accuracy(topk=(1, 2))
    a = m.compute(torch.from_numpy(pred), torch.from_numpy(lab))
    b = m.compute(tp.to_tensor(pred), tp.to_tensor(lab))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.dtype.name == "float32" and a.shape == [17, 2]


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall_match_jax(name):
    rng = np.random.default_rng(4)
    ms = [getattr(P.metric, name)() for P in (jp, tp)]
    for _ in range(3):
        p = rng.random(40).astype(np.float32)
        y = rng.integers(0, 2, 40)
        for P, m in zip((jp, tp), ms):
            m.update(P.to_tensor(p), P.to_tensor(y))
    assert ms[0].accumulate() == ms[1].accumulate()
    assert ms[1].name() == name.lower()


@pytest.mark.parametrize("two_col", [False, True])
@pytest.mark.parametrize("thresholds", [4095, 200])
def test_auc_matches_jax(two_col, thresholds):
    rng = np.random.default_rng(5)
    ms = [P.metric.Auc(num_thresholds=thresholds) for P in (jp, tp)]
    for _ in range(3):
        p = rng.random(64).astype(np.float32)
        if two_col:
            p = np.stack([1 - p, p], 1)
        y = rng.integers(0, 2, 64)
        for P, m in zip((jp, tp), ms):
            m.update(P.to_tensor(p), P.to_tensor(y))
    np.testing.assert_allclose(ms[0].accumulate(), ms[1].accumulate(),
                               **TOL)
    assert 0.0 < ms[1].accumulate() < 1.0
    ms[1].reset()
    assert ms[1].accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_functional_accuracy_matches_jax(k):
    pred, lab = _batches(6)[0]
    a = jp.metric.accuracy(jp.to_tensor(pred), jp.to_tensor(lab), k=k)
    b = tp.metric.accuracy(tp.to_tensor(pred), tp.to_tensor(lab), k=k)
    np.testing.assert_allclose(np.asarray(a.numpy()), b.numpy(), **TOL)
    assert b.dtype.name == "float32" and b.shape == []


def test_metric_base_and_names():
    m = tp.metric.Metric()
    assert m.compute(1, 2) == (1, 2)
    for meth in ("reset", "accumulate", "name"):
        with pytest.raises(NotImplementedError):
            getattr(m, meth)()
