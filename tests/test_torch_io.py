"""The port's io (``paddle_tpu_torch.io``) against the JAX package's
(``paddle_tpu.io``) on the CPU: the same datasets from numpy seeds give
the same batches (values exact, dtypes and shapes equal), the samplers
give the same index lists (a seeded ``RandomSampler`` included: both
draw from ``np.random.default_rng(generator.initial_seed())``), and
worker processes give the batches the main process gives."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    prev = place_mod._current_place
    tp.set_device("cpu")
    yield
    place_mod._current_place = prev


def _arrays(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3)).astype(np.float32), np.arange(n)


def _ds(P, n=20):
    x, y = _arrays(n)
    return P.io.TensorDataset([P.to_tensor(x), P.to_tensor(y)])


def _flat(obj):
    """Leaves of a batch as (numpy value, dtype name) / plain values."""
    if isinstance(obj, (list, tuple)):
        return [v for o in obj for v in _flat(o)]
    if isinstance(obj, dict):
        return [v for k in sorted(obj) for v in _flat(obj[k])]
    if hasattr(obj, "numpy"):
        return [(np.asarray(obj.numpy()), obj.dtype.name)]
    return [obj]


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        if isinstance(x, tuple):
            assert x[1] == y[1]
            np.testing.assert_array_equal(x[0], y[0])
        else:
            assert x == y


@pytest.mark.parametrize("batch_size,drop_last", [(6, False), (6, True),
                                                  (5, False), (1, False)])
def test_batches_match_jax(batch_size, drop_last):
    got = [list(DL) for DL in (
        jp.io.DataLoader(_ds(jp), batch_size=batch_size, drop_last=drop_last),
        tp.io.DataLoader(_ds(tp), batch_size=batch_size, drop_last=drop_last))]
    assert len(got[0]) == len(got[1]) == len(
        tp.io.DataLoader(_ds(tp), batch_size=batch_size, drop_last=drop_last))
    for a, b in zip(*got):
        _same(a, b)


def test_no_auto_batching_yields_samples():
    a = list(jp.io.DataLoader(_ds(jp, 7), batch_size=None))
    b = list(tp.io.DataLoader(_ds(tp, 7), batch_size=None))
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        _same(x, y)
    assert b[3][0].shape == [3]


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset(drop_last):
    def make(P):
        class Stream(P.io.IterableDataset):
            def __iter__(self):
                for i in range(11):
                    yield np.full((2,), i, np.float32), i
        return Stream()
    a = list(jp.io.DataLoader(make(jp), batch_size=4, drop_last=drop_last))
    b = list(tp.io.DataLoader(make(tp), batch_size=4, drop_last=drop_last))
    assert len(a) == len(b) == (2 if drop_last else 3)
    for x, y in zip(a, b):
        _same(x, y)
    with pytest.raises(TypeError):
        len(tp.io.DataLoader(make(tp), batch_size=4))


def _nested_samples():
    rng = np.random.default_rng(3)
    return [{"img": rng.standard_normal((2, 2)),           # float64
             "pair": (int(i), float(i) / 3),
             "seq": [rng.integers(0, 9, 3), np.float32(i)],
             "name": f"s{i}"} for i in range(4)]


def test_nested_collate_matches_jax():
    samples = _nested_samples()
    a = jp.io.default_collate_fn(samples)
    b = tp.io.default_collate_fn(samples)
    _same(a, b)
    assert b["img"].dtype.name == "float32"      # float64 -> default
    assert b["pair"][0].dtype.name == "int64"
    assert b["name"] == ["s0", "s1", "s2", "s3"]
    with pytest.raises(TypeError):
        tp.io.default_collate_fn([object(), object()])


def test_sequence_and_batch_samplers():
    for P in (jp, tp):
        ds = _ds(P, 11)
        assert list(P.io.SequenceSampler(ds)) == list(range(11))
    a = list(jp.io.BatchSampler(_ds(jp, 11), batch_size=4))
    b = list(tp.io.BatchSampler(_ds(tp, 11), batch_size=4))
    assert a == b and len(tp.io.BatchSampler(_ds(tp, 11), batch_size=4)) == 3
    b = tp.io.BatchSampler(_ds(tp, 11), batch_size=4, drop_last=True)
    assert list(b) == a[:2] and len(b) == 2


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("replacement,num_samples", [(False, None),
                                                     (True, 30),
                                                     (False, 9)])
def test_seeded_random_sampler_gives_jax_indices(seed, replacement,
                                                 num_samples):
    lists = []
    for P in (jp, tp):
        g = torch.Generator().manual_seed(seed)
        s = P.io.RandomSampler(_ds(P), replacement=replacement,
                               num_samples=num_samples, generator=g)
        lists.append((list(s), len(s)))
    assert lists[0] == lists[1]
    # the stream restarts from the seed at every pass, as in the JAX package
    s = tp.io.RandomSampler(_ds(tp), replacement=replacement,
                            num_samples=num_samples,
                            generator=torch.Generator().manual_seed(seed))
    got = list(tp.io.BatchSampler(sampler=s, batch_size=6))
    assert [i for b in got for i in b] == lists[1][0] == list(s)


def test_subset_random_sampler_and_random_split():
    g = torch.Generator().manual_seed(5)
    a = list(jp.io.SubsetRandomSampler([3, 5, 8, 13, 21], generator=g))
    b = list(tp.io.SubsetRandomSampler([3, 5, 8, 13, 21], generator=g))
    assert a == b and sorted(b) == [3, 5, 8, 13, 21]
    sa = jp.io.random_split(_ds(jp), [12, 8], generator=g)
    sb = tp.io.random_split(_ds(tp), [12, 8], generator=g)
    assert [s.indices for s in sa] == [s.indices for s in sb]
    _same(sa[1][3], sb[1][3])
    with pytest.raises(ValueError):
        tp.io.random_split(_ds(tp), [12, 9])


@pytest.mark.parametrize("shuffle,drop_last,n", [(False, False, 17),
                                                 (True, False, 17),
                                                 (True, True, 17),
                                                 (False, True, 16)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last, n):
    for epoch in (0, 3):
        for rank in range(4):
            got = []
            for P in (jp, tp):
                s = P.io.DistributedBatchSampler(
                    _ds(P, n), batch_size=2, num_replicas=4, rank=rank,
                    shuffle=shuffle, drop_last=drop_last)
                s.set_epoch(epoch)
                got.append((list(s), len(s)))
            assert got[0] == got[1]


def test_composed_datasets_match_jax():
    def make(P):
        x, y = _arrays(10)
        a = P.io.TensorDataset([P.to_tensor(x)])
        b = P.io.TensorDataset([P.to_tensor(y)])
        return (P.io.ComposeDataset([a, b]), P.io.ConcatDataset([a, a]),
                P.io.Subset(b, [9, 0, 4]))
    for dj, dt in zip(make(jp), make(tp)):
        assert len(dj) == len(dt)
        for i in (0, len(dt) - 1, -1 if not isinstance(dt, tp.io.Subset)
                  else 1):
            _same(dj[i], dt[i])


class _Squares:
    """A map-style dataset of numpy samples whose workers record their
    ids (``get_worker_info``)."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        info = tp.io.get_worker_info()
        wid = -1 if info is None else info.id
        return np.full((4, 4), i, np.float32), np.int64(i), np.int64(wid)


def test_workers_match_the_main_process_over_two_epochs():
    ds = tp.io.TensorDataset([tp.to_tensor(_arrays(20)[0]),
                              tp.to_tensor(_arrays(20)[1])])
    plain = list(tp.io.DataLoader(ds, batch_size=6))
    dl = tp.io.DataLoader(ds, batch_size=6, num_workers=2,
                          persistent_workers=True)
    for _ in range(2):
        got = list(dl)
        assert len(got) == len(plain)
        for a, b in zip(plain, got):
            _same(a, b)
    assert dl._workers is not None      # kept across epochs


def test_workers_run_worker_init_and_report_their_ids():
    seen = []
    dl = tp.io.DataLoader(_Squares(), batch_size=4, num_workers=2,
                          worker_init_fn=lambda wid: None)
    for x, y, wid in dl:
        assert x.shape == [4, 4, 4]
        np.testing.assert_array_equal(x.numpy()[:, 0, 0], y.numpy())
        seen.extend(wid.numpy().tolist())
    assert sorted(set(seen)) == [0, 1]
    assert tp.io.get_worker_info() is None


def test_custom_collate_runs_in_the_main_process_with_workers():
    def collate(samples):
        assert tp.io.get_worker_info() is None
        return len(samples), tp.io.default_collate_fn(samples)
    got = list(tp.io.DataLoader(_Squares(), batch_size=5, num_workers=2,
                                collate_fn=collate))
    assert [n for n, _ in got] == [5, 5, 5, 1]
    np.testing.assert_array_equal(got[-1][1][1].numpy(), [15])


def test_workers_refuse_a_dataset_off_the_cpu():
    ds = tp.io.TensorDataset([torch.zeros(8, 2, device="meta")])
    with pytest.raises(ValueError, match="worker processes"):
        list(tp.io.DataLoader(ds, batch_size=4, num_workers=2))


@pytest.mark.parametrize("prefetch", [1, 2, 5])
def test_buffer_reader_keeps_values_and_order(prefetch):
    ds = _ds(tp, 12)
    plain = list(tp.io.DataLoader(ds, batch_size=4, use_buffer_reader=False))
    buffered = list(tp.io.DataLoader(ds, batch_size=4, use_buffer_reader=True,
                                     prefetch_factor=prefetch))
    assert len(plain) == len(buffered) == 3
    for a, b in zip(plain, buffered):
        _same(a, b)
    it = iter(tp.io.DataLoader(ds, batch_size=4, prefetch_factor=prefetch))
    next(it)
    del it                              # early abandon does not wedge


def test_shuffle_draws_every_index_once():
    dl = tp.io.DataLoader(_ds(tp), batch_size=5, shuffle=True)
    seen = sorted(int(i) for b in dl for i in b[1].numpy())
    assert seen == list(range(20))
