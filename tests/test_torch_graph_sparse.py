"""The port's ``geometric``, ``incubate``'s graph names and ``sparse``
against the JAX package's on the same seeded inputs.

Segment and message-passing ops: values and input gradients within the
f32 gate, with empty segments (JAX's -inf / +inf fill) and max / min ties
(the gradient split as ``jax.grad`` splits it). The samplers draw from
the port's seeded generator where the JAX package's are unseeded, so they
are held by their properties (a subset of the neighbours with no
repeats, ``count = min(sample_size, degree)``, the edge ids of the picked
edges, the weighted sampler's frequencies by a chi-square test) and by
reproducibility under ``seed``; ``graph_reindex`` and its relatives are
bit-equal. ``sparse``: every op in COO and CSR against the JAX
package's dense values, indices and nnz (``multiply`` by its dense
values: BCOO pads its product), ``matmul``'s gradient in the dense
operand against the dense product's, and the sparse convolutions, pooling
and batch norm at [1, 6, 8, 8, 3]."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from test_torch_parity_util import (arr, assert_f32_gate,  # noqa: F401
                                    cpu_place, run_both)

pytestmark = pytest.mark.usefixtures("cpu_place")


def _ids(*v):
    return np.asarray(v, np.int64)


# -- segment ops ---------------------------------------------------------------

SEG = _ids(0, 0, 2, 2, 2, 5)            # segments 1, 3 and 4 are empty


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops_with_empty_segments_and_ties(op):
    data = arr(6, 3, seed=1)
    data[1] = data[0]                    # a tie in segment 0
    data[4, 1] = data[3, 1]              # a tie in segment 2, one column
    out = run_both(lambda d, s: getattr(jp.geometric, op)(d, s),
                   lambda d, s: getattr(tp.geometric, op)(d, s),
                   [data, SEG], gate=True)
    v = out[0].numpy()
    assert v.shape == (6, 3)
    if op in ("segment_max", "segment_min"):
        assert np.all(np.isinf(v[[1, 3, 4]]))
    # the incubate names are the same functions
    assert getattr(tp.incubate, op) is getattr(tp.geometric, op)


def test_segment_max_of_integers_fills_with_the_extreme():
    data = np.arange(12, dtype=np.int32).reshape(6, 2)
    for op in ("segment_max", "segment_min"):
        j = getattr(jp.geometric, op)(jp.to_tensor(data), jp.to_tensor(SEG))
        t = getattr(tp.geometric, op)(tp.to_tensor(data), tp.to_tensor(SEG))
        assert t.dtype.name == j.dtype.name
        np.testing.assert_array_equal(t.numpy(), j.numpy())


def _graph(n=6, e=14, seed=2):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n - 1, e).astype(np.int64)   # node n-1 gets none
    return src, dst


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_u_recv(reduce_op):
    src, dst = _graph()
    x = arr(6, 4, seed=3)
    x[2] = x[4]                          # equal messages: ties
    run_both(lambda a, s, d: jp.geometric.send_u_recv(a, s, d, reduce_op),
             lambda a, s, d: tp.geometric.send_u_recv(a, s, d, reduce_op),
             [x, src, dst], gate=True)
    run_both(lambda a, s, d: jp.incubate.graph_send_recv(a, s, d, reduce_op,
                                                         out_size=8),
             lambda a, s, d: tp.incubate.graph_send_recv(a, s, d, reduce_op,
                                                         out_size=8),
             [x, src, dst], gate=True)


@pytest.mark.parametrize("message_op", ["add", "mul"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_ue_recv(message_op, reduce_op):
    src, dst = _graph(seed=4)
    x, e = arr(6, 4, seed=5), arr(14, 1, seed=6)
    run_both(lambda a, w, s, d: jp.geometric.send_ue_recv(
                 a, w, s, d, message_op, reduce_op),
             lambda a, w, s, d: tp.geometric.send_ue_recv(
                 a, w, s, d, message_op, reduce_op),
             [x, e, src, dst], gate=True)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv(message_op):
    src, dst = _graph(seed=7)
    x, y = arr(6, 3, seed=8), arr(6, 3, seed=9, lo=0.5, hi=2.0)
    run_both(lambda a, b, s, d: jp.geometric.send_uv(a, b, s, d, message_op),
             lambda a, b, s, d: tp.geometric.send_uv(a, b, s, d, message_op),
             [x, y, src, dst], gate=True)
    with pytest.raises(ValueError):
        tp.geometric.send_uv(tp.to_tensor(x), tp.to_tensor(y),
                             tp.to_tensor(src), tp.to_tensor(dst), "pow")


# -- samplers ------------------------------------------------------------------

def _csc(n=30, seed=10):
    """A CSC graph: colptr over destination nodes, row = source ids."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    row = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    colptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return row.astype(np.int64), colptr, deg


@pytest.mark.parametrize("sample_size", [-1, 1, 4, 20])
def test_sample_neighbors_properties(sample_size):
    row, colptr, deg = _csc()
    nodes = np.arange(0, 30, 3, dtype=np.int64)
    eids = np.arange(len(row), dtype=np.int64) * 7
    tp.seed(11)
    nb, cnt, ei = tp.geometric.sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(nodes),
        sample_size, eids=tp.to_tensor(eids), return_eids=True)
    nb, cnt, ei = nb.numpy(), cnt.numpy(), ei.numpy()
    assert cnt.dtype == np.int32
    want = [deg[n] if sample_size < 0 else min(sample_size, deg[n])
            for n in nodes]
    assert cnt.tolist() == want
    off = 0
    for n, c in zip(nodes, cnt):
        neigh = row[colptr[n]:colptr[n + 1]]
        got, got_e = nb[off:off + c], ei[off:off + c]
        assert len(set(got.tolist())) == c           # no repeats
        assert set(got.tolist()) <= set(neigh.tolist())
        # each edge id is the id of the edge that brought the neighbour
        pos = colptr[n] + np.array([np.where(neigh == g)[0][0] for g in got],
                                   np.int64)
        np.testing.assert_array_equal(got_e, eids[pos])
        off += c
    # reproducible under seed
    tp.seed(11)
    nb2, cnt2 = tp.incubate.graph_sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(nodes),
        sample_size=sample_size)
    np.testing.assert_array_equal(nb2.numpy(), nb)
    # the JAX sampler (unseeded) gives the same counts
    jnb, jcnt = jp.geometric.sample_neighbors(
        jp.to_tensor(row), jp.to_tensor(colptr), jp.to_tensor(nodes),
        sample_size)
    assert jcnt.numpy().tolist() == cnt.tolist()


def test_weighted_sampler_follows_the_weights():
    # one node with 5 neighbours of weights 1..5; draw 1 a time, 4,000 times
    row = np.arange(5, dtype=np.int64)
    colptr = np.array([0, 5], np.int64)
    w = np.arange(1, 6, dtype=np.float32)
    tp.seed(12)
    nodes = tp.to_tensor(np.zeros(4000, np.int64))
    nb, cnt = tp.geometric.weighted_sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(w), nodes,
        sample_size=1)
    assert cnt.numpy().tolist() == [1] * 4000
    freq = np.bincount(nb.numpy(), minlength=5)
    expect = 4000 * w / w.sum()
    chi2 = float(((freq - expect) ** 2 / expect).sum())
    assert chi2 < 18.47                  # chi-square, 4 dof, p = 0.001
    # without replacement: 3 of 5 distinct, and the JAX sampler's counts
    nb3, cnt3 = tp.geometric.weighted_sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(w),
        tp.to_tensor(np.zeros(50, np.int64)), sample_size=3)
    picks = nb3.numpy().reshape(50, 3)
    assert all(len(set(p)) == 3 for p in picks.tolist())
    jnb, jcnt = jp.geometric.weighted_sample_neighbors(
        jp.to_tensor(row), jp.to_tensor(colptr), jp.to_tensor(w),
        jp.to_tensor(np.zeros(50, np.int64)), sample_size=3)
    assert jcnt.numpy().tolist() == cnt3.numpy().tolist()


def test_graph_reindex_is_bit_equal():
    x = _ids(5, 9, 2)
    nb = _ids(9, 7, 7, 3, 5, 11, 2, 3)
    cnt = np.array([3, 2, 3], np.int32)
    for jf, tf in ((jp.incubate.graph_reindex, tp.incubate.graph_reindex),
                   (jp.geometric.reindex_graph, tp.geometric.reindex_graph)):
        jo = jf(jp.to_tensor(x), jp.to_tensor(nb), jp.to_tensor(cnt))
        to = tf(tp.to_tensor(x), tp.to_tensor(nb), tp.to_tensor(cnt))
        for a, b in zip(jo, to):
            assert a.dtype.name == b.dtype.name
            np.testing.assert_array_equal(b.numpy(), a.numpy())
    nbs = [_ids(9, 4, 4), _ids(2, 8)]
    cnts = [np.array([1, 1, 1], np.int32), np.array([0, 2, 0], np.int32)]
    jo = jp.geometric.reindex_heter_graph(
        jp.to_tensor(x), [jp.to_tensor(a) for a in nbs],
        [jp.to_tensor(c) for c in cnts])
    to = tp.geometric.reindex_heter_graph(
        tp.to_tensor(x), [tp.to_tensor(a) for a in nbs],
        [tp.to_tensor(c) for c in cnts])
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_khop_sampler_properties():
    row, colptr, deg = _csc(seed=13)
    seeds = _ids(1, 4, 9)
    eids = np.arange(len(row), dtype=np.int64) + 100
    tp.seed(14)
    src, dst, nodes, sidx, ei = tp.incubate.graph_khop_sampler(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(seeds),
        [3, 2], sorted_eids=tp.to_tensor(eids), return_eids=True)
    nodes = nodes.numpy()
    assert nodes[:3].tolist() == seeds.tolist()
    assert sidx.numpy().tolist() == [0, 1, 2]
    edges = {(int(row[k]), int(d)) for d in range(30)
             for k in range(colptr[d], colptr[d + 1])}
    for s, d, e in zip(nodes[src.numpy()], nodes[dst.numpy()], ei.numpy()):
        assert (s, d) in edges
        assert row[e - 100] == s
    jo = jp.incubate.graph_khop_sampler(
        jp.to_tensor(row), jp.to_tensor(colptr), jp.to_tensor(seeds), [3, 2])
    assert jo[2].numpy()[:3].tolist() == seeds.tolist()
    assert jo[3].numpy().tolist() == [0, 1, 2]


# -- sparse --------------------------------------------------------------------

IDX = _ids(0, 1, 1, 2, 1), _ids(1, 0, 2, 1, 0)     # (1, 0) twice
VALS = np.array([1.0, -2.0, 3.0, 4.0, 0.5], np.float32)
IDX2 = _ids(0, 1, 2), _ids(1, 1, 2)
VALS2 = np.array([5.0, 6.0, -7.0], np.float32)


def _coo(pkg, fmt="coo", second=False):
    idx, v = (IDX2, VALS2) if second else (IDX, VALS)
    if fmt == "csr":
        order = np.lexsort((idx[1], idx[0]))
        rows, cols = idx[0][order], idx[1][order]
        crows = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                           minlength=3))])
        return pkg.sparse.sparse_csr_tensor(
            pkg.to_tensor(crows.astype(np.int64)), pkg.to_tensor(cols),
            pkg.to_tensor(v[order]), [3, 3])
    return pkg.sparse.sparse_coo_tensor(pkg.to_tensor(np.stack(idx)),
                                        pkg.to_tensor(v), [3, 3])


def _same(j, t, nnz=True):
    assert type(t).__name__ == type(j).__name__
    if isinstance(j, jp.sparse.SparseTensor):
        assert t.shape == j.shape
        assert t.is_sparse_csr() == j.is_sparse_csr()
        if nnz:
            assert t.nnz() == j.nnz()
            assert t.indices().dtype.name == j.indices().dtype.name
            np.testing.assert_array_equal(t.indices().numpy(),
                                          j.indices().numpy())
            np.testing.assert_allclose(t.values().numpy(),
                                       j.values().numpy(), rtol=1e-6)
        np.testing.assert_allclose(t.to_dense().numpy(),
                                   j.to_dense().numpy(), rtol=1e-6)
    else:
        np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5,
                                   atol=1e-6)


_UNARY = ["relu", "abs", "sin", "tanh", "square", "neg", "asinh", "atan",
          "sinh", "tan", "expm1", "deg2rad", "rad2deg"]


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("op", _UNARY)
def test_sparse_unary(op, fmt):
    _same(getattr(jp.sparse, op)(_coo(jp, fmt)),
          getattr(tp.sparse, op)(_coo(tp, fmt)))


def test_sparse_isnan_values():
    # the JAX package's bool BCOO cannot be made dense: compare entries
    j, t = jp.sparse.isnan(_coo(jp)), tp.sparse.isnan(_coo(tp))
    assert t.values().dtype.name == j.values().dtype.name == "bool"
    np.testing.assert_array_equal(t.values().numpy(), j.values().numpy())
    np.testing.assert_array_equal(t.indices().numpy(), j.indices().numpy())


_BINARY = {
    "add": lambda s, a, b: s.add(a, b),
    "subtract": lambda s, a, b: s.subtract(a, b),
    "a + b": lambda s, a, b: a + b,
    "coalesce(add)": lambda s, a, b: s.coalesce(s.add(a, a)),
    "divide": lambda s, a, b: s.divide(a, b),
    "scalar *": lambda s, a, b: a * 2.5,
    "pow": lambda s, a, b: s.pow(s.abs(a), 1.5),
    "sqrt": lambda s, a, b: s.sqrt(s.abs(a)),
    "log1p": lambda s, a, b: s.log1p(s.abs(a)),
    "asin": lambda s, a, b: s.asin(a * 0.2),
    "atanh": lambda s, a, b: s.atanh(a * 0.2),
    "cast": lambda s, a, b: s.cast(a, "int32", "float64"),
    "transpose": lambda s, a, b: s.transpose(a, [1, 0]),
    "reshape": lambda s, a, b: s.reshape(a, [9]),
    "reshape 2-d": lambda s, a, b: s.reshape(a, [1, 9]),
    "slice": lambda s, a, b: s.slice(a, [0, 1], [1, 0], [3, -1]),
    "sum": lambda s, a, b: s.sum(a, axis=0),
    "sum all": lambda s, a, b: s.sum(a),
    "sum keepdim": lambda s, a, b: s.sum(a, axis=1, keepdim=True,
                                         dtype="float64"),
}


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("op", sorted(_BINARY))
def test_sparse_ops(op, fmt):
    j = _BINARY[op](jp.sparse, _coo(jp, fmt), _coo(jp, fmt, True))
    t = _BINARY[op](tp.sparse, _coo(tp, fmt), _coo(tp, fmt, True))
    # BCOO reshapes [3, 3] -> [1, 9] into a batch dimension: its indices
    # have another layout, its dense values are the same
    _same(j, t, nnz=op != "reshape 2-d")


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_sparse_multiply_keeps_the_dense_values(fmt):
    for f in (lambda s, a, b: s.multiply(a, b), lambda s, a, b: a * b):
        j = f(jp.sparse, _coo(jp, fmt), _coo(jp, fmt, True))
        t = f(tp.sparse, _coo(tp, fmt), _coo(tp, fmt, True))
        _same(j, t, nnz=False)
        assert t.nnz() == 1              # the one shared site, (0, 1)
    dense = np.arange(9, dtype=np.float32).reshape(3, 3)
    _same(_coo(jp, fmt) * jp.to_tensor(dense),
          _coo(tp, fmt) * tp.to_tensor(dense))


def test_sparse_creation_and_conversion():
    _same(_coo(jp), _coo(tp))
    j = jp.sparse.sparse_coo_tensor(jp.to_tensor(np.stack(IDX)),
                                    jp.to_tensor(VALS))
    t = tp.sparse.sparse_coo_tensor(tp.to_tensor(np.stack(IDX)),
                                    tp.to_tensor(VALS))
    _same(j, t)
    dense = np.array([[0, 1.5, 0], [2, 0, 0], [0, 0, -3]], np.float32)
    # sparse_dim is ignored: every dimension sparse, int32 indices
    _same(jp.sparse.to_sparse_coo(jp.to_tensor(dense), 1),
          tp.sparse.to_sparse_coo(tp.to_tensor(dense), 1))
    assert tp.sparse.is_sparse(t) and not tp.sparse.is_sparse(
        tp.to_tensor(dense))
    assert tp.sparse.is_same_shape(t, tp.to_tensor(dense))
    assert repr(t) == repr(j)
    _same(jp.sparse.creation.sparse_coo_tensor(
              jp.to_tensor(np.stack(IDX)), jp.to_tensor(VALS), [3, 4]),
          tp.sparse.creation.sparse_coo_tensor(
              tp.to_tensor(np.stack(IDX)), tp.to_tensor(VALS), [3, 4]))
    d3 = np.zeros((2, 3, 4), np.float32)
    d3[0, 1, 2], d3[1, 2, 3] = 1.0, 2.0
    s3j, s3t = (p.sparse.to_sparse_coo(p.to_tensor(d3)) for p in (jp, tp))
    _same(jp.sparse.transpose(s3j, [2, 0, 1]),
          tp.sparse.transpose(s3t, [2, 0, 1]))
    _same(jp.sparse.reshape(s3j, [6, 4]), tp.sparse.reshape(s3t, [6, 4]))


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_sparse_matmul_is_differentiable_in_the_dense_operand(fmt):
    y = arr(3, 4, seed=20)
    dense_a = _coo(jp, fmt).to_dense().numpy()
    run_both(lambda b: jp.matmul(jp.to_tensor(dense_a), b),
             lambda b: tp.sparse.matmul(_coo(tp, fmt), b), [y], gate=True)
    v = arr(3, seed=21)
    run_both(lambda b: jp.matmul(jp.to_tensor(dense_a), b),
             lambda b: tp.sparse.mv(_coo(tp, fmt), b), [v], gate=True)
    # and each against the JAX package's sparse op
    _same(jp.sparse.matmul(_coo(jp, fmt), jp.to_tensor(y)),
          tp.sparse.matmul(_coo(tp, fmt), tp.to_tensor(y)))
    _same(jp.sparse.mv(_coo(jp, fmt), jp.to_tensor(v)),
          tp.sparse.mv(_coo(tp, fmt), tp.to_tensor(v)))
    _same(_coo(jp, fmt).matmul(_coo(jp, fmt, True)),
          _coo(tp, fmt).matmul(_coo(tp, fmt, True)))


def test_sparse_addmm_masked_matmul_mask_as_pca():
    a, b, base = arr(3, 5, seed=22), arr(5, 3, seed=23), arr(3, 3, seed=24)
    for pkg_j, pkg_t in ((jp, tp),):
        _same(pkg_j.sparse.addmm(pkg_j.to_tensor(base), _coo(pkg_j),
                                 pkg_j.to_tensor(arr(3, 3, seed=25)), 0.5,
                                 2.0),
              pkg_t.sparse.addmm(pkg_t.to_tensor(base), _coo(pkg_t),
                                 pkg_t.to_tensor(arr(3, 3, seed=25)), 0.5,
                                 2.0))
        _same(pkg_j.sparse.addmm(_coo(pkg_j), pkg_j.to_tensor(base),
                                 pkg_j.to_tensor(base)),
              pkg_t.sparse.addmm(_coo(pkg_t), pkg_t.to_tensor(base),
                                 pkg_t.to_tensor(base)))
    _same(jp.sparse.masked_matmul(jp.to_tensor(a), jp.to_tensor(b),
                                  _coo(jp, "csr")),
          tp.sparse.masked_matmul(tp.to_tensor(a), tp.to_tensor(b),
                                  _coo(tp, "csr")))
    _same(jp.sparse.mask_as(jp.to_tensor(base), _coo(jp)),
          tp.sparse.mask_as(tp.to_tensor(base), _coo(tp)))
    m = arr(6, 4, seed=26)
    ju, js, jv = jp.sparse.pca_lowrank(jp.to_tensor(m), q=2)
    tu, ts, tv = tp.sparse.pca_lowrank(tp.to_tensor(m), q=2)
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(
        tp.sparse.reshape(_coo(tp), [-1]).indices().numpy(),
        tp.sparse.reshape(_coo(tp), [9]).indices().numpy())
    # singular vectors agree up to sign
    for x, y in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(np.abs(x.numpy()), np.abs(y.numpy()),
                                   atol=1e-5)
    s = tp.sparse.pca_lowrank(_coo(tp))[1].numpy()
    np.testing.assert_allclose(s, jp.sparse.pca_lowrank(_coo(jp))[1].numpy(),
                               rtol=1e-5, atol=1e-6)


def _voxels(shape=(1, 6, 8, 8, 3), n_active=40, seed=30):
    rng = np.random.default_rng(seed)
    dense = np.zeros(shape, np.float32)
    flat = rng.choice(int(np.prod(shape[:-1])), n_active, replace=False)
    sites = np.stack(np.unravel_index(flat, shape[:-1]))
    dense[tuple(sites)] = rng.standard_normal((n_active, shape[-1]))
    return dense, sites


def _layer_pair(cls, *args, **kw):
    jl = getattr(jp.sparse.nn, cls)(*args, **kw)
    tl = getattr(tp.sparse.nn, cls)(*args, **kw)
    for (n, jpar), (m, tpar) in zip(jl.named_parameters(),
                                    tl.named_parameters()):
        assert n == m
        tpar.set_value(jpar.numpy())
    return jl, tl


@pytest.mark.parametrize("cls,kw", [
    ("SubmConv3D", dict(padding=1)), ("Conv3D", dict(padding=1)),
    ("Conv3D", dict(stride=2)), ("SubmConv3D", dict(padding=1, groups=1))])
def test_sparse_conv3d(cls, kw):
    dense, _ = _voxels()
    jl, tl = _layer_pair(cls, 3, 4, 3, **kw)
    jo = jl(jp.sparse.to_sparse_coo(jp.to_tensor(dense)))
    to = tl(tp.sparse.to_sparse_coo(tp.to_tensor(dense)))
    assert to.nnz() == jo.nnz() and to.shape == jo.shape
    assert_f32_gate(to.to_dense().numpy(), jo.to_dense().numpy())
    if cls == "SubmConv3D":
        active = np.any(dense != 0, axis=-1)
        assert not np.any(to.to_dense().numpy()[~active])
    # differentiable in the weight through the values
    to.values().sum().backward()
    assert tl.weight.grad is not None and np.all(np.isfinite(
        tl.weight.grad.numpy()))


def test_sparse_conv2d_from_a_hybrid_coo():
    dense, sites = _voxels((1, 8, 8, 3), 12, seed=31)
    vals = dense[tuple(sites)]                         # [nnz, C]
    for cls in ("Conv2D", "SubmConv2D"):
        jl, tl = _layer_pair(cls, 3, 2, 3, padding=1)
        jx = jp.sparse.sparse_coo_tensor(jp.to_tensor(sites),
                                         jp.to_tensor(vals), [1, 8, 8, 3])
        tx = tp.sparse.sparse_coo_tensor(tp.to_tensor(sites),
                                         tp.to_tensor(vals), [1, 8, 8, 3])
        assert_f32_gate(tl(tx).to_dense().numpy(),
                        jl(jx).to_dense().numpy())


def test_sparse_pool_batchnorm_activations():
    dense, sites = _voxels()
    jx = jp.sparse.to_sparse_coo(jp.to_tensor(dense))
    tx = tp.sparse.to_sparse_coo(tp.to_tensor(dense))
    _same(jp.sparse.nn.MaxPool3D(2)(jx), tp.sparse.nn.MaxPool3D(2)(tx))
    _same(jp.sparse.nn.functional.max_pool3d(jx, 3, 2, 1),
          tp.sparse.nn.functional.max_pool3d(tx, 3, 2, 1))
    jb, tb = _layer_pair("BatchNorm", 3)
    assert_f32_gate(tb(tx).to_dense().numpy(), jb(jx).to_dense().numpy())
    # the hybrid layout normalises the stored rows
    vals = dense[tuple(sites[:4])]
    jh = jp.sparse.sparse_coo_tensor(jp.to_tensor(sites[:4]),
                                     jp.to_tensor(vals), [1, 6, 8, 8, 3])
    th = tp.sparse.sparse_coo_tensor(tp.to_tensor(sites[:4]),
                                     tp.to_tensor(vals), [1, 6, 8, 8, 3])
    jb2, tb2 = _layer_pair("SyncBatchNorm", 3)
    assert_f32_gate(tb2(th).values().numpy(), jb2(jh).values().numpy())
    for cls, args in (("ReLU", ()), ("ReLU6", ()), ("LeakyReLU", (0.2,)),
                      ("Softmax", (-1,))):
        _same(getattr(jp.sparse.nn, cls)(*args)(jx),
              getattr(tp.sparse.nn, cls)(*args)(tx))
    with pytest.raises(NotImplementedError):
        tp.sparse.nn.functional.attention(None, None, None, None)
