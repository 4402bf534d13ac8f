"""The port's ``text.viterbi_decode`` / ``ViterbiDecoder``, ``text``'s seven
synthetic datasets, ``hub``, the ``tensor`` namespace and ``CustomPlace``
against the JAX package's: the Viterbi's scores (with gradients) and
paths on the same seeded inputs, against brute force, at ties, length 1
and padded lengths, and beside the other JAX Viterbi convention
(``ops.search.viterbi_decode``: the stop column added once at the end,
where ``text.viterbi`` adds the stop row at each sequence's last step);
the datasets bit-equal; the hub over a local ``hubconf.py``."""
import itertools

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as place_mod

from test_torch_parity_util import cpu_place, run_both  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_place")


def _inputs(B=3, T=6, N=5, seed=0, lens=(6, 3, 1)):
    rng = np.random.default_rng(seed)
    emis = rng.standard_normal((B, T, N)).astype(np.float32)
    trans = rng.standard_normal((N, N)).astype(np.float32)
    return emis, trans, np.asarray(lens, np.int64)


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_matches_jax_with_gradients(bos_eos):
    emis, trans, lens = _inputs()
    out = run_both(
        lambda e, t, n: jp.text.viterbi_decode(e, t, n, bos_eos),
        lambda e, t, n: tp.text.viterbi_decode(e, t, n, bos_eos),
        [emis, trans, lens])
    assert out[1].dtype.name == "int64"


def _brute(emis, trans, length, bos_eos):
    N = emis.shape[-1]
    best, arg = -np.inf, None
    for path in itertools.product(range(N), repeat=length):
        s = emis[0, path[0]] + (trans[N - 1, path[0]] if bos_eos else 0.0)
        for t in range(1, length):
            s += trans[path[t - 1], path[t]] + emis[t, path[t]]
        if bos_eos:
            s += trans[N - 2, path[-1]]
        if s > best:
            best, arg = s, list(path)
    return best, arg


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_matches_brute_force_at_padded_lengths(bos_eos):
    emis, trans, lens = _inputs(B=3, T=5, N=4, seed=1, lens=(5, 3, 1))
    sc, paths = tp.text.viterbi_decode(tp.to_tensor(emis),
                                       tp.to_tensor(trans),
                                       tp.to_tensor(lens), bos_eos)
    for b, n in enumerate(lens):
        best, arg = _brute(emis[b], trans, int(n), bos_eos)
        np.testing.assert_allclose(sc.numpy()[b], best, rtol=1e-5)
        got = paths.numpy()[b].tolist()
        assert got[:n] == arg
        # past the length the path repeats its last tag
        assert got[n:] == [arg[-1]] * (len(got) - n)


def test_the_two_jax_viterbi_conventions_are_carried():
    """``text.viterbi_decode`` adds the stop row ``trans[N-2]`` at each
    sequence's last step; ``paddle.viterbi_decode`` (ops.search) adds the
    stop column ``trans[:, -2]`` once. An asymmetric matrix tells them
    apart, and each matches its own JAX function."""
    emis, trans, lens = _inputs(B=2, T=4, N=4, seed=2, lens=(4, 4))
    trans[2, :] += 3.0 * np.arange(4)          # row N-2 != column N-2
    args = [emis, trans, lens]
    row = run_both(lambda e, t, n: jp.text.viterbi_decode(e, t, n),
                   lambda e, t, n: tp.text.viterbi_decode(e, t, n), args,
                   grad=False)
    col = run_both(lambda e, t, n: jp.viterbi_decode(e, t, n),
                   lambda e, t, n: tp.viterbi_decode(e, t, n), args,
                   grad=False)
    assert not np.allclose(row[0].numpy(), col[0].numpy())
    for b in range(2):
        best, _ = _brute(emis[b], trans, 4, True)
        np.testing.assert_allclose(row[0].numpy()[b], best, rtol=1e-5)


def test_viterbi_ties_take_the_first_maximum():
    emis = np.zeros((2, 5, 4), np.float32)
    trans = np.zeros((4, 4), np.float32)
    lens = np.array([5, 2], np.int64)
    for bos_eos in (True, False):
        out = run_both(
            lambda e, t, n: jp.text.viterbi_decode(e, t, n, bos_eos),
            lambda e, t, n: tp.text.viterbi_decode(e, t, n, bos_eos),
            [emis, trans, lens])
        assert out[1].numpy().tolist() == [[0] * 5, [0] * 5]


def test_viterbi_length_one_and_decoder_layer():
    emis, trans, lens = _inputs(B=2, T=3, N=3, seed=3, lens=(1, 1))
    run_both(lambda e, t, n: jp.text.viterbi_decode(e, t, n),
             lambda e, t, n: tp.text.viterbi_decode(e, t, n),
             [emis, trans, lens])
    emis, trans, lens = _inputs(seed=4)
    jd = jp.text.ViterbiDecoder(jp.to_tensor(trans), include_bos_eos_tag=False)
    td = tp.text.ViterbiDecoder(tp.to_tensor(trans), include_bos_eos_tag=False)
    js, jpath = jd(jp.to_tensor(emis), jp.to_tensor(lens))
    ts, tpath = td(tp.to_tensor(emis), tp.to_tensor(lens))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(tpath.numpy(), jpath.numpy())


def test_text_namespace_rebinding():
    import paddle_tpu_torch.text as text
    assert callable(text.viterbi_decode)
    assert text.viterbi_decode is text.viterbi.viterbi_decode
    assert text.viterbi_decode_module.ViterbiDecoder is text.ViterbiDecoder
    assert text.viterbi_decode_module.__all__ == ["viterbi_decode",
                                                  "ViterbiDecoder"]
    jnames = {n for n in dir(jp.text) if not n.startswith("_")}
    assert jnames - set(dir(text)) == set()


def _items(ds, idx):
    item = ds[idx]
    return item if isinstance(item, tuple) else (item,)


@pytest.mark.parametrize("name,kw", [
    ("Imdb", {}), ("Imdb", dict(mode="test", cutoff=40)),
    ("UCIHousing", {}), ("Conll05st", {}), ("Imikolov", {}),
    ("Imikolov", dict(data_type="SEQ")), ("Movielens", dict(rand_seed=3)),
    ("WMT14", {}), ("WMT16", dict(mode="test"))])
def test_text_datasets_are_bit_equal(name, kw):
    jd, td = getattr(jp.text, name)(**kw), getattr(tp.text, name)(**kw)
    assert len(jd) == len(td)
    for idx in (0, len(jd) // 2, len(jd) - 1):
        for a, b in zip(_items(jd, idx), _items(td, idx)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if hasattr(jd, "word_idx"):
        assert jd.word_idx == td.word_idx
    if hasattr(jd, "get_dict"):
        assert jd.get_dict("de", reverse=True) == td.get_dict(
            "de", reverse=True)


_HUBCONF = '''
import paddle_tpu_torch as paddle


def tiny_mlp(width=4):
    """A two-layer MLP."""
    return paddle.nn.Sequential(paddle.nn.Linear(width, 8),
                                paddle.nn.ReLU(), paddle.nn.Linear(8, 2))


def _private():
    return None
'''


def test_hub_local_list_help_load(tmp_path):
    (tmp_path / "hubconf.py").write_text(_HUBCONF)
    assert tp.hub.list(str(tmp_path), source="local") == ["tiny_mlp"]
    assert tp.hub.help(str(tmp_path), "tiny_mlp") == "A two-layer MLP."
    net = tp.hub.load(str(tmp_path), "tiny_mlp", width=6)
    out = net(tp.ones([3, 6]))
    assert out.shape == [3, 2]
    with pytest.raises(ValueError):
        tp.hub.load(str(tmp_path), "absent")


@pytest.mark.parametrize("source", ["github", "gitee"])
def test_hub_remote_sources_raise_as_jax(source):
    for pkg in (jp, tp):
        with pytest.raises(RuntimeError):
            pkg.hub.list("owner/repo", source=source)
        with pytest.raises(RuntimeError):
            pkg.hub.load("owner/repo", "m", source=source)
    with pytest.raises(ValueError):
        tp.hub.list("owner/repo", source="svn")


def test_tensor_namespace_matches_jax():
    assert tp.tensor.random is tp.tensor.creation
    assert tp.tensor.attribute is tp.tensor.manipulation
    missing = {n for n in dir(jp.tensor) if not n.startswith("_")} - \
        set(dir(tp.tensor)) - {"jax", "jnp"}
    assert missing == set()
    x = tp.tensor.to_tensor(np.arange(4.0, dtype=np.float32))
    np.testing.assert_array_equal(tp.tensor.math.add(x, x).numpy(),
                                  2 * np.arange(4.0))


def test_custom_place_constructs_prints_and_compares():
    jc, tc = jp.CustomPlace("npu", 1), tp.CustomPlace("npu", 1)
    assert repr(tc) == repr(jc) == "Place(npu:1)"
    assert tc == tp.CustomPlace("npu", 1)
    assert tc != tp.CustomPlace("npu", 0) and tc != tp.CPUPlace()
    assert hash(tc) == hash(tp.CustomPlace("npu", 1))
    prev = place_mod._current_place
    with pytest.raises(ValueError):
        tp.set_device(tc)
    with pytest.raises(ValueError):
        tp.set_device("npu:0")
    assert place_mod._current_place is prev
