"""Recurrent layers of the eager surface (paddle_tpu_torch.nn.layer.rnn)
against the JAX package on the same weights (bridge.layer_state_from_jax):
SimpleRNN (tanh / relu), LSTM and GRU over layers x directions x
time_major, with and without initial states; the cells, RNN and BiRNN
over a cell; dynamic_decode + BeamSearchDecoder ids; inter-layer
dropout's rate and scale.

Tolerance: float32 outputs, final states and gradients within rtol 1e-4,
atol 1e-5 (torch's recurrence sums in another order than lax.scan);
decoded ids exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.bridge import layer_state_from_jax

from test_torch_parity_util import arr, cpu_place, run_both  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def pair(build):
    jl, tl = build(jnn), build(tnn)
    missing, unexpected = tl.set_state_dict(layer_state_from_jax(jl))
    assert not missing and not unexpected
    assert list(tl.state_dict()) == list(jl.state_dict())
    return jl, tl


def check_param_grads(jl, tl):
    for (n, jpar), (_, tpar) in zip(jl.named_parameters(),
                                    tl.named_parameters()):
        np.testing.assert_allclose(tpar.grad.numpy(), jpar.grad.numpy(),
                                   **TOL, err_msg=n)


MODES = {"rnn_tanh": lambda nn, **kw: nn.SimpleRNN(5, 6, **kw),
         "rnn_relu": lambda nn, **kw: nn.SimpleRNN(5, 6, activation="relu",
                                                   **kw),
         "lstm": lambda nn, **kw: nn.LSTM(5, 6, **kw),
         "gru": lambda nn, **kw: nn.GRU(5, 6, **kw)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("time_major", [False, True], ids=["bt", "tb"])
def test_sequence_layer_matches_jax(mode, direction, layers, time_major):
    jl, tl = pair(lambda nn: MODES[mode](
        nn, num_layers=layers, direction=direction, time_major=time_major))
    x = arr(*((7, 3, 5) if time_major else (3, 7, 5)), seed=1)
    run_both(jl, tl, [x], tol=TOL)
    check_param_grads(jl, tl)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_initial_states_match_jax(mode):
    """Outputs and weight gradients from given initial states. The JAX
    layer unwraps the states (rnn.py:113), so no gradient reaches them
    there; the port's do get one (next test)."""
    jl, tl = pair(lambda nn: MODES[mode](nn, num_layers=2,
                                         direction="bidirect"))
    x = arr(3, 4, 5, seed=2)
    h0 = arr(4, 3, 6, seed=3)
    if mode == "lstm":
        c0 = arr(4, 3, 6, seed=4)
        run_both(lambda a, h, c: jl(a, (h, c)),
                 lambda a, h, c: tl(a, (h, c)), [x, h0, c0], tol=TOL,
                 int_args=(1, 2))
    else:
        run_both(jl, tl, [x, h0], tol=TOL, int_args=(1,))
    check_param_grads(jl, tl)


def test_initial_state_gradient_matches_the_jax_cell_loop():
    """The gradient into h0 / c0 of the port's LSTM equals the JAX
    package's RNN-over-LSTMCell (which passes the states as Tensors)."""
    jl = jnn.RNN(jnn.LSTMCell(5, 6))
    tl = tnn.LSTM(5, 6)
    cell = layer_state_from_jax(jl)
    tl.set_state_dict({f"{k.split('.')[-1]}_l0": v
                       for k, v in cell.items()})
    x, h0, c0 = arr(3, 4, 5, seed=2), arr(3, 6, seed=3), arr(3, 6, seed=4)
    run_both(lambda a, h, c: jl(a, (h, c)),
             lambda a, h, c: (lambda o: (o[0], (o[1][0][0], o[1][1][0])))(
                 tl(a, (h.unsqueeze(0), c.unsqueeze(0)))),
             [x, h0, c0], tol=TOL)


def test_sequence_length_is_read_by_neither():
    """The JAX forward takes sequence_length and never reads it: every
    sequence runs its full length. The port carries that."""
    jl, tl = pair(lambda nn: nn.GRU(5, 6))
    x = arr(2, 6, 5, seed=5)
    lens = np.array([6, 2], np.int64)
    full = tl(tp.to_tensor(x))[0].numpy()
    cut = tl(tp.to_tensor(x), sequence_length=tp.to_tensor(lens))[0].numpy()
    np.testing.assert_array_equal(cut, full)
    want = jl(jp.to_tensor(x), sequence_length=jp.to_tensor(lens))[0]
    np.testing.assert_allclose(cut, want.numpy(), **TOL)


def test_inter_layer_dropout_rate_and_scale():
    """Training-mode dropout between stacked layers: masks are the port
    generator's, so only the rate and the 1/(1-p) scale are held (eval
    mode equals the JAX forward exactly)."""
    tp.seed(0)
    lstm = tnn.LSTM(4, 200, num_layers=2, dropout=0.4)
    x = tp.to_tensor(arr(2, 3, 4, seed=6))
    import paddle_tpu_torch.nn.functional as tF
    orig = tF.dropout
    outs = []

    def spy(v, p=0.5, **kw):
        r = orig(v, p=p, **kw)
        outs.append((v.numpy(), r.numpy(), p))
        return r
    import paddle_tpu_torch.nn.layer.rnn as rnn_mod
    rnn_mod.F.dropout = spy
    try:
        lstm.train()
        lstm(x)
        lstm.eval()
        lstm(x)
    finally:
        rnn_mod.F.dropout = orig
    assert len(outs) == 1                    # train only, between layers
    v, r, p = outs[0]
    assert p == 0.4
    kept = r != 0
    np.testing.assert_allclose(r[kept], v[kept] / 0.6, rtol=1e-6)
    assert abs(1.0 - kept.mean() - 0.4) < 0.05


CELLS = {"SimpleRNNCell": lambda nn: nn.SimpleRNNCell(5, 6),
         "SimpleRNNCell_relu": lambda nn: nn.SimpleRNNCell(
             5, 6, activation="relu"),
         "LSTMCell": lambda nn: nn.LSTMCell(5, 6),
         "GRUCell": lambda nn: nn.GRUCell(5, 6)}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_matches_jax(cell, with_state):
    jl, tl = pair(CELLS[cell])
    x = arr(3, 5, seed=7)
    if not with_state:
        run_both(jl, tl, [x], tol=TOL)
    elif cell == "LSTMCell":
        run_both(lambda a, h, c: jl(a, (h, c)),
                 lambda a, h, c: tl(a, (h, c)),
                 [x, arr(3, 6, seed=8), arr(3, 6, seed=9)], tol=TOL)
    else:
        run_both(jl, tl, [x, arr(3, 6, seed=8)], tol=TOL)
    check_param_grads(jl, tl)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_over_a_cell_matches_jax(reverse, time_major):
    jl, tl = pair(lambda nn: nn.RNN(nn.LSTMCell(5, 6), is_reverse=reverse,
                                    time_major=time_major))
    run_both(jl, tl, [arr(4, 3, 5, seed=10)], tol=TOL)
    check_param_grads(jl, tl)


def test_birnn_matches_jax():
    jl, tl = pair(lambda nn: nn.BiRNN(nn.GRUCell(5, 6), nn.GRUCell(5, 6)))
    run_both(jl, tl, [arr(3, 4, 5, seed=11)], tol=TOL)
    check_param_grads(jl, tl)
    run_both(lambda a, h1, h2: jl(a, (h1, h2)),
             lambda a, h1, h2: tl(a, (h1, h2)),
             [arr(3, 4, 5, seed=11), arr(3, 6, seed=12),
              arr(3, 6, seed=13)], tol=TOL)


def test_rnn_cell_base_initial_states():
    class Cell(tnn.RNNCellBase):
        hidden_size = 7
    ref = tp.to_tensor(arr(4, 3))
    st = Cell().get_initial_states(ref, init_value=0.5)
    assert st.shape == [4, 7] and float(st.numpy().max()) == 0.5
    assert Cell().state_shape == [7]


def _decoder(nn, pkg):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(12, 6)
            self.cell = nn.GRUCell(6, 8)
            self.out = nn.Linear(8, 12)
    net = Net()
    dec = nn.BeamSearchDecoder(net.cell, start_token=0, end_token=11,
                               beam_size=3, embedding_fn=net.emb,
                               output_fn=net.out)
    return net, dec


@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_ids_match_jax(time_major):
    jnet, jdec = _decoder(jnn, jp)
    tnet, tdec = _decoder(tnn, tp)
    tnet.set_state_dict(layer_state_from_jax(jnet))
    h0 = arr(2, 8, seed=14)
    jids, jst, jlen = jnn.dynamic_decode(
        jdec, inits=jp.to_tensor(h0), max_step_num=6,
        output_time_major=time_major, return_length=True)
    tids, tst, tlen = tnn.dynamic_decode(
        tdec, inits=tp.to_tensor(h0), max_step_num=6,
        output_time_major=time_major, return_length=True)
    np.testing.assert_array_equal(tids.numpy(), jids.numpy())
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    np.testing.assert_allclose(tst.numpy(), jst.numpy(), **TOL)
