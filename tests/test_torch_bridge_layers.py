"""The eager-surface weight bridge for conv, batch-norm-2D and recurrent
layers (bridge.layer_state_from_jax / layer_state_to_numpy): JAX
parameters -> the port's layer -> back into a fresh JAX layer gives the
same JAX forward, bit for bit, and the port's forward on the carried
weights equals the JAX one.

Tolerance: the round trip exactly; the port's forward within rtol 1e-4,
atol 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.bridge import layer_state_from_jax, layer_state_to_numpy

from test_torch_parity_util import arr, cpu_place  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):
    yield


def _out(o):
    return o[0] if isinstance(o, tuple) else o


LAYERS = {
    "conv2d": (lambda nn: nn.Conv2D(3, 4, 3, padding=1), (2, 3, 6, 6)),
    "conv1d_transpose": (lambda nn: nn.Conv1DTranspose(3, 2, 3, stride=2),
                         (2, 3, 5)),
    "conv3d": (lambda nn: nn.Conv3D(2, 3, 2), (1, 2, 4, 4, 4)),
    "batchnorm2d": (lambda nn: nn.BatchNorm2D(3), (2, 3, 4, 4)),
    "lstm_bidir_2layer": (lambda nn: nn.LSTM(5, 4, num_layers=2,
                                             direction="bidirect"),
                          (2, 6, 5)),
    "gru": (lambda nn: nn.GRU(5, 4), (2, 6, 5)),
    "simple_rnn": (lambda nn: nn.SimpleRNN(5, 4), (2, 6, 5)),
    "gru_cell": (lambda nn: nn.GRUCell(5, 4), (3, 5)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_round_trip_keeps_the_jax_forward(case):
    build, shape = LAYERS[case]
    x = arr(*shape, seed=1)
    jl = build(jnn)
    if case == "batchnorm2d":        # running stats that are not 0 / 1
        jl.train()
        jl(jp.to_tensor(arr(*shape, seed=2) * 3 + 1))
    jl.eval()
    want = _out(jl(jp.to_tensor(x))).numpy()
    tl = build(tnn)
    missing, unexpected = tl.set_state_dict(layer_state_from_jax(jl))
    assert not missing and not unexpected
    tl.eval()
    np.testing.assert_allclose(_out(tl(tp.to_tensor(x))).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    back = build(jnn)
    back.set_state_dict({k: jp.to_tensor(v)
                         for k, v in layer_state_to_numpy(tl).items()})
    back.eval()
    np.testing.assert_array_equal(_out(back(jp.to_tensor(x))).numpy(), want)
    names = list(layer_state_to_numpy(tl))
    if case.startswith("lstm"):
        assert "weight_ih_l1_reverse" in names and "bias_hh_l0" in names
    if case == "batchnorm2d":
        assert names == ["weight", "bias", "_mean", "_variance"]
