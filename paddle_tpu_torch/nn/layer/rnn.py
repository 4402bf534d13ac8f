"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``):
SimpleRNN / LSTM / GRU, their cells, ``RNN`` / ``BiRNN`` over a cell,
``RNNCellBase``, ``BeamSearchDecoder`` and ``dynamic_decode``.

Weights are the JAX layers': per layer and direction ``weight_ih_l{k}``
[G*H, in], ``weight_hh_l{k}`` [G*H, H], ``bias_ih_l{k}`` and
``bias_hh_l{k}`` [G*H] (``_reverse`` for the backward direction), every
one U(-1/sqrt(H), 1/sqrt(H)). The gate orders are torch's (LSTM i, f, g,
o; GRU r, z, n with r applied to W_hn h + b_hn), so the sequence layers
run torch's own recurrence op one stacked layer at a time, both
directions in one call, with the four weights of each direction as they
are: cuDNN on the card (which packs the four into its flat layout at
each call), torch's loop on the CPU, one body for both. The
inter-layer dropout (every layer's output but the last, in training) is
``nn.functional.dropout`` between the calls, so its mask comes from the
port's generator: the JAX package's threefry masks cannot be
reproduced, the rate and the 1/(1 - p) scale are the same. As in the JAX
layers, ``sequence_length`` is taken and not read: every sequence runs
its full length. The cells run the JAX step functions in torch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dispatch import run_op, unwrap, wrap
from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _lstm_step(carry, x_t, wi, wh, bi, bh):
    h, c = carry
    i, f, g, o = torch.chunk(x_t @ wi.T + h @ wh.T + bi + bh, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def _gru_step(carry, x_t, wi, wh, bi, bh):
    h = carry
    ri, ui, ci = torch.chunk(x_t @ wi.T + bi, 3, dim=-1)
    rh, uh, ch = torch.chunk(h @ wh.T + bh, 3, dim=-1)
    r = torch.sigmoid(ri + rh)
    u = torch.sigmoid(ui + uh)
    h = u * h + (1.0 - u) * torch.tanh(ci + r * ch)
    return h, h


def _rnn_step_tanh(carry, x_t, wi, wh, bi, bh):
    h = torch.tanh(x_t @ wi.T + carry @ wh.T + bi + bh)
    return h, h


def _rnn_step_relu(carry, x_t, wi, wh, bi, bh):
    h = torch.relu(x_t @ wi.T + carry @ wh.T + bi + bh)
    return h, h


#: mode -> (cell step, gates, has a cell state, torch's recurrence op)
_STEPS = {"LSTM": (_lstm_step, 4, True, torch._VF.lstm),
          "GRU": (_gru_step, 3, False, torch._VF.gru),
          "RNN_TANH": (_rnn_step_tanh, 1, False, torch._VF.rnn_tanh),
          "RNN_RELU": (_rnn_step_relu, 1, False, torch._VF.rnn_relu)}


class RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = float(dropout)
        self.bidirect = direction != "forward"
        self.num_directions = 2 if self.bidirect else 1
        _, gates, self.has_cell, _ = _STEPS[mode]
        std = 1.0 / math.sqrt(hidden_size)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                for nm, shape in (
                        (f"weight_ih{sfx}", [gates * hidden_size, in_sz]),
                        (f"weight_hh{sfx}",
                         [gates * hidden_size, hidden_size]),
                        (f"bias_ih{sfx}", [gates * hidden_size]),
                        (f"bias_hh{sfx}", [gates * hidden_size])):
                    setattr(self, nm, self.create_parameter(
                        shape, default_initializer=I.Uniform(-std, std)))

    def _layer_params(self, layer, d):
        sfx = f"_l{layer}" + ("_reverse" if d else "")
        return [getattr(self, f"{nm}{sfx}")
                for nm in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _, _, has_cell, op = _STEPS[self.mode]
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        if initial_states is None:
            b = unwrap(inputs).shape[1 if self.time_major else 0]
            z = torch.zeros((L * D, b, H), dtype=unwrap(inputs).dtype,
                            device=unwrap(inputs).device)
            inits = [z, z] if has_cell else [z]
        else:
            inits = list(initial_states) if has_cell else [initial_states]
        batch_first = not self.time_major
        out = inputs
        hs, cs = [], []
        for layer in range(L):
            params = [p for d in range(D)
                      for p in self._layer_params(layer, d)]
            rows = slice(layer * D, layer * D + D)

            def fn(x, *arrs):
                ws, st = list(arrs[:4 * D]), arrs[4 * D:]
                hx = tuple(s[rows] for s in st) if has_cell \
                    else st[0][rows]
                # train=True keeps cuDNN's reserve for the backward
                res = op(x, hx, ws, True, 1, 0.0, torch.is_grad_enabled(),
                         D == 2, batch_first)
                return tuple(res)
            res = run_op(self.mode.lower(), fn, [out] + params + inits)
            out = res[0]
            hs.append(res[1])
            if has_cell:
                cs.append(res[2])
            if self.training and self.dropout > 0 and layer < L - 1:
                out = F.dropout(out, p=self.dropout, training=True)
        from ...ops.manipulation import concat
        h_n = concat(hs, axis=0) if L > 1 else hs[0]
        if has_cell:
            return out, (h_n, concat(cs, axis=0) if L > 1 else cs[0])
        return out, h_n


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class _CellBase(Layer):
    def __init__(self, mode, input_size, hidden_size):
        super().__init__()
        _, gates, self.has_cell, _ = _STEPS[mode]
        self.mode = mode
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size],
            default_initializer=I.Uniform(-std, std))
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size],
            default_initializer=I.Uniform(-std, std))
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], is_bias=True,
            default_initializer=I.Uniform(-std, std))
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], is_bias=True,
            default_initializer=I.Uniform(-std, std))

    def forward(self, inputs, states=None):
        step_fn, _, has_cell, _ = _STEPS[self.mode]
        H = self.hidden_size

        def fn(x, wi, wh, bi, bh, *ss):
            if ss:
                carry = (ss[0], ss[1]) if has_cell else ss[0]
            else:
                z = torch.zeros((x.shape[0], H), dtype=x.dtype,
                                device=x.device)
                carry = (z, z) if has_cell else z
            carry, y = step_fn(carry, x, wi, wh, bi, bh)
            return (y,) + tuple(carry) if has_cell else (y, carry)

        extra = []
        if states is not None:
            extra = list(states) if isinstance(states, (tuple, list)) \
                else [states]
        res = run_op(self.mode.lower() + "_cell", fn,
                     [inputs, self.weight_ih, self.weight_hh,
                      self.bias_ih, self.bias_hh] + extra)
        if has_cell:
            y, h, c = res
            return y, (h, c)
        return res[0], res[1]


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__("RNN_RELU" if activation == "relu"
                         else "RNN_TANH", input_size, hidden_size)


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__("LSTM", input_size, hidden_size)


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__("GRU", input_size, hidden_size)


class RNN(Layer):
    """A cell run over the time axis, one step a call."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops import manipulation as M
        axis = 0 if self.time_major else 1
        T = inputs.shape[axis]
        states = initial_states
        outs = []
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        for t in steps:
            x_t = M.squeeze(M.slice(inputs, [axis], [t], [t + 1]), [axis])
            y, states = self.cell(x_t, states)
            outs.append(y)
        if self.is_reverse:
            outs = outs[::-1]
        return M.stack(outs, axis=axis), states


class RNNCellBase(Layer):
    """Base of user-defined cells: ``get_initial_states`` and the
    (inputs, states) -> (outputs, states) step contract."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ...ops.creation import full
        batch = batch_ref.shape[batch_dim_idx]
        shape = list(shape) if shape is not None \
            else [getattr(self, "hidden_size", 0)]
        if shape and shape[0] == -1:
            shape = shape[1:]
        return full([batch] + list(shape), init_value, dtype or "float32")

    @property
    def state_shape(self):
        return [getattr(self, "hidden_size", 0)]


class BiRNN(Layer):
    """Two cells over the sequence, forward and reversed, outputs
    concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat
        st_fw, st_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, fin_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, fin_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return concat([out_fw, out_bw], axis=-1), (fin_fw, fin_bw)


class BeamSearchDecoder(Layer):
    """Beam search over a cell; ``dynamic_decode`` runs its time loop on
    the host, as the JAX package's does."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run a BeamSearchDecoder to the end: (ids [B, T, beam] backtraced
    through gather_tree, final states[, lengths])."""
    from ...core.tensor import to_tensor
    from ...ops.manipulation import cast
    cell = decoder.cell
    W = decoder.beam_size
    max_steps = int(max_step_num if max_step_num is not None else 100)
    if inits is None:
        raise ValueError("dynamic_decode needs initial cell states")
    first = inits[0] if isinstance(inits, (tuple, list)) else inits
    B = first.shape[0]

    def tile(t):
        return wrap(unwrap(t).repeat_interleave(W, dim=0))
    states = tuple(tile(s) for s in inits) \
        if isinstance(inits, (tuple, list)) else tile(inits)
    dev = unwrap(first).device
    tokens = np.full((B * W,), decoder.start_token, np.int64)
    # only beam 0 is live at t=0, so identical beams share no probability
    log_probs = np.full((B, W), -1e9, np.float32)
    log_probs[:, 0] = 0.0
    finished = np.zeros((B, W), bool)
    lengths = np.zeros((B, W), np.int64)
    ids_steps, parent_steps = [], []
    for _ in range(max_steps):
        tok = to_tensor(tokens, place=str(dev))
        emb = decoder.embedding_fn(tok) if decoder.embedding_fn is not None \
            else cast(tok.reshape([-1, 1]), "float32")
        out, states = cell(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn is not None \
            else out
        lp = unwrap(F.log_softmax(logits, axis=-1)).detach().cpu().numpy()
        V = lp.shape[-1]
        lp = lp.reshape(B, W, V)
        # a finished beam extends only with end_token, at no cost
        fin_row = np.full((V,), -1e30, np.float32)
        fin_row[decoder.end_token] = 0.0
        lp = np.where(finished[:, :, None], fin_row[None, None, :], lp)
        flat = (log_probs[:, :, None] + lp).reshape(B, W * V)
        top_idx = np.argsort(-flat, axis=1)[:, :W]
        log_probs = np.take_along_axis(flat, top_idx, axis=1)
        parents = top_idx // V
        words = top_idx % V
        finished = np.take_along_axis(finished, parents, axis=1) \
            | (words == decoder.end_token)
        lengths = np.take_along_axis(lengths, parents, axis=1) + \
            (~finished).astype(np.int64)
        ids_steps.append(words)
        parent_steps.append(parents)
        gather = torch.as_tensor(
            (np.arange(B)[:, None] * W + parents).reshape(-1), device=dev)

        def reorder(s):
            return wrap(unwrap(s)[gather])
        states = tuple(reorder(s) for s in states) \
            if isinstance(states, (tuple, list)) else reorder(states)
        tokens = words.reshape(-1)
        if finished.all():
            break
    ids = to_tensor(np.stack(ids_steps), place=str(dev))
    par = to_tensor(np.stack(parent_steps), place=str(dev))
    traced = F.gather_tree(ids, par)
    if not output_time_major:
        traced = traced.transpose([1, 0, 2])
    if return_length:
        return traced, states, to_tensor(lengths, place=str(dev))
    return traced, states
