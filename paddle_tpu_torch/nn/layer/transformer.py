"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention`` keeps paddle's [batch, seq, heads, head_dim]
layout and runs its core through ``nn.functional.
scaled_dot_product_attention``: the flash kernels for no mask or a bool
key-padding mask. As in the JAX package, the attention dropout is handed
to sdpa and not applied there (``dropout_p``; the layer's other dropouts
are).
"""
from __future__ import annotations

import copy

from ...ops import manipulation
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm


def _convert_param_attr_to_list(attr, n):
    if isinstance(attr, (list, tuple)):
        assert len(attr) == n
        return list(attr)
    return [attr] * n


class MultiHeadAttention(Layer):
    """Reference: nn/layer/transformer.py MultiHeadAttention."""

    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        b, s = x.shape[0], x.shape[1]
        return manipulation.reshape(x, [b, s, self.num_heads, self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            pk, pv = cache
            k = manipulation.concat([pk, k], axis=1)
            v = manipulation.concat([pv, v], axis=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = manipulation.reshape(out, [b, s, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        import numpy as np
        from ...core.tensor import Tensor
        b = key.shape[0]
        empty = Tensor(np.zeros((b, 0, self.num_heads, self.head_dim),
                                np.float32))
        return (empty, empty)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [l.gen_cache(src) for l in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, sc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (sc,))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        for i, mod in enumerate(self.layers):
            output = mod(output, memory, tgt_mask, memory_mask,
                         None if cache is None else cache[i])
            if cache is not None:
                output = output[0]
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        import numpy as np
        from ...core.tensor import Tensor
        m = np.triu(np.full((length, length), -np.inf, np.float32), k=1)
        return Tensor(m)
