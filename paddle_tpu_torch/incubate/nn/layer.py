"""Fused layers (counterpart of ``paddle_tpu/incubate/nn/layer.py``):
eager-surface ``Layer``s over the fused functionals, with the JAX
package's parameter names, shapes and initializers."""
from __future__ import annotations

from ...nn.initializer import Constant
from ...nn.layer.layers import Layer
from . import functional as F

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedFeedForward",
    "FusedMultiHeadAttention", "FusedBiasDropoutResidualLayerNorm",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer",
]


class FusedLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              self.transpose_weight)


class FusedDropoutAdd(Layer):
    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F.fused_dropout_add(x, y, self.p, self.training, self.mode)


class FusedBiasDropoutResidualLayerNorm(Layer):
    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = self.create_parameter([embed_dim], attr=bias_attr,
                                                 is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr, default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)

    def forward(self, x, residual):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            self.dropout_rate, self.epsilon, self.training)


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        one = Constant(1.0)
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate \
            if act_dropout_rate is not None else dropout_rate
        self.epsilon = epsilon
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr)
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr)
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True)
        self.ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr, default_initializer=one)
        self.ln1_bias = self.create_parameter([d_model], is_bias=True)
        self.ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr, default_initializer=one)
        self.ln2_bias = self.create_parameter([d_model], is_bias=True)

    def forward(self, src, cache=None):
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            self.linear1_bias, self.linear2_bias, self.ln1_scale,
            self.ln1_bias, self.ln2_scale, self.ln2_bias,
            self.act_dropout_rate, self.dropout_rate, self.activation,
            self.epsilon, self.epsilon, self.normalize_before,
            self.training)


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        one = Constant(1.0)
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr)
        self.qkv_bias = self.create_parameter(
            [3 * embed_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr)
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr, default_initializer=one)
        self.pre_ln_bias = self.create_parameter([embed_dim], is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr, default_initializer=one)
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            self.normalize_before, self.pre_ln_scale, self.pre_ln_bias,
            self.ln_scale, self.ln_bias, self.epsilon, self.qkv_bias,
            self.linear_bias, cache, attn_mask, self.dropout_rate,
            self.attn_dropout_rate, self.epsilon, self.training)


class FusedTransformerEncoderLayer(Layer):
    """Fused MHA then fused FFN (reference
    FusedTransformerEncoderLayer)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate,
            attn_dropout_rate if attn_dropout_rate is not None
            else dropout_rate, normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate, activation=activation,
            act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """Refused, as in the JAX package: stack
    ``FusedTransformerEncoderLayer``s."""

    def __init__(self, *a, **kw):
        super().__init__()
        raise NotImplementedError(
            "stack FusedTransformerEncoderLayer layers (or "
            "nn.TransformerEncoder); the single-call decoder stack is not "
            "carried")
