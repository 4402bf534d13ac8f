"""paddle.onnx.export of the port (counterpart of
``paddle_tpu/onnx/__init__.py``): a self-contained ONNX exporter.

A layer walk by class name emits ONNX ModelProto directly in the
protobuf wire format (``_proto.py``), with no dependency on the onnx
package. Covered: Sequential / LayerList (and torch's ModuleList),
Linear, Conv2D, BatchNorm2D, MaxPool2D / AvgPool2D, Flatten, Dropout
(dropped at export: inference semantics), LayerNorm, Embedding,
ReLU / Tanh / Sigmoid / Softmax / LeakyReLU / GELU, and BERT's
``BertSelfAttention`` / ``BertEncoderLayer``. Anything else raises, with
``paddle.jit.save`` (a ``torch.export`` program) as the way out.

Each layer's weights are read in its own layout: a surface ``Linear``
keeps paddle's [in, out], a ``torch.nn.Linear`` of the port's text
models torch's [out, in], which is transposed here (a square linear
would take the wrong one without a shape error). The exported graph is
the JAX exporter's, node for node, for the same weights.

A Flatten node is inserted automatically when a rank>2 activation meets
a Linear, so conv stacks like LeNet's Sequential export directly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _proto as P

__all__ = ["export"]


def _np(t):
    """A weight (surface Tensor or torch tensor) as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _linear_weight(lyr):
    """A linear's weight as [in, out]: a torch ``nn.Linear`` keeps
    [out, in]."""
    w = _np(lyr.weight)
    return w.T if isinstance(lyr, torch.nn.Module) else w


def _norm_attrs(lyr):
    """(normalized shape, epsilon) of a surface LayerNorm or of the port's
    module ``nn._modules.LayerNorm``."""
    if isinstance(lyr, torch.nn.Module):
        return list(lyr.normalized_shape), float(lyr.epsilon)
    return list(lyr._normalized_shape), float(lyr._epsilon)


def _pair(v):
    if isinstance(v, (tuple, list)):
        return [int(v[0]), int(v[1])]
    return [int(v), int(v)]


class _Exporter:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self.n = 0
        # lowest opset the emitted op set is valid under (Gelu: 20,
        # LayerNormalization: 17); export() stamps max(this, requested)
        self.min_opset = 13

    def name(self, kind):
        self.n += 1
        return f"{kind}_{self.n}"

    def add_init(self, name, arr):
        arr = np.asarray(arr)
        if arr.dtype not in (np.dtype(np.int64), np.dtype(np.int32)):
            arr = arr.astype(np.float32)
        self.inits.append(P.tensor_proto(name, arr))

    def emit(self, op, inputs, attrs=b""):
        if op == "Gelu":
            self.min_opset = max(self.min_opset, 20)
        out = self.name(op.lower())
        self.nodes.append(P.node_proto(op, inputs, [out],
                                       name=self.name(op), attrs=attrs))
        return out

    # -- per-layer emitters -------------------------------------------------
    def linear(self, lyr, x, shape):
        w = _linear_weight(lyr)  # [in, out]
        in_f = w.shape[0]
        if len(shape) > 2:
            tail = int(np.prod(shape[1:]))
            if shape[-1] == in_f:
                # paddle Linear contracts the LAST dim on rank>2 inputs:
                # rank-preserving MatMul (+ Add for bias) — Gemm/Flatten
                # would contract prod(shape[1:]) and be silently wrong
                wn = self.name("w")
                self.add_init(wn, w)
                out = self.emit("MatMul", [x, wn])
                if lyr.bias is not None:
                    bn = self.name("b")
                    self.add_init(bn, _np(lyr.bias))
                    out = self.emit("Add", [out, bn])
                return out, list(shape[:-1]) + [w.shape[1]]
            if tail != in_f:
                raise NotImplementedError(
                    f"onnx.export: Linear(in={in_f}) fed a rank-"
                    f"{len(shape)} activation of shape {shape}: neither "
                    "the last dim nor the flattened width matches")
            x = self.emit("Flatten", [x],
                          P._attr_wrap([P.attr_int("axis", 1)]))
            shape = [shape[0], tail]
        wn = self.name("w")
        self.add_init(wn, w)
        ins = [x, wn]
        if lyr.bias is not None:
            bn = self.name("b")
            self.add_init(bn, _np(lyr.bias))
            ins.append(bn)
        out = self.emit("Gemm", ins)
        return out, [shape[0], w.shape[1]]

    def conv2d(self, lyr, x, shape):
        w = _np(lyr.weight)  # [out, in/g, kh, kw] — ONNX Conv layout
        pad = lyr._padding
        if isinstance(pad, str):
            raise NotImplementedError(
                f"onnx.export: string padding {pad!r} is not supported; "
                "use explicit integer padding")
        ph, pw = _pair(pad)
        sh, sw = [int(s) for s in lyr._stride]
        dh, dw = [int(d) for d in lyr._dilation]
        kh, kw = w.shape[2], w.shape[3]
        wn = self.name("w")
        self.add_init(wn, w)
        ins = [x, wn]
        if lyr.bias is not None:
            bn = self.name("b")
            self.add_init(bn, _np(lyr.bias))
            ins.append(bn)
        attrs = P._attr_wrap([
            P.attr_ints("kernel_shape", [kh, kw]),
            P.attr_ints("strides", [sh, sw]),
            P.attr_ints("pads", [ph, pw, ph, pw]),
            P.attr_ints("dilations", [dh, dw]),
            P.attr_int("group", int(lyr._groups)),
        ])
        out = self.emit("Conv", ins, attrs)
        oh = (shape[2] + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        ow = (shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        return out, [shape[0], w.shape[0], oh, ow]

    def pool2d(self, lyr, x, shape, op):
        if getattr(lyr, "ceil_mode", False):
            raise NotImplementedError("onnx.export: ceil_mode pooling")
        kh, kw = _pair(lyr.kernel_size)
        sh, sw = _pair(lyr.stride if lyr.stride is not None
                       else lyr.kernel_size)
        ph, pw = _pair(lyr.padding)
        attrs = P._attr_wrap([
            P.attr_ints("kernel_shape", [kh, kw]),
            P.attr_ints("strides", [sh, sw]),
            P.attr_ints("pads", [ph, pw, ph, pw]),
        ])
        out = self.emit(op, [x], attrs)
        oh = (shape[2] + 2 * ph - kh) // sh + 1
        ow = (shape[3] + 2 * pw - kw) // sw + 1
        return out, [shape[0], shape[1], oh, ow]

    def batchnorm(self, lyr, x, shape):
        names = []
        for suffix, arr in [("scale", _np(lyr.weight)),
                            ("bias", _np(lyr.bias)),
                            ("mean", _np(lyr._mean)),
                            ("var", _np(lyr._variance))]:
            n = self.name(suffix)
            self.add_init(n, arr)
            names.append(n)
        attrs = P._attr_wrap([P.attr_float("epsilon",
                                           float(lyr._epsilon))])
        return self.emit("BatchNormalization", [x] + names, attrs), shape

    def layer_norm(self, lyr, x, shape):
        """ONNX LayerNormalization (opset 17) over the trailing dims."""
        self.min_opset = max(self.min_opset, 17)
        shape_, eps = _norm_attrs(lyr)
        parts = [x]
        for t, fill in ((lyr.weight, 1.0), (lyr.bias, 0.0)):
            n = self.name("ln")
            self.add_init(n, _np(t) if t is not None
                          else np.full(shape_, fill, np.float32))
            parts.append(n)
        attrs = P._attr_wrap([
            P.attr_int("axis", -len(shape_)),
            P.attr_float("epsilon", eps)])
        return self.emit("LayerNormalization", parts, attrs), shape

    def embedding(self, lyr, x, shape):
        """int ids -> Gather over the [num, dim] table (axis 0)."""
        wn = self.name("embed")
        self.add_init(wn, _np(lyr.weight))
        out = self.emit("Gather", [wn, x],
                        P._attr_wrap([P.attr_int("axis", 0)]))
        return out, list(shape) + [int(lyr.weight.shape[1])]

    def _transpose(self, x, perm):
        return self.emit("Transpose", [x],
                         P._attr_wrap([P.attr_ints("perm", perm)]))

    def _reshape(self, x, tgt):
        sn = self.name("shape")
        self.add_init(sn, np.asarray(
            [0 if d is None else int(d) for d in tgt], np.int64))
        return self.emit("Reshape", [x, sn])

    def bert_attention(self, lyr, x, shape):
        """BertSelfAttention decomposed to MatMul/Reshape/Transpose/
        Softmax primitives: the fused qkv weight is SLICED into per-head
        q/k/v mats at export time, scores = softmax(q k^T / sqrt(d))."""
        b, s, hmod = shape
        heads, hd = lyr.num_heads, lyr.head_dim
        w = _linear_weight(lyr.qkv)               # [h, 3h]
        bias = _np(lyr.qkv.bias) if lyr.qkv.bias is not None else None
        pieces = []
        for i, nm in enumerate(("q", "k", "v")):
            wn = self.name(f"w{nm}")
            self.add_init(wn, w[:, i * hmod:(i + 1) * hmod])
            part = self.emit("MatMul", [x, wn])
            if bias is not None:
                bn = self.name(f"b{nm}")
                self.add_init(bn, bias[i * hmod:(i + 1) * hmod])
                part = self.emit("Add", [part, bn])
            part = self._reshape(part, [None, s, heads, hd])
            pieces.append(self._transpose(part, [0, 2, 1, 3]))
        q, k, v = pieces                         # [b, heads, s, hd]
        kt = self._transpose(k, [0, 1, 3, 2])
        scores = self.emit("MatMul", [q, kt])
        sc = self.name("scale")
        self.add_init(sc, np.float32(1.0 / np.sqrt(hd)))
        scores = self.emit("Mul", [scores, sc])
        probs = self.emit("Softmax", [scores],
                          P._attr_wrap([P.attr_int("axis", -1)]))
        ctx = self.emit("MatMul", [probs, v])    # [b, heads, s, hd]
        ctx = self._transpose(ctx, [0, 2, 1, 3])
        ctx = self._reshape(ctx, [None, s, hmod])
        return self.linear(lyr.out, ctx, [b, s, hmod])

    def bert_layer(self, lyr, x, shape):
        """BertEncoderLayer: post-LN residual attention + GELU FFN
        (dropout dropped — inference export)."""
        attn, _ = self.bert_attention(lyr.attention, x, shape)
        x = self.emit("Add", [x, attn])
        x, _ = self.layer_norm(lyr.attn_norm, x, shape)
        h, hshape = self.linear(lyr.fc1, x, shape)
        h = self.emit("Gelu", [h])
        h, _ = self.linear(lyr.fc2, h, hshape)
        x = self.emit("Add", [x, h])
        return self.layer_norm(lyr.ffn_norm, x, shape)

    def walk(self, layer, x, shape):
        kind = type(layer).__name__
        simple = {"ReLU": "Relu", "Tanh": "Tanh", "Sigmoid": "Sigmoid",
                  "LeakyReLU": "LeakyRelu", "GELU": "Gelu"}
        if kind in ("Sequential", "LayerList", "ModuleList"):
            for _, child in layer.named_children():
                x, shape = self.walk(child, x, shape)
            return x, shape
        if kind == "LayerNorm":
            return self.layer_norm(layer, x, shape)
        if kind == "Embedding":
            return self.embedding(layer, x, shape)
        if kind == "BertSelfAttention":
            return self.bert_attention(layer, x, shape)
        if kind == "BertEncoderLayer":
            return self.bert_layer(layer, x, shape)
        if kind == "Linear":
            return self.linear(layer, x, shape)
        if kind == "Conv2D":
            return self.conv2d(layer, x, shape)
        if kind == "MaxPool2D":
            return self.pool2d(layer, x, shape, "MaxPool")
        if kind == "AvgPool2D":
            return self.pool2d(layer, x, shape, "AveragePool")
        if kind == "BatchNorm2D":
            return self.batchnorm(layer, x, shape)
        if kind == "Flatten":
            r = len(shape)
            s = int(layer.start_axis) % r
            e = int(layer.stop_axis) % r
            new_shape = list(shape[:s]) + \
                [int(np.prod(shape[s:e + 1]))] + list(shape[e + 1:])
            if s == 1 and e == r - 1:
                # exactly ONNX Flatten(axis=1) semantics
                out = self.emit("Flatten", [x], P._attr_wrap(
                    [P.attr_int("axis", 1)]))
                return out, new_shape
            # general (start, stop) range: ONNX Flatten collapses the
            # WHOLE tensor to 2-D around one axis — not the same op.
            # Emit Reshape with a static target (0 = copy input dim,
            # covering symbolic batch dims)
            tgt = np.asarray([0 if d is None else int(d)
                              for d in new_shape], np.int64)
            sn = self.name("shape")
            self.add_init(sn, tgt)
            out = self.emit("Reshape", [x, sn])
            return out, new_shape
        if kind == "Softmax":
            axis = int(getattr(layer, "_axis", -1))
            return self.emit("Softmax", [x], P._attr_wrap(
                [P.attr_int("axis", axis)])), shape
        if kind.startswith("Dropout"):
            return x, shape  # inference export: identity
        if kind in simple:
            return self.emit(simple[kind], [x]), shape
        raise NotImplementedError(
            f"onnx.export: layer {kind} is not supported by the minimal "
            "exporter; supported: Sequential/LayerList/Linear/Conv2D/"
            "BatchNorm2D/MaxPool2D/AvgPool2D/Flatten/Dropout/LayerNorm/"
            "Embedding/BertSelfAttention/BertEncoderLayer/activations. "
            "For arbitrary models use paddle.jit.save (a torch.export "
            "program).")


def export(layer, path, input_spec=None, opset_version=13, **configs):
    """Export a Sequential-composed Layer to ``path + '.onnx'``
    (reference: paddle.onnx.export signature and file-naming behavior,
    python/paddle/onnx/export.py:35).

    input_spec: [InputSpec] or a [shape] list — the first entry fixes
    the graph input shape. Returns the written filename.
    """
    if input_spec is None or not input_spec:
        raise ValueError(
            "onnx.export requires input_spec=[InputSpec([...])] to fix "
            "the graph input shape")
    spec = input_spec[0]
    # None / -1 dims stay symbolic (ONNX dim_param): shape arithmetic
    # below never consumes the batch dim, so it flows through untouched
    shape = [int(d) if d is not None and int(d) > 0 else None
             for d in getattr(spec, "shape", spec)]
    in_dtype = str(getattr(spec, "dtype", "float32"))
    in_elem = P.INT64 if "int64" in in_dtype else (
        P.INT32 if "int32" in in_dtype else P.FLOAT)
    ex = _Exporter()
    out, out_shape = ex.walk(layer, "input", shape)
    graph = P.graph_proto(
        ex.nodes, "paddle_tpu_torch_graph", ex.inits,
        [P.value_info("input", in_elem, shape)],
        [P.value_info(out, P.FLOAT, out_shape)])
    # never stamp an opset the emitted ops are invalid under (Gelu
    # needs 20, LayerNormalization 17 — onnx.checker would reject)
    model = P.model_proto(graph, opset=max(int(opset_version),
                                           ex.min_opset))
    fname = path if path.endswith(".onnx") else path + ".onnx"
    with open(fname, "wb") as f:
        f.write(model)
    return fname
