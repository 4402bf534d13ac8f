"""Op registry of the port (counterpart of ``paddle_tpu/ops/registry.py``):
loads ``ops.yaml`` and validates it against the port's op modules.

``ops.yaml`` lists every public op of the 14 op modules (the JAX
package's list, with the port's differences: ROADMAP section 3), one
flat record each (``op``, ``module``, ``args`` or ``alias_of``,
``tensor_method``). ``validate()`` raises when the registry and the
modules drifted apart in either direction; ``coverage()`` accounts for
the reference's op list (``reference_ops.txt``). The records are read by
hand (``_parse``), so the registry needs no YAML library.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List

_DIR = os.path.dirname(os.path.abspath(__file__))
OPS_YAML = os.path.join(_DIR, "ops.yaml")
REF_OPS = os.path.join(_DIR, "reference_ops.txt")


def _scalar(raw: str):
    """A YAML scalar as ops.yaml writes them: single-quoted ('' an
    escaped quote), true / false, or plain."""
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1].replace("''", "'")
    if raw in ("true", "false"):
        return raw == "true"
    return raw


def _parse(text: str) -> List[dict]:
    """The records of ops.yaml: a list of flat mappings (``- op: x``, then
    ``  key: value`` lines; a more-indented line continues the value
    before it, folded with one space)."""
    records, raw, key = [], None, None
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line.startswith("- "):
            raw = {}
            records.append(raw)
            line = "  " + line[2:]
        if line.startswith("    "):
            raw[key] += " " + line.strip()
            continue
        key, _, value = line.strip().partition(":")
        raw[key] = value.strip()
    return [{k: _scalar(v) for k, v in r.items()} for r in records]


@lru_cache(maxsize=1)
def load() -> List[dict]:
    with open(OPS_YAML) as f:
        return _parse(f.read())


@lru_cache(maxsize=1)
def reference_op_names() -> List[str]:
    with open(REF_OPS) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def _modules() -> Dict[str, object]:
    from .. import fft as _fft
    from .. import geometric as _geo
    from .. import ops
    from .. import signal as _signal
    from ..nn import functional as F
    from ..quantization import functional as _qf
    from ..vision import ops as _vops
    return {
        "math": ops.math, "creation": ops.creation,
        "manipulation": ops.manipulation, "logic": ops.logic,
        "search": ops.search, "stat": ops.stat, "linalg": ops.linalg,
        "nn.functional": F,
        "fft": _fft, "signal": _signal, "geometric": _geo,
        "vision.ops": _vops, "quantization.functional": _qf,
        "inplace": ops.inplace,
    }


def validate() -> None:
    """Raise if ops.yaml and the op modules drifted apart."""
    mods = _modules()
    registered = {}
    problems = []
    for e in load():
        mod = mods.get(e["module"])
        if mod is None:
            problems.append(f"unknown module {e['module']} for {e['op']}")
            continue
        fn = getattr(mod, e["op"], None)
        if not callable(fn):
            problems.append(
                f"{e['module']}.{e['op']} registered but not implemented")
        registered.setdefault(e["module"], set()).add(e["op"])
    import inspect
    for mod_name, mod in mods.items():
        have = registered.get(mod_name, set())
        for name in dir(mod):
            if name.startswith("_") or name in have:
                continue
            fn = getattr(mod, name)
            if not callable(fn) or isinstance(fn, type) or \
                    inspect.ismodule(fn):
                continue
            if not (getattr(fn, "__module__", "") or "").startswith(
                    "paddle_tpu_torch"):
                continue
            problems.append(
                f"{mod_name}.{name} implemented but not in ops.yaml")
    if problems:
        raise RuntimeError("op registry drift:\n  " +
                           "\n  ".join(problems[:40]))


# reference ops with no counterpart by design, the JAX package's list
# (collectives are the distributed package's calls, not ops; the device
# and stream ops are ``paddle.device``'s; PS / legacy-CTR infrastructure
# is out of scope; the CUDA-runtime weight formats belong to the
# quantization package)
_NOT_APPLICABLE_PREFIXES = (
    "c_", "partial_", "barrier", "distributed_", "global_scatter",
    "global_gather", "push_", "pull_", "send_", "recv_", "memcpy",
    "get_tensor_from_selected_rows", "dgc", "nop", "share_data",
    # PS / legacy CTR serving stack
    "pyramid_hash", "tdm_", "shuffle_batch", "cvm", "batch_fc",
    "rank_attention", "match_matrix_tensor", "lookup_table_dequant",
    "attention_lstm", "im2sequence", "sequence_conv", "sequence_pool",
    "crf_decoding", "ctc_align",
    # CUDA-runtime-specific paths
    "cudnn_lstm", "npu_identity", "sync_calc_stream", "depend", "data",
    "apply_per_channel_scale", "coalesce_tensor", "merge_selected_rows",
    "copy_to", "sparse_attention", "calc_reduced_attn_scores",
    # IO ops handled by the Python data pipeline
    "read_file", "decode_jpeg",
)

# reference ops whose CAPABILITY lives in another subsystem of this
# framework (the reference exposes them as kernel-level ops because its
# optimizer/amp/moe/fft run op-by-op; here they are module APIs)
_COVERED_BY = {
    # quantized execution: int8 weight-only / llm.int8
    # matmuls + the weight (de)quantizers behind PTQ.convert
    "weight_only_linear": "nn.quant.weight_only_linear",
    "llm_int8_linear": "nn.quant.llm_int8_linear",
    "weight_quantize": "quantization.functional.weight_quantize",
    "weight_dequantize": "quantization.functional.weight_dequantize",
    # compiled search decoding
    "beam_search": "text.beam_search",
    "beam_search_decode": "text.beam_search",
    # optimizer update kernels -> the optimizer classes
    "sgd_": "optimizer.SGD", "momentum_": "optimizer.Momentum",
    "adam_": "optimizer.Adam", "adamw_": "optimizer.AdamW",
    "adamax_": "optimizer.Adamax", "adagrad_": "optimizer.Adagrad",
    "adadelta_": "optimizer.Adadelta", "rmsprop_": "optimizer.RMSProp",
    "lamb_": "optimizer.Lamb", "nadam_": "optimizer.NAdam",
    "radam_": "optimizer.RAdam", "asgd_": "optimizer.ASGD",
    "rprop_": "optimizer.Rprop", "ftrl": "optimizer",
    "dpsgd": "optimizer", "decayed_adagrad": "optimizer",
    "merged_adam_": "optimizer (one fused Adam launch a step)",
    "merged_momentum_": "optimizer",
    "average_accumulates_": "incubate.ModelAverage analog",
    # collectives -> compiled mesh collectives
    "all_reduce": "distributed.communication.all_reduce",
    "all_gather": "distributed.communication.all_gather",
    "all_to_all": "distributed.communication.alltoall",
    "broadcast": "distributed.communication.broadcast",
    "reduce": "distributed.communication.reduce",
    "reduce_scatter": "distributed.communication.reduce_scatter",
    "mp_allreduce_sum": "fleet.layers.mpu.mp_ops._mp_allreduce",
    # AMP loss-scaling kernels -> GradScaler
    "check_finite_and_unscale_": "amp.GradScaler",
    "update_loss_scaling_": "amp.GradScaler",
    "check_numerics": "amp.debugging.check_numerics",
    "enable_check_model_nan_inf": "amp.debugging.enable_tensor_checker",
    "disable_check_model_nan_inf": "amp.debugging.disable_tensor_checker",
    "accuracy_check": "amp.debugging.compare_accuracy",
    # MoE routing kernels -> gate module
    "limit_by_capacity": "incubate...moe.gate.topk_gating",
    "prune_gate_by_capacity": "incubate...moe.gate.topk_gating",
    "random_routing": "incubate...moe.gate (switch jitter)",
    "assign_pos": "incubate...moe.gate.topk_gating",
    # sequence/recurrent kernels -> nn layer library
    "rnn": "nn.SimpleRNN/LSTM/GRU",
    "lstm": "nn.LSTM", "gru": "nn.GRU", "gru_unit": "nn.GRUCell",
    "warpctc": "nn.functional.ctc_loss",
    "warprnnt": "nn.functional.rnnt_loss",
    "segment_pool": "geometric.segment_sum/mean/max/min",
    "stft": "signal.stft",
    # quantization kernels -> quantization.functional
    "fake_quantize_abs_max": "quantization.functional",
    "fake_quantize_dequantize_abs_max": "quantization.functional",
    "fake_channel_wise_quantize_abs_max": "quantization.functional",
    "fake_channel_wise_quantize_dequantize_abs_max":
        "quantization.functional",
    "fake_quantize_dequantize_moving_average_abs_max":
        "quantization.functional",
    "fake_quantize_moving_average_abs_max": "quantization.functional",
    "fake_quantize_range_abs_max": "quantization.functional",
    "fake_channel_wise_dequantize_max_abs": "quantization.functional",
    "fake_dequantize_max_abs": "quantization.functional",
    "dequantize_abs_max": "quantization.functional",
    "dequantize_log": "quantization.functional",
    "quantize_linear": "quantization.functional",
    "dequantize_linear": "quantization.functional",
    # attention kernels -> kernels/nn.functional
    "flash_attn": "nn.functional.flash_attn",
    "flash_attn_qkvpacked": "nn.functional.flash_attn_qkvpacked",
    "flash_attn_unpadded": "nn.functional.flash_attn_unpadded",
    "flash_attn_varlen_qkvpacked": "nn.functional (unpadded variant)",
    "flashmask_attention": "nn.functional.flashmask_attention",
    "memory_efficient_attention": "nn.functional",
    "fused_batch_norm_act": "nn.functional.batch_norm",
    "fused_bn_add_activation": "nn.functional.batch_norm",
    # misc module-level coverage
    "update_parameter": "optimizer",
    "cross_entropy_with_softmax": "nn.functional.cross_entropy",
    "depthwise_conv2d": "nn.functional.depthwise_conv2d",
    "conv2d_transpose_bias": "nn.functional.conv2d_transpose_bias",
    "pool2d": "nn.functional.avg_pool2d/max_pool2d",
    "pool3d": "nn.functional.avg_pool3d/max_pool3d",
    "max_pool2d_with_index": "nn.functional.max_pool2d(return_mask)",
    "max_pool3d_with_index": "nn.functional.max_pool3d(return_mask)",
    "sync_batch_norm_": "nn.functional.batch_norm",
    "exponential_": "ops.creation.exponential_",
    "uniform_inplace": "ops.creation.uniform_inplace",
    "gaussian_inplace": "ops.creation.gaussian_inplace",
    "fill": "ops.manipulation.fill_",
    "set": "Tensor.set_value",
    "set_value_with_tensor": "Tensor.set_value",
    "view_slice": "ops.manipulation.slice",
    "assign_value_": "ops.manipulation.assign_value_",
    "assign_out_": "ops.manipulation.assign_out_",
    # kernels whose implementation lives under a DIFFERENT name or a
    # namespace outside the op registry (same-named ops register
    # directly through ops.yaml and never reach this table)
    "deformable_conv": "vision.ops.deform_conv2d / DeformConv2D",
    "unpool": "nn.functional.max_unpool2d",
    "unpool3d": "nn.functional.max_unpool3d",
    "graph_khop_sampler": "incubate.graph_khop_sampler",
    "graph_sample_neighbors": "incubate.graph_sample_neighbors",
    "masked_multihead_attention_":
        "incubate.nn.functional.masked_multihead_attention",
}


def coverage() -> dict:
    """Coverage of the reference op list by this framework."""
    ours = set()
    for e in load():
        ours.add(e["op"])
        if "alias_of" in e:
            ours.add(e["alias_of"])
    ref = reference_op_names()
    covered, covered_by, missing, not_applicable = [], {}, [], []
    for name in ref:
        base = name[:-1] if name.endswith("_") else name
        if name in ours or base in ours:
            covered.append(name)
        elif name in _COVERED_BY:
            covered_by[name] = _COVERED_BY[name]
        elif name.startswith(_NOT_APPLICABLE_PREFIXES):
            not_applicable.append(name)
        else:
            missing.append(name)
    n_cov = len(covered) + len(covered_by)
    return {
        "total_reference": len(ref),
        "covered": sorted(covered),
        "covered_by_subsystem": dict(sorted(covered_by.items())),
        "missing": sorted(missing),
        "not_applicable": sorted(not_applicable),
        "extra": sorted(ours - set(ref)
                        - {n[:-1] for n in ref if n.endswith("_")}),
        "covered_pct": round(
            100 * n_cov / max(len(ref) - len(not_applicable), 1), 1),
    }
