"""The port's op registry (``paddle_tpu_torch.ops.registry``) against the
JAX package's: the port's ``validate()`` passes; its ``ops.yaml`` is the
JAX package's with the listed differences and no other; each op module
exports the JAX module's op names with the listed differences and no
other; ``coverage()`` gives JAX's totals; the records are read without a
YAML library, as PyYAML reads them.
"""
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

ROOT = Path(__file__).resolve().parent.parent

#: JAX ops.yaml records the port leaves out: dispatch helpers the JAX
#: modules happen to export (a core function bound in an op module), not
#: ops; the port's modules do not export them
ONLY_IN_JAX = {("stat", "wrap"), ("nn.functional", "run_op"),
               ("nn.functional", "unwrap"),
               ("quantization.functional", "run_op")}

#: the port's op-module exports that the JAX package's modules lack: core
#: helpers bound in an op module (run_op, run_op_nodiff, wrap, to_numpy,
#: surface, make_inplace), the shared frame overlap-add, the flashmask
#: document mask and the KV quantizers (which JAX's modules export but its
#: ops.yaml lacks), and three public nn.functional names JAX's
#: nn.functional does not export
ONLY_IN_PORT = {("creation", "run_op"), ("creation", "run_op_nodiff"),
                ("manipulation", "overlap_add_frames"),
                ("nn.functional", "conv2d_transpose_bias"),
                ("nn.functional", "cross_entropy_with_softmax"),
                ("nn.functional", "depthwise_conv2d"),
                ("nn.functional", "document_startend_row_indices"),
                ("fft", "wrap"), ("signal", "overlap_add_frames"),
                ("vision.ops", "to_numpy"), ("vision.ops", "wrap"),
                ("quantization.functional", "kv_dequantize_arrays"),
                ("quantization.functional", "kv_quantize_arrays"),
                ("quantization.functional", "surface"),
                ("inplace", "make_inplace")}

#: reference ops the port's ops.yaml registers by name where the JAX
#: package credits them to a subsystem (its _COVERED_BY)
COVERED_DIRECTLY = {"conv2d_transpose_bias", "cross_entropy_with_softmax",
                    "depthwise_conv2d"}


def _keys(records):
    return {(r["module"], r["op"]) for r in records}


def test_port_registry_validates():
    treg.validate()


def test_port_yaml_is_jax_yaml_with_the_listed_differences():
    jrec, trec = jreg.load(), treg.load()
    assert _keys(jrec) - _keys(trec) == ONLY_IN_JAX
    assert _keys(trec) - _keys(jrec) == ONLY_IN_PORT
    jmap = {(r["module"], r["op"]): r for r in jrec}
    for r in trec:
        key = (r["module"], r["op"])
        if key in jmap:
            assert r == jmap[key], key
    assert len(trec) == len(jrec) - len(ONLY_IN_JAX) + len(ONLY_IN_PORT)


def _exports(modules, prefix):
    out = set()
    for mod_name, mod in modules.items():
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.startswith("_") or not callable(fn) or \
                    isinstance(fn, type) or type(fn).__name__ == "module":
                continue
            if (getattr(fn, "__module__", "") or "").startswith(prefix):
                out.add((mod_name, name))
    return out


def test_module_exports_differ_by_the_listed_names():
    jmods, tmods = jreg._modules(), treg._modules()
    assert list(tmods) == list(jmods) and len(tmods) == 14
    jx = _exports(jmods, "paddle_tpu")
    tx = _exports(tmods, "paddle_tpu_torch")
    # JAX's modules export three names its ops.yaml lacks (its validate()
    # is red on them); the port registers them
    jax_unregistered = {("nn.functional", "document_startend_row_indices"),
                        ("quantization.functional", "kv_quantize_arrays"),
                        ("quantization.functional", "kv_dequantize_arrays")}
    assert jx - _keys(jreg.load()) == jax_unregistered
    assert jx - tx == ONLY_IN_JAX
    assert tx - jx == ONLY_IN_PORT - jax_unregistered
    assert tx == _keys(treg.load())


def test_coverage_equals_jax():
    t, j = treg.coverage(), jreg.coverage()
    for key in ("total_reference", "missing", "not_applicable",
                "covered_pct"):
        assert t[key] == j[key], key
    assert t["total_reference"] == 470 and t["covered_pct"] == 100.0
    assert t["missing"] == []
    assert set(t["covered"]) - set(j["covered"]) == COVERED_DIRECTLY
    assert set(j["covered_by_subsystem"]) - set(t["covered_by_subsystem"]) \
        == COVERED_DIRECTLY
    assert set(t["covered"]) | set(t["covered_by_subsystem"]) == \
        set(j["covered"]) | set(j["covered_by_subsystem"])
    assert treg.reference_op_names() == jreg.reference_op_names()


def test_records_read_as_pyyaml_reads_them():
    assert treg.load() == yaml.safe_load(open(treg.OPS_YAML))
    text = ("- op: a\n  module: m\n  args: (x, y=1,\n    name=None)\n"
            "  tensor_method: true\n- op: b\n  module: m\n  alias_of: a\n"
            "- op: c\n  module: m\n  args: '(n: ''str'') -> ''int'''\n"
            "  tensor_method: false\n")
    assert treg._parse(text) == yaml.safe_load(text)


@pytest.mark.parametrize("call", ["load()", "validate()", "coverage()"])
def test_registry_imports_without_pyyaml(call):
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "from paddle_tpu_torch.ops import registry\n"
            f"registry.{call}\n"
            "assert 'jax' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
