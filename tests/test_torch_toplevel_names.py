"""The port's top level against the JAX package's, name by name: every
public name of ``paddle_tpu`` exists in ``paddle_tpu_torch`` but for the
modules not ported yet (listed here; the list only shrinks), the names
the high-level slice brought resolve after a bare import (lazily, with
no jax and nothing of ``paddle_tpu`` pulled in), and ``dir()`` lists
them; the quantization slice's ``quantization``, ``nn.quant`` and
``incubate`` names resolve after a bare import too, and every public name
of the JAX package's ``quantization`` and ``nn.quant`` modules exists in
the port's; the observability slice's ``profiler``, ``device``, ``utils``,
``sysconfig``, ``version``, ``to_dlpack`` and ``from_dlpack`` resolve
lazily (a bare import pulls in none of them); the vision slice's
``vision`` resolves lazily, and the public names of the JAX package's
``vision``, ``vision.models``, ``vision.datasets``, ``vision.ops`` and
``vision.transforms`` all exist in the port's; the signal / graph /
distribution slice's ``tensor``, ``fft``, ``signal``, ``audio``,
``distribution``, ``sparse``, ``geometric`` and ``hub`` resolve lazily
and import no jax, ``CustomPlace`` is a top-level name, and the public
names of those modules, ``text`` and ``incubate``'s graph names all exist
in the port's."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

ROOT = Path(__file__).resolve().parent.parent

#: public names of paddle_tpu with no counterpart in the port yet
NOT_PORTED = {"analysis", "cost_model", "csrc"}

#: public names of paddle_tpu never ported, by design: the JAX modules
#: the JAX package re-exports (the port imports no jax)
NEVER_PORTED = {"jax", "jnp"}

#: the names the high-level training / inference slice brought
HIGH_LEVEL = ("LazyGuard", "Model", "batch", "callbacks", "check_shape",
              "create_parameter", "disable_signal_handler", "flops",
              "get_cuda_rng_state", "hapi", "io", "metric", "reader",
              "set_cuda_rng_state", "set_printoptions", "summary")


#: the names the distributed slice brought to the top level
DISTRIBUTED = ("DataParallel",)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_dir_parity_with_the_jax_top_level():
    missing = _public(jp) - _public(tp)
    assert missing == NOT_PORTED | NEVER_PORTED
    assert not set(HIGH_LEVEL) & missing


@pytest.mark.parametrize("name", DISTRIBUTED)
def test_distributed_names_resolve_lazily_without_jax(name):
    code = ("import sys\n"
            "import paddle_tpu_torch as p\n"
            "assert 'paddle_tpu_torch.distributed.fleet' not in sys.modules\n"
            f"obj = getattr(p, {name!r})\n"
            f"assert {name!r} in dir(p)\n"
            "assert obj.__module__.startswith('paddle_tpu_torch.distributed')\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m.split('.')[0] == 'paddle_tpu' "
            "for m in sys.modules)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("name", HIGH_LEVEL)
def test_high_level_names_exist(name):
    assert name in dir(tp)
    assert getattr(tp, name) is not None


@pytest.mark.parametrize("path,name", [
    ("jit", "InputSpec"), ("jit", "save"), ("jit", "load"),
    ("jit", "TranslatedLayer"), ("jit", "functional_call"),
    ("jit", "get_params"), ("jit", "get_buffers"),
    ("inference", "create_predictor"), ("inference", "Config"),
    ("inference", "Predictor"), ("inference", "PredictorPool"),
    ("nn.utils", "weight_norm"), ("nn.utils", "clip_grad_norm_")])
def test_subpackage_names_match_jax(path, name):
    def get(mod):
        for part in path.split("."):
            mod = getattr(mod, part)
        return mod
    assert hasattr(get(jp), name) and hasattr(get(tp), name)


def test_high_level_names_resolve_lazily_without_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch as p\n"
            "lazy = [m for m in ('paddle_tpu_torch.io', "
            "'paddle_tpu_torch.hapi', 'paddle_tpu_torch.metric') "
            "if m in sys.modules]\n"
            f"names = {HIGH_LEVEL!r}\n"
            "print([n for n in names if getattr(p, n, None) is None])\n"
            "print(lazy)\n"
            "print(p.Model.__module__, p.io.__name__, p.hapi.__name__)\n"
            "import paddle_tpu_torch.jit.serialization\n"
            "import paddle_tpu_torch.inference.predictor\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "[]", "[]", "paddle_tpu_torch.hapi.model paddle_tpu_torch.io "
        "paddle_tpu_torch.hapi", "[]"]


#: names the quantization / incubate slice brought, by attribute path
QUANT_NAMES = ("quantization.WeightOnlyLinear",
               "quantization.quantize_for_inference", "quantization.PTQ",
               "quantization.QAT", "quantization.functional.weight_quantize",
               "nn.quant.weight_only_linear", "nn.quant.llm_int8_linear",
               "nn.quant.Stub", "nn.quant.quant_layers.FakeQuantAbsMax",
               "incubate.LookAhead", "incubate.ModelAverage",
               "incubate.nn.FusedTransformerEncoderLayer",
               "incubate.nn.functional.fused_moe",
               "incubate.optimizer.functional.minimize_lbfgs",
               "incubate.asp.prune_model", "incubate.autograd.forward_grad",
               "incubate.autotune.set_config", "incubate.softmax_mask_fuse",
               "incubate.inference.create_predictor")


def test_quantization_names_resolve_after_a_bare_import():
    code = ("import sys\n"
            "import paddle_tpu_torch as p\n"
            f"paths = {QUANT_NAMES!r}\n"
            "def get(path):\n"
            "    obj = p\n"
            "    for part in path.split('.'):\n"
            "        obj = getattr(obj, part, None)\n"
            "    return obj\n"
            "print([n for n in paths if get(n) is None])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["[]", "[]"]


@pytest.mark.parametrize("path", ["quantization", "quantization.functional",
                                  "quantization.observers",
                                  "quantization.quanters",
                                  "quantization.qat", "quantization.layers",
                                  "nn.quant", "nn.quant.quant_layers"])
def test_quantization_names_match_jax(path):
    import importlib
    jmod = importlib.import_module("paddle_tpu." + path)
    tmod = importlib.import_module("paddle_tpu_torch." + path)
    imports = {"annotations", "jax", "jnp", "np", "run_op", "unwrap", "wrap",
               "torch", "Layer", "copy", "abc"}
    missing = {n for n in dir(jmod) if not n.startswith("_")} - \
        set(dir(tmod)) - imports
    assert missing == set()


#: the names the observability slice brought (profiler, device, utils)
OBSERVABILITY = ("device", "profiler", "utils", "sysconfig", "version",
                 "to_dlpack", "from_dlpack")


@pytest.mark.parametrize("name", OBSERVABILITY)
def test_observability_names_exist(name):
    assert name in dir(tp) and getattr(tp, name) is not None
    assert name in dir(jp)


def test_observability_names_resolve_lazily_without_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch as p\n"
            "mods = ('profiler', 'device', 'utils', 'sysconfig', 'version')\n"
            "print(sorted(m for m in mods if 'paddle_tpu_torch.' + m in "
            "sys.modules))\n"
            "print(p.to_dlpack.__module__, p.from_dlpack.__module__, "
            "p.profiler.__name__, p.device.cuda.__name__, "
            "p.version.with_gpu, p.sysconfig.__name__, p.utils.__name__)\n"
            "import paddle_tpu_torch.amp.debugging\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "[]", "paddle_tpu_torch.utils.dlpack paddle_tpu_torch.utils.dlpack "
        "paddle_tpu_torch.profiler paddle_tpu_torch.device.cuda ON "
        "paddle_tpu_torch.sysconfig paddle_tpu_torch.utils", "[]"]


def test_vision_resolves_lazily_without_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch as p\n"
            "print([m for m in sys.modules if m.startswith("
            "'paddle_tpu_torch.vision')])\n"
            "print('vision' in dir(p), p.vision.__name__, "
            "p.vision.models.resnet50.__module__)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "[]", "True paddle_tpu_torch.vision "
        "paddle_tpu_torch.vision.models.resnet", "[]"]


@pytest.mark.parametrize("path", ["vision", "vision.models",
                                  "vision.datasets", "vision.ops",
                                  "vision.transforms",
                                  "vision.transforms.functional",
                                  "vision.image"])
def test_vision_names_match_jax(path):
    import importlib
    jmod = importlib.import_module("paddle_tpu." + path)
    tmod = importlib.import_module("paddle_tpu_torch." + path)
    imports = {"annotations", "jax", "jnp", "run_op", "run_op_nodiff",
               "unwrap"}
    missing = {n for n in dir(jmod) if not n.startswith("_")} - \
        set(dir(tmod)) - imports
    assert missing == set()


#: the subpackages the signal / graph / distribution slice brought
SLICE21 = ("tensor", "fft", "signal", "audio", "distribution", "sparse",
           "geometric", "hub")

#: every module of that slice, by dotted path under the package
SLICE21_MODULES = (
    "tensor", "fft", "signal", "audio", "audio.functional",
    "audio.features", "audio.backends", "audio.datasets", "distribution",
    "distribution.transform", "distribution.distributions",
    "distribution.chi2", "distribution.kl", "distribution.lkj_cholesky",
    "sparse", "sparse.creation", "sparse.nn", "sparse.nn.functional",
    "geometric", "hub", "text", "text.viterbi", "text.viterbi_decode",
    "text.datasets", "incubate", "incubate.graph")


def test_slice21_subpackages_resolve_lazily_without_jax():
    code = ("import importlib, sys\n"
            "import paddle_tpu_torch as p\n"
            f"names = {SLICE21!r}\n"
            "print([n for n in names if 'paddle_tpu_torch.' + n in "
            "sys.modules])\n"
            "print([n for n in names if n not in dir(p)])\n"
            "print(p.CustomPlace('npu', 0))\n"
            f"for m in {SLICE21_MODULES!r}:\n"
            "    importlib.import_module('paddle_tpu_torch.' + m)\n"
            "print([n for n in names if getattr(p, n).__name__ != "
            "'paddle_tpu_torch.' + n])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["[]", "[]", "Place(npu:0)", "[]",
                                       "[]"]


@pytest.mark.parametrize("path", SLICE21_MODULES)
def test_slice21_names_match_jax(path, monkeypatch):
    import importlib
    for root in ("paddle_tpu.", "paddle_tpu_torch."):
        # a first import of a submodule binds it on its package, over a
        # name of the same spelling (the JAX package's text.viterbi_decode
        # is the function and never imports its submodule): put the
        # attribute back after the test for the tests sharing the process
        parent, _, leaf = (root + path).rpartition(".")
        pkg = importlib.import_module(parent)
        if hasattr(pkg, leaf):
            monkeypatch.setattr(pkg, leaf, getattr(pkg, leaf))
    jmod = importlib.import_module("paddle_tpu." + path)
    tmod = importlib.import_module("paddle_tpu_torch." + path)
    imports = {"annotations", "jax", "jnp", "jsparse", "np", "run_op",
               "run_op_nodiff", "unwrap", "wrap", "Tensor", "math",
               "random_mod", "Dict", "Tuple", "Type", "importlib", "os",
               "sys", "Dataset", "Layer", "dtype_mod"}
    missing = {n for n in dir(jmod) if not n.startswith("_")} - \
        set(dir(tmod)) - imports
    assert missing == set()


@pytest.mark.parametrize("name", ["graph_khop_sampler", "graph_reindex",
                                  "graph_sample_neighbors", "graph_send_recv",
                                  "segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_incubate_graph_names(name):
    assert name in dir(tp.incubate) and name in dir(jp.incubate)
    assert callable(getattr(tp.incubate, name))
