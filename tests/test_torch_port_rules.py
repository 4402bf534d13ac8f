"""Rules of the PyTorch/CUDA port (paddle_tpu_torch/ and chip_smoke.py):

- no module of the port, and not chip_smoke.py, imports ``jax`` or
  anything of the JAX package ``paddle_tpu`` (checked on the source's
  AST, and by importing the port in a fresh interpreter);
- the entry points run on ``cuda`` by default and raise without a GPU
  unless the caller passes ``device="cpu"``;
- chip_smoke.py exits non-zero, printing no result line, when no GPU is
  visible.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.inference import Engine
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.bridge\n"
        "import paddle_tpu_torch.inference.engine\n"
        "import paddle_tpu_torch.kernels.flash_attention\n"
        "import paddle_tpu_torch.kernels.paged_attention\n"
        "import paddle_tpu_torch.text.models.llama\n"
        "import paddle_tpu_torch.text.models.ernie_moe\n"
        "import paddle_tpu_torch.kernels.moe, paddle_tpu_torch.profile_moe\n"
        "import paddle_tpu_torch.incubate.distributed.models.moe\n"
        "import paddle_tpu_torch.jit, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.nn, paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.incubate.nn.functional\n"
        "import paddle_tpu_torch.text.models.bert\n"
        "import paddle_tpu_torch.inference.encoder\n"
        "import paddle_tpu_torch.profile_encoder\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    cfg = LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg, device="cuda")
    net = LlamaForCausalLM(cfg, device="cpu")
    assert net.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(net)
    assert Engine(net, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_moe_entry_points_default_to_cuda(no_gpu):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                              ErnieMoEForCausalLM)
    cfg = ErnieMoEConfig.tiny(vocab=32, hidden=16, heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieMoEForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(16, 32, 2)
    net = ErnieMoEForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(net)
    assert Engine(net, device="cpu").moe_pallas_eligible


def test_encoder_entry_points_default_to_cuda(no_gpu):
    from paddle_tpu_torch.inference import BatchEncoder
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForPretraining, BertModel)
    cfg = BertConfig.tiny(vocab=32, hidden=16, layers=1, heads=2)
    for cls in (BertModel, BertForPretraining):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg)
    net = BertModel(cfg, device="cpu")
    assert net.device == torch.device("cpu")
    assert net.generator.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchEncoder(net)
    assert BatchEncoder(net, device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
