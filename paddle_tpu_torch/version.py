"""Version info (counterpart of ``paddle_tpu/version.py``)."""
full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
commit = "unknown"
with_gpu = "ON"
with_tpu = "OFF"


def show():
    import torch
    print(f"paddle_tpu_torch {full_version} (PyTorch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")


def cuda():
    """The CUDA version torch was built with ("12.8"), False without."""
    import torch
    return torch.version.cuda or False


def tpu():
    return False
