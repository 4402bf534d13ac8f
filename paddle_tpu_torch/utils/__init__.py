"""paddle.utils (counterpart of ``paddle_tpu/utils``): unique_name,
deprecated, try_import, require_version, run_check, download (local
cache only), DLPack interop and the custom-op extension API
(``cpp_extension``)."""
from . import dlpack  # noqa: F401
from . import unique_name  # noqa: F401
from .deprecated import deprecated  # noqa: F401
from .lazy_import import try_import  # noqa: F401


def require_version(min_version: str, max_version=None) -> bool:
    from .. import version

    def parse(v):
        parts = [int(p) for p in str(v).split(".")[:3] if p.isdigit()]
        return tuple(parts + [0] * (3 - len(parts)))  # pad: 0.1 == 0.1.0

    cur = parse(version.full_version)
    if cur < parse(min_version):
        raise RuntimeError(
            f"requires paddle_tpu_torch >= {min_version}, have "
            f"{version.full_version}")
    if max_version is not None and cur > parse(max_version):
        raise RuntimeError(
            f"requires paddle_tpu_torch <= {max_version}, have "
            f"{version.full_version}")
    return True


def run_check():
    """Check that the install computes on the current place (the GPU
    unless ``set_device("cpu")`` was called; raises without one)."""
    import numpy as np

    from .. import to_tensor
    from ..core.place import current_device

    a = to_tensor(np.ones((2, 2), np.float32))
    out = (a @ a).numpy()
    assert float(out.sum()) == 8.0
    dev = current_device()
    kind = "CPU" if dev.type == "cpu" else \
        __import__("torch").cuda.get_device_name(dev)
    print(f"paddle_tpu_torch works on {dev} ({kind}).")


from . import download  # noqa: F401,E402
from . import cpp_extension  # noqa: F401,E402
