"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library with a plain C interface under ``build/`` at the repository
root (listed in ``.gitignore``), then loaded with ``ctypes``. All
sources are compiled at once, one ``nvcc`` process each, in parallel.
A library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and an unchanged one is reused.

Every library also carries the capability probe of ``csrc/common.cuh``
(``o = x + x`` on an [8, 128] f32 tile — the counterpart of
``_pallas_supported`` in ``paddle_tpu/kernels/flash_attention.py``). It
is launched once when the library is loaded, and the load raises if it
does not return the right answer: the port never routes around a
kernel that does not run.

Nothing here runs at import: ``nvcc`` and the GPU are touched only when
a wrapper is first called on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

#: kernel library name -> its source file under csrc/
SOURCES = {"paged_decode": "paged_decode.cu", "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu", "grouped_ffn_fwd": "grouped_ffn_fwd.cu",
           "grouped_ffn_bwd": "grouped_ffn_bwd.cu"}
HEADERS = ("common.cuh", "flash_common.cuh", "grouped_gemm.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_FLASH_BWD = [_P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I,
              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
              _P, _L, _L, _L, _I, _I, _I, _F, _I, _P]

#: C signatures of each library's launch entries (all return cudaError_t)
SIGNATURES = {
    "paged_decode": {"paged_decode_launch":
                     [_P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]},
    "flash_fwd": {"flash_fwd_launch":
                  [_P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _P, _L, _L, _L, _I, _I, _I, _F, _I, _P],
                  "flash_fwd_minor64_probe": [_P, _P, _P]},
    "flash_bwd": {"flash_bwd_dq_launch": _FLASH_BWD,
                  "flash_bwd_dkv_launch": _FLASH_BWD},
    "grouped_ffn_fwd": {"grouped_ffn_fwd_launch":
                        [_P] * 9 + [_I] * 6 + [_P]},
    "grouped_ffn_bwd": {"grouped_ffn_bwd_dx_launch":
                        [_P] * 16 + [_I] * 6 + [_P],
                        "grouped_ffn_bwd_dw_launch":
                        [_P] * 10 + [_I] * 5 + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas/nvcc output of each build in this process (name -> text)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled from csrc/ at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for fname in (SOURCES[name],) + HEADERS:
        h.update((CSRC / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet — one ``nvcc``
    each, all started together — and return name -> library path.
    Raises RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[n]} (nvcc rc={proc.returncode})"
                          f"\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
            build.libraries_built += 1
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


#: kernel libraries compiled by this process (the serving surfaces count
#: the builds that happen inside their steps)
build.libraries_built = 0


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def probe(name: str, device=None) -> torch.Tensor:
    """Launch library ``name``'s capability probe (``o = x + x`` over an
    [8, 128] f32 tile) on ``device`` and check the answer. Counts one
    launch on ``probe.launches``. Returns the output tensor."""
    lib = load(name)
    return _run_probe(lib, name, device)


def _run_probe(lib, name, device=None) -> torch.Tensor:
    dev = torch.device("cuda") if device is None else torch.device(device)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    o = torch.empty_like(x)
    fn = getattr(lib, f"{name}_probe")
    check(fn(x.data_ptr(), o.data_ptr(), x.numel(),
             torch.cuda.current_stream(dev).cuda_stream),
          f"{name} probe")
    probe.launches += 1
    if not torch.equal(o, x + x):
        raise RuntimeError(
            f"{name} probe kernel returned a wrong result on "
            f"{torch.cuda.get_device_name(dev)}: the kernels of this "
            f"library cannot be trusted on this card")
    return o


probe.launches = 0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use, probed
    once at load)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = build()[name]
        lib = ctypes.CDLL(str(path))
        for fname, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        pfn = getattr(lib, f"{name}_probe")
        pfn.argtypes = [_P, _P, _I, _P]
        pfn.restype = ctypes.c_int
        _run_probe(lib, name)
        _libs[name] = lib
        return lib
