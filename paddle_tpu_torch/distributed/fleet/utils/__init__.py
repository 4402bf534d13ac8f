"""fleet.utils (counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``): the file-system
clients of the checkpoint code, ``DistributedInfer``, the recompute
re-exports, and ``sequence_parallel_utils``."""
from __future__ import annotations

import os
import shutil

from ..recompute import recompute, recompute_sequential  # noqa: F401
from . import sequence_parallel_utils  # noqa: F401


class LocalFS:
    """Local file-system client (reference fleet/utils/fs.py LocalFS): the
    checkpoint and elastic code's FS abstraction."""

    def ls_dir(self, fs_path):
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if not overwrite and os.path.exists(dst):
            raise FileExistsError(dst)
        os.replace(src, dst)

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if not exist_ok and os.path.exists(fs_path):
            raise FileExistsError(fs_path)
        open(fs_path, "a").close()

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]


class HDFSClient:
    """HDFS client (reference fleet/utils/fs.py HDFSClient wraps the
    hadoop CLI): constructing it raises unless a hadoop binary exists."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300000,
                 sleep_inter=1000):
        hadoop = shutil.which("hadoop") if hadoop_home is None else \
            hadoop_home
        if not hadoop:
            raise RuntimeError(
                "HDFSClient needs a hadoop installation (hadoop binary "
                "not found); use LocalFS for local checkpoints")
        self._hadoop = hadoop


class DistributedInfer:
    """Distributed inference helper (reference fleet/utils/__init__.py
    DistributedInfer, a parameter-server-era wrapper that swaps programs
    for inference). Dygraph form: the layer in eval mode."""

    def __init__(self, main_program=None, startup_program=None):
        self._layer = main_program

    def get_dist_infer_program(self):
        if self._layer is not None and hasattr(self._layer, "eval"):
            self._layer.eval()
        return self._layer
