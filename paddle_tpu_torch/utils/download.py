"""paddle.utils.download (counterpart of ``paddle_tpu/utils/download.py``).

No network: ``get_weights_path_from_url`` resolves a URL's file name in
the local cache (``~/.cache/paddle/weights``) and raises for a file that
is not there, where the reference would download it.
"""
from __future__ import annotations

import os

__all__ = ["get_weights_path_from_url"]

WEIGHTS_HOME = os.path.expanduser("~/.cache/paddle/weights")


def get_weights_path_from_url(url, md5sum=None):
    """The cached file of ``url``'s base name; raises RuntimeError if it
    is not cached (nothing is downloaded)."""
    fname = os.path.basename(url)
    path = os.path.join(WEIGHTS_HOME, fname)
    if os.path.exists(path):
        return path
    raise RuntimeError(
        f"weights {fname} not in local cache {WEIGHTS_HOME}, and nothing "
        "is downloaded: place the file there")
