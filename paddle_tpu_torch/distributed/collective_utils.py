"""Ring helpers (counterpart of ``paddle_tpu/distributed/
collective_utils.py``). ``varying`` marks a value as varying over a
``shard_map`` manual axis: a JAX type-system artifact with no
counterpart in a multi-process port."""
from __future__ import annotations


def ring_perm(n):
    """[(0, 1), (1, 2), ..., (n - 1, 0)]: one hop around the ring."""
    return [(i, (i + 1) % n) for i in range(n)]

