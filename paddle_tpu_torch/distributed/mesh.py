"""The hybrid-parallel topology over ranks (counterpart of
``paddle_tpu/distributed/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices with the
axes ``("pp", "dp", "sharding", "sep", "mp")``, outermost first, and its
groups are axis names that XLA reduces over. The port's ``Mesh`` is the
same grid over global *ranks*, in the same axis order (``mp`` innermost,
so that tensor-parallel peers are neighbouring ranks, on one node), with
one process group per slice of each axis: the ranks that share every
coordinate but that axis's. ``dcn_degrees`` makes the outer part of an
axis node-major, as the JAX package's makes it slice-major.

``CommunicateTopology`` (:264) and ``HybridCommunicateGroup`` (:307)
keep their names and accessors; a group accessor returns this rank's
``Group`` on that axis. The JAX package's jax-compatibility helpers
(``ambient_concrete_mesh``, ``_SetMeshCompat``, ``use_mesh``,
``_shard_map_compat``, ``fake_mesh``) have no counterpart: they exist for
jax versions and device-free tracing.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

HYBRID_AXES = ("pp", "dp", "sharding", "sep", "mp")

_global_mesh: Optional["Mesh"] = None


class Mesh:
    """A grid of global ranks with named axes. ``ranks`` is the int
    array, ``shape`` {axis: degree}; ``group(axes)`` this process's group
    on one axis or a tuple of them (made for every slice at the first
    ask, by every rank, as ``torch.distributed`` requires)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = {ax: int(d) for ax, d in
                      zip(self.axis_names, self.ranks.shape)}
        self._groups: Dict[tuple, object] = {}

    def coord(self, rank: int) -> Dict[str, int]:
        idx = np.argwhere(self.ranks == int(rank))
        if not len(idx):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in idx[0])))

    def slices(self, axes) -> List[List[int]]:
        """Every group of ranks along ``axes`` (the others fixed), each in
        rank-grid order, the groups in the order of the fixed
        coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        along = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in along]
        arr = np.transpose(self.ranks, rest + along)
        n = math.prod(self.ranks.shape[i] for i in along)
        return [list(map(int, row)) for row in arr.reshape(-1, n)]

    def ranks_of(self, axes, rank: int) -> List[int]:
        return next(s for s in self.slices(axes) if int(rank) in s)

    def group(self, axes, rank: Optional[int] = None):
        """The ``Group`` of ``rank`` (this process by default) along
        ``axes``."""
        from . import env
        from .communication import group as group_mod
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(sorted(axes, key=self.axis_names.index))
        if key not in self._groups:
            made = {}
            for s in self.slices(key):
                g = group_mod.new_group(s)
                for r in s:
                    made[r] = g
            self._groups[key] = made
        me = env.get_rank() if rank is None else int(rank)
        return self._groups[key][me]

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(degrees: Dict[str, int], world_size: Optional[int] = None,
               axis_order: Sequence[str] = HYBRID_AXES,
               dcn_degrees: Optional[Dict[str, int]] = None) -> Mesh:
    """A ``Mesh`` from per-axis degrees (missing axes 1, still named)
    over the first ranks of the world (``world_size``, by default the
    initialized world's, else exactly the mesh's size).

    ``dcn_degrees``: each named axis's degree becomes ``dcn * degree``
    with the dcn part outer, so that its inner part stays within one node
    (a contiguous block of ranks) and only the outer part crosses nodes."""
    from . import env
    full = {ax: int(degrees.get(ax, 1)) for ax in axis_order}
    extra = [k for k in degrees if k not in full]
    axis_names = tuple(axis_order) + tuple(extra)
    for k in extra:
        full[k] = int(degrees[k])
    if dcn_degrees:
        bad = [k for k in dcn_degrees if k not in axis_names]
        if bad:
            raise ValueError(f"unknown dcn axes {bad}")
        dcn = {ax: int(dcn_degrees.get(ax, 1)) for ax in axis_names}
    else:
        dcn = {ax: 1 for ax in axis_names}
    total = {ax: full[ax] * dcn[ax] for ax in axis_names}
    n = math.prod(total.values())
    if world_size is None:
        world_size = env.get_world_size() if env.is_initialized() else n
    if n > world_size:
        raise ValueError(f"mesh degrees {total} need {n} ranks, the world "
                         f"has {world_size}")
    k = len(axis_names)
    arr = np.arange(n).reshape(tuple(dcn[a] for a in axis_names)
                               + tuple(full[a] for a in axis_names))
    order = [i for d in range(k) for i in (d, d + k)]
    arr = arr.transpose(order).reshape(tuple(total[a] for a in axis_names))
    return Mesh(arr, axis_names)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def ensure_mesh() -> Mesh:
    """The global mesh, built as pure data parallelism over the world
    when none was set."""
    from . import env
    if _global_mesh is None:
        set_mesh(build_mesh({"dp": env.get_world_size()}))
    return _global_mesh


def mesh_axis_sizes(mesh=None) -> Dict[str, int]:
    mesh = mesh if mesh is not None else get_mesh()
    return {} if mesh is None else dict(mesh.shape)


def axis_degree(name: str) -> int:
    mesh = get_mesh()
    return 1 if mesh is None else mesh.shape.get(name, 1)


def data_axes(mesh: Optional[Mesh] = None) -> List[str]:
    """The axes the global batch is split over (dp and sharding)."""
    sizes = mesh_axis_sizes(mesh or ensure_mesh())
    return [ax for ax in ("dp", "sharding") if sizes.get(ax, 1) > 1] \
        or ["dp"]


class CommunicateTopology:
    """Cartesian rank coordinates over named axes (reference
    topology.py:70; JAX :264), row-major with the last axis fastest."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._axes = list(hybrid_group_names or HYBRID_AXES)
        self._dims = [int(d) for d in
                      (dims or [axis_degree(a) for a in self._axes])]

    def get_hybrid_group_names(self):
        return list(self._axes)

    def get_dim(self, axis_name):
        return self._dims[self._axes.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return math.prod(self._dims)

    def get_rank(self, **coords) -> int:
        assert sorted(coords) == sorted(self._axes)
        rank = 0
        for ax, dim in zip(self._axes, self._dims):
            rank = rank * dim + coords[ax]
        return rank

    def get_coord(self, rank: int):
        coords = []
        for dim in reversed(self._dims):
            coords.append(rank % dim)
            rank //= dim
        return dict(zip(self._axes, reversed(coords)))

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every global rank whose coordinate on ``axis_name`` is
        ``index``."""
        return [r for r in range(self.world_size())
                if self.get_coord(r)[axis_name] == index]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank lists of the groups along ``axis_name`` (reference
        topology.py get_comm_list)."""
        others = [a for a in self._axes if a != axis_name]
        out = []
        for fixed in itertools.product(
                *[range(self.get_dim(a)) for a in others]):
            c = dict(zip(others, fixed))
            out.append([self.get_rank(**c, **{axis_name: i})
                        for i in range(self.get_dim(axis_name))])
        return out


class HybridCommunicateGroup:
    """This rank's view of the hybrid topology (reference
    fleet/base/topology.py:189; JAX :307): degrees, its coordinates and
    its ``Group`` on each axis, over the global mesh."""

    def __init__(self, topology: Optional[CommunicateTopology] = None):
        from . import env
        self._mesh = ensure_mesh()
        self._topo = topology or CommunicateTopology(
            list(self._mesh.axis_names),
            [self._mesh.shape[a] for a in self._mesh.axis_names])
        self._global_rank = env.get_rank()

    def _coord(self):
        return self._mesh.coord(self._global_rank)

    # degrees
    def get_data_parallel_world_size(self):
        return axis_degree("dp")

    def get_model_parallel_world_size(self):
        return axis_degree("mp")

    def get_pipe_parallel_world_size(self):
        return axis_degree("pp")

    def get_sharding_parallel_world_size(self):
        return axis_degree("sharding")

    def get_sep_parallel_world_size(self):
        return axis_degree("sep")

    # ranks
    def get_global_rank(self):
        return self._global_rank

    def get_data_parallel_rank(self):
        return self._coord()["dp"]

    def get_model_parallel_rank(self):
        return self._coord()["mp"]

    def get_stage_id(self):
        return self._coord()["pp"]

    def get_sharding_parallel_rank(self):
        return self._coord()["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord()["sep"]

    # groups
    def get_data_parallel_group(self):
        return self._mesh.group("dp")

    def get_model_parallel_group(self):
        return self._mesh.group("mp")

    def get_pipe_parallel_group(self):
        return self._mesh.group("pp")

    def get_sharding_parallel_group(self):
        return self._mesh.group("sharding")

    def get_sep_parallel_group(self):
        return self._mesh.group("sep")

    def get_dp_sharding_group(self):
        """The whole data group: the ranks that hold the same model
        shard (dp x sharding), over which the batch is split."""
        return self._mesh.group(("dp", "sharding"))

    def get_data_sep_group(self):
        """The ranks that hold the same model shard: dp x sharding x sep,
        over which the batch and the sequence are split and the gradients
        averaged."""
        return self._mesh.group(("dp", "sharding", "sep"))

    # expert parallelism: the mesh's "ep" axis (an extra axis of
    # ``build_mesh``), absent unless it was asked for
    def get_expert_parallel_world_size(self):
        return axis_degree("ep")

    def get_expert_parallel_group(self):
        if "ep" not in self._mesh.axis_names:
            return None
        return self._mesh.group("ep")

    def get_check_parallel_group(self, *a, **k):
        from .communication.group import _get_global_group
        return _get_global_group()

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    def get_sharding_parallel_group_src_rank(self):
        return self.get_sharding_parallel_group().ranks[0]

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if axis_degree("pp") > 1:
            return "pipeline"
        if axis_degree("sharding") > 1:
            return "sharding"
        if axis_degree("mp") > 1:
            return "model"
        return "data"


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg) -> None:
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    global _hcg
    if _hcg is None:
        _hcg = HybridCommunicateGroup()
    return _hcg


def _reset():
    global _global_mesh, _hcg
    _global_mesh = None
    _hcg = None
