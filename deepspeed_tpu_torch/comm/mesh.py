"""The device mesh over ``torch.distributed`` ranks.

Counterpart of ``deepspeed_tpu/comm/mesh.py``. JAX builds one
``jax.sharding.Mesh`` over every device and XLA inserts the collectives
over its named axes. Here every rank is a process, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
JAX's :data:`MESH_AXES`, in that order. Rank ``r`` sits at the position
``r`` of the reshaped rank list, the coordinates JAX gives the device at
the same position of its reshaped device list (``build_mesh``).

The collectives of ``comm/comm.py`` run over the process group of one
axis or of several axes together (:func:`axis_group`); a group of several
axes orders its ranks by their combined index, the first axis major, as
JAX orders the devices of ``("data", "fsdp")``.

Without a process group nothing here is built: the engines stay at world
size 1 (``get_*_parallel_world_size`` then give 1).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

# Canonical axis order: innermost (fastest interconnect) last.
MESH_AXES = ("pipe", "data", "fsdp", "seq", "tensor")
# The batch's leading dim splits over plain DP and the hybrid-shard axis.
DATA_AXES = ("data", "fsdp")

Axes = Union[str, Sequence[str]]

_GLOBAL_MESH = None
_GROUPS: Dict[Tuple, Tuple[object, Tuple[int, ...]]] = {}
_COORDS: Dict[Tuple[int, int], Dict[str, int]] = {}
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees for each parallel axis; -1 on data = absorb remaining
    devices."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> dict:
        fixed = self.fsdp * self.tensor * self.seq * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by "
                    f"fsdp*tensor*seq*pipe={fixed}")
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.seq}x{self.tensor}x{self.pipe}"
                f" != device count {n_devices}")
        return dict(pipe=self.pipe, data=data, fsdp=self.fsdp, seq=self.seq,
                    tensor=self.tensor)


def build_mesh(config: Optional[MeshConfig] = None,
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``(pipe, data, fsdp, seq, tensor)`` over
    every rank of the default process group (which must exist:
    ``comm.init_distributed``). ``device_type`` defaults to ``cuda``
    under NCCL and ``cpu`` otherwise."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a process group: call "
            "deepspeed_tpu_torch.init_distributed() first")
    config = config or MeshConfig()
    ws = dist.get_world_size()
    sizes = config.resolve(ws)
    shape = tuple(sizes[a] for a in MESH_AXES)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(ws).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)


def mesh_for(config: Optional[MeshConfig] = None):
    """The global mesh when it has ``config``'s shape, else a new one
    (then the global mesh): engines built one after another share their
    mesh and its process groups."""
    config = config or MeshConfig()
    sizes = config.resolve(dist.get_world_size())
    if _GLOBAL_MESH is not None and mesh_shape(_GLOBAL_MESH) == sizes:
        return _GLOBAL_MESH
    set_global_mesh(build_mesh(config))
    return _GLOBAL_MESH


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or a mapping already)."""
    if mesh is None:
        return {a: 1 for a in MESH_AXES}
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in MESH_AXES}
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names,
                                      mesh.mesh.shape)}


def _axes(axis_name: Axes) -> Tuple[str, ...]:
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    bad = [a for a in axes if a not in MESH_AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}; the axes are {MESH_AXES}")
    return axes


def mesh_coordinate(mesh=None, rank: Optional[int] = None) -> Dict[str, int]:
    """This rank's (or ``rank``'s) coordinate on each axis."""
    mesh = mesh if mesh is not None else get_global_mesh()
    if mesh is None:
        return {a: 0 for a in MESH_AXES}
    if rank is None:
        rank = dist.get_rank()
    key = (id(mesh), rank)
    if key not in _COORDS:   # read on every step of a model: made once
        idx = (mesh.mesh == rank).nonzero()[0].tolist()
        _COORDS[key] = dict(zip(mesh.mesh_dim_names, idx))
    return _COORDS[key]


def axis_index(axis_name: Axes, mesh=None) -> int:
    """This rank's index along ``axis_name``; for several axes their
    combined index, the first axis major (JAX ``lax.axis_index``)."""
    shape = mesh_shape(mesh if mesh is not None else get_global_mesh())
    coord = mesh_coordinate(mesh)
    idx = 0
    for a in _axes(axis_name):
        idx = idx * shape[a] + coord[a]
    return idx


def axis_size(axis_name: Axes, mesh=None) -> int:
    shape = mesh_shape(mesh if mesh is not None else get_global_mesh())
    return math.prod(shape[a] for a in _axes(axis_name))


def axis_group(axis_name: Axes, mesh=None):
    """``(process group, ranks)`` of this rank along ``axis_name``: the
    ranks that share every other coordinate, ordered by their index on
    the axes. Made once per mesh and axes; every rank makes every group
    of the partition in the same order, as ``new_group`` requires."""
    mesh = mesh if mesh is not None else get_global_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: call init_distributed() and build_mesh")
    axes = _axes(axis_name)
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in order]
        grid = mesh.mesh.permute(rest + order).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in order))
        me = dist.get_rank()
        mine = None
        for row in grid.tolist():
            # every rank takes part in making every group
            g = dist.new_group(row, timeout=GROUP_TIMEOUT)
            if me in row:
                mine = (g, tuple(row))
        _GROUPS[key] = mine
    return _GROUPS[key]


def set_global_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    logger.info(f"global mesh set: {mesh_shape(mesh)}")


def get_global_mesh():
    """The global mesh: the one set, else one built over the process
    group when there is one, else None (world size 1)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None and dist.is_initialized():
        _GLOBAL_MESH = build_mesh()
    return _GLOBAL_MESH


def has_global_mesh() -> bool:
    return _GLOBAL_MESH is not None


def reset_global_mesh() -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = None
    _GROUPS.clear()
    _COORDS.clear()


def seq_axis_active() -> bool:
    """True when the global mesh shards the ``seq`` axis."""
    if not has_global_mesh():
        return False
    return mesh_shape(get_global_mesh())["seq"] > 1


# ---------------------------------------------------------------------------
# Axis-size accessors (JAX comm/mesh.py; reference groups.py:287-399)
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh if mesh is not None else get_global_mesh())[axis]


def get_data_parallel_world_size(mesh=None) -> int:
    # ZeRO partitions over data x fsdp combined
    return _axis_size(mesh, "data") * _axis_size(mesh, "fsdp")


def get_model_parallel_world_size(mesh=None) -> int:
    return _axis_size(mesh, "tensor")


def get_sequence_parallel_world_size(mesh=None) -> int:
    return _axis_size(mesh, "seq")


def get_pipe_parallel_world_size(mesh=None) -> int:
    return _axis_size(mesh, "pipe")


def get_expert_parallel_world_size(mesh=None,
                                   max_experts: Optional[int] = None) -> int:
    """Expert parallelism folds over the ZeRO/data axis, capped by the
    number of experts."""
    ep = get_data_parallel_world_size(mesh)
    if max_experts is not None:
        ep = min(ep, max_experts)
    return ep

