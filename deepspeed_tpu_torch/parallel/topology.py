"""Named-axis cartesian process topology.

Counterpart of ``deepspeed_tpu/parallel/topology.py`` (reference
``deepspeed/runtime/pipe/topology.py``: ``ProcessTopology`` :9,
``PipeDataParallelTopology`` :232, ``PipeModelDataParallelTopology`` :243,
``PipelineParallelGrid`` :249), a copy of its pure coordinate math: rank
<-> named coordinate, for checkpoint reshaping, stage assignment and
debugging. It makes no process groups: those are the mesh's
(``comm/mesh.py``).

Axis-major ordering matches the reference: the FIRST listed axis varies
slowest (ranks from ``itertools.product`` over the axis ranges in listed
order).
"""
from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Dict, List, Sequence


class ProcessTopology:
    """Maps a flat rank space onto a named cartesian grid.

    ``ProcessTopology(axes=['pipe','data'], dims=[2,4])`` gives 8 ranks where
    rank = pipe * 4 + data — identical to the reference's mapping
    (runtime/pipe/topology.py:9-227).
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        self.axes = list(axes)
        self.dims = list(int(d) for d in dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(itertools.product(*ranges)):
            key = self.ProcessCoord(*coord)
            self.mapping[key] = global_rank
        # coords are generated in rank order: rank -> coord is O(1)
        self._coords = list(self.mapping)

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(
                f"get_rank() needs all axes {self.axes}, got {coord_kwargs}")
        key = self.ProcessCoord(**coord_kwargs)
        if key not in self.mapping:
            raise ValueError(f"coord {key} out of range for dims {self.dims}")
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank: int, omit_axes=("data",),
                      inner_sep: str = "_", outer_sep: str = "-") -> str:
        """String like ``pipe_0-tensor_1`` naming a rank (checkpoint paths)."""
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        if not 0 <= rank < len(self._coords):
            raise ValueError(f"rank {rank} not in topology")
        return self._coords[rank]

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that would communicate along ``axis`` — every
        combination of the other axes' coordinates yields one list."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for other_coord in itertools.product(*ranges):
            fixed = dict(zip(other_axes, other_coord))
            ranks = [self.get_rank(**{axis: i, **fixed})
                     for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match the given axis values."""
        def matches(coord):
            return all(getattr(coord, k) == v
                       for k, v in filter_kwargs.items())
        return sorted(r for c, r in self.mapping.items() if matches(c))

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return sorted(r for c, r in self.mapping.items()
                      if getattr(c, axis) == idx)

    @property
    def world_size(self) -> int:
        import math
        return math.prod(self.dims)

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """pipe × data — ZeRO-friendly layout: adjacent data ranks share a stage
    (reference runtime/pipe/topology.py:232)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe × data × model 3D layout (reference runtime/pipe/topology.py:243)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Rank bookkeeping over a topology (reference topology.py:249-452)
    for stage-id / data-parallel-id queries and checkpoint naming; the
    process groups are the mesh's."""

    def __init__(self, topology: ProcessTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size
        self.data_parallel_size = max(topology.get_dim("data"), 1)
        self.pipe_parallel_size = max(topology.get_dim("pipe"), 1)
        self.model_parallel_size = max(topology.get_dim("model"), 1)
        if self.world_size != (self.data_parallel_size *
                               self.pipe_parallel_size *
                               self.model_parallel_size):
            raise RuntimeError("topology dims do not factor the world size")

    def get_stage_id(self, rank=None) -> int:
        rank = self.global_rank if rank is None else rank
        return getattr(self._topo.get_coord(rank), "pipe", 0)

    def get_data_parallel_id(self, rank=None) -> int:
        rank = self.global_rank if rank is None else rank
        return getattr(self._topo.get_coord(rank), "data", 0)

    def get_model_parallel_id(self, rank=None) -> int:
        rank = self.global_rank if rank is None else rank
        coord = self._topo.get_coord(rank)
        return getattr(coord, "model", 0)

    def stage_to_global(self, stage_id: int, **kwargs) -> int:
        me = self._topo.get_coord(self.global_rank)
        transform = me._replace(pipe=stage_id, **kwargs)._asdict()
        return self._topo.get_rank(**transform)

    def is_first_stage(self, rank=None) -> bool:
        return self.get_stage_id(rank) == 0

    def is_last_stage(self, rank=None) -> bool:
        return self.get_stage_id(rank) == self.pipe_parallel_size - 1

    # p2p neighbours along the pipe axis (reference p2p groups :370)
    def stage_prev(self, rank=None) -> int:
        stage = self.get_stage_id(rank)
        return self.stage_to_global(
            (stage - 1) % self.pipe_parallel_size)

    def stage_next(self, rank=None) -> int:
        stage = self.get_stage_id(rank)
        return self.stage_to_global(
            (stage + 1) % self.pipe_parallel_size)

    @property
    def topology(self) -> ProcessTopology:
        return self._topo
