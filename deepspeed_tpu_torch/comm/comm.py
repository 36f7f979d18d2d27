"""Communication facade over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (reference
``deepspeed/comm/comm.py:112-760``). JAX runs one controller over a mesh
of devices and its collectives are ``lax`` ops inside ``shard_map``; here
every rank is a process and each collective runs eagerly over the process
group of a named mesh axis (``comm/mesh.py`` :func:`axis_group`). Each
one's result on a rank is what JAX's gives on the device at the same mesh
position:

* ``init_distributed()`` — start-up with the launchers' environments:
  torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``,
  then JAX's ``DS_*``, then ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
  ``PROCESS_ID``, then :func:`mpi_discovery`. NCCL on the card, gloo on
  the CPU. With none of them set nothing starts: world size 1.
* rank and world-size accessors.
* collectives over a named axis (or a tuple of axes): ``all_reduce``
  (SUM/AVG/MAX/MIN/PROD), ``all_gather`` and ``reduce_scatter``
  (``tiled`` as JAX), ``all_to_all`` / ``all_to_all_single``,
  ``broadcast``, ``reduce``, ``gather``, ``scatter``, ``ppermute`` /
  ``send_recv`` and ``axis_index``. Without a process group an axis has
  size 1 and each gives what JAX gives over a one-device axis.
* host-level helpers: ``barrier``, ``monitored_barrier``,
  ``broadcast_obj``.
* :class:`CommsLogger` — calls and elements per op, keyed as JAX keys
  them (``all_reduce[data]``). No timing: JAX has none either.
"""
from __future__ import annotations

import datetime
import json
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import mesh as _mesh
from deepspeed_tpu_torch.utils.logging import logger

_INITIALIZED = False

# Reduce ops (reference ReduceOp names)
SUM = "sum"
MAX = "max"
MIN = "min"
AVG = "avg"
PROD = "prod"

_TORCH_OPS = {SUM: "SUM", MAX: "MAX", MIN: "MIN", PROD: "PRODUCT",
              AVG: "SUM"}


class CommsLogger:
    """Counts collective calls and element volume per op name (reference
    ``deepspeed/utils/comms_logging.py``)."""

    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.comms_dict: dict = {}

    def configure(self, enabled=False, verbose=False, prof_all=True,
                  debug=False):
        self.enabled = enabled
        self.verbose = verbose

    def append(self, op_name: str, nelems: int, dtype) -> None:
        if not self.enabled:
            return
        rec = self.comms_dict.setdefault(op_name, {"count": 0, "elements": 0})
        rec["count"] += 1
        rec["elements"] += int(nelems)
        if self.verbose:
            logger.info(f"comm op: {op_name} | elements: {nelems} | "
                        f"dtype: {dtype}")

    def reset(self) -> None:
        self.comms_dict = {}

    def log_all(self):
        for name, rec in sorted(self.comms_dict.items()):
            logger.info(f"{name}: {rec['count']} calls, "
                        f"{rec['elements']} elements")


comms_logger = CommsLogger()


def configure(deepspeed_config=None, enabled=None, verbose=None, **kwargs):
    if deepspeed_config is not None and \
            getattr(deepspeed_config, "comms_logger", None):
        cl = deepspeed_config.comms_logger
        comms_logger.configure(enabled=cl.enabled, verbose=cl.verbose)
    elif enabled is not None:
        comms_logger.configure(enabled=enabled, verbose=bool(verbose))


def _log(op_name: str, x) -> None:
    if comms_logger.enabled:
        comms_logger.append(op_name, x.numel(), x.dtype)


# ---------------------------------------------------------------------------
# Start-up (reference init_distributed, comm/comm.py:599)
# ---------------------------------------------------------------------------

def in_aml() -> bool:
    """AzureML job environment (reference comm.py:708)."""
    return "AZUREML_EXPERIMENT_ID" in os.environ


def in_aws_sm() -> bool:
    """AWS SageMaker job environment (reference comm.py:713)."""
    return os.environ.get("SM_TRAINING_ENV") is not None or \
        "SM_CURRENT_HOST" in os.environ


def in_dlts() -> bool:
    """DLTS cluster environment (reference comm.py:718)."""
    return "DLTS_JOB_ID" in os.environ


def mpi_discovery(coordinator_port: int = 29500,
                  require_addr: bool = True):
    """``(coordinator_address, num_processes, process_id)`` from an MPI
    launcher's environment (reference ``mpi_discovery``, comm.py:664):
    OpenMPI's size and rank; the coordinator host from
    ``DS_COORDINATOR_ADDR`` or the AzureML / SageMaker master-node
    variables."""
    env = os.environ

    def master_host():
        addr = env.get("DS_COORDINATOR_ADDR")
        if addr is None and in_aml():
            addr = env.get("AZ_BATCH_MASTER_NODE",
                           env.get("AZ_BATCHAI_MPI_MASTER_NODE"))
            addr = addr.split(":")[0] if addr else None
        if addr is None:
            hosts = sorted(json.loads(env.get("SM_HOSTS", "[]")))
            if hosts:
                addr = hosts[0]
        return addr

    if "OMPI_COMM_WORLD_SIZE" in env:
        size = int(env["OMPI_COMM_WORLD_SIZE"])
        rank = int(env["OMPI_COMM_WORLD_RANK"])
        addr = master_host()
        if addr is None and size > 1 and require_addr:
            raise RuntimeError(
                "mpi_discovery: set DS_COORDINATOR_ADDR to the rank-0 "
                "host (OpenMPI exports no hostlist)")
        return (f"{addr}:{coordinator_port}" if addr else None, size, rank)
    if in_aws_sm():
        hosts = sorted(json.loads(env.get("SM_HOSTS", "[]")))
        cur = env.get("SM_CURRENT_HOST")
        if hosts and cur in hosts:
            return (f"{hosts[0]}:{coordinator_port}", len(hosts),
                    hosts.index(cur))
    return None, None, None


def _env_int(*names) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def discover(coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None,
             auto_mpi_discovery: bool = True):
    """``(address, world size, rank)`` in the order of the module
    docstring; ``None`` where nothing says."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    coordinator_address = (coordinator_address or
                           env.get("DS_COORDINATOR_ADDR") or
                           env.get("COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "DS_NUM_PROCESSES",
                                 "NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "DS_PROCESS_ID", "PROCESS_ID")
    if auto_mpi_discovery and num_processes is None and \
            ("OMPI_COMM_WORLD_SIZE" in env or in_aws_sm()):
        # an explicit coordinator waives the discovery's address need
        addr, size, rank = mpi_discovery(
            require_addr=coordinator_address is None)
        if size is not None and size > 1:
            coordinator_address = coordinator_address or addr
            num_processes, process_id = size, rank
            logger.info(f"mpi discovery: process {rank}/{size} "
                        f"coordinator={coordinator_address}")
    return coordinator_address, num_processes, process_id


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None,
                     store=None, device=None) -> None:
    """Start the default process group if the environment (or the
    arguments) name several processes, or a ``store`` is given; else stay
    at world size 1. ``dist_backend`` defaults to NCCL when a card is
    present and the caller does not ask for the CPU (``device="cpu"``),
    else gloo. ``timeout`` bounds every collective of the process groups
    (the mesh's groups too)."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return
    addr, ws, rank = discover(coordinator_address, num_processes,
                              process_id, auto_mpi_discovery)
    if store is None and not (ws is not None and ws > 1) and \
            not (ws is None and addr is not None):
        _INITIALIZED = True   # one process: nothing to start
        return
    if dist_backend in (None, "xla"):
        cpu = device is not None and torch.device(device).type == "cpu"
        dist_backend = ("nccl" if torch.cuda.is_available() and not cpu
                        else "gloo")
    if timeout is not None:
        _mesh.GROUP_TIMEOUT = timeout
    opts = {"backend": dist_backend, "world_size": ws if ws else 1,
            "rank": rank or 0}
    if timeout is not None:
        opts["timeout"] = timeout
    if store is not None:
        opts["store"] = store
    else:
        opts["init_method"] = f"tcp://{addr}"
    if dist_backend == "nccl":
        local = get_local_rank()
        torch.cuda.set_device(local)
        opts["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**opts)
    logger.info(f"torch.distributed initialized ({dist_backend}): process "
                f"{dist.get_rank()}/{dist.get_world_size()}")
    _INITIALIZED = True


def is_initialized() -> bool:
    return _INITIALIZED


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK",
                              os.environ.get("DS_LOCAL_RANK", 0)))


def get_device_count() -> int:
    """Devices over every process: one a rank."""
    return get_world_size()


# ---------------------------------------------------------------------------
# Collectives over named mesh axes (JAX comm.py:240-380)
# ---------------------------------------------------------------------------

def capturable() -> bool:
    """Whether a CUDA graph can capture this process group's collectives:
    NCCL's run on the device, gloo's on the host."""
    return not dist.is_initialized() or dist.get_backend() == "nccl"


def _group(axis_name):
    """``(group, ranks, my index)``; no group without a mesh (size 1). A
    host (gloo) collective met inside a CUDA graph capture raises: the
    replay would leave it out."""
    mesh = _mesh.get_global_mesh()
    if mesh is None:
        _mesh._axes(axis_name)
        return None, (0,), 0
    g, ranks = _mesh.axis_group(axis_name, mesh)
    if (len(ranks) > 1 and not capturable() and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"a collective over {axis_name!r} inside a CUDA graph capture: "
            f"the {dist.get_backend()} backend runs it on the host, so a "
            "replay would leave it out (run the step eagerly)")
    return g, ranks, ranks.index(dist.get_rank())


def _call(fn, *args, **kwargs):
    # torch 2.13 renames all_gather_into_tensor / reduce_scatter_tensor
    # (FutureWarning); the card's torch has only the old names
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _reduce_op(op: str):
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


def all_reduce(x: torch.Tensor, op: str = SUM, axis_name="data"):
    _log(f"all_reduce[{axis_name}]", x)
    op_ = _reduce_op(op)
    g, ranks, _ = _group(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    if g is not None:
        dist.all_reduce(out, op=op_, group=g)
    if op == AVG and len(ranks) > 1:
        out = out / len(ranks)
    return out


def all_gather(x: torch.Tensor, axis_name="data", axis: int = 0,
               tiled: bool = True):
    _log(f"all_gather[{axis_name}]", x)
    return _all_gather(x, axis_name, axis, tiled)


def _all_gather(x, axis_name, axis, tiled):
    g, ranks, _ = _group(axis_name)
    n = len(ranks)
    src = x.contiguous().unsqueeze(0)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if g is not None:
        _call(dist.all_gather_into_tensor, out, src, group=g)
    else:
        out.copy_(src)
    if not tiled:
        return out.movedim(0, axis)
    if axis == 0:
        return out.view((n * x.shape[0],) + tuple(x.shape[1:]))
    # one copy into place (none over one rank)
    return out[0] if n == 1 else torch.cat(out.unbind(0), dim=axis)


def reduce_scatter(x: torch.Tensor, axis_name="data", axis: int = 0,
                   tiled: bool = True):
    """Sum-reduce, then each index keeps its chunk along ``axis``
    (``tiled``), or its row of an axis of the group's size (not tiled),
    as ``lax.psum_scatter``."""
    _log(f"reduce_scatter[{axis_name}]", x)
    g, ranks, _ = _group(axis_name)
    n = len(ranks)
    if x.shape[axis] % n or (not tiled and x.shape[axis] != n):
        raise ValueError(f"reduce_scatter: dim {axis} size {x.shape[axis]} "
                         f"does not split over {n} ranks")
    shape = list(x.shape)
    shape[axis] //= n
    # the ranks' chunks one after another along dim 0: no copy along dim
    # 0 or over one rank, else one
    if axis == 0 or n == 1:
        src = x.contiguous()
    else:
        src = torch.cat(torch.chunk(x, n, dim=axis), dim=0)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if g is not None:
        _call(dist.reduce_scatter_tensor, out, src, group=g)
    else:
        out.copy_(src)
    return out if tiled else out.squeeze(axis)


def all_to_all(x: torch.Tensor, axis_name="expert", split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True):
    """Chunk ``i`` of ``split_axis`` goes to index ``i``; the chunks
    received are concatenated (``tiled``) or stacked along
    ``concat_axis`` in source order (``lax.all_to_all``)."""
    _log(f"all_to_all[{axis_name}]", x)
    g, ranks, _ = _group(axis_name)
    n = len(ranks)
    if x.shape[split_axis] % n or (not tiled and x.shape[split_axis] != n):
        raise ValueError(f"all_to_all: dim {split_axis} size "
                         f"{x.shape[split_axis]} does not split over {n}")
    parts = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    out = torch.empty_like(parts)
    if g is not None:
        dist.all_to_all_single(out, parts, group=g)
    else:
        out.copy_(parts)
    if tiled:
        return torch.cat(out.unbind(0), dim=concat_axis)
    return torch.stack([p.squeeze(split_axis) for p in out.unbind(0)],
                       dim=concat_axis)


def all_to_all_single(x, axis_name="expert", split_axis: int = 0,
                      concat_axis: int = 0):
    """Alias of :func:`all_to_all` (reference all_to_all_single,
    comm.py:361)."""
    return all_to_all(x, axis_name=axis_name, split_axis=split_axis,
                      concat_axis=concat_axis)


def broadcast(x: torch.Tensor, src_index: int = 0, axis_name="data"):
    """Index ``src_index``'s value on every index of the axis."""
    _log(f"broadcast[{axis_name}]", x)
    g, ranks, _ = _group(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    if g is not None:
        dist.broadcast(out, src=ranks[src_index], group=g)
    return out


def ppermute(x: torch.Tensor, perm, axis_name="pipe"):
    """Index ``dst`` receives index ``src``'s value for each ``(src,
    dst)`` of ``perm``; an index that receives nothing gets zeros."""
    _log(f"ppermute[{axis_name}]", x)
    g, ranks, me = _group(axis_name)
    src = x.contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], g))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def axis_index(axis_name) -> int:
    return _group(axis_name)[2]


def reduce(x: torch.Tensor, dst_index: int = 0, op: str = SUM,
           axis_name="data"):
    """``dst_index`` receives the reduction; every other index keeps its
    input (reference comm.py:492)."""
    _log(f"reduce[{axis_name}]", x)
    red = all_reduce(x, op=op, axis_name=axis_name)
    return red if axis_index(axis_name) == dst_index else x.clone()


def gather(x: torch.Tensor, dst_index: int = 0, axis_name="data",
           axis: int = 0):
    """``dst_index`` gets the concatenation along ``axis``; the others
    zeros of that shape (reference comm.py:428)."""
    _log(f"gather[{axis_name}]", x)
    out = _all_gather(x, axis_name, axis, True)
    return out if axis_index(axis_name) == dst_index \
        else torch.zeros_like(out)


def scatter(x: torch.Tensor, src_index: int = 0, axis_name="data",
            axis: int = 0):
    """Each index receives its chunk of ``src_index``'s array along
    ``axis`` (reference comm.py:445)."""
    _log(f"scatter[{axis_name}]", x)
    n = _mesh.axis_size(axis_name) if _mesh.get_global_mesh() is not None \
        else 1
    if x.shape[axis] % n:
        raise ValueError(f"scatter: dim {axis} size {x.shape[axis]} not "
                         f"divisible by axis size {n}")
    src = broadcast(x, src_index=src_index, axis_name=axis_name)
    chunk = x.shape[axis] // n
    return src.narrow(axis, axis_index(axis_name) * chunk, chunk).clone()


def send_recv(x, pairs, axis_name="pipe"):
    """Point-to-point transfer as a permutation: ``pairs`` is ``[(src,
    dst), ...]``; indices not receiving get zeros (reference
    send/recv, comm.py:380-427)."""
    return ppermute(x, pairs, axis_name=axis_name)


# ---------------------------------------------------------------------------
# Host-level helpers
# ---------------------------------------------------------------------------

def barrier() -> None:
    """Cross-process sync point (reference dist.barrier)."""
    if get_world_size() > 1:
        dist.barrier()


def monitored_barrier(timeout=None) -> None:
    """A barrier that names the ranks it waits on (gloo); NCCL has no
    monitored barrier, so there the log lines bracket a plain one."""
    logger.info(f"monitored_barrier: process {get_rank()}"
                f"/{get_world_size()} entering")
    if get_world_size() > 1:
        if dist.get_backend() == "gloo":
            if isinstance(timeout, (int, float)):
                timeout = datetime.timedelta(seconds=timeout)
            dist.monitored_barrier(timeout=timeout)
        else:
            dist.barrier()
    logger.info(f"monitored_barrier: process {get_rank()} passed")


def broadcast_obj(obj: Any, root: int = 0) -> Any:
    """A picklable host object from process ``root`` to every process
    (checkpoint tag validation, reference engine.py:3043)."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def log_summary():
    comms_logger.log_all()


def destroy_process_group() -> None:
    """Tear down the process group and the mesh built over it."""
    global _INITIALIZED
    _mesh.reset_global_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False
