"""nvcc builder + ctypes loader for the port's CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder/builder.py`` (g++ + ctypes
for host ops). Each ``deepspeed_tpu_torch/ops/csrc/<name>.cu`` compiles on
first use, by itself, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/deepspeed_tpu_torch_kernels/<name>-<hash>.so

cached by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, and loaded with ctypes. No source includes a PyTorch header, so a
build takes seconds.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
A build that fails raises: there is no path around a missing kernel.

:class:`HostOpBuilder` does the same for the host ops under
``ops/csrc/<name>.cpp`` (the ZeRO-Offload Adam) with g++ and the JAX
package's flags (``HOST_CXX_FLAGS``), cached by a hash of the source, the
flags and the host CPU (``-march=native`` code must not reach another
CPU). There is no retry without ``-march=native`` or ``-fopenmp`` and no
numpy fallback behind a failed build: it raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

from deepspeed_tpu_torch.utils.logging import logger

_PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = _PKG_ROOT / "ops" / "csrc"
BUILD_DIR = _PKG_ROOT.parent / "build" / "deepspeed_tpu_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default place; raises when there is none."""
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
                  if os.environ.get("CUDA_HOME") else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "deepspeed_tpu_torch are built from source on first "
                       "use")


class CUDAOpBuilder:
    """One ``.cu`` source → one cached ``.so``. ``bind`` sets ``argtypes``
    and ``restype`` on the loaded library's functions."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[str] = None
        self.ptxas_log = ""   # ``-Xptxas -v``: registers, shared memory, spills

    def so_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):   # shared device helpers
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> None:
        """Start ``nvcc`` in the background unless the library is cached."""
        so = self.so_path()
        if so.is_file() or self._proc is not None:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one tmp file per process: concurrent first-use builds never
        # write into the same file
        self._tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, str(self.source), "-o", self._tmp]
        logger.info(f"building CUDA kernel {self.name}: {' '.join(cmd)}")
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)

    def finish_build(self) -> None:
        """Wait for the build started by :meth:`start_build`; raise if
        ``nvcc`` failed."""
        if self._proc is None:
            return
        out, err = self._proc.communicate()
        rc, self._proc = self._proc.returncode, None
        self.ptxas_log = err
        if rc != 0:
            raise RuntimeError(f"nvcc failed to build {self.name} "
                               f"(exit {rc}):\n{out}\n{err}")
        os.replace(self._tmp, self.so_path())

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        if self._lib is None:
            self.start_build()
            self.finish_build()
            lib = ctypes.CDLL(str(self.so_path()))
            self._bind(lib)
            lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dstt_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.dstt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """SMs of the CUDA ``device`` (a ``torch.device``; the current device
    when it has no index), read once per device: the kernels' grids and
    split plans are sized from it."""
    import torch
    return _sms(torch.cuda.current_device() if device.index is None
                else device.index)


HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
                  "-fopenmp"]


def find_cxx() -> str:
    """``g++`` (else ``c++``) on the PATH; raises when there is none."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on the PATH: the host ops "
                           "of deepspeed_tpu_torch are built from source on "
                           "first use")
    return cxx


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags, for the cache key."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


class HostOpBuilder:
    """One ``ops/csrc/<name>.cpp`` → one cached ``.so`` built by g++ and
    loaded with ctypes; ``bind`` sets the functions' signatures."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cpp"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def so_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(HOST_CXX_FLAGS).encode())
        h.update(_host_cpu())
        return BUILD_DIR / f"{self.name}-host-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; raise if g++ fails."""
        if self._lib is None:
            so = self.so_path()
            if not so.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [find_cxx(), *HOST_CXX_FLAGS, str(self.source), "-o",
                       tmp]
                logger.info(f"building host op {self.name}: {' '.join(cmd)}")
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed to build {self.name} (exit "
                        f"{r.returncode}):\n{r.stdout}\n{r.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(builders: Iterable[CUDAOpBuilder]) -> Dict[str, ctypes.CDLL]:
    """Build every kernel in parallel (one ``nvcc`` per source, all started
    together), then load each."""
    builders = list(builders)
    for b in builders:
        b.start_build()
    for b in builders:
        b.finish_build()
    return {b.name: b.load() for b in builders}
