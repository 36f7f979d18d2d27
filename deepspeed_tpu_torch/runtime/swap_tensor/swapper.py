"""Optimizer-state NVMe swapper.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/swapper.py`` (reference
``partitioned_optimizer_swapper.py`` + ``async_swapper.py``): the optimizer
moments live in files under ``swap_dir``; around each leaf's update its
state is read in, updated in host memory and written back, with the next
leaf's read queued before the caller updates the current one
(:meth:`OptimizerStateSwapper.iter_pipelined`). File names are JAX's
(``_path``), so the two packages' swap directories look alike.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Tuple

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle


class OptimizerStateSwapper:
    def __init__(self, swap_dir: str, num_threads: int = 4):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.aio = AsyncIOHandle(num_threads)
        self._initialized: set = set()

    def _path(self, key: str, part: str) -> str:
        safe = key.replace("/", "_").replace(".", "_")
        return os.path.join(self.swap_dir, f"{safe}.{part}.swp")

    def write_state(self, key: str, state: Dict, sync: bool = False) -> None:
        for part, arr in state.items():
            self.aio.pwrite(self._path(key, part), arr)
        self._initialized.add(key)
        if sync:
            self.ensure(self.aio.wait() == 0, f"swap-out of {key}")

    def zero_state(self, key: str, nbytes: Dict[str, int]) -> None:
        """Zero state files of ``nbytes[part]`` bytes each, made as holes
        (truncated to length): they read back as zeros, as JAX's written
        zeros do, and cost no disk write until the first write-back."""
        for part, n in nbytes.items():
            with open(self._path(key, part), "wb") as f:
                f.truncate(int(n))
        self._initialized.add(key)

    def read_state(self, key: str, buffers: Dict, sync: bool = False) -> None:
        for part, arr in buffers.items():
            self.aio.pread(self._path(key, part), arr)
        if sync:
            self.ensure(self.aio.wait() == 0, f"swap-in of {key}")

    def wait(self) -> None:
        self.ensure(self.aio.wait() == 0, "pending swaps")

    @staticmethod
    def ensure(ok: bool, what: str) -> None:
        if not ok:
            raise IOError(f"NVMe swap failed: {what}")

    def iter_pipelined(self, keys: List[str],
                       make_buffers: Callable[[str], Dict]
                       ) -> Iterator[Tuple[str, Dict]]:
        """Yield ``(key, state_buffers)`` with the next key's read in
        flight while the caller updates the current one.
        ``make_buffers(key)`` gives the host buffers for a key. After the
        caller's update the state is written back and every request
        waited for before the next key is yielded: a buffer is reused
        only once its write has landed."""
        if not keys:
            return
        bufs = {keys[0]: make_buffers(keys[0])}
        self.read_state(keys[0], bufs[keys[0]], sync=True)
        for i, key in enumerate(keys):
            if i + 1 < len(keys):
                bufs[keys[i + 1]] = make_buffers(keys[i + 1])
                self.read_state(keys[i + 1], bufs[keys[i + 1]])
            yield key, bufs[key]
            # the caller updated bufs[key]: write it back, and wait for
            # that write and the prefetch together
            self.write_state(key, bufs[key])
            self.wait()
            del bufs[key]

    def close(self) -> None:
        self.aio.close()
