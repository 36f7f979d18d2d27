"""The decode step as one captured program: CUDA graphs.

Counterpart of how the JAX package runs its hot path: each step is one
compiled program, launched once per step. The JAX server jits its decode
and verify steps with the cache donated (``_decode_jit`` / ``_verify_jit``,
``deepspeed_tpu/inference/server.py:551-582``) and the JAX engine compiles
``generate``'s whole decode loop (``engine.py:795``, ``_generate_loop
:1022``). On CUDA the counterpart is a graph captured once per static shape
and replayed every step: one ``cudaGraphLaunch`` in place of the thousands
of kernel launches a step of the model makes from Python.

:class:`GraphedStep` holds one step function, its static input buffers,
its side stream, its ``torch.cuda.CUDAGraph`` and its static output:

* **Warm-up.** The first call runs the step eagerly on the side stream.
  That builds and loads every kernel library, makes cuBLAS's workspace for
  that stream, and creates the split kernels' ticket scratch, which
  ``ops/decode_attention.py`` keeps per stream, so that the capture
  allocates none of it.
* **Capture and replay.** The second call captures the step on the side
  stream (capture executes nothing, so it advances no state) and replays
  it; every later call replays. A replay runs on the caller's current
  stream, behind whatever the caller wrote into the static inputs there.
* **State.** The graph reads and writes the tensors it was captured with.
  The step's state (KV cache or pool, lengths, block tables) is updated in
  place by every writer, and each replay checks that the state tensors the
  caller names still sit at the captured addresses, raising otherwise.
* **Grad mode.** Warm-up and capture run under the caller's grad mode,
  which each caller keeps fixed (``no_grad`` for the server,
  ``inference_mode`` for ``generate``), so the graph's allocations are of
  the kind its state is: an inference tensor is written in place only in
  inference mode.
* **Output.** Each call returns a copy of the static output (one launch),
  so a step's result outlives the next replay: the server's lag-N loop
  holds several steps' tokens at once.
* **Launch counts.** The kernel wrappers count launches on the host
  (``ops.launch_counters``). A capture takes back what it counted, and each
  replay adds the captured counts again, so every count stays a count of
  kernel executions.
* **Garbage collection.** Destroying a graph while another is being
  captured invalidates that capture, and a cyclic garbage collection
  during a capture may destroy an earlier runner's unreachable graph
  (``torch.cuda.graph`` no longer collects before it captures). So a
  capture collects first and holds the collector off until it ends.
* **Collectives.** A step over a tensor or seq mesh makes all-reduces
  (``comm/comm.py``). NCCL's run on the device and are captured and
  replayed with the step; gloo's run on the host, so the engine and the
  server run such steps eagerly (decided at their construction), and a
  gloo collective met during a capture raises rather than be left out of
  the replay.
* **Compile watch.** With ``watch`` (a
  :class:`~deepspeed_tpu_torch.telemetry.compile_watch.WatchedFunction`)
  the capture is recorded as the step's compile, keyed by the static
  inputs' shapes and dtypes, with the capture's host wall as its time.
  Replays never build a key: the static inputs are the same tensors
  every step, so there is nothing new to see.
* **No fallback.** A capture or a replay that fails raises. The callers
  create a GraphedStep only for a CUDA device; on the CPU their steps run
  eagerly.

The scratch of a graph is that of its side stream. PyTorch hands out side
streams from a pool of 32 a device, round robin, so after 32 runners two of
them may share a stream and so their scratch. That is safe as long as
their replays run in order on one stream, as every caller in the package
replays them.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops import launch_counters


class GraphedStep:
    """One step function run as a CUDA graph (see the module doc).

    ``fn(*inputs)`` is the step: it reads the static ``inputs`` (device
    buffers the caller fills before each call) and returns one tensor.
    ``state()`` names the tensors the step reads and writes besides its
    inputs; their addresses are checked before every replay."""

    def __init__(self, name: str, fn: Callable[..., torch.Tensor],
                 inputs: Sequence[torch.Tensor],
                 state: Callable[[], Sequence[Optional[torch.Tensor]]],
                 watch=None):
        device = inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs CUDA inputs, got "
                             f"{device}")
        self.name = name
        self.inputs = tuple(inputs)
        self._fn = fn
        self._state = state
        self.watch = watch
        self._counters = launch_counters()
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0        # host wall of the capture
        self.pool_bytes = 0         # device memory the graph's pool reserved
        self._launches: Dict[str, int] = {}   # wrapper -> launches a replay
        self._addresses: Tuple[int, ...] = ()
        self._warm = False

    def __call__(self) -> torch.Tensor:
        if not self._warm:
            self._warm = True
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self._replay()
        return self.output.clone()

    def _state_addresses(self) -> Tuple[int, ...]:
        return tuple(0 if t is None else t.data_ptr() for t in self._state())

    def _warm_up(self) -> torch.Tensor:
        """The real step, eagerly, on the side stream."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._fn(*self.inputs)
        cur.wait_stream(self.stream)
        out.record_stream(cur)
        return out

    def _capture(self) -> None:
        before = {k: f.launches for k, f in self._counters.items()}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                reserved = torch.cuda.memory_reserved(self.stream.device)
                out = self._fn(*self.inputs)
        finally:
            if gc_on:
                gc.enable()
            # the capture executed nothing: take back what it counted
            counted = {k: f.launches - before[k]
                       for k, f in self._counters.items()}
            for k, n in counted.items():
                self._counters[k].launches -= n
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = (torch.cuda.memory_reserved(self.stream.device)
                           - reserved)
        self._launches = {k: n for k, n in counted.items() if n}
        self._addresses = self._state_addresses()
        self.graph, self.output = graph, out
        self.captures += 1
        if self.watch is not None:
            self.watch.record_compile(self.inputs, {}, self.capture_s)

    def _replay(self) -> None:
        if self._state_addresses() != self._addresses:
            raise RuntimeError(
                f"{self.name}: the step's state tensors moved since the "
                f"capture; the graph would read and write freed memory")
        self.graph.replay()
        self.replays += 1
        for k, n in self._launches.items():
            self._counters[k].launches += n

    def snapshot(self) -> dict:
        """Captures, replays, capture seconds and graph-pool bytes."""
        return {"captures": self.captures, "replays": self.replays,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "launches_per_replay": dict(self._launches)}
