"""ZeRO-Offload: the optimizer state in host memory.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py`` (reference
stage-1/2 ``cpu_offload``, ``stage_1_and_2.py:1069-1219``: grads stream
into pinned host buffers, the fp32 master update runs in DeepSpeedCPUAdam,
the updated 16-bit params copy back). Two realizations, picked by
``offload_optimizer.implementation`` (``runtime/engine.py``):

* :class:`HostOffloadOptimizer` (``host``): the fp32 master and the Adam
  moments are plain (pageable) host tensors, updated by the C++ SIMD Adam
  of ``ops/cpu_adam.py``, which writes the bf16 copy in the same pass.
  :meth:`~HostOffloadOptimizer.step_streamed` pipelines the leaves in
  chunks of ``CHUNK`` elements through a few pinned staging slots: the
  device→host copy of a finished gradient chunk (a copy stream), the host
  Adam on the chunk that landed, and the host→device copy of its 16-bit
  payload (a second copy stream) overlap across chunks. Pinned memory is
  bounded by ``slots`` chunks, whatever the model's size. Chunks start at
  multiples of 4096 elements, the C++ step's block, so the bits are those
  of one call over each whole leaf (the JAX package's).
* :class:`StreamedOffloadOptimizer` (``stream``, CUDA only): the fp32
  master and the optimizer state live in pinned host memory; each leaf is
  copied to the card, updated there by the engine's own optimizer
  (``ops/adam.py``) and copied back, the copies on two side streams
  overlapping the next leaf's update. Its numbers are the in-HBM path's.

With ``device="nvme"`` (the host path only) the moments live in swap
files under ``nvme_path`` and stream through the C++ aio pool around each
leaf's update (``runtime/swap_tensor``), double-buffered: the next leaf's
moments are read while the current leaf is updated, so host memory for the
moments is two arenas of the largest leaf, whatever the model's size (JAX
``runtime/zero/offload.py``). :meth:`~HostOffloadOptimizer.step_swapped`
takes each leaf's gradient from the card as the pipeline reaches it (two
pinned slots of the largest leaf), never the whole gradient tree at once.
Its bits are the host tier's: the same kernel, one bias-correction step
for all leaves.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.utils.logging import logger

CHUNK = 1 << 24       # elements a pipeline chunk (a multiple of 4096)
SLOTS = 4             # pinned staging slots of the pipeline


PARTS = ("m", "v")    # the Adam moments of a leaf, as JAX names them


class HostOffloadOptimizer:
    """Owns the host fp32 master and moments and the update step."""

    def __init__(self, params: Dict[str, torch.Tensor], optimizer_params,
                 device: str = "cpu", nvme_path: Optional[str] = None,
                 use_native: bool = True, chunk: int = CHUNK,
                 slots: int = SLOTS, aio_threads: int = 4):
        if chunk % 4096:
            raise ValueError(f"chunk {chunk} is not a multiple of 4096")
        p = dict(optimizer_params or {})
        self.adam = DeepSpeedCPUAdam(
            lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
            use_native=use_native)
        self.device = device
        self.shapes = {k: tuple(v.shape) for k, v in params.items()}
        # the fp32 master in pageable host memory, one flat tensor a leaf
        self.master = {k: torch.as_tensor(v).detach().to(
            "cpu", torch.float32, copy=True).reshape(-1)
            for k, v in params.items()}
        self.keys = list(self.master)
        self.chunk, self.slots = chunk, slots
        self._bf16_out = None
        self._staging = None    # pinned slots, made on the first CUDA step
        self._streams = None
        self._arenas = None     # the NVMe tier's two moment arenas
        self._arena_idx = 0
        self.last_times: Dict[str, float] = {}
        self.swapper = None
        if device == "nvme":
            if not nvme_path:
                raise ValueError("offload_optimizer.device=nvme requires "
                                 "nvme_path")
            from deepspeed_tpu_torch.runtime.swap_tensor import \
                OptimizerStateSwapper
            self.swapper = OptimizerStateSwapper(nvme_path, aio_threads)
            t = time.perf_counter()
            # zero moments on disk: files of holes, which read as zeros
            # and are written first by the first step's write-back
            for k, w in self.master.items():
                self.swapper.zero_state(k, {p: 4 * w.numel()
                                            for p in PARTS})
            self.state = None
            self.init_s = time.perf_counter() - t
            gb = 8 * sum(w.numel() for w in self.master.values()) / 1e9
            logger.info(f"optimizer state swapped to NVMe at {nvme_path}: "
                        f"{gb:.2f} GB of zero moments made in "
                        f"{self.init_s:.1f} s")
        else:
            self.state = self.adam.init_state(self.master)
        mb = sum(w.numel() * 4 for w in self.master.values()) / 2 ** 20
        logger.info(f"host-offload optimizer: {len(self.keys)} leaves, fp32 "
                    f"master {mb:.0f} MiB on host, moments on {device}, "
                    f"native SIMD={self.adam.native}")

    # ------------------------------------------------------------ steps
    def step(self, grads_host: Dict[str, Any], lr: float,
             param_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        """Update the master in place from host f32 grads (flat); return
        the new params in ``param_dtype`` (host tensors, the leaves'
        shapes)."""
        bf16 = param_dtype == torch.bfloat16
        if bf16 and self._bf16_out is None:
            self._bf16_out = {k: torch.empty(w.shape, dtype=torch.bfloat16)
                              for k, w in self.master.items()}
        if self.swapper is not None:   # leaf by leaf over the swap files
            out = self._bf16_out if bf16 else {
                k: torch.empty(s, dtype=param_dtype)
                for k, s in self.shapes.items()}
            self.step_swapped({k: torch.as_tensor(g)
                               for k, g in grads_host.items()}, lr, out)
            return {k: out[k].reshape(self.shapes[k]) for k in self.keys}
        self.adam.step(self.master, grads_host, self.state, lr=lr,
                       bf16_out=self._bf16_out if bf16 else None)
        return {k: (self._bf16_out[k] if bf16
                    else self.master[k].to(param_dtype)).reshape(
                        self.shapes[k]) for k in self.keys}

    def step_streamed(self, grads: Dict[str, torch.Tensor], lr: float,
                      params: Dict[str, torch.Tensor]) -> None:
        """One Adam step over every leaf: ``grads`` (f32 or bf16, on the
        card or on the host) in, the new params written into ``params``
        (their dtype, on the card or on the host) in place. Numerically
        :meth:`step` (the same kernel, one bias-correction step for all
        leaves). On CUDA grads the chunk pipeline of the module docstring
        runs; ``last_times`` then holds its seconds: ``d2h_s`` and
        ``h2d_s`` the copy streams' busy time (CUDA events), ``adam_s``
        the host Adam, ``wait_s`` the host's waits for gradient chunks,
        ``tail_s`` the wait for the last payload copies, ``total_s`` the
        whole call."""
        if self.swapper is not None:
            raise RuntimeError("step_streamed does not support NVMe-swapped "
                               "moments; use step()")
        t0 = time.perf_counter()
        step = self.adam.step_count + 1
        cuda = any(g.is_cuda for g in grads.values())
        if cuda:
            self._step_pipelined(grads, lr, params, step)
        else:
            adam_s = 0.0
            for k in self.keys:
                g = grads[k].detach().reshape(-1)
                if g.dtype != torch.float32 or not g.is_contiguous():
                    g = g.to(torch.float32).contiguous()
                dst = params[k].detach()
                direct = (dst.dtype == torch.bfloat16 and dst.is_contiguous()
                          and dst.device.type == "cpu")
                out = dst.view(-1) if direct else None
                t = time.perf_counter()
                self.adam.step({k: self.master[k]}, {k: g},
                               {k: self.state[k]}, lr=lr,
                               bf16_out=None if out is None else {k: out},
                               step=step)
                adam_s += time.perf_counter() - t
                if not direct:
                    dst.copy_(self.master[k].reshape(dst.shape))
            self.last_times = {"adam_s": adam_s}
        self.last_times["total_s"] = time.perf_counter() - t0

    def _slots(self, device, gdtype, pdtype):
        """The pinned staging slots for (grad dtype, param dtype), made
        once and reused every step."""
        key = (gdtype, pdtype)
        if self._staging is None or self._staging[0] != key:
            n = self.chunk

            def pinned(dtype):
                return torch.empty(n, dtype=dtype, pin_memory=True)
            self._staging = (key, [
                {"g": pinned(gdtype),
                 "g32": pinned(torch.float32) if gdtype != torch.float32
                 else None,
                 "out": pinned(pdtype),
                 "d2h": torch.cuda.Event(), "h2d": None}
                for _ in range(self.slots)])
        if self._streams is None:
            self._streams = (torch.cuda.Stream(device),
                             torch.cuda.Stream(device))
        return self._staging[1]

    def _step_pipelined(self, grads, lr, params, step):
        keys = self.keys
        g0 = grads[keys[0]]
        device = g0.device
        gdtype = g0.dtype
        pdtype = params[keys[0]].dtype
        slots = self._slots(device, gdtype, pdtype)
        d2h, h2d = self._streams
        compute = torch.cuda.current_stream(device)
        ready = torch.cuda.Event()
        ready.record(compute)
        d2h.wait_event(ready)
        h2d.wait_event(ready)   # the step's params are no longer read
        chunks = [(k, lo, min(lo + self.chunk, self.master[k].numel()))
                  for k in keys for lo in range(0, self.master[k].numel(),
                                                self.chunk)]
        timed = []   # (start, end) event pairs of every copy, by stream

        def fetch(i):
            k, lo, hi = chunks[i]
            s = slots[i % len(slots)]
            src = grads[k].detach().reshape(-1)[lo:hi]
            with torch.cuda.stream(d2h):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record(d2h)
                s["g"][:hi - lo].copy_(src, non_blocking=True)
                b.record(d2h)
                s["d2h"].record(d2h)
            timed.append(("d2h", a, b))

        for i in range(min(len(slots), len(chunks))):
            fetch(i)
        adam_s = wait_s = 0.0
        for i, (k, lo, hi) in enumerate(chunks):
            s = slots[i % len(slots)]
            n = hi - lo
            t = time.perf_counter()
            s["d2h"].synchronize()
            if s["h2d"] is not None:
                s["h2d"].synchronize()   # the slot's last payload is out
            t1 = time.perf_counter()
            wait_s += t1 - t
            g = s["g"][:n]
            if s["g32"] is not None:
                s["g32"][:n].copy_(g)
                g = s["g32"][:n]
            dst = params[k].detach().view(-1)[lo:hi]
            # params on the host (offload_param): the payload lands there
            on_host = dst.device.type == "cpu"
            out = dst if on_host else s["out"][:n]
            st = {p: a[lo:hi] for p, a in self.state[k].items()}
            if pdtype == torch.bfloat16:
                self.adam.step({k: self.master[k][lo:hi]}, {k: g}, {k: st},
                               lr=lr, bf16_out={k: out}, step=step)
            else:
                self.adam.step({k: self.master[k][lo:hi]}, {k: g}, {k: st},
                               lr=lr, step=step)
                out.copy_(self.master[k][lo:hi])
            t2 = time.perf_counter()
            adam_s += t2 - t1
            if i + len(slots) < len(chunks):
                fetch(i + len(slots))   # the slot's gradient was read
            if on_host:
                continue
            with torch.cuda.stream(h2d):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record(h2d)
                dst.copy_(out, non_blocking=True)
                b.record(h2d)
                ev = torch.cuda.Event()
                ev.record(h2d)
            s["h2d"] = ev
            timed.append(("h2d", a, b))
        t = time.perf_counter()
        h2d.synchronize()
        d2h.synchronize()
        tail_s = time.perf_counter() - t
        # the next step's backward writes the gradients and reads the
        # params the copy streams touched
        compute.wait_stream(d2h)
        compute.wait_stream(h2d)
        busy = {"d2h": 0.0, "h2d": 0.0}
        for what, a, b in timed:
            busy[what] += a.elapsed_time(b) / 1e3
        self.last_times = {"d2h_s": busy["d2h"], "adam_s": adam_s,
                           "h2d_s": busy["h2d"], "wait_s": wait_s,
                           "tail_s": tail_s, "chunks": len(chunks)}

    # ------------------------------------------------------------- NVMe
    def _nvme_buffers(self, key: str) -> Dict[str, torch.Tensor]:
        """The moment arenas: at most two leaves are live at a time (the
        current one and the prefetch), so two arenas of the largest leaf
        bound host memory whatever the model's size (JAX
        ``_nvme_buffers``)."""
        if self._arenas is None:
            n = max(w.numel() for w in self.master.values())
            self._arenas = [{p: torch.empty(n, dtype=torch.float32)
                             for p in PARTS} for _ in range(2)]
        n = self.master[key].numel()
        arena = self._arenas[self._arena_idx % 2]
        self._arena_idx += 1
        return {p: a[:n] for p, a in arena.items()}

    def step_swapped(self, grads: Dict[str, torch.Tensor], lr: float,
                     params: Dict[str, torch.Tensor]) -> None:
        """The NVMe tier's step: :meth:`step_streamed`'s contract (grads
        on the card or the host in, new params written into ``params``
        in place), leaf by leaf over ``iter_pipelined``. On the card a
        leaf's gradient is copied to one of two pinned slots of the
        largest leaf on a copy stream while the previous leaf is updated,
        and its payload goes back from a second pair of slots, so the
        whole gradient tree never sits in host memory. ``last_times``:
        ``io_s`` the waits for the swap files, ``adam_s``, ``wait_s`` the
        waits for gradients, ``total_s``, and the bytes read and
        written."""
        t0 = time.perf_counter()
        step = self.adam.step_count + 1
        keys = self.keys
        cuda = any(g.is_cuda for g in grads.values())
        slots = fetch = None
        if cuda:
            slots, fetch, h2d, d2h = self._swap_slots(grads, params)
            fetch(0)
        adam_s = wait_s = io_s = 0.0
        t_end = time.perf_counter()
        for i, (k, st) in enumerate(self.swapper.iter_pipelined(
                keys, self._nvme_buffers)):
            t = time.perf_counter()
            io_s += t - t_end
            n = self.master[k].numel()
            dst = params[k].detach()
            on_host = dst.device.type == "cpu"
            if cuda:
                s = slots[i % 2]
                s["d2h"].synchronize()
                if s["h2d"] is not None:
                    s["h2d"].synchronize()   # the slot's payload is out
                g = s["g"][:n]
                if s["g32"] is not None:
                    s["g32"][:n].copy_(g)
                    g = s["g32"][:n]
                if i + 1 < len(keys):
                    fetch(i + 1)   # the next leaf's gradient, meanwhile
            else:
                g = grads[k].detach().reshape(-1)
                if g.dtype != torch.float32 or not g.is_contiguous():
                    g = g.to(torch.float32).contiguous()
            direct = (dst.dtype == torch.bfloat16 and dst.is_contiguous()
                      and on_host)
            if direct:
                out = dst.view(-1)
            elif cuda and not on_host and dst.dtype == torch.bfloat16:
                out = s["out"][:n]
            else:
                out = None
            t1 = time.perf_counter()
            wait_s += t1 - t
            self.adam.step({k: self.master[k]}, {k: g}, {k: st}, lr=lr,
                           bf16_out=None if out is None else {k: out},
                           step=step)
            adam_s += time.perf_counter() - t1
            if not direct:
                if cuda and not on_host:
                    if out is None:
                        out = s["out"][:n]
                        out.copy_(self.master[k])
                    with torch.cuda.stream(h2d):
                        dst.view(-1).copy_(out, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(h2d)
                    s["h2d"] = ev
                else:
                    dst.copy_(self.master[k].reshape(dst.shape))
            t_end = time.perf_counter()
        if cuda:
            h2d.synchronize()
            d2h.synchronize()
            compute = torch.cuda.current_stream(h2d.device)
            compute.wait_stream(d2h)
            compute.wait_stream(h2d)
        moved = 8 * sum(w.numel() for w in self.master.values())
        self.last_times = {"io_s": io_s, "adam_s": adam_s, "wait_s": wait_s,
                           "total_s": time.perf_counter() - t0,
                           "swap_read_bytes": moved,
                           "swap_write_bytes": moved}

    def _swap_slots(self, grads, params):
        """Two pinned slots of the largest leaf for :meth:`step_swapped`
        (made once) and the copy streams; returns ``(slots, fetch, h2d,
        d2h)``, ``fetch(i)`` queuing leaf ``i``'s gradient copy."""
        keys = self.keys
        g0 = grads[keys[0]]
        gdtype, pdtype = g0.dtype, params[keys[0]].dtype
        key = ("swap", gdtype, pdtype)
        if self._staging is None or self._staging[0] != key:
            n = max(w.numel() for w in self.master.values())

            def pinned(dtype):
                return torch.empty(n, dtype=dtype, pin_memory=True)
            self._staging = (key, [
                {"g": pinned(gdtype),
                 "g32": pinned(torch.float32) if gdtype != torch.float32
                 else None,
                 "out": pinned(pdtype), "d2h": torch.cuda.Event(),
                 "h2d": None} for _ in range(2)])
        if self._streams is None:
            self._streams = (torch.cuda.Stream(g0.device),
                             torch.cuda.Stream(g0.device))
        d2h, h2d = self._streams
        compute = torch.cuda.current_stream(g0.device)
        ready = torch.cuda.Event()
        ready.record(compute)
        d2h.wait_event(ready)
        h2d.wait_event(ready)
        slots = self._staging[1]
        for s in slots:
            s["h2d"] = None

        def fetch(i):
            k = keys[i]
            s = slots[i % 2]
            src = grads[k].detach().reshape(-1)
            with torch.cuda.stream(d2h):
                s["g"][:src.numel()].copy_(src, non_blocking=True)
                s["d2h"].record(d2h)
        return slots, fetch, h2d, d2h

    def moments(self, key: str) -> Dict[str, torch.Tensor]:
        """Leaf ``key``'s moments (flat f32): the host state, or read from
        the swap files into new tensors."""
        if self.swapper is None:
            return self.state[key]
        bufs = {p: torch.empty(self.master[key].numel(), dtype=torch.float32)
                for p in PARTS}
        self.swapper.read_state(key, bufs, sync=True)
        return bufs

    def set_moment(self, key: str, part: str, flat) -> None:
        """Overwrite one moment of a leaf (flat f32), on disk where the
        moments are swapped."""
        flat = torch.as_tensor(flat).to(torch.float32).reshape(-1)
        if self.swapper is None:
            self.state[key][part].copy_(flat)
        else:
            self.swapper.write_state(key, {part: flat.contiguous()},
                                     sync=True)

    def close(self) -> None:
        """Close the aio handle of the swap files."""
        if self.swapper is not None:
            self.swapper.close()

    # --------------------------------------------------------- restore
    def sync_master_from(self, params: Dict[str, torch.Tensor]) -> None:
        """Re-seed the fp32 master from (restored) params."""
        for k in self.keys:
            self.master[k].copy_(params[k].detach().reshape(-1))

    def state_dict(self) -> Dict[str, Any]:
        """The master, the moments (read from the swap files on the NVMe
        tier: every moment in host memory at once, as in JAX) and the
        step."""
        state = (self.state if self.swapper is None else
                 {k: self.moments(k) for k in self.keys})
        return {"master": self.master, "state": state,
                "step": self.adam.step_count}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for k in self.keys:
            self.master[k].copy_(torch.as_tensor(sd["master"][k]))
        self.adam.step_count = int(sd["step"])
        for k in self.keys:
            for p in PARTS:
                self.set_moment(k, p, sd["state"][k][p])


class StreamedOffloadOptimizer:
    """``implementation='stream'``: the f32 master (mixed precision) and
    the optimizer state's tensors in pinned host memory, each leaf updated
    on the card by ``optimizer`` between two copies. ``master`` and
    ``opt_state`` have the in-HBM engine's layout (host tensors), so
    checkpoints are the same files."""

    def __init__(self, optimizer, params: Dict[str, torch.Tensor],
                 mixed: bool):
        self.optimizer = optimizer
        self.mixed = mixed

        def pinned(t):
            out = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
            return out.copy_(t)
        self.master = ({k: pinned(v.detach()) for k, v in params.items()}
                       if mixed else None)
        src = self.master if mixed else {
            k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in params.items()}
        state = optimizer.init(src)
        self.fields = [f.name for f in dataclasses.fields(state)
                       if isinstance(getattr(state, f.name), dict)]
        for f in self.fields:   # the moments, pinned
            setattr(state, f, {k: torch.zeros(v.shape, dtype=torch.float32,
                                              pin_memory=True)
                               for k, v in getattr(state, f).items()})
        self.opt_state = state
        self._streams = None
        self._pending = None

    def synchronize(self) -> None:
        """Wait until the last step's copies back to the host landed (for
        readers of the host tensors)."""
        if self._pending is not None:
            self._pending.synchronize()
            self._pending = None

    def step(self, grads: Dict[str, torch.Tensor], lr: float,
             params: Dict[str, torch.Tensor]) -> None:
        names = list(params)
        device = params[names[0]].device
        if self._streams is None:
            self._streams = (torch.cuda.Stream(device),
                             torch.cuda.Stream(device))
        h2d, d2h = self._streams
        compute = torch.cuda.current_stream(device)
        h2d.wait_stream(d2h)   # last step's state is back on the host
        hosts = ([self.master] if self.mixed else []) + [
            getattr(self.opt_state, f) for f in self.fields]
        count = self.opt_state.count

        def fetch(n):
            # allocated on the copy stream, so no memory the compute
            # stream may still use is written early
            with torch.cuda.stream(h2d):
                bufs = [torch.empty(t[n].shape, dtype=torch.float32,
                                    device=device) for t in hosts]
                for b, t in zip(bufs, hosts):
                    b.copy_(t[n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(h2d)
            return bufs, ev

        nxt = fetch(names[0])
        for i, n in enumerate(names):
            bufs, ev = nxt
            if i + 1 < len(names):
                nxt = fetch(names[i + 1])
            compute.wait_event(ev)
            master = bufs[0] if self.mixed else params[n].detach()
            state = dataclasses.replace(self.opt_state, count=count, **{
                f: {n: b} for f, b in zip(self.fields,
                                          bufs[1 if self.mixed else 0:])})
            updates, _ = self.optimizer.update({n: grads[n]}, state,
                                               {n: master}, lr)
            torch._foreach_add_([master], [updates[n]])
            del updates
            if self.mixed:
                torch._foreach_copy_([params[n].detach()], [master])
            done = torch.cuda.Event()
            done.record(compute)
            with torch.cuda.stream(d2h):
                d2h.wait_event(done)
                for b, t in zip(bufs, hosts):
                    t[n].copy_(b, non_blocking=True)
            for b in bufs:
                b.record_stream(compute)
                b.record_stream(d2h)
            del bufs
        self.opt_state.count = count + 1
        self._pending = torch.cuda.Event()
        self._pending.record(d2h)
