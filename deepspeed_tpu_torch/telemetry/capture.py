"""On-demand ``torch.profiler`` capture, scoped in DECODE STEPS.

Host-pure copy of ``deepspeed_tpu/telemetry/capture.py`` (same keys, families,
help strings and ring events), over the port's registry and event ring.

"Trace the next N decode steps to this logdir" — the serving analog of
``nsys profile`` on a running daemon: always-on histograms say *that*
p99 regressed, a step-scoped Chrome trace says *where*. Arming is
host-only state; until armed, the per-step hooks are two attribute
reads, so the hot path pays nothing.

The start/stop functions are injectable so the state machine is testable
without a real profiler session (and so a broken profiler install
degrades capture, never the serving loop).
"""
from __future__ import annotations

from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger


_session: dict = {}


def _default_start(logdir: str) -> None:
    """Start a ``torch.profiler.profile`` session over the host and,
    where there is a card, the device."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _session["prof"], _session["logdir"] = prof, logdir


def _default_stop() -> None:
    """Stop the session and write its Chrome trace into the logdir as
    ``trace_<pid>_<n>.json``."""
    import os
    prof, logdir = _session.pop("prof"), _session.pop("logdir")
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


class ProfilerCapture:
    """Arm → capture N steps → auto-stop.

    The owner of a step loop calls ``step_begin()`` before dispatching
    the step and ``step_end()`` after it completes; the trace starts at
    the first ``step_begin`` after arming and stops at the Nth
    ``step_end``, so all N steps land fully inside the capture window.
    """

    def __init__(self, start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None):
        self._start = start_fn or _default_start
        self._stop = stop_fn or _default_stop
        self._remaining = 0
        self._logdir: Optional[str] = None
        self._tracing = False

    def arm(self, num_steps: int, logdir: str) -> None:
        """Request a capture of the next ``num_steps`` steps."""
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        if self._remaining or self._tracing:
            raise RuntimeError(
                "profiler capture already armed/active — one capture at "
                "a time (the profiler allows a single trace session)")
        self._remaining = int(num_steps)
        self._logdir = logdir

    @property
    def active(self) -> bool:
        """True between arming and the final step's completion."""
        return self._remaining > 0 or self._tracing

    def step_begin(self) -> None:
        if self._remaining and not self._tracing:
            try:
                self._start(self._logdir)
                self._tracing = True
                logger.info(f"profiler capture started → {self._logdir} "
                            f"({self._remaining} steps)")
            except Exception as e:  # noqa: BLE001 — never kill the loop
                logger.warning(f"profiler capture failed to start: {e}")
                self._remaining = 0

    def step_end(self) -> None:
        if not self._tracing:
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self._tracing = False
            try:
                self._stop()
                logger.info(f"profiler capture written to {self._logdir}")
            except Exception as e:  # noqa: BLE001
                logger.warning(f"profiler capture failed to stop: {e}")
