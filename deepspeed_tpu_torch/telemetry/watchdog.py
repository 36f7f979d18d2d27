"""Hang watchdog: progress deadline + forensic dump.

Host-pure copy of ``deepspeed_tpu/telemetry/watchdog.py``.

A wedged collective or a deadlocked host thread produces no error —
only silence. The watchdog turns that silence into a dump: the step
loop calls :meth:`Watchdog.notify_progress` every time a step/decode
completes; a config-gated background thread checks the deadline, and
when no progress lands inside it, fires ONCE per stall — dumping the
flight-recorder event ring plus every thread's stack to the log (and
optionally a file) before the operator has to guess.

Testability: the clock is injectable and :meth:`check` is callable
directly, so tier-1 tests drive a fake clock with zero real sleeps; the
thread (:meth:`start`) is just a loop around ``check``.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import deepspeed_tpu_torch.telemetry.events as _ev
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry, get_registry
from deepspeed_tpu_torch.utils.logging import logger


def thread_stacks() -> dict:
    """Current stack of every python thread, keyed by thread name —
    the "where is everyone stuck" half of the stall dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = traceback.format_stack(frame)
    return out


class Watchdog:
    """Deadline on step progress; fires a forensic dump on stall.

    ``deadline_s`` — seconds without :meth:`notify_progress` before the
    watchdog fires. One dump per stall: after firing it re-arms only
    when progress resumes, so a long hang produces one dump, not one
    per check interval.
    """

    def __init__(self, deadline_s: float,
                 registry: Optional[MetricRegistry] = None,
                 ring: Optional[_ev.EventRing] = None,
                 clock: Callable[[], float] = time.monotonic,
                 dump_path: Optional[str] = None,
                 on_dump: Optional[Callable[[dict], None]] = None,
                 name: str = "watchdog"):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.name = name
        self._registry = registry
        self._ring = ring
        self._clock = clock
        self._dump_path = dump_path
        self._on_dump = on_dump
        self._lock = threading.Lock()
        self._last_progress = clock()
        self._fired = False
        self._disarmed = False
        self.stalls = 0
        self.last_dump: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None

    # ------------------------------------------------------------ progress

    def set_on_dump(self, on_dump) -> None:
        """Install/replace the advisory dump callback after
        construction — the incident recorder (telemetry/incident.py)
        unifies the stall-dump path with alert-fire capture this way."""
        self._on_dump = on_dump

    def notify_progress(self) -> None:
        """Call at every step/decode completion — a host attribute write
        under an uncontended lock, nothing the hot path can feel."""
        with self._lock:
            self._last_progress = self._clock()
            self._fired = False

    def idle_seconds(self) -> float:
        """Seconds since the last :meth:`notify_progress` — the heartbeat
        age a supervisor (inference/frontend.py) reads to drive its
        replica health state machine without touching the dump path."""
        with self._lock:
            return self._clock() - self._last_progress

    def disarm(self) -> None:
        """Permanently silence :meth:`check` (until a future
        :meth:`start`): an owner tearing itself down calls this FIRST,
        so neither the checker thread nor a late manual check can fire
        a fresh dump against teardown-time idleness. ``stop()`` alone
        deliberately does not disarm — tests drive a stopped watchdog's
        ``check()`` by hand."""
        with self._lock:
            self._disarmed = True
            # a disarm issued DURING an active suspend() must survive
            # the suspension exit's restore of the entry-time flag
            self._suspend_prev_disarmed = True

    def suspend(self):
        """Context manager for known-long legitimate pauses — a
        checkpoint save/verify or a supervised recovery rollback stops
        step progress for real seconds, and the deadline must not read
        that as a hang. Entering disarms the checker; exiting re-arms it
        AND counts the whole pause as progress (the deadline restarts
        from now, not from the last pre-pause step). Re-entrant: nested
        suspensions re-arm only when the outermost one exits."""
        import contextlib

        @contextlib.contextmanager
        def _scope():
            with self._lock:
                depth = getattr(self, "_suspend_depth", 0)
                if depth == 0:
                    # a watchdog its owner already disarmed (teardown)
                    # must stay disarmed after the suspension exits
                    self._suspend_prev_disarmed = self._disarmed
                self._suspend_depth = depth + 1
                self._disarmed = True
            try:
                yield self
            finally:
                with self._lock:
                    self._suspend_depth -= 1
                    if self._suspend_depth == 0:
                        self._disarmed = self._suspend_prev_disarmed
                        self._last_progress = self._clock()
                        self._fired = False
        return _scope()

    def check(self) -> bool:
        """Evaluate the deadline now; returns True if a dump fired. A
        disarmed watchdog never fires: teardown of an already-stalled
        owner (a supervisor closing a dead replica) must not race the
        checker thread into a second dump for the same stall."""
        with self._lock:
            idle = self._clock() - self._last_progress
            if self._disarmed or self._fired or idle <= self.deadline_s:
                return False
            self._fired = True
            self.stalls += 1
        self._fire(idle)
        return True

    # ---------------------------------------------------------------- dump

    def _fire(self, idle_s: float) -> None:
        # explicit None checks: an empty EventRing is falsy (__len__)
        ring = self._ring if self._ring is not None \
            else _ev.get_event_ring()
        reg = self._registry if self._registry is not None \
            else get_registry()
        dump = {
            "watchdog": self.name,
            "idle_seconds": round(idle_s, 3),
            "deadline_seconds": self.deadline_s,
            "events": json.loads(ring.to_json()),
            "threads": thread_stacks(),
        }
        self.last_dump = dump
        reg.counter("watchdog_stalls_total",
                    help="watchdog deadline expiries (one per stall)",
                    labels={"watchdog": self.name}).inc()
        ring.record(_ev.WATCHDOG_DUMP, watchdog=self.name,
                    idle_seconds=round(idle_s, 3))
        logger.error(
            f"[{self.name}] no step progress for {idle_s:.1f}s "
            f"(deadline {self.deadline_s}s) — dumping event ring "
            f"({len(dump['events']['events'])} events) and "
            f"{len(dump['threads'])} thread stacks")
        for name, stack in dump["threads"].items():
            logger.error(f"[{self.name}] thread {name}:\n"
                         + "".join(stack[-8:]))
        if self._dump_path:
            try:
                with open(self._dump_path, "w") as f:
                    json.dump(dump, f, default=str)
                logger.error(f"[{self.name}] dump written to "
                             f"{self._dump_path}")
            except OSError as e:
                logger.warning(f"[{self.name}] dump write failed: {e}")
        if self._on_dump is not None:
            try:
                self._on_dump(dump)
            except Exception as e:  # noqa: BLE001 — callback is advisory
                logger.warning(f"[{self.name}] on_dump callback failed: "
                               f"{e}")

    # -------------------------------------------------------------- thread

    def start(self, check_interval_s: Optional[float] = None) -> None:
        """Launch the background checker (daemon). Interval defaults to
        deadline/4 capped at 5 s — late enough to be cheap, early enough
        that a stall is reported within ~1.25 deadlines."""
        self.stop()
        with self._lock:
            self._disarmed = False
            self._suspend_prev_disarmed = False
        interval = check_interval_s or min(self.deadline_s / 4.0, 5.0)
        stop = threading.Event()

        def loop():
            while not stop.wait(interval):
                try:
                    self.check()
                except Exception:  # noqa: BLE001 — never kill the process
                    pass

        t = threading.Thread(target=loop, name=f"telemetry-{self.name}",
                             daemon=True)
        self._thread, self._stop = t, stop
        t.start()

    def stop(self) -> None:
        t, stop = self._thread, self._stop
        self._thread = self._stop = None
        if stop is not None:
            stop.set()
        if t is not None:
            t.join(timeout=5)
