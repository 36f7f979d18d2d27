"""Live capacity model: "how much headroom is left at the current mix".

Host-pure copy of ``deepspeed_tpu/telemetry/capacity.py`` (same keys, families,
help strings and ring events), over the port's registry and event ring.

The :class:`SLOMonitor` snapshot-delta idiom (telemetry/slo.py) applied
to capacity instead of latency: each evaluation snapshots the relevant
CUMULATIVE registry state (tokens committed, requests finished) and the
windowed rate is the delta against the snapshot taken ``window_s`` ago
— no new sample storage. On top of the windowed rates ride the live
occupancy levels (slots, pool blocks — read through owner-supplied
callables, never by walking scheduler internals) and the step
observatory's goodput fraction, composing into:

* ``tokens_per_s``                — windowed committed-token throughput
* ``sustainable_tokens_per_s``    — tokens_per_s / goodput_fraction:
  what the same hardware would commit at goodput 1.0 (the device is
  already busy ``goodput`` of the wall; the rest is host overhead the
  mix could still absorb)
* ``admissible_requests_per_s``   — sustainable tokens/s divided by the
  windowed mean tokens per request: the request arrival rate the
  CURRENT MIX could sustain

Report-only this PR: nothing gates admission on these numbers — they
serve at ``GET /debug/capacity`` and in ``stats["capacity"]``, and
:func:`rollup_capacity` folds per-replica rows into the pool view the
frontend serves beside them (sums for rates and levels, re-derived
fractions — pool == rollup of the rows by construction).

Host-pure; the clock is injectable so tests drive window expiry with
zero real sleeps.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.telemetry.registry import MetricRegistry, get_registry

# cumulative counters the windowed rates are delta'd over (name ->
# row-field stem); both are unlabeled single-series serving counters
_RATE_COUNTERS = {
    "serve_tokens_total": "tokens",
    "serve_requests_finished_total": "requests",
}

# synthetic-probe attribution subtracted from the rates when a canary
# prober is armed (telemetry/canary.py): the probes run through the real
# step path — their tokens land in serve_tokens_total like anyone's —
# but capacity is a statement about TENANT traffic, so the canary's
# settled counters net them back out (rate-counter name -> canary
# counter). With no prober these families never register and the
# subtraction reads 0 — byte-identical rates.
_CANARY_COUNTERS = {
    "serve_tokens_total": "serve_canary_tokens_total",
    "serve_requests_finished_total": "serve_canary_requests_total",
}


def _ratio(num: Optional[float], den: Optional[float]
           ) -> Optional[float]:
    if num is None or not den:
        return None
    return num / den


class CapacityModel:
    """Windowed capacity evaluation over one server's registry.

    ``levels`` is a zero-arg callable returning the live occupancy
    ``(active_slots, num_slots, free_blocks, total_blocks)`` — the
    owner (server) supplies it reading its own scheduler between steps.
    ``goodput`` is a zero-arg callable returning the step profiler's
    current goodput fraction (or None before any worked step).

    The serving loop calls :meth:`maybe_evaluate` once per step next to
    the SLO monitor's; it re-evaluates at ``eval_interval_s`` cadence
    and is a clock read otherwise. :meth:`snapshot` (scrape thread /
    stats) returns the last evaluated row, evaluating once on first
    read so an idle server still answers self-describingly.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 window_s: float = 60.0, eval_interval_s: float = 5.0,
                 levels: Optional[Callable[[], tuple]] = None,
                 goodput: Optional[Callable[[], Optional[float]]] = None):
        self.registry = registry if registry is not None else get_registry()
        self._clock = clock
        self.window_s = float(window_s)
        self.eval_interval_s = float(eval_interval_s)
        self._levels = levels
        self._goodput = goodput
        self._lock = threading.Lock()
        self._window: deque = deque()   # (ts, {field: cumulative})
        self._last_eval: Optional[float] = None
        self._last_row: Optional[dict] = None
        self.evaluations = 0

    # ----------------------------------------------------------- collect

    def _collect(self) -> Dict[str, float]:
        snap = self.registry.snapshot()

        def _total(name):
            fam = snap.get(name)
            return (sum(s["value"] for s in fam["series"])
                    if fam else 0.0)

        state: Dict[str, float] = {}
        for name, stem in _RATE_COUNTERS.items():
            state[stem] = max(
                _total(name) - _total(_CANARY_COUNTERS[name]), 0.0)
        return state

    # ---------------------------------------------------------- evaluate

    def maybe_evaluate(self) -> Optional[dict]:
        """Step-cadence entry point (None when not due yet)."""
        now = self._clock()
        with self._lock:
            due = (self._last_eval is None
                   or now - self._last_eval >= self.eval_interval_s)
        if not due:
            return None
        return self.evaluate()

    def evaluate(self) -> dict:
        now = self._clock()
        cur = self._collect()
        with self._lock:
            self._last_eval = now
            self.evaluations += 1
            # same bounded-retention discipline as SLOMonitor: snapshots
            # only feed the window-edge baseline, so spacing below
            # window_s/64 adds memory but no accuracy
            spacing = self.window_s / 64.0
            if not self._window or now - self._window[-1][0] >= spacing:
                self._window.append((now, cur))
            edge = now - self.window_s
            while len(self._window) >= 2 and self._window[1][0] <= edge:
                self._window.popleft()
            base_ts, base = self._window[0]
            span = now - base_ts
            if base_ts > edge and span <= 0:
                # first-ever evaluation: no window yet
                base, span = cur, 0.0
        d_tokens = cur["tokens"] - base["tokens"]
        d_requests = cur["requests"] - base["requests"]
        tokens_per_s = (d_tokens / span) if span > 0 else None
        requests_per_s = (d_requests / span) if span > 0 else None
        mean_tokens = _ratio(d_tokens, d_requests)
        goodput = self._goodput() if self._goodput is not None else None
        sustainable = _ratio(tokens_per_s, goodput)
        row = {
            "enabled": True,
            "window_s": self.window_s,
            "evaluations": self.evaluations,
            "tokens_per_s": tokens_per_s,
            "requests_per_s": requests_per_s,
            "mean_tokens_per_request": mean_tokens,
            "goodput_fraction": goodput,
            "sustainable_tokens_per_s": sustainable,
            "admissible_requests_per_s": _ratio(sustainable, mean_tokens),
        }
        if self._levels is not None:
            active, slots, free, total = self._levels()
            row.update({
                "active_slots": active, "num_slots": slots,
                "slot_occupancy": _ratio(float(active), float(slots)),
                "free_blocks": free, "total_blocks": total,
                "block_utilization": _ratio(float(total - free),
                                            float(total)),
            })
        else:
            row.update({
                "active_slots": None, "num_slots": None,
                "slot_occupancy": None, "free_blocks": None,
                "total_blocks": None, "block_utilization": None,
            })
        with self._lock:
            self._last_row = row
        return row

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        with self._lock:
            row = self._last_row
        return row if row is not None else self.evaluate()


def rollup_capacity(rows: List[dict]) -> dict:
    """Fold per-replica capacity rows into the pool view. Levels and
    rates SUM; fractions re-derive from the sums (so the pool row is a
    pure function of the replica rows — pool == rollup, test-pinned);
    the pool goodput fraction is the token-weighted mean (falling back
    to a simple mean when no replica reports traffic)."""
    rows = [r for r in rows if r and r.get("enabled")]
    if not rows:
        return {"enabled": False, "replicas": 0}

    def _sum(field):
        vals = [r.get(field) for r in rows if r.get(field) is not None]
        return sum(vals) if vals else None

    active, slots = _sum("active_slots"), _sum("num_slots")
    free, total = _sum("free_blocks"), _sum("total_blocks")
    tokens_per_s = _sum("tokens_per_s")
    requests_per_s = _sum("requests_per_s")
    gp_rows = [r for r in rows if r.get("goodput_fraction") is not None]
    weighted = [(r["goodput_fraction"], r.get("tokens_per_s") or 0.0)
                for r in gp_rows]
    wsum = sum(w for _, w in weighted)
    if not weighted:
        goodput = None
    elif wsum > 0:
        goodput = sum(g * w for g, w in weighted) / wsum
    else:
        goodput = sum(g for g, _ in weighted) / len(weighted)
    sustainable = _sum("sustainable_tokens_per_s")
    mean_tokens = _ratio(tokens_per_s, requests_per_s)
    return {
        "enabled": True,
        "replicas": len(rows),
        "active_slots": active, "num_slots": slots,
        "slot_occupancy": (_ratio(float(active), float(slots))
                           if active is not None and slots is not None
                           else None),
        "free_blocks": free, "total_blocks": total,
        "block_utilization": (_ratio(float(total - free), float(total))
                              if free is not None and total is not None
                              else None),
        "tokens_per_s": tokens_per_s,
        "requests_per_s": requests_per_s,
        "mean_tokens_per_request": mean_tokens,
        "goodput_fraction": goodput,
        "sustainable_tokens_per_s": sustainable,
        "admissible_requests_per_s": _ratio(sustainable, mean_tokens),
    }
