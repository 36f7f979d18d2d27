"""One-shot incident bundles: the forensics, captured at the page.

Host-pure copy of ``deepspeed_tpu/telemetry/incident.py`` (same keys, families,
help strings and ring events), over the port's registry and event ring.

When an alert fires, the operator's first minutes go to re-assembling
context that existed at the moment of the page and has since scrolled
away — the ring events around the transition, the replica rows, the
capacity picture, which traces errored. The incident recorder captures
all of it as ONE self-contained JSON artifact at the instant a rule
enters firing (and on the hang watchdog's stall dump — the two
automatic forensic paths are unified here): the owner's observability
snapshot, recent flight-recorder events, kept error traces, replica +
capacity + alert rows, and a config fingerprint, so two bundles from
different builds are never confused.

Rate limiting is **episode-scoped**, not time-based: the first trigger
opens an episode and captures the bundle; further triggers while the
episode is open (a second rule joining the storm, the watchdog firing
on the same stall) attach to the open bundle instead of capturing a
new one; :meth:`resolve` closes the episode — appending a resolution
snapshot, so the bundle also carries the *post-recovery* picture (the
stitched traces of affected requests finish during the episode, not at
its first instant) — and re-arms the recorder for the next incident.

Bundles are JSON round-tripped at capture (the ``_capture_obs``
discipline: a bundle that cannot serialize is a bug found now, not
during an outage), listed at ``GET /debug/incidents``, written to
``telemetry.incident.dir`` when set, and dumpable on demand via
``dump_incident()``.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.telemetry import events as _ev
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry, get_registry
from deepspeed_tpu_torch.utils.logging import logger

# the most recent bundle path written by ANY recorder in the process —
# ds_report's "last incident" pointer (None until something captured)
_LAST_INCIDENT_PATH: Optional[str] = None


def last_incident_path() -> Optional[str]:
    return _LAST_INCIDENT_PATH


def config_fingerprint(cfg) -> str:
    """Stable short digest of a pydantic config model — the bundle's
    build/config identity."""
    try:
        payload = cfg.model_dump_json()
    except Exception:  # noqa: BLE001 — fingerprint is best-effort
        payload = repr(cfg)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class IncidentRecorder:
    """Episode-scoped bundle capture over one serving owner.

    ``collect`` is the owner's zero-arg forensic callable returning the
    bundle body (observability snapshot, replica/capacity rows, traces
    — whatever the owner can attest to); it is called once at capture
    and once at resolve. ``fingerprint`` stamps every bundle.
    """

    def __init__(self, cfg, collect: Callable[[], dict],
                 registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 ring: Optional[_ev.EventRing] = None,
                 fingerprint: Optional[str] = None,
                 name: str = "incidents"):
        self.cfg = cfg
        self._collect = collect
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self._ring = ring
        self.fingerprint = fingerprint
        self.name = name
        self._lock = threading.Lock()
        self._seq = 0
        self._open: Optional[dict] = None       # the open episode's bundle
        self._open_rules: set = set()
        self.incidents: List[dict] = []         # bounded (max_incidents)
        self.captured_total = 0
        self.suppressed_total = 0

    def _events(self) -> _ev.EventRing:
        # explicit None check: an empty ring is falsy
        return self._ring if self._ring is not None else _ev.get_event_ring()

    # ------------------------------------------------------------ capture

    def capture(self, trigger: str, rule: Optional[str] = None,
                info: Optional[dict] = None) -> Optional[dict]:
        """A forensic trigger (``trigger`` = "alert" / "watchdog" /
        "manual"). Captures ONE bundle per episode: returns the new
        bundle on first trigger, None when the open episode absorbed
        this trigger instead."""
        now = self.clock()
        with self._lock:
            if self._open is not None:
                # the episode is open: attach, don't re-capture
                self._open["triggers"].append(_trigger_row(
                    now, trigger, rule, info))
                if rule:
                    self._open_rules.add(rule)
                self.suppressed_total += 1
                return None
            self._seq += 1
            seq = self._seq
        body = self._safe_collect()
        bundle = {
            "incident": seq,
            "captured_ts": now,
            "trigger": trigger,
            "rule": rule,
            "triggers": [_trigger_row(now, trigger, rule, info)],
            "config_fingerprint": self.fingerprint,
            "resolved": False,
            **body,
        }
        # serialization is the contract (/debug/incidents, the on-disk
        # artifact): round-trip NOW so an unserializable field is a bug
        # caught at capture, not during the outage review
        bundle = json.loads(json.dumps(bundle, default=str))
        with self._lock:
            self._open = bundle
            self._open_rules = {rule} if rule else set()
            self.incidents.append(bundle)
            del self.incidents[:-self.cfg.max_incidents]
            self.captured_total += 1
        bundle["path"] = self._write(bundle)
        self._events().record(_ev.INCIDENT_CAPTURE, incident=seq,
                              trigger=trigger, rule=rule,
                              path=bundle.get("path"))
        where = f" -> {bundle['path']}" if bundle.get("path") else ""
        logger.error(
            f"[{self.name}] incident {seq} captured (trigger={trigger}"
            f"{f', rule={rule}' if rule else ''}){where}")
        return bundle

    def resolve(self, rule: Optional[str] = None,
                info: Optional[dict] = None) -> Optional[dict]:
        """An alert episode resolved: close the open bundle when every
        rule that joined it has resolved (a lone watchdog episode closes
        on its first resolve call), append the post-recovery snapshot,
        and re-arm for the next incident."""
        with self._lock:
            bundle = self._open
            if bundle is None:
                return None
            self._open_rules.discard(rule)
            if self._open_rules:
                return None                    # storm not over yet
            self._open = None
        resolution = self._safe_collect()
        resolution["ts"] = self.clock()
        if info:
            resolution["info"] = dict(info)
        bundle["resolved"] = True
        bundle["resolution"] = json.loads(
            json.dumps(resolution, default=str))
        path = self._write(bundle)
        if path:
            bundle["path"] = path
        return bundle

    def _safe_collect(self) -> dict:
        try:
            body = self._collect()
            return body if isinstance(body, dict) else {"body": body}
        except Exception as e:  # noqa: BLE001 — a half bundle beats none
            return {"collect_error": repr(e)}

    def _write(self, bundle: dict) -> Optional[str]:
        global _LAST_INCIDENT_PATH
        if not self.cfg.dir:
            return None
        path = os.path.join(self.cfg.dir,
                            f"incident_{bundle['incident']}.json")
        try:
            os.makedirs(self.cfg.dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(bundle, f, default=str)
        except OSError as e:
            logger.warning(f"[{self.name}] bundle write failed: {e}")
            return None
        _LAST_INCIDENT_PATH = path
        return path

    def dump(self, path: str) -> Optional[dict]:
        """On-demand capture to an explicit path (``dump_incident()``):
        collects a fresh manual bundle outside the episode machinery —
        an operator asking for forensics must never be told "rate
        limited"."""
        global _LAST_INCIDENT_PATH
        with self._lock:
            self._seq += 1
            seq = self._seq
        bundle = {
            "incident": seq,
            "captured_ts": self.clock(),
            "trigger": "manual",
            "rule": None,
            "triggers": [_trigger_row(self.clock(), "manual", None, None)],
            "config_fingerprint": self.fingerprint,
            "resolved": False,
            **self._safe_collect(),
        }
        bundle = json.loads(json.dumps(bundle, default=str))
        with open(path, "w") as f:
            json.dump(bundle, f, default=str)
        bundle["path"] = path
        _LAST_INCIDENT_PATH = path
        with self._lock:
            self.incidents.append(bundle)
            del self.incidents[:-self.cfg.max_incidents]
            self.captured_total += 1
        return bundle

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The /debug/incidents body: bounded retained bundles plus the
        recorder's episode accounting."""
        with self._lock:
            return {
                "captured_total": self.captured_total,
                "suppressed_total": self.suppressed_total,
                "episode_open": self._open is not None,
                "open_rules": sorted(self._open_rules),
                "incidents": [dict(b) for b in self.incidents],
            }


def _trigger_row(ts: float, trigger: str, rule: Optional[str],
                 info: Optional[dict]) -> dict:
    row: Dict[str, object] = {"ts": ts, "trigger": trigger}
    if rule:
        row["rule"] = rule
    if info:
        row["info"] = dict(info)
    return row
