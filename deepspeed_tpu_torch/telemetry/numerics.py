"""Training numerics observatory: per-block statistics + host watch.

Counterpart of ``deepspeed_tpu/telemetry/numerics.py`` (docs/observability
"Training numerics & goodput"):

* **Block statistics** — the params are grouped into *layer blocks* by the
  first ``depth`` components of their paths in the JAX package's tree
  (:func:`block_spec`; the port's dotted names map to JAX's ``/`` paths
  as ``host_optimizer.npz``'s keys do, and the blocks come in JAX's
  flatten order), so a block is named as JAX names it. When
  ``telemetry.numerics_enabled`` is on, the engine's step computes each
  block's grad, param and update norms and its count of non-finite
  gradient elements on the device (:func:`block_sq_norms`,
  :func:`block_nonfinite_counts`) and reads them back once a step.
* **Host watch** (:class:`NumericsWatch`, a host-pure copy of JAX's) —
  per-block gauges, the first block whose gradients went NaN/Inf (event
  ring + snapshot), and the loss-spike detector (rolling median + MAD
  over recent losses) that flips ``train_numerics_anomaly`` and dumps the
  event ring.
"""
from __future__ import annotations

import statistics
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

import deepspeed_tpu_torch.telemetry.events as _ev
from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry,
                                                    get_registry)
from deepspeed_tpu_torch.utils.logging import logger


# ---------------------------------------------------------------------------
# block grouping (host, once per engine)
# ---------------------------------------------------------------------------

class BlockSpec:
    """Static grouping of a flat tree's leaves into named layer blocks.
    ``names`` are the blocks in JAX's order; ``keys`` the leaves in the
    order the tree was given, ``leaf_block`` each leaf's block."""
    __slots__ = ("names", "leaf_block", "keys")

    def __init__(self, names: Tuple[str, ...], leaf_block: Tuple[int, ...],
                 keys: Tuple[str, ...] = ()):
        self.names = tuple(names)
        self.leaf_block = tuple(leaf_block)
        self.keys = tuple(keys)

    def __len__(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return (f"BlockSpec({len(self.names)} blocks over "
                f"{len(self.leaf_block)} leaves)")


def _jax_path(name: str) -> List[str]:
    """The port's dotted leaf name as the JAX tree's path components
    (``runtime/checkpointing.py`` ``_jax_name``)."""
    return name.split(".")


def _flatten_key(parts: List[str]):
    """JAX's flatten order: dict keys sorted as strings, list indices (a
    component of digits) as numbers."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in parts)


def block_spec(tree, depth: int = 1) -> BlockSpec:
    """Group ``tree``'s leaves (a flat dict by the port's dotted names) by
    the first ``depth`` components of their JAX paths: ``depth=1`` makes
    every top-level child one block (GPT-2's ``h_0``, BERT's ``layers``),
    ``depth=2`` isolates BERT's ``layers/0``. Leaves shallower than
    ``depth`` group under their full path. The names equal JAX's
    ``block_spec`` over JAX's tree, in the same order."""
    if depth < 1:
        raise ValueError(f"block depth must be >= 1, got {depth}")
    keys = list(tree)
    paths = {k: _jax_path(k) for k in keys}
    names: List[str] = []
    index: Dict[str, int] = {}
    for k in sorted(keys, key=lambda k: _flatten_key(paths[k])):
        parts = paths[k]
        name = "/".join(parts[:depth]) if parts else "<root>"
        if name not in index:
            index[name] = len(names)
            names.append(name)
    leaf_block = ["/".join(paths[k][:depth]) for k in keys]
    return BlockSpec(tuple(names), tuple(index[n] for n in leaf_block),
                     tuple(keys))


def _check_leaves(spec: BlockSpec, tree) -> None:
    if set(tree) != set(spec.keys):
        raise ValueError(
            f"tree has {len(tree)} leaves but the block spec was built "
            f"over {len(spec.keys)} — numerics must be computed on the "
            "same tree the engine grouped")


def block_sq_norms(tree, spec: BlockSpec, weight=None) -> torch.Tensor:
    """Each block's sum of squared elements, f32 ``[B]`` on the leaves'
    device (one ``_foreach_norm`` over the leaves, f32 accumulation).
    ``weight(name)`` (0 or 1) drops a leaf's share (a leaf that another
    rank already counts)."""
    _check_leaves(spec, tree)
    keys = [k for k in spec.keys if weight is None or weight(k)]
    leaves = [tree[k].detach() for k in keys]
    dev = leaves[0].device if leaves else torch.device("cpu")
    out = torch.zeros(len(spec.names), dtype=torch.float32, device=dev)
    if not leaves:
        return out
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    block = {k: b for k, b in zip(spec.keys, spec.leaf_block)}
    idx = torch.tensor([block[k] for k in keys], device=dev)
    return out.index_add_(0, idx, torch.stack(norms).square())


def block_nonfinite_counts(tree, spec: BlockSpec, weight=None
                           ) -> torch.Tensor:
    """Each block's count of NaN/Inf elements, int32 ``[B]``. Run on the
    pre-clip gradients: the global-norm clip carries one block's NaN into
    every block."""
    _check_leaves(spec, tree)
    keys = [k for k in spec.keys if weight is None or weight(k)]
    dev = (tree[keys[0]].device if keys else torch.device("cpu"))
    out = torch.zeros(len(spec.names), dtype=torch.int32, device=dev)
    block = {k: b for k, b in zip(spec.keys, spec.leaf_block)}
    for k in keys:
        leaf = tree[k].detach()
        if leaf.is_floating_point():
            out[block[k]] += (~torch.isfinite(leaf)).sum().to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# host watch
# ---------------------------------------------------------------------------

class NumericsWatch:
    """Per-step consumer of the in-graph block statistics.

    One ``observe()`` per optimizer step (numerics-enabled engines only):
    converts the stacked block arrays to numpy (the single device→host
    transfer numerics costs per step), publishes per-block gauges,
    attributes non-finite gradients to the first offending block, and
    runs the rolling median+MAD loss-spike detector. Thread-safe: the
    scrape endpoint snapshots while the training loop observes.
    """

    def __init__(self, block_names: Sequence[str],
                 registry: Optional[MetricRegistry] = None,
                 window: int = 64,
                 threshold: Optional[float] = 6.0,
                 source: str = "train",
                 dump_path: Optional[str] = None):
        self.block_names = tuple(str(n) for n in block_names)
        self.registry = registry if registry is not None else get_registry()
        self.window = max(int(window), 8)
        self.threshold = (float(threshold)
                          if threshold is not None and threshold > 0
                          else None)
        self.source = source
        self.dump_path = dump_path
        self._lock = threading.Lock()
        self._losses: deque = deque(maxlen=self.window)
        self.anomalies_total = 0
        self.nonfinite_steps_total = 0
        self._clean_steps = 0
        self._anomaly_active = False
        self._last: Optional[dict] = None
        self._last_nonfinite: Optional[dict] = None
        self._last_anomaly: Optional[dict] = None
        self._anomaly_gauge().set(0.0)

    # ------------------------------------------------------------ metrics

    def _anomaly_gauge(self):
        return self.registry.gauge(
            "train_numerics_anomaly",
            help="1 while the loss-spike/non-finite detector considers "
                 "the run anomalous; re-arms to 0 after a full clean "
                 "window (docs/observability.md)")

    # ------------------------------------------------------------ observe

    def observe(self, step: int, loss: float,
                grad_norms=None, param_norms=None, update_norms=None,
                nonfinite=None) -> Optional[str]:
        """Record one step. Returns the anomaly reason (``"loss_spike"``,
        ``"nonfinite_loss"``, ``"nonfinite_grads"``) or None."""
        import numpy as np

        def _host(x):
            return None if x is None else np.asarray(x, np.float64)

        g = _host(grad_norms)
        p = _host(param_norms)
        u = _host(update_norms)
        nf = None if nonfinite is None else np.asarray(nonfinite, np.int64)
        loss = float(loss)

        blocks: List[dict] = []
        for i, name in enumerate(self.block_names):
            entry: dict = {"block": name}
            if g is not None:
                entry["grad_norm"] = float(g[i])
                self.registry.gauge(
                    "train_block_grad_norm",
                    help="per-layer-block gradient norm (post-unscale, "
                         "pre-clip) of the last numerics-enabled step",
                    labels={"block": name}).set(float(g[i]))
            if p is not None:
                entry["param_norm"] = float(p[i])
                self.registry.gauge(
                    "train_block_param_norm",
                    help="per-layer-block parameter norm (fp32 master) "
                         "at the last numerics-enabled step",
                    labels={"block": name}).set(float(p[i]))
            if u is not None:
                entry["update_norm"] = float(u[i])
                ratio = (float(u[i]) / float(p[i])
                         if p is not None and float(p[i]) > 0.0 else 0.0)
                entry["update_ratio"] = ratio
                self.registry.gauge(
                    "train_block_update_ratio",
                    help="per-layer-block optimizer-update norm / param "
                         "norm (the lr-health signal) of the last "
                         "numerics step",
                    labels={"block": name}).set(ratio)
            if nf is not None:
                entry["nonfinite"] = int(nf[i])
            blocks.append(entry)

        reason: Optional[str] = None
        first_bad: Optional[str] = None
        if nf is not None:
            bad = [i for i in range(len(self.block_names)) if nf[i] > 0]
            self.registry.gauge(
                "train_nonfinite_blocks",
                help="blocks with NaN/Inf gradients at the last "
                     "numerics-enabled step").set(float(len(bad)))
            if bad:
                first_bad = self.block_names[bad[0]]
                reason = "nonfinite_grads"
                with self._lock:
                    self.nonfinite_steps_total += 1
                    self._last_nonfinite = {
                        "step": int(step), "block": first_bad,
                        "blocks": {self.block_names[i]: int(nf[i])
                                   for i in bad}}
                self.registry.counter(
                    "train_nonfinite_steps_total",
                    help="steps whose gradients contained NaN/Inf "
                         "(provenance in the event ring / "
                         "/debug/numerics)").inc()
                _ev.record_event(
                    _ev.NUMERICS_NONFINITE, source=self.source,
                    step=int(step), first_block=first_bad,
                    blocks={self.block_names[i]: int(nf[i]) for i in bad})
                logger.warning(
                    "[numerics:%s] step %d: non-finite gradients first "
                    "appear in block %r (%d block(s) affected)",
                    self.source, step, first_bad, len(bad))

        # ---- loss-spike / divergence detector (rolling median + MAD)
        spike_stats: dict = {}
        if not (loss == loss and abs(loss) != float("inf")):  # NaN/Inf
            reason = reason or "nonfinite_loss"
        else:
            with self._lock:
                hist = list(self._losses)
            if self.threshold is not None and len(hist) >= 8:
                med = statistics.median(hist)
                mad = statistics.median([abs(h - med) for h in hist])
                # 1.4826 ≈ MAD→σ for a normal window; the relative floor
                # keeps a near-constant loss history from flagging float
                # noise as divergence
                scale = max(1.4826 * mad, 1e-3 * abs(med), 1e-12)
                spike_stats = {"median": med, "mad": mad}
                if abs(loss - med) > self.threshold * scale:
                    reason = reason or "loss_spike"
            with self._lock:
                self._losses.append(loss)

        if reason is not None:
            with self._lock:
                self.anomalies_total += 1
                self._clean_steps = 0
                self._anomaly_active = True
                self._last_anomaly = {"step": int(step), "reason": reason,
                                      "loss": loss, **spike_stats}
            self._anomaly_gauge().set(1.0)
            self.registry.counter(
                "train_numerics_anomalies_total",
                help="loss spikes + non-finite steps flagged by the "
                     "numerics watch").inc()
            if reason != "nonfinite_grads":   # grads already recorded
                _ev.record_event(_ev.LOSS_SPIKE, source=self.source,
                                 step=int(step), reason=reason, loss=loss,
                                 **spike_stats)
            # flight-recorder forensics: freeze the event window that led
            # into the anomaly (next anomaly overwrites — newest wins)
            if self.dump_path:
                _ev.dump_ring(self.dump_path + ".anomaly",
                              reason="numerics_" + reason,
                              extra={"source": self.source,
                                     "step": int(step), "loss": loss,
                                     "first_block": first_bad,
                                     **spike_stats})
        else:
            with self._lock:
                self._clean_steps += 1
                rearm = (self._anomaly_active and
                         self._clean_steps >= self.window)
                if rearm:
                    self._anomaly_active = False
            if rearm:
                self._anomaly_gauge().set(0.0)

        with self._lock:
            self._last = {"step": int(step), "loss": loss,
                          "blocks": blocks}
        return reason

    # ----------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON-able state for ``/debug/numerics``."""
        with self._lock:
            hist = list(self._losses)
            last = dict(self._last) if self._last else None
            med = statistics.median(hist) if hist else None
            out = {
                "source": self.source,
                "blocks": list(self.block_names),
                "window": self.window,
                "threshold": self.threshold,
                "last": last,
                "loss": {
                    "n": len(hist),
                    "median": med,
                    "mad": (statistics.median(
                        [abs(h - med) for h in hist]) if hist else None),
                },
                "anomaly": {
                    # mirrors the train_numerics_anomaly gauge exactly:
                    # set on anomaly, cleared only by a full clean window
                    "active": int(self._anomaly_active),
                    "total": self.anomalies_total,
                    "last": self._last_anomaly,
                },
                "nonfinite": {
                    "steps_total": self.nonfinite_steps_total,
                    "last": self._last_nonfinite,
                },
            }
        return out


# ---------------------------------------------------------------------------
# process-wide watch registry (the /debug/numerics surface)
# ---------------------------------------------------------------------------

_watch_lock = threading.Lock()
_watches: Dict[str, NumericsWatch] = {}


def register_numerics_watch(name: str, watch: NumericsWatch) -> None:
    """Expose ``watch`` under ``name`` on ``/debug/numerics`` (newest
    registration for a name wins — matches the memory monitor's
    component semantics)."""
    with _watch_lock:
        _watches[name] = watch


def unregister_numerics_watch(name: str, watch: NumericsWatch) -> None:
    """Instance-matched removal: a newer engine's re-registration of the
    same name survives an older engine's teardown."""
    with _watch_lock:
        if _watches.get(name) is watch:
            del _watches[name]


def numerics_snapshot() -> dict:
    """All registered watches, by name — the ``/debug/numerics`` body."""
    with _watch_lock:
        items = list(_watches.items())
    return {name: watch.snapshot() for name, watch in items}
