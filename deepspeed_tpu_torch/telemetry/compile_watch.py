"""Compile watch: every step program becomes attributable.

Counterpart of ``deepspeed_tpu/telemetry/compile_watch.py``. A new
argument shape makes a program of the port do new work once: the eager
prefill meets a new bucket, the chunk a new width, a graphed step is
captured. This module wraps the programs (the server's prefill, chunk,
decode and verify steps, ``generate``'s prefill and decode, the training
engine's step) so that every such event is:

* **detected** — the wrapper keys calls by abstract signature (shape /
  dtype per tensor leaf, value for statics, type for python scalars), as
  JAX keys its trace cache, so a new key IS the counterpart of a retrace;
* **attributed** — the signature diff against the previous key names the
  argument whose shape/dtype changed (``ids: i64[1,128] -> i64[1,256]``),
  recorded as a ``retrace`` flight-recorder event and a
  ``jit_retraces_total{fn=...}`` counter, in JAX's text;
* **timed** — for an eager program the first call of a new key is its
  "compile" (its host wall: kernel builds and first launches); for a
  :class:`~deepspeed_tpu_torch.inference.cuda_graph.GraphedStep` the
  capture is, recorded by the graph itself through
  :meth:`WatchedFunction.record_compile`, so its replays never build a
  key at all.

There is no compiled executable to ask for flops or a memory footprint,
so JAX's ``executable_cost`` has no counterpart and the report leaves
those columns out. A watched function never changes what it wraps: it
calls it and returns its result. It holds a bound method weakly, so a
watch kept by the method's owner (an engine, a server) makes no reference
cycle: the owner and its device memory go as soon as the last reference
does, without waiting for the cycle collector.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import deepspeed_tpu_torch.telemetry.events as _ev
from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry,
                                                    get_registry)

_DTYPE_SHORT = (("bfloat16", "bf16"), ("float", "f"), ("uint", "u"),
                ("int", "i"), ("complex", "c"))


def _short_dtype(name: str) -> str:
    for long, short in _DTYPE_SHORT:
        if name.startswith(long):
            return short + name[len(long):]
    return name


def _leaf_key(x) -> Tuple:
    """Abstract key for one leaf — shape/dtype for tensors and arrays,
    type identity for python scalars (keyed weakly, not by value, as JAX
    keys them). Runs on the hot path (every watched call), so the dtype
    stays an object — hashable and comparable without a per-call str()
    allocation."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), x.dtype,
                bool(getattr(x, "weak_type", False)))
    if isinstance(x, (bool, int, float, complex)):
        return ("py", type(x).__name__)
    return ("static", repr(x))


def _fmt_key(key: Tuple) -> str:
    if key and key[0] == "py":
        return f"py:{key[1]}"
    if key and key[0] == "static":
        return f"static:{key[1]}"
    shape, dtype, weak = key
    dims = ",".join(str(d) for d in shape)
    name = str(dtype).replace("torch.", "")
    return f"{_short_dtype(name)}[{dims}]{'~' if weak else ''}"


def _flatten(tree, path: Tuple = ()):
    """``(structure, [(path, leaf), ...])`` of a tree of dicts (by sorted
    key), lists, tuples and dataclasses (by field, as JAX's registered
    dataclass nodes such as a KV cache), in JAX's leaf order; ``None``
    holds no leaf. A path is a tuple of ``("k", key)`` / ``("i", index)``
    / ``("a", field)`` entries."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = [_flatten(getattr(tree, n), path + (("a", n),))
                 for n in names]
        return ((type(tree).__name__, tuple(p[0] for p in parts)),
                [x for p in parts for x in p[1]])
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k], path + (("k", k),)) for k in keys]
        return (("d", tuple(keys), tuple(p[0] for p in parts)),
                [x for p in parts for x in p[1]])
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, path + (("i", i),)) for i, v in enumerate(tree)]
        return ((type(tree).__name__, tuple(p[0] for p in parts)),
                [x for p in parts for x in p[1]])
    if tree is None:
        return (None, [])
    return ("*", [(path, tree)])


def _keystr(path) -> str:
    """JAX's ``keystr`` spelling of a path: ``['wte'][0].k``."""
    return "".join(f"[{v!r}]" if k == "k" else f".{v}" if k == "a"
                   else f"[{v}]" for k, v in path)


@dataclasses.dataclass
class ExecutableRecord:
    """One signature (compiled, captured or first run) of a watched
    function."""
    index: int
    summary: str                       # per-arg aval summary (report)
    leaves: Dict[str, Tuple]           # path -> leaf key (retrace diff)
    compile_seconds: float
    calls: int = 0


_registry_lock = threading.Lock()
_watched: "weakref.WeakSet" = weakref.WeakSet()
_watched_counter = [0]


def all_watched() -> List["WatchedFunction"]:
    """Live watched functions, in creation order."""
    with _registry_lock:
        return sorted(_watched, key=lambda w: w._order_id)


class WatchedFunction:
    """A program with a flight recorder attached. Drop-in: call it —
    plus ``.retraces``, ``.executables``, ``.report()`` and
    ``._cache_size()``. ``static_argnames`` / ``static_argnums`` are
    keyed by value, as a static argument of ``jax.jit``."""

    def __init__(self, fun, name: str,
                 registry: Optional[MetricRegistry] = None,
                 ring: Optional[_ev.EventRing] = None,
                 static_argnames=(), static_argnums=()):
        # a bound method weakly (see the module docstring)
        self._method = (weakref.WeakMethod(fun) if inspect.ismethod(fun)
                        else None)
        self._plain = None if self._method is not None else fun
        self.name = name
        self._registry = registry
        self._ring = ring
        self._static_names = tuple(static_argnames or ())
        self._static_nums = tuple(static_argnums or ())
        self._execs: Dict[Tuple, ExecutableRecord] = {}
        self._records: List[ExecutableRecord] = []   # creation order
        self._last: Optional[ExecutableRecord] = None
        self.retraces: List[dict] = []
        self._lock = threading.RLock()
        self._arg_names = self._positional_names(fun)
        # static_argnames resolved to POSITIONS too — a static passed
        # positionally must be value-keyed like one passed by name
        self._static_idx = tuple(sorted(set(
            list(self._static_nums)
            + [self._arg_names.index(n) for n in self._static_names
               if n in self._arg_names])))
        with _registry_lock:
            _watched_counter[0] += 1
            self._order_id = _watched_counter[0]
        _watched.add(self)

    def _target(self):
        return self._plain if self._method is None else self._method()

    @staticmethod
    def _positional_names(fun) -> List[str]:
        try:
            return [p.name for p in
                    inspect.signature(fun).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]
        except (TypeError, ValueError):
            return []

    # ---------------------------------------------------------- signature

    def _path_str(self, path) -> str:
        """Human path for one leaf of ``(args, kwargs)``: the top-level
        argument name (from the wrapped function's signature when
        resolvable) plus the intra-tree remainder."""
        top, rest = path[0], path[1:]
        if top[1] == 0:    # positional args
            i = rest[0][1] if rest else 0
            base = (self._arg_names[i] if i < len(self._arg_names)
                    else f"args[{i}]")
        else:              # kwargs
            base = str(rest[0][1]) if rest else "kwargs"
        rest = rest[1:]
        return base + (_keystr(rest) if rest else "")

    def _signature(self, args, kwargs) -> Tuple:
        """Hot-path cache key: the tree structure plus per-leaf abstract
        keys. Path strings for retrace diffing are NOT built here — see
        :meth:`_leaves_with_paths`, which only runs on a miss."""
        struct, flat = _flatten((args, dict(kwargs)))
        key: Tuple = (struct, tuple(_leaf_key(x) for _, x in flat))
        # static args are keyed by VALUE; the coarse leaf key above
        # would collide e.g. K=4 with K=8
        statics = tuple(
            (n, repr(kwargs[n])) for n in self._static_names
            if n in kwargs) + tuple(
            (i, repr(args[i])) for i in self._static_idx
            if i < len(args))
        if statics:
            key = key + (statics,)
        return key

    def _leaves_with_paths(self, args, kwargs) -> Dict[str, Tuple]:
        _, flat = _flatten((args, dict(kwargs)))
        out = {self._path_str(p): _leaf_key(x) for p, x in flat}
        # static args are VALUE-keyed in the signature (_signature), so
        # the retrace diff must see their values too
        for i in self._static_idx:
            if i < len(args):
                name = (self._arg_names[i] if i < len(self._arg_names)
                        else f"args[{i}]")
                out[name] = ("static", repr(args[i]))
        for n in self._static_names:
            if n in kwargs:
                out[n] = ("static", repr(kwargs[n]))
        return out

    def _summarize(self, args, kwargs) -> str:
        """Per-argument aval summary: small args spelled out, big trees
        as leaf counts — ``params:<58 leaves>, input_ids:i32[1,128]``."""
        parts = []
        for i, a in enumerate(args):
            name = (self._arg_names[i] if i < len(self._arg_names)
                    else f"args[{i}]")
            parts.append((name, a))
        parts += sorted(kwargs.items())
        out = []
        for name, val in parts:
            lv = [x for _, x in _flatten(val)[1]]
            if len(lv) == 1:
                out.append(f"{name}:{_fmt_key(_leaf_key(lv[0]))}")
            else:
                out.append(f"{name}:<{len(lv)} leaves>")
        return ", ".join(out)

    # ------------------------------------------------------------- helpers

    def _reg(self) -> MetricRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def _events(self) -> _ev.EventRing:
        # explicit None check: an EMPTY ring is falsy (__len__ == 0) and
        # `or` would silently swap in the process ring
        return self._ring if self._ring is not None \
            else _ev.get_event_ring()

    def _diff(self, prev: Dict[str, Tuple], new: Dict[str, Tuple]):
        """What changed between two signatures: per-leaf transitions plus
        the set of top-level argument names they belong to."""
        changed, args = [], []
        for path in sorted(set(prev) | set(new)):
            a, b = prev.get(path), new.get(path)
            if a == b:
                continue
            a_s = _fmt_key(a) if a is not None else "<absent>"
            b_s = _fmt_key(b) if b is not None else "<absent>"
            changed.append(f"{path}: {a_s} -> {b_s}")
            top = path.split("[")[0].split(".")[0]
            if top not in args:
                args.append(top)
        return changed, args

    # ---------------------------------------------------------------- call

    def _begin(self, key, args, kwargs) -> ExecutableRecord:
        """Record a new signature: the ``compile_begin`` event and, after
        the first signature, the retrace attribution. Caller holds the
        lock; :meth:`_end` closes the record with its seconds."""
        leaves = self._leaves_with_paths(args, kwargs)
        summary = self._summarize(args, kwargs)
        ring, reg = self._events(), self._reg()
        prev = self._last
        ring.record(_ev.COMPILE_BEGIN, fn=self.name, signature=summary,
                    index=len(self._records))
        if prev is not None:
            changed, arg_names = self._diff(prev.leaves, leaves)
            info = {"fn": self.name, "changed": changed,
                    "args": arg_names,
                    "prev_signature": prev.summary,
                    "signature": summary}
            self.retraces.append(info)
            ring.record(_ev.RETRACE, **info)
            reg.counter(
                "jit_retraces_total",
                help="recompiles after the first trace, by function "
                     "(the silent-stall regression — see "
                     "docs/observability.md)",
                labels={"fn": self.name}).inc()
        rec = ExecutableRecord(index=len(self._records), summary=summary,
                               leaves=leaves, compile_seconds=0.0)
        self._execs[key] = rec
        self._records.append(rec)
        self._last = rec
        return rec

    def _end(self, rec: ExecutableRecord, seconds: float) -> None:
        reg = self._reg()
        rec.compile_seconds = seconds
        reg.counter("jit_compiles_total",
                    help="executables compiled, by function",
                    labels={"fn": self.name}).inc()
        reg.histogram("jit_compile_seconds",
                      help="trace+lower+compile wall time, by function",
                      labels={"fn": self.name}).observe(seconds)
        self._events().record(_ev.COMPILE_END, fn=self.name,
                              seconds=round(seconds, 6), index=rec.index)

    def __call__(self, *args, **kwargs):
        key = self._signature(args, kwargs)
        rec = self._execs.get(key)
        if rec is None:
            with self._lock:
                rec = self._execs.get(key)   # lost the race → reuse
                if rec is None:
                    rec = self._begin(key, args, kwargs)
                    rec.calls += 1
                    t0 = time.perf_counter()
                    try:
                        return self._target()(*args, **kwargs)
                    finally:
                        self._end(rec, time.perf_counter() - t0)
        rec.calls += 1
        return self._target()(*args, **kwargs)

    def record_compile(self, args, kwargs, seconds: float
                       ) -> ExecutableRecord:
        """Record the signature of ``(args, kwargs)`` as compiled in
        ``seconds`` without calling the function: a CUDA graph's capture
        (``GraphedStep``) over its static inputs. A signature already
        recorded only counts the call."""
        key = self._signature(args, kwargs)
        with self._lock:
            rec = self._execs.get(key)
            if rec is None:
                rec = self._begin(key, args, kwargs)
                self._end(rec, seconds)
        rec.calls += 1
        return rec

    def _cache_size(self) -> int:
        """Signature count."""
        return len(self._records)

    # -------------------------------------------------------------- report

    @property
    def executables(self) -> List[ExecutableRecord]:
        return list(self._records)

    def report(self) -> str:
        lines = [f"{self.name}: {len(self._records)} executable(s), "
                 f"{len(self.retraces)} retrace(s)"]
        for rec in self._records:
            lines.append(
                f"  [{rec.index}] {rec.summary}\n"
                f"      compile {rec.compile_seconds * 1e3:.1f} ms, "
                f"calls {rec.calls}")
        for r in self.retraces:
            lines.append("  retrace: " + "; ".join(r["changed"][:4])
                         + (" …" if len(r["changed"]) > 4 else ""))
        return "\n".join(lines)


def watched(fun, name: str, registry: Optional[MetricRegistry] = None,
            ring: Optional[_ev.EventRing] = None, static_argnames=(),
            static_argnums=()) -> WatchedFunction:
    """``fun`` with new-signature detection, attribution and timing
    (see module docstring); the port's ``watched_jit``."""
    return WatchedFunction(fun, name, registry=registry, ring=ring,
                           static_argnames=static_argnames,
                           static_argnums=static_argnums)


def compile_report() -> str:
    """Human-readable report over every live watched function: per
    signature its summary, compile time and calls;
    per function its retrace history with argument attribution. The
    after-the-fact answer to "why did that step take 40 s"."""
    watched = all_watched()
    if not watched:
        return "compile report: no watched functions"
    total_execs = sum(len(w._records) for w in watched)
    total_re = sum(len(w.retraces) for w in watched)
    total_s = sum(r.compile_seconds for w in watched for r in w._records)
    lines = [f"compile report: {len(watched)} function(s), "
             f"{total_execs} executable(s), {total_re} retrace(s), "
             f"{total_s:.2f} s total compile time"]
    lines += [w.report() for w in watched]
    return "\n".join(lines)
