"""Checkpoint save/load of the training engine.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py`` (reference
``deepspeed/runtime/engine.py:3061,2706``), on one process. The state is
the engine's f32 master (the params themselves in fp32), the optimizer
state (its host ``count`` and ``mu``/``nu`` or ``accum``) and the loss
scale's dynamic fields; the compute params are cast from the master on
load, by the same cast the step makes, so their bits are the ones saved.
Loads copy into the engine's own tensors, which keeps the tensors the
step's foreach lists hold and never puts a second copy on the card.

Publication is the JAX package's commit protocol, file for file:

1. the checkpoint engine persists ``<tag>/state`` (one atomic file per
   group, ``checkpoint/checkpoint_engine.py``);
2. ``client_state.json`` lands via tmp+fsync+rename with STRICT JSON
   (an unserializable value raises — never ``default=str``);
3. ``manifest.json`` (checkpoint/integrity.py) hashes every file in the
   tag dir and is itself written atomically, then re-verified against
   the bytes on disk;
4. only then does ``latest`` advance (tmp+fsync+rename again).

A crash anywhere before step 4 leaves ``latest`` on the previous good
tag and the half-written dir manifest-less, so the loader's fallback
ladder skips it. Load verifies the manifest before restoring anything
and falls back — loudly, with a ``ckpt_fallback`` ring event and a
``ckpt_verify_failures_total`` tick per rejected tag — to the previous
committed tag rather than ever restoring garbage params.

Layout under ``save_dir``::

    latest                       — text file with the newest tag
    <tag>/state/*.pt             — master, optimizer, loss_scale
    <tag>/host_optimizer.npz     — ZeRO-Offload's host state (below)
    <tag>/client_state.json      — step counters + user state
    <tag>/manifest.json          — per-file sha256 + step/config fingerprint

With ``offload_optimizer`` ``implementation='host'`` the f32 master and
the Adam moments live on the host: ``<tag>/state`` then holds the compute
params (``params.pt``) and the loss scale, and ``host_optimizer.npz``
beside it the host state under JAX's keys (``step``, ``master::<path>``,
``state::<path>::m``/``v``, flat f32, ``<path>`` the JAX tree's
``/``-joined path of the port's dotted name; JAX
``runtime/checkpointing.py:196-229``). A load with the optimizer state
restores it; a load without it (``load_module_only`` or
``load_optimizer_states=False``) or of a tag without the file re-seeds
the master from the restored params (JAX ``:512-545``).

Over several ranks the checkpoint keeps this one logical layout: every
rank takes part in gathering each sharded leaf (leaf by leaf, so at most
one whole leaf is on the card at a time), rank 0 writes the files and
publishes the tag, and every rank reaches the barrier after the
publication even when it failed on rank 0 (JAX ``:280-292``); the tag is
first checked against rank 0's (``checkpoint.tag_validation``, JAX
``:75``). Every rank loads the whole leaves (memory-mapped) and keeps its
blocks, so a tag saved at one world size resumes at another. The async
engine finalizes in the background at world size 1 only, as JAX.

Not here yet: the MoQ schedule (A9). The JAX package also saves its PRNG
key; the port's ``loss_fn`` gets no key (no dropout), so there is none to
save.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.checkpoint.integrity import (MANIFEST_NAME,
                                                      atomic_write_json,
                                                      atomic_write_text,
                                                      committed_tags,
                                                      gc_tags,
                                                      read_manifest,
                                                      verify_checkpoint,
                                                      write_manifest)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.telemetry import events as _ev
from deepspeed_tpu_torch.utils.logging import logger


def _engine_for(engine):
    """One checkpoint engine per training engine — the async one owns a
    writer thread and host buffers, so per-call construction would leak
    them and defeat the overlap."""
    ce = getattr(engine, "_ckpt_engine", None)
    if ce is None:
        from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
            make_checkpoint_engine)
        ce = make_checkpoint_engine(engine.config.checkpoint_config.engine)
        engine._ckpt_engine = ce
    return ce


def _ckpt_cfg(engine):
    return engine.config.checkpoint_config


def _tag_validation(tag: str, mode: str) -> None:
    """Cross-process tag agreement check (reference
    engine._checkpoint_tag_validation, engine.py:3043): rank 0's tag is
    broadcast; a mismatch fails or warns by ``mode``."""
    if comm.get_world_size() == 1 or mode.lower() == "ignore":
        return
    root_tag = comm.broadcast_obj(tag)
    if str(root_tag) != str(tag):
        msg = (f"checkpoint tag mismatch: rank {comm.get_rank()} has "
               f"{tag!r}, rank 0 has {root_tag!r}")
        if mode.lower() == "fail":
            raise ValueError(msg)
        logger.warning(msg)


def _registry_for(engine):
    reg = getattr(engine, "telemetry", None)
    if reg is not None:
        return reg
    from deepspeed_tpu_torch.telemetry import get_registry
    return get_registry()


def _count_verify_failure(engine, reason: str) -> None:
    # label carries the failure CLASS only (missing_manifest,
    # checksum_mismatch, …), never the per-file suffix — labels must
    # stay low-cardinality
    _registry_for(engine).counter(
        "ckpt_verify_failures_total",
        help="checkpoint tags rejected by manifest verification "
             "(runtime/checkpointing.py; each rejection also records a "
             "ckpt_fallback ring event naming the tag)",
        labels={"reason": reason.split(":", 1)[0]}).inc()


def _count_gc_reclaimed(engine, reclaimed_bytes: int) -> None:
    _registry_for(engine).counter(
        "ckpt_gc_reclaimed_total",
        help="bytes reclaimed by bounded checkpoint retention "
             "(checkpoint.keep_last; runtime/checkpointing.py)").inc(
        float(reclaimed_bytes))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None) -> str:
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    # surface a failed previous async finalize BEFORE writing anything —
    # else we'd burn a full state write and leave an uncommitted tag dir
    _join_pending_finalize(engine)
    _tag_validation(tag, _ckpt_cfg(engine).tag_validation)
    ckpt_dir = os.path.join(save_dir, str(tag))
    root = comm.get_rank() == 0
    if root:
        _prepare_tag_dir(save_dir, ckpt_dir, tag)
    state_path = os.path.join(ckpt_dir, "state")
    ce = _engine_for(engine)
    # every rank gathers (collectives); rank 0 alone writes
    state = engine._checkpoint_state()
    write_err: Optional[BaseException] = None
    if root:
        try:
            ce.create(tag)
            ce.save(state, state_path)
        except BaseException as e:  # noqa: BLE001
            write_err = e
    del state
    if getattr(engine, "host_opt", None) is not None:
        err = _save_host_optimizer(
            engine.host_opt.adam.step_count, engine._host_state_leaves(),
            ckpt_dir, write=root and write_err is None)
        write_err = write_err or err

    # Counters are snapshotted NOW: an async finalize that read them live
    # at commit time would stamp a later step onto this state snapshot.
    meta = {
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "micro_steps": engine._micro_steps,
        "zero_stage": engine.zero_optimization_stage(),
        "precision": engine.config.precision_dtype,
        "client_state": client_state or {},
        "ds_version": _version(),
    }
    step_snapshot = int(engine.global_steps)
    fingerprint = {"zero_stage": engine.zero_optimization_stage(),
                   "precision": engine.config.precision_dtype,
                   "ds_version": _version()}
    injector = getattr(engine, "fault_injector", None)

    # durability ordering: 'latest' must only name a COMMITTED checkpoint
    # — a crash between an async save and commit must not leave 'latest'
    # pointing at a half-written tag. The async engine finalizes in the
    # background so training overlaps the persist; a failure ANYWHERE
    # before the final rename leaves the tag dir manifest-less (the
    # loader skips it) and 'latest' untouched.
    def _finalize():
        if injector is not None:
            # chaos site: the mid-save crash — after the state write
            # started, before the tag commits/publishes
            injector.check_ckpt_write(tag)
        ce.commit(tag)
        _write_meta_and_latest(engine, save_dir, ckpt_dir, tag, meta,
                               step_snapshot, fingerprint)
        logger.info(f"saved checkpoint {tag} to {save_dir}")

    if _ckpt_cfg(engine).engine in ("async", "nebula") and \
            comm.get_world_size() == 1 and write_err is None:
        import threading

        # A failure here (a write error, disk full writing 'latest') must
        # not vanish with the thread: log it NOW (the save may be the
        # script's last act, with no later join point) and stash it to
        # re-raise at the next save/load, else 'latest' silently stays
        # stale.
        def _finalize_captured():
            try:
                _finalize()
            except BaseException as e:  # noqa: BLE001
                logger.error(
                    f"async checkpoint finalize for tag {tag!r} failed; "
                    f"'latest' was NOT updated: {e!r}")
                engine._ckpt_finalize_error = e

        # non-daemon: interpreter exit waits for the finalize, so a save
        # issued as a script's last act is never silently lost
        t = threading.Thread(target=_finalize_captured, daemon=False)
        t.start()
        engine._ckpt_finalize_thread = t
        _register_atexit_join(engine)
    else:
        err = write_err
        if root and err is None:
            try:
                _finalize()
            except BaseException as e:  # noqa: BLE001
                err = e
        # every rank must reach the barrier even when publication failed
        # on rank 0: raising before it would leave the other ranks
        # blocked in it instead of failing loudly
        comm.barrier()
        if err is not None:
            raise err
    return ckpt_dir


def _prepare_tag_dir(save_dir: str, ckpt_dir: str, tag) -> None:
    """Make the tag dir (rank 0)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # a re-save into a previously half-written tag must start from a
    # clean verdict: drop the stale manifest (it hashes the OLD bytes)
    # and any atomic-write debris before new content lands.
    # Invalidating a COMMITTED tag that 'latest' names would open a crash
    # window where 'latest' points at a manifest-less, torn dir (and,
    # were it the only committed tag, the legacy rung would load the
    # torn state unverified). Demote 'latest' to the newest OTHER
    # committed tag — or drop the pointer — BEFORE the manifest goes
    # away; a successful save re-advances it.
    latest_path = os.path.join(save_dir, "latest")
    if os.path.isfile(os.path.join(ckpt_dir, MANIFEST_NAME)) and \
            os.path.isfile(latest_path):
        with open(latest_path) as f:
            current_latest = f.read().strip()
        if current_latest == str(tag):
            others = [name for _, name in committed_tags(save_dir)
                      if name != str(tag)]
            if others:
                atomic_write_text(latest_path, others[0])
            else:
                try:
                    os.unlink(latest_path)
                except OSError:
                    pass
    for name in [MANIFEST_NAME] + \
            [n for n in os.listdir(ckpt_dir) if n.endswith(".tmp")]:
        try:
            os.unlink(os.path.join(ckpt_dir, name))
        except OSError:
            pass


# engines with an async finalize possibly in flight at interpreter exit;
# the thread is non-daemon (exit waits for it), but the ERROR it may have
# stashed must still surface instead of dying with the process silently
_ATEXIT_ENGINES = None


def _register_atexit_join(engine) -> None:
    global _ATEXIT_ENGINES
    if _ATEXIT_ENGINES is None:
        import atexit
        import weakref
        _ATEXIT_ENGINES = weakref.WeakSet()

        def _join_all():
            for eng in list(_ATEXIT_ENGINES):
                try:
                    _join_pending_finalize(eng)
                except RuntimeError as e:
                    logger.error(f"checkpoint finalize failed at exit: {e}")
        atexit.register(_join_all)
    _ATEXIT_ENGINES.add(engine)


def _join_pending_finalize(engine) -> None:
    """Join an in-flight async finalize and surface its failure, if any —
    the caller (next save/load, ``engine.destroy()``, atexit) must not
    proceed believing the previous checkpoint committed when it did not.
    Idempotent: a second join is a no-op, and a surfaced error is
    cleared so it is raised exactly once."""
    prev = getattr(engine, "_ckpt_finalize_thread", None)
    if prev is not None:
        if prev.is_alive():
            prev.join()
        engine._ckpt_finalize_thread = None
    err = getattr(engine, "_ckpt_finalize_error", None)
    if err is not None:
        engine._ckpt_finalize_error = None
        raise RuntimeError(
            "async checkpoint finalize failed; 'latest' was not updated "
            "for the previous save") from err


def _write_meta_and_latest(engine, save_dir, ckpt_dir, tag, meta,
                           step, fingerprint):
    """Publish a committed tag: client_state.json (atomic, STRICT json),
    then the integrity manifest, then — only after the manifest verifies
    against the bytes on disk — the ``latest`` pointer (atomic). Every
    write is tmp+fsync+rename; a crash at any point leaves ``latest``
    on the previous good tag."""
    atomic_write_json(os.path.join(ckpt_dir, "client_state.json"), meta)
    if _ckpt_cfg(engine).verify:
        write_manifest(ckpt_dir, tag, step, fingerprint)
        # shallow (existence + byte sizes): write_manifest just hashed
        # these very bytes, and a second deep pass would re-read them
        # from the page cache — doubling the save window on a multi-GB
        # tag while catching nothing a size check doesn't (a racing
        # truncation/deletion). The loader deep-verifies before any
        # restore.
        ok, reason = verify_checkpoint(ckpt_dir, deep=False)
        if not ok:
            # do NOT advance 'latest'; the manifest stays (it is honest
            # about the bytes) but the tag is rejected at load
            _count_verify_failure(engine, reason)
            raise RuntimeError(
                f"checkpoint {tag!r} failed post-write verification "
                f"({reason}); 'latest' not advanced")
    atomic_write_text(os.path.join(save_dir, "latest"), str(tag))
    _gc_old_tags(engine, save_dir, keep_tag=str(tag))


def _gc_old_tags(engine, save_dir: str, keep_tag: str) -> None:
    """Bounded retention (``checkpoint.keep_last``): drop the oldest
    committed tags past the cap — never the tag just published, never
    the one ``latest`` names. Best-effort: GC failure must not fail the
    save that triggered it."""
    keep_last = _ckpt_cfg(engine).keep_last
    if keep_last <= 0:
        return
    try:
        protect = {keep_tag}
        latest_path = os.path.join(save_dir, "latest")
        if os.path.isfile(latest_path):
            with open(latest_path) as f:
                protect.add(f.read().strip())
        deleted, reclaimed = gc_tags(save_dir, keep_last,
                                     protect=tuple(protect))
        if deleted:
            _count_gc_reclaimed(engine, reclaimed)
            _ev.record_event(_ev.CKPT_GC, dir=str(save_dir),
                             deleted=deleted, reclaimed_bytes=reclaimed,
                             keep_last=keep_last)
            logger.info(
                f"checkpoint GC: dropped {deleted} "
                f"({reclaimed / 2**20:.1f} MiB), keep_last={keep_last}")
    except Exception as e:  # noqa: BLE001
        logger.warning(f"checkpoint GC under {save_dir} failed: {e}")


def _candidate_tags(load_dir: str, requested: Optional[str],
                    explicit: bool) -> list:
    """The fallback ladder: the requested tag first (whatever ``latest``
    names), then every other committed tag, newest step first. A stale
    ``latest`` naming a deleted tag simply contributes a first rung
    that fails ``missing_dir`` and the walk continues. An EXPLICIT
    caller-pinned tag gets a one-rung ladder: substituting a different
    checkpoint than the one a reproducibility run pinned would be worse
    than failing loudly."""
    if explicit:
        return [str(requested)]
    ladder = []
    if requested is not None:
        ladder.append(str(requested))
    for _, name in committed_tags(load_dir):
        if name not in ladder:
            ladder.append(name)
    return ladder


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False):
    """Restore the newest verified tag (or the pinned ``tag``); returns
    ``(tag dir, client_state)``, or ``(None, {})`` when ``load_dir``
    holds no checkpoint. The schedule is a function of ``global_steps``,
    so ``load_lr_scheduler_states`` has nothing of its own to restore."""
    _join_pending_finalize(engine)  # an async save may still be finalizing
    explicit = tag is not None
    requested = tag
    if requested is None:
        latest = os.path.join(load_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                requested = f.read().strip()
        elif not committed_tags(load_dir):
            logger.warning(f"no 'latest' file under {load_dir}; nothing loaded")
            return None, {}
        # latest missing but committed tags exist (crash before the very
        # first publish finished, or an operator deleted the pointer):
        # the ladder below still finds the newest good tag

    verify = _ckpt_cfg(engine).verify
    ladder = _candidate_tags(load_dir, requested, explicit)
    chosen = None
    for i, cand in enumerate(ladder):
        ckpt_dir = os.path.join(load_dir, cand)
        if verify:
            ok, reason = verify_checkpoint(ckpt_dir)
        else:
            ok, reason = os.path.isdir(ckpt_dir), "missing_dir"
        if ok:
            chosen = cand
            if i > 0:
                # landed below the top rung: say so everywhere — a
                # silent fallback is how a run quietly loses steps
                logger.error(
                    f"checkpoint fallback: tag {ladder[0]!r} rejected; "
                    f"restoring previous good tag {cand!r}")
            break
        _count_verify_failure(engine, reason)
        _ev.record_event(_ev.CKPT_FALLBACK, dir=str(load_dir),
                         tag=str(cand), reason=reason,
                         rung=i, remaining=len(ladder) - i - 1)
        logger.error(
            f"checkpoint tag {cand!r} failed verification ({reason}); "
            + ("trying previous good tag"
               if i + 1 < len(ladder) else "no tags left"))
    if chosen is None:
        if ladder and not committed_tags(load_dir) and \
                os.path.isdir(os.path.join(load_dir, ladder[0], "state")):
            # legacy layout: a pre-manifest checkpoint and nothing else.
            # Loading it blindly is the old behavior; keep it possible,
            # but loudly unverified.
            chosen = ladder[0]
            logger.warning(
                f"checkpoint {chosen!r} predates integrity manifests — "
                "loading UNVERIFIED (resave to upgrade)")
        elif explicit:
            # diagnose the manifest-less case: a pre-manifest legacy
            # tag and a torn (crashed-save) dir look identical from
            # here, so neither is restored unverified — but the error
            # must not call a legacy checkpoint "corrupt"
            hint = ""
            if not read_manifest(os.path.join(load_dir, str(requested))) \
                    and os.path.isdir(os.path.join(
                        load_dir, str(requested), "state")):
                hint = (" — the tag has no integrity manifest (a "
                        "pre-manifest legacy checkpoint, or a save "
                        "that crashed mid-write); set checkpoint."
                        "verify=false to trust the directory")
            raise RuntimeError(
                f"requested checkpoint tag {requested!r} under "
                f"{load_dir!r} failed verification — refusing to "
                "silently substitute a different tag (load with "
                f"tag=None for the fallback ladder){hint}")
        else:
            raise RuntimeError(
                f"no loadable checkpoint under {load_dir!r}: every "
                f"candidate tag failed verification ({ladder}) — refusing "
                "to restore unverified params")
    tag = chosen
    ckpt_dir = os.path.join(load_dir, str(tag))
    state_path = os.path.abspath(os.path.join(ckpt_dir, "state"))
    state = _engine_for(engine).load(state_path)
    with_opt = load_optimizer_states and not load_module_only
    engine._load_checkpoint_state(state, load_optimizer_states=with_opt)
    if getattr(engine, "host_opt", None) is not None:
        host_path = os.path.join(ckpt_dir, HOST_OPTIMIZER_FILE)
        if with_opt and os.path.isfile(host_path):
            engine._load_host_state(*_load_host_optimizer(host_path))
        else:
            # no host state restored: re-seed the fp32 master from the
            # restored params, else the next step would overwrite them
            # with the construction-time master
            engine.host_opt.sync_master_from(engine._params_as_master())

    meta_path = os.path.join(ckpt_dir, "client_state.json")
    client_state = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = int(meta.get("global_steps", 0))
        engine.skipped_steps = int(meta.get("skipped_steps", 0))
        engine._micro_steps = int(meta.get("micro_steps", 0))
        client_state = meta.get("client_state", {})
    logger.info(f"loaded checkpoint {tag} from {load_dir}")
    return ckpt_dir, client_state


HOST_OPTIMIZER_FILE = "host_optimizer.npz"


def _save_host_optimizer(step: int, leaves, ckpt_dir: str,
                         write: bool) -> Optional[BaseException]:
    """The host master and moments as one ``.npz`` with JAX's keys,
    written atomically (tmp, fsync, rename) before the tag commits, so
    the manifest hashes it. ``leaves`` (``engine._host_state_leaves()``)
    are streamed into the archive one at a time, as ``np.savez`` stores
    them. Every rank consumes them, since their gathers are collectives;
    only where ``write`` is a file written. Returns the write's error."""
    import zipfile

    import numpy as np

    def put(zf, key, arr):
        with zf.open(key + ".npy", "w", force_zip64=True) as fh:
            np.lib.format.write_array(fh, np.asanyarray(arr),
                                      allow_pickle=False)

    final = os.path.join(ckpt_dir, HOST_OPTIMIZER_FILE)
    tmp = final + ".tmp"
    err: Optional[BaseException] = None
    f = zf = None
    try:
        if write:
            f = open(tmp, "wb")
            zf = zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                 allowZip64=True)
            put(zf, "step", np.int64(step))
    except BaseException as e:  # noqa: BLE001
        err = e
    for (group, k, part), leaf in leaves:
        if zf is None or err is not None:
            continue
        key = (f"master::{_jax_name(k)}" if group == "master"
               else f"state::{_jax_name(k)}::{part}")
        try:
            put(zf, key, leaf.numpy())
        except BaseException as e:  # noqa: BLE001
            err = e
        del leaf
    try:
        if zf is not None:
            zf.close()
        if f is not None:
            if err is None:
                f.flush()
                os.fsync(f.fileno())
            f.close()
            if err is None:
                os.replace(tmp, final)
    except BaseException as e:  # noqa: BLE001
        err = err or e
    return err


def _load_host_optimizer(path: str):
    """``(step, leaves)`` of a ``host_optimizer.npz``: ``leaves`` yields
    ``((group, name, part), array)``, each member read from the archive
    only when its turn comes (``engine._load_host_state``)."""
    import numpy as np
    blob = np.load(path)
    step = int(blob["step"])

    def leaves():
        with blob:
            for key in blob.files:
                if key.startswith("master::"):
                    yield ("master", _port_name(key[len("master::"):]),
                           None), blob[key]
                elif key.startswith("state::"):
                    _, leaf, part = key.split("::")
                    yield ("state", _port_name(leaf), part), blob[key]
    return step, leaves()


def _jax_name(name: str) -> str:
    """The port's dotted param name as the JAX tree's ``/``-joined path
    (``flatten_with_names``), the key format of ``host_optimizer.npz``."""
    return name.replace(".", "/")


def _port_name(path: str) -> str:
    return path.replace("/", ".")


def checkpoint_integrity_report(save_dir: str) -> dict:
    """JSON-able integrity view of one save dir — the manifest verdicts,
    without loading anything. SHALLOW checks only (existence + byte
    sizes): deep-hashing a multi-GB tag on every report would steal disk
    bandwidth from training. The loader re-verifies deeply before any
    actual restore."""
    latest_path = os.path.join(save_dir, "latest")
    latest = None
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            latest = f.read().strip()
    tags = []
    for step, name in committed_tags(save_dir):
        ok, reason = verify_checkpoint(
            os.path.join(save_dir, name), deep=False)
        m = read_manifest(os.path.join(save_dir, name)) or {}
        tags.append({"tag": name, "step": step, "verified": ok,
                     "reason": reason, "deep": False,
                     "files": len(m.get("files", {}))})
    return {"save_dir": str(save_dir), "latest": latest, "tags": tags,
            "latest_committed": any(t["tag"] == latest and t["verified"]
                                    for t in tags)}


def _version():
    from deepspeed_tpu_torch import __version__
    return __version__
