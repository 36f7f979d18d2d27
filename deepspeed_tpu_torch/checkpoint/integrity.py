"""Checkpoint integrity: atomic publication + per-file manifests.

A copy of ``deepspeed_tpu/checkpoint/integrity.py`` (the port imports
nothing of the JAX package, not even its JAX-free modules); the two
write and read the same ``manifest.json``.

The reference engine trusts its checkpoint directory blindly: ``latest``
and ``client_state.json`` are written with plain ``open(...,"w")``, so a
crash (or a preemption of a spot machine) mid
``save_checkpoint`` can leave a half-written tag that the next
``load_checkpoint`` happily restores as garbage params. This module is
the CheckFreq/Orbax-async discipline for the whole tag directory:

* :func:`atomic_write_text` / :func:`atomic_write_json` — write to
  ``<path>.tmp``, flush+fsync, ``os.replace`` (atomic on POSIX), fsync
  the directory so the rename itself is durable. A crash at any point
  leaves either the old file or the new one, never a torn write.
  ``atomic_write_json`` serializes STRICTLY — an unserializable value
  raises instead of being silently stringified (``default=str`` would
  round-trip ``step`` counters as strings and corrupt a resume).
* :func:`write_manifest` — after the checkpoint engine commits a tag,
  walk every file under the tag dir, hash it (sha256), and atomically
  publish ``manifest.json`` carrying the per-file digests plus the
  step/config fingerprint. The ``latest`` pointer is only advanced
  AFTER the manifest verifies against the bytes on disk — so ``latest``
  names a checkpoint that is proven whole, by construction.
* :func:`verify_checkpoint` — re-hash a tag dir against its manifest:
  catches truncated files, flipped bytes, deleted files, and a missing
  manifest (an uncommitted tag). Returns ``(ok, reason)`` so the loader
  can walk its fallback ladder with a per-tag verdict.
* :func:`committed_tags` — the tags under a save dir that finished
  publication (manifest present), newest step first: the loader's
  fallback ladder and the retention GC both walk this list.
* :func:`gc_tags` — bounded retention: keep the newest ``keep_last``
  committed tags, delete the rest (reclaimed bytes counted by the
  caller). Uncommitted tag dirs (no manifest — a crash's debris or an
  in-flight async save) are never GC'd from here; the next save to the
  same tag overwrites them.

Host-pure (no torch): usable from tests and tooling without a device
in sight.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"

# files the manifest never covers: itself, and in-flight tmp files from
# an interrupted atomic write (debris, not content)
_EXCLUDED_SUFFIXES = (".tmp",)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss.
    Best-effort: some filesystems refuse O_RDONLY dir fsync — the
    rename is still atomic, only its durability window widens."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def atomic_write_text(path: str, text: str) -> None:
    """Durable atomic replace: tmp + flush + fsync + rename + dir
    fsync. Readers see the old content or the new, never a torn
    write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj: Any) -> None:
    """Atomic JSON write with STRICT serialization: a value json cannot
    represent raises ``TypeError`` here, before any bytes hit disk —
    never ``default=str``, which would silently persist e.g. a device
    array's repr and feed garbage to the next resume."""
    try:
        text = json.dumps(obj, indent=2, allow_nan=False)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"checkpoint metadata for {path!r} is not JSON-serializable "
            f"({e}); convert device arrays / custom objects to plain "
            "python values before checkpointing") from e
    atomic_write_text(path, text)


def sha256_file(path: str, chunk_bytes: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _manifest_files(ckpt_dir: str) -> List[str]:
    """Relative paths of every content file under the tag dir."""
    out = []
    for dirpath, _, files in os.walk(ckpt_dir):
        for fname in files:
            rel = os.path.relpath(os.path.join(dirpath, fname), ckpt_dir)
            if rel == MANIFEST_NAME or rel.endswith(_EXCLUDED_SUFFIXES):
                continue
            out.append(rel)
    return sorted(out)


def build_manifest(ckpt_dir: str, tag: str, step: int,
                   fingerprint: Optional[Dict[str, Any]] = None) -> dict:
    """Hash every file under ``ckpt_dir`` into a manifest dict. The
    ``fingerprint`` carries step/config identity so a tag restored onto
    a mismatched run can be detected, not just a corrupted one."""
    files: Dict[str, dict] = {}
    for rel in _manifest_files(ckpt_dir):
        full = os.path.join(ckpt_dir, rel)
        files[rel] = {"sha256": sha256_file(full),
                      "bytes": os.path.getsize(full)}
    return {
        "format": 1,
        "tag": str(tag),
        "step": int(step),
        "fingerprint": dict(fingerprint or {}),
        "files": files,
    }


def write_manifest(ckpt_dir: str, tag: str, step: int,
                   fingerprint: Optional[Dict[str, Any]] = None) -> dict:
    """Build + atomically publish the manifest. Returns it."""
    manifest = build_manifest(ckpt_dir, tag, step, fingerprint)
    atomic_write_json(os.path.join(ckpt_dir, MANIFEST_NAME), manifest)
    return manifest


def read_manifest(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return manifest if isinstance(manifest, dict) else None


def verify_checkpoint(ckpt_dir: str,
                      deep: bool = True) -> Tuple[bool, str]:
    """Verdict on one tag dir: ``(True, "ok")`` or ``(False, reason)``.

    ``deep=False`` checks existence + byte sizes only (cheap pre-flight
    for huge checkpoints); ``deep=True`` (default) re-hashes every file,
    catching flipped bytes, not just truncation."""
    if not os.path.isdir(ckpt_dir):
        return False, "missing_dir"
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return False, "missing_manifest"
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return False, "empty_manifest"
    for rel, meta in files.items():
        full = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(full):
            return False, f"missing_file:{rel}"
        if os.path.getsize(full) != int(meta.get("bytes", -1)):
            return False, f"size_mismatch:{rel}"
        if deep and sha256_file(full) != meta.get("sha256"):
            return False, f"checksum_mismatch:{rel}"
    # files that appeared after publication are suspicious but not
    # corruption — the hashed content is intact; accept.
    return True, "ok"


def committed_tags(save_dir: str) -> List[Tuple[int, str]]:
    """``(step, tag)`` of every committed (manifest-bearing) tag under
    ``save_dir``, NEWEST step first — the fallback ladder's walk order
    (ties broken by directory mtime, newest first)."""
    out = []
    if not os.path.isdir(save_dir):
        return out
    for name in os.listdir(save_dir):
        ckpt_dir = os.path.join(save_dir, name)
        if not os.path.isdir(ckpt_dir):
            continue
        manifest = read_manifest(ckpt_dir)
        if manifest is None:
            continue
        try:
            mtime = os.path.getmtime(ckpt_dir)
        except OSError:
            mtime = 0.0
        out.append((int(manifest.get("step", -1)), mtime, name))
    out.sort(reverse=True)
    return [(step, name) for step, _, name in out]


def dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for fname in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, fname))
            except OSError:
                pass
    return total


def gc_tags(save_dir: str, keep_last: int,
            protect: Tuple[str, ...] = ()) -> Tuple[List[str], int]:
    """Delete committed tags beyond the newest ``keep_last``; returns
    ``(deleted tag names, reclaimed bytes)``. ``protect`` names tags
    never deleted regardless of age (the tag just written, the one
    ``latest`` names). ``keep_last <= 0`` keeps everything."""
    if keep_last <= 0:
        return [], 0
    tags = committed_tags(save_dir)
    victims = [name for _, name in tags[keep_last:] if name not in protect]
    deleted, reclaimed = [], 0
    for name in victims:
        ckpt_dir = os.path.join(save_dir, name)
        reclaimed += dir_bytes(ckpt_dir)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        deleted.append(name)
    return deleted, reclaimed
