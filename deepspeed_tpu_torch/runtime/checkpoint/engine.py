"""Checkpoint commit primitives — the part of
``deepspeed_tpu/runtime/checkpoint/engine.py`` that the serving cold tier
(``inference/v2/coldstore.py``) builds on: stage into ``<dir>.tmp/``, write
a ``manifest.json`` (per-file size + digest + meta), fsync every file and
the parent directory, then commit with one ``os.replace`` rename; and
``verify_checkpoint``, which checks a directory against its manifest.

The checkpoint engine itself (``save_checkpoint`` / ``load_checkpoint``,
the ``latest`` pointer, async saves, fallback to the newest valid tag) is
not ported yet: it arrives with ROADMAP.md queue A item A12.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import Any, Dict, List

from ...utils.logging import logger

_MANIFEST = "manifest.json"
_TMP_SUFFIX = ".tmp"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _digest_file(path: str, algorithm: str) -> str:
    if algorithm == "crc32":
        crc = 0
        with open(path, "rb") as f:
            while chunk := f.read(1 << 20):
                crc = zlib.crc32(chunk, crc)
        return f"{crc & 0xFFFFFFFF:08x}"
    if algorithm == "sha256":
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 20):
                h.update(chunk)
        return h.hexdigest()
    raise ValueError(f"unknown integrity algorithm {algorithm!r} "
                     "(want none|crc32|sha256)")


def _write_manifest(ckpt_dir: str, meta: Dict, algorithm: str) -> None:
    """Size+digest every file in ``ckpt_dir``, fsync them, write the
    manifest (fsync'd), fsync the directory.  Digests are computed by
    reading the files BACK from the filesystem, so a write the kernel
    mangled before this point is caught at the next verify."""
    files: Dict[str, Dict[str, Any]] = {}
    for name in sorted(os.listdir(ckpt_dir)):
        if name == _MANIFEST:
            continue
        path = os.path.join(ckpt_dir, name)
        entry: Dict[str, Any] = {"size": os.path.getsize(path)}
        if algorithm != "none":
            entry["digest"] = _digest_file(path, algorithm)
        files[name] = entry
        _fsync_path(path)
    manifest = {"format_version": 1, "digest": algorithm,
                "files": files, "meta": meta}
    path = os.path.join(ckpt_dir, _MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(ckpt_dir)


def _commit_dir(tmp_dir: str, final_dir: str) -> None:
    """Atomic commit: one rename.  An existing committed dir under the same
    tag (re-save) is removed first — a crash inside that window leaves no
    dir for this tag, which the fallback walk handles like any other
    missing tag."""
    if os.path.lexists(final_dir):
        logger.warning(f"overwriting existing checkpoint {final_dir}")
        shutil.rmtree(final_dir, ignore_errors=True)
    os.replace(tmp_dir, final_dir)
    _fsync_path(os.path.dirname(final_dir) or ".")


def verify_checkpoint(ckpt_dir: str, check_digests: bool = True) -> List[str]:
    """Check a checkpoint directory against its manifest.  Returns a list
    of problems — empty means valid.  A missing manifest is reported as
    ``"missing manifest.json"`` (uncommitted, or written by a pre-manifest
    version — callers decide whether legacy counts)."""
    if not os.path.isdir(ckpt_dir):
        return [f"not a directory: {ckpt_dir}"]
    problems: List[str] = []
    if ckpt_dir.rstrip(os.sep).endswith(_TMP_SUFFIX):
        problems.append("uncommitted (.tmp) staging directory")
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        return problems + ["missing manifest.json"]
    try:
        with open(path) as f:
            manifest = json.load(f)
        files = manifest["files"]
        algorithm = manifest.get("digest", "none")
    except (OSError, ValueError, KeyError) as e:
        return problems + [f"unreadable manifest.json: {e!r}"]
    for name, entry in files.items():
        fpath = os.path.join(ckpt_dir, name)
        if not os.path.exists(fpath):
            problems.append(f"{name}: missing")
            continue
        size = os.path.getsize(fpath)
        if size != entry.get("size"):
            problems.append(f"{name}: size {size} != manifest "
                            f"{entry.get('size')}")
            continue
        if check_digests and algorithm != "none" and "digest" in entry:
            digest = _digest_file(fpath, algorithm)
            if digest != entry["digest"]:
                problems.append(f"{name}: {algorithm} digest mismatch")
    return problems
