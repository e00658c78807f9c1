"""Checkpoint save/load — the port of
``deepspeed_tpu/runtime/checkpoint/engine.py`` (the ``native`` and
``fast`` engines; ``orbax``, the multi-host engine, arrives with
ROADMAP.md A13).

The layout is the reference's, file for file and key for key, so a
checkpoint of either package loads into the other:

* ``<save_dir>/<tag>/`` (tag ``global_step<N>`` by default) holds
  ``model.safetensors`` (the parameter tree under its slash-joined paths),
  ``optimizer.safetensors`` (the optimizer state under optax's paths, e.g.
  ``0/0/mu/layers/attn/wq``; ``runtime/optimizers.py``),
  ``engine_state.json`` (step, skipped steps, the loss scale's three
  fields, ``rng``, zero stage, world size, client state) and
  ``manifest.json``;
* ``<save_dir>/latest`` names the newest committed tag.

The tree files are written as the reference writes them: tensors in the
safetensors library's order, bf16 as a ``uint16`` view named in the
``bf16_keys`` metadata, f16 as ``F16``; the ``fast`` engine writes the
same tensors through the FastPersist writer (``io/fast_writer.py``).

Durability, as in the reference: a save stages into ``<tag>.tmp/``, writes
a manifest (per-file size + digest, computed by reading the files back),
fsyncs every file and the directory, commits with one ``os.replace``, then
moves the ``latest`` pointer (write-temp-then-rename).  A kill at any
instant leaves a committed-and-valid tag or an orphaned ``.tmp`` that the
next save garbage-collects.  :func:`load_checkpoint` verifies before it
reads and, with ``fallback``, walks committed tags newest to oldest to the
newest valid one.  Async saves (``checkpoint.async_save``) record their
failures, which :func:`wait_for_async_saves` and the next save re-raise.

Two design differences from the reference:

* **In-place updates.** The port's optimizer updates parameters in place
  (``runtime/engine.py``), where the reference's step donates its
  buffers; either way the device state changes under a background save, so
  an async save copies every tensor to host memory before
  ``save_checkpoint`` returns, and only the file IO runs on the thread.
* **The step's random key.** The reference keeps a JAX key in
  ``engine_state.json`` (``rng``) and splits it every step; the port
  seeds its generator from ``config.seed`` and the step count.  A save
  writes ``rng`` in the key format (``[0, seed * 1000003 + step mod
  2^32]``), so the reference's engine loads it; a load (of either
  package's checkpoint) ignores ``rng`` and derives the generator from the
  restored step.

Fault sites (``utils/faults.py``): ``ckpt.write.model``,
``ckpt.write.optimizer``, ``ckpt.write.meta``, ``ckpt.write.manifest``,
``ckpt.commit``, ``ckpt.latest``; torn writes ``ckpt.truncate.model`` /
``ckpt.truncate.optimizer``.

The commit primitives (``_write_manifest``, ``_commit_dir``,
``verify_checkpoint``) also back the serving cold tier
(``inference/v2/coldstore.py``) and the adapter registry
(``serving/adapters.py``); :func:`export_merged_weights` folds a PEFT
run's own LoRA nodes, or a registry adapter, into the base weights.

PEFT (``peft.lora``): a save writes ``adapter_model.safetensors`` (the
``lora_a`` / ``lora_b`` leaves) in place of ``model.safetensors`` and
``"peft_adapter_only": true``; a load splices it over the engine's frozen
base.  An adapter-only checkpoint into a plain engine, or a full one into
a PEFT engine, raises the reference's errors.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import shutil
import sys
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...io.fast_writer import header_from_host, read_safetensors
from ...observability.recorder import recorder
from ...observability.trace import tracer
from ...utils import faults
from ...utils.logging import logger
from ...utils.tree_io import (ST_DTYPES, host_array, node_fields,
                               node_items, node_replace)

_LATEST = "latest"
_MANIFEST = "manifest.json"
_TMP_SUFFIX = ".tmp"
# RLock: _prune_old and the GC take it too, and are called from _do_save
# which already holds it
_SAVE_LOCK = threading.RLock()
_async_threads: List[threading.Thread] = []
#: (ckpt_dir, exception) per failed async save — drained by
#: _raise_pending_async_errors (next save / wait_for_async_saves)
_async_errors: List[Tuple[str, BaseException]] = []


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed manifest verification (or no valid checkpoint
    exists where one was expected)."""


class SafetensorError(Exception):
    """A tree file that is not a whole safetensors payload (the safetensors
    library's error in the reference)."""


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


def _write_latest(save_dir: str, tag: str) -> None:
    """Update the ``latest`` pointer atomically (write-temp-then-rename):
    a crash mid-update leaves the previous pointer, never a torn file."""
    tmp = os.path.join(save_dir, _LATEST + _TMP_SUFFIX)
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, _LATEST))
    _fsync_path(save_dir)


def _gc_stale_tmp(save_dir: str, current: Optional[str] = None) -> None:
    """Remove uncommitted ``*.tmp`` leftovers from crashed saves.  Called
    under _SAVE_LOCK, so any tmp entry other than ``current`` is
    orphaned."""
    try:
        names = os.listdir(save_dir)
    except FileNotFoundError:
        return
    for name in names:
        if not name.endswith(_TMP_SUFFIX) or name == current:
            continue
        path = os.path.join(save_dir, name)
        logger.warning(f"garbage-collecting uncommitted checkpoint leftover "
                       f"{path}")
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass


def is_committed(ckpt_dir: str) -> bool:
    """Committed iff renamed into place (not a ``.tmp`` staging dir) and
    carrying a manifest (or, pre-manifest, ``engine_state.json``)."""
    if ckpt_dir.rstrip(os.sep).endswith(_TMP_SUFFIX):
        return False
    return (os.path.exists(os.path.join(ckpt_dir, _MANIFEST))
            or os.path.exists(os.path.join(ckpt_dir, "engine_state.json")))


def _is_legacy_only(problems: List[str]) -> bool:
    return problems == ["missing manifest.json"]


def checkpoint_candidates(load_dir: str) -> List[str]:
    """Committed tags, newest first: ``global_step<N>`` tags by N, then any
    custom tags by directory mtime.  ``.tmp`` staging dirs never appear."""
    try:
        names = os.listdir(load_dir)
    except FileNotFoundError:
        return []
    steps, custom = [], []
    for name in names:
        path = os.path.join(load_dir, name)
        if (name.endswith(_TMP_SUFFIX) or not os.path.isdir(path)
                or not is_committed(path)):
            continue
        if name.startswith("global_step"):
            try:
                steps.append((int(name.removeprefix("global_step")), name))
                continue
            except ValueError:
                pass
        try:
            custom.append((os.path.getmtime(path), name))
        except OSError:
            continue
    return ([name for _, name in sorted(steps, reverse=True)]
            + [name for _, name in sorted(custom, reverse=True)])


def find_latest_valid_checkpoint(load_dir: str, check_digests: bool = True,
                                 allow_legacy: bool = True
                                 ) -> Optional[str]:
    """The newest committed tag that passes verification, or None."""
    for tag in checkpoint_candidates(load_dir):
        problems = verify_checkpoint(os.path.join(load_dir, tag),
                                     check_digests=check_digests)
        if not problems:
            return tag
        if _is_legacy_only(problems) and allow_legacy:
            logger.warning(f"checkpoint {tag} predates manifests — accepted "
                           "unverified")
            return tag
        logger.error(f"checkpoint {tag} failed verification: {problems}")
    return None


# ---------------------------------------------------------------------------
# parameter trees as safetensors files
# ---------------------------------------------------------------------------

#: the safetensors library writes tensors sorted by dtype (this order,
#: widest first) and then by name; so does :func:`_save_tree`
_ST_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
             "I16", "I8", "U8", "BOOL")


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{slash/joined/path: leaf} of a nested dict (or list) tree, in the
    reference's flatten order (dict keys sorted; a LoRA node's children
    ``.../lora_a``, a quantized base's ``.../base/codes``); a ``None`` leaf
    (a frozen leaf of ``trainable_subtree``) is absent, as in the
    reference."""
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        node_items(tree)
    if items is None:
        return {} if tree is None else {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return flat


def _tree_hosts(tree: Any) -> Tuple[Dict[str, Tuple[Any, str]], List[str]]:
    """``({key: (host array, safetensors dtype)}, bf16 keys)`` of a tree in
    the safetensors library's order (by dtype, widest first, then by name),
    bf16 as its ``uint16`` bits."""
    hosts: Dict[str, Any] = {}
    bf16_keys: List[str] = []
    for key, leaf in flatten_with_paths(tree).items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16_keys.append(key)
            leaf = leaf.detach().cpu().contiguous().view(torch.uint16)
        arr, _ = host_array(leaf)
        hosts[key] = (arr, ST_DTYPES[str(arr.dtype)])
    order = sorted(hosts, key=lambda k: (_ST_ORDER.index(hosts[k][1]), k))
    return {k: hosts[k] for k in order}, bf16_keys


def _save_tree(tree: Any, path: str) -> None:
    """Write a parameter tree (tensors or numpy arrays) as one safetensors
    file, byte for byte what the reference's ``_save_tree`` writes for the
    same tree."""
    hosts, bf16_keys = _tree_hosts(tree)
    header, _, _ = header_from_host(
        hosts, {"bf16_keys": json.dumps(sorted(bf16_keys))})
    with open(path, "wb") as f:
        f.write(header)
        for arr, _ in hosts.values():
            f.write(arr.reshape(-1).view(np.uint8).data)


def _save_trees_fast(trees_and_paths) -> None:
    """The ``fast`` engine: the same files (tensors, dtypes, ``bf16_keys``)
    written through the FastPersist writer's AIO pool."""
    from ...io.fast_writer import get_fast_writer

    writer = get_fast_writer()
    for tree, path in trees_and_paths:
        hosts, bf16_keys = _tree_hosts(tree)
        writer.write_safetensors({k: a for k, (a, _) in hosts.items()}, path,
                                 {"bf16_keys": json.dumps(sorted(bf16_keys))})


def _load_tree_flat(path: str) -> Dict[str, torch.Tensor]:
    """{path: CPU tensor} of a :func:`_save_tree` file (the reference's
    too); the ``bf16_keys`` come back as bf16.  A payload shorter than its
    header says, or a header that does not parse, raises
    :class:`SafetensorError`."""
    with open(path, "rb") as f:
        payload = bytearray(f.read())  # writable: the tensors view it
    try:
        hlen = int.from_bytes(payload[:8], "little")
        if len(payload) < 8 or 8 + hlen > len(payload):
            raise SafetensorError(f"{path}: header runs past the file")
        hdr = json.loads(bytes(payload[8:8 + hlen]).decode())
        end = max([e["data_offsets"][1] for k, e in hdr.items()
                   if k != "__metadata__"] or [0])
        if 8 + hlen + end > len(payload):
            raise SafetensorError(f"{path}: {len(payload)} bytes, header "
                                  f"wants {8 + hlen + end}")
        arrays, meta = read_safetensors(payload)
    except (ValueError, KeyError, TypeError) as e:  # JSON, offsets, dtypes
        raise SafetensorError(f"{path}: not a safetensors payload: "
                              f"{e!r}") from e
    for k in json.loads(meta.get("bf16_keys", "[]")):
        arrays[k] = arrays[k].view(torch.bfloat16)
    return arrays


def _unflatten_like(template: Any, flat: Dict[str, Any],
                    prefix: str = "") -> Any:
    """``template``'s nesting with each leaf taken from ``flat`` by its
    path."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    fields = node_fields(template)
    if fields:
        return node_replace(template, [
            _unflatten_like(getattr(template, f), flat,
                            f"{prefix}/{f}" if prefix else f)
            for f in fields])
    if prefix not in flat:
        raise KeyError(f"checkpoint missing tensor {prefix!r}")
    return flat[prefix]


def export_merged_weights(engine, save_dir: str, tag: str = "merged",
                          adapter_id: Optional[str] = None,
                          adapters: Any = None) -> str:
    """Fold LoRA adapters into their (dequantized) base weights and write
    the result as a plain full-model safetensors file, the serving artifact
    (reference: the same function, ``:808-860``).  The exported tree has a
    never-LoRA'd model's structure, so the inference engines and any
    full-checkpoint tooling read it (:func:`load_merged_params`).  The
    adapters come from

    * the engine's own LoRA nodes (a PEFT training run; default), or
    * ``adapter_id`` in ``adapters``, a serving
      :class:`~deepspeed_tpu_torch.serving.adapters.AdapterRegistry`: its
      pack is grafted onto the engine's plain tree with ``scaling=1.0``
      (a registry pack carries the scaling in ``lora_b``).

    The merge runs where the parameters lie (the reference's, on the
    host).  Returns ``<save_dir>/<tag>``, holding ``model.safetensors`` and
    ``engine_state.json``."""
    from ...linear.optimized_linear import (graft_adapter_pack, has_lora,
                                            merge_lora_weights)

    params = getattr(engine, "params", None)
    if params is None:
        raise ValueError("export_merged_weights: engine has neither "
                         "state.params nor params")
    if adapter_id is not None:
        if adapters is None:
            raise ValueError("export_merged_weights: adapter_id needs the "
                             "AdapterRegistry in `adapters`")
        params = graft_adapter_pack(params, adapters.get_pack(adapter_id),
                                    scaling=1.0)
    elif not has_lora(params):
        raise ValueError(
            "export_merged_weights: engine has no LoRA adapters")
    with torch.no_grad():
        merged = merge_lora_weights(params)
    out_dir = os.path.join(save_dir, tag)
    with _SAVE_LOCK:
        os.makedirs(out_dir, exist_ok=True)
        _save_tree(merged, os.path.join(out_dir, "model.safetensors"))
        with open(os.path.join(out_dir, "engine_state.json"), "w") as f:
            json.dump({"merged_lora": True, "merged_adapter_id": adapter_id,
                       "framework_version": _version()}, f, indent=2)
    logger.info(f"exported merged LoRA weights -> {out_dir}")
    return out_dir


def load_merged_params(ckpt_dir: str, template: Any) -> Any:
    """A merged-weight export (or any full ``model.safetensors``) in the
    nesting of ``template``: CPU tensors."""
    flat = _load_tree_flat(os.path.join(ckpt_dir, "model.safetensors"))
    return _unflatten_like(template, flat)


# ---------------------------------------------------------------------------
# the training engine's checkpoints
# ---------------------------------------------------------------------------


def _host_copy(flat: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A CPU copy of every tensor, taken now (the engine updates its
    tensors in place, so a later read would see a later step)."""
    return {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}


def _version() -> str:
    from ... import __version__

    return __version__


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None) -> str:
    """Write model, optimizer and engine state (reference: the same
    function).  Everything stages into ``<tag>.tmp/``; the manifest is
    written and fsync'd last inside it; one ``os.replace`` makes the
    checkpoint visible.  With ``checkpoint.async_save`` the host snapshot
    is complete before this returns and only the file IO runs on a
    thread."""
    cfg = engine.config.checkpoint
    _raise_pending_async_errors()  # a silent prior failure must not let
    # callers believe they have more durable checkpoints than they do
    tag = tag or f"global_step{engine.step_count}"
    ckpt_dir = os.path.join(save_dir, tag)
    peft = bool(getattr(engine, "peft_enabled", False))
    ls = engine.loss_scale
    meta = {
        "step": int(engine.step_count),
        "skipped_steps": int(engine.skipped_steps),
        "loss_scale": float(ls.scale),
        "loss_scale_good_steps": int(ls.good_steps),
        "loss_scale_hysteresis": int(ls.hysteresis),
        "rng": [0, (engine.config.seed * 1_000_003 + engine.step_count)
                % (2 ** 32)],
        "zero_stage": 0,
        "world_size": 1,
        "client_state": client_state or {},
        "framework_version": _version(),
        "peft_adapter_only": peft,
    }
    # PEFT: an adapter-only checkpoint (the reference's, ``:358-402``): the
    # frozen base is rebuilt from the original weights, so only the
    # trainable leaves (lora_a / lora_b) are written, and the optimizer
    # state is the adapters' by construction
    params = (dict(zip(engine._paths, engine._leaves)) if peft
              else flatten_with_paths(engine.params))
    opt = engine.optimizer_state_flat()
    if cfg.async_save:
        params, opt = _host_copy(params), _host_copy(opt)
    tmp_dir = ckpt_dir + _TMP_SUFFIX

    def _write_trees():
        model_path = os.path.join(
            tmp_dir, "adapter_model.safetensors" if peft
            else "model.safetensors")
        opt_path = os.path.join(tmp_dir, "optimizer.safetensors")
        faults.maybe_fail("ckpt.write.model")
        if cfg.engine == "fast":
            _save_trees_fast([(params, model_path), (opt, opt_path)])
        else:
            _save_tree(params, model_path)
            faults.maybe_fail("ckpt.write.optimizer")
            _save_tree(opt, opt_path)
        faults.maybe_truncate("ckpt.truncate.model", model_path)
        faults.maybe_truncate("ckpt.truncate.optimizer", opt_path)

    def _do_save():
        with _SAVE_LOCK, tracer.span("ckpt/save", tag=tag, dir=ckpt_dir,
                                     engine=cfg.engine,
                                     async_save=cfg.async_save):
            _gc_stale_tmp(save_dir, current=None)
            os.makedirs(tmp_dir, exist_ok=True)
            _write_trees()
            faults.maybe_fail("ckpt.write.meta")
            with open(os.path.join(tmp_dir, "engine_state.json"), "w") as f:
                json.dump(meta, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            faults.maybe_fail("ckpt.write.manifest")
            _write_manifest(tmp_dir, meta, cfg.integrity)
            faults.maybe_fail("ckpt.commit")
            _commit_dir(tmp_dir, ckpt_dir)
            faults.maybe_fail("ckpt.latest")
            _write_latest(save_dir, tag)
            logger.info(f"saved checkpoint {ckpt_dir}")
            recorder.record_event("ckpt/commit", tag=tag, dir=ckpt_dir)
            _prune_old(save_dir, cfg.keep_n_latest, latest_tag=tag)

    if cfg.async_save:
        def _runner():
            try:
                _do_save()
            except BaseException as e:  # noqa: BLE001 — must not vanish
                logger.error(
                    f"ASYNC CHECKPOINT SAVE FAILED ({ckpt_dir}): {e!r} — "
                    "this checkpoint does NOT exist on disk; the error "
                    "re-raises at wait_for_async_saves() / next save")
                _async_errors.append((ckpt_dir, e))

        t = threading.Thread(target=_runner, daemon=False)
        t.start()
        _async_threads.append(t)
    else:
        _do_save()
    return ckpt_dir


def _raise_pending_async_errors() -> None:
    if not _async_errors:
        return
    errors = list(_async_errors)
    _async_errors.clear()
    for ckpt, err in errors[1:]:
        logger.error(f"additional async checkpoint failure ({ckpt}): {err!r}")
    raise errors[0][1]


def wait_for_async_saves() -> None:
    """Join every in-flight async save and re-raise the first failure."""
    for t in _async_threads:
        t.join()
    _async_threads.clear()
    _raise_pending_async_errors()


def _atexit_drain() -> None:
    # atexit must not raise, but data loss must reach the log's tail
    for t in _async_threads:
        t.join()
    _async_threads.clear()
    for ckpt, err in _async_errors:
        msg = (f"CHECKPOINT DATA LOSS: async save of {ckpt} failed "
               f"({err!r}) and the process exited before "
               "wait_for_async_saves() could re-raise it")
        logger.error(msg)
        print(msg, file=sys.stderr, flush=True)


atexit.register(_atexit_drain)


def _prune_old(save_dir: str, keep: Optional[int],
               latest_tag: Optional[str] = None) -> None:
    """Delete the oldest committed ``global_step`` tags beyond ``keep``;
    never a ``.tmp`` dir, never the ``latest`` pointer's target."""
    if not keep:
        return
    with _SAVE_LOCK:
        if latest_tag is None:
            try:
                with open(os.path.join(save_dir, _LATEST)) as f:
                    latest_tag = f.read().strip()
            except OSError:
                latest_tag = None
        tags = []
        for d in os.listdir(save_dir):
            path = os.path.join(save_dir, d)
            if (d.endswith(_TMP_SUFFIX) or not d.startswith("global_step")
                    or not os.path.isdir(path) or not is_committed(path)):
                continue
            try:
                tags.append((int(d.removeprefix("global_step")), d))
            except ValueError:
                continue
        for _, d in sorted(tags)[:-keep]:
            if d == latest_tag:
                continue
            shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)


#: load failures that mean "this checkpoint is damaged", safe to walk past
#: under fallback; config mismatches (ValueError, KeyError) are not
_RECOVERABLE_LOAD_ERRORS = (OSError, EOFError, json.JSONDecodeError,
                            SafetensorError)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    fallback: Optional[bool] = None,
                    ) -> Tuple[Optional[str], Dict]:
    """Load into the engine (reference: the same function).  Every
    checkpoint is verified against its manifest before any byte is
    deserialized; ``fallback`` (default ``checkpoint.fallback_on_corruption``)
    walks committed tags newest to oldest past a corrupt one.  Returns
    ``(checkpoint dir, client_state)``, or ``(None, {})`` when there is
    nothing to load."""
    cfg = engine.config.checkpoint
    if fallback is None:
        fallback = cfg.fallback_on_corruption
    requested = tag
    pointer = None
    if tag is None:
        latest = os.path.join(load_dir, _LATEST)
        if os.path.exists(latest):
            with open(latest) as f:
                pointer = tag = f.read().strip()
    if requested is not None:
        order: List[str] = [requested]
        if fallback:
            order += [t for t in checkpoint_candidates(load_dir)
                      if t not in order]
    elif fallback:
        # newest first over every committed tag: a commit that landed just
        # before a crash (pointer not moved yet) is newer and valid
        order = checkpoint_candidates(load_dir)
        if pointer is not None and pointer not in order:
            order.append(pointer)
    else:
        order = [pointer] if pointer is not None else []
    if not order:
        logger.warning(f"no {_LATEST} file in {load_dir}")
        return None, {}

    failures: List[str] = []
    for t in order:
        ckpt_dir = os.path.join(load_dir, t)
        if not os.path.isdir(ckpt_dir):
            if not fallback:
                raise FileNotFoundError(f"checkpoint dir not found: {ckpt_dir}")
            failures.append(f"{t}: directory missing")
            continue
        problems = verify_checkpoint(ckpt_dir,
                                     check_digests=cfg.integrity != "none")
        if _is_legacy_only(problems):
            logger.warning(f"checkpoint {t} predates manifests — loading "
                           "unverified")
            problems = []
        if problems:
            msg = f"checkpoint {t} failed verification: {problems}"
            if not fallback:
                raise CheckpointIntegrityError(msg)
            logger.error(f"{msg} — falling back to an older checkpoint")
            failures.append(msg)
            continue
        try:
            with tracer.span("ckpt/load", tag=t, dir=ckpt_dir):
                result = _load_native(engine, ckpt_dir, load_optimizer_states)
        except _RECOVERABLE_LOAD_ERRORS as e:
            if not fallback:
                raise
            logger.error(f"checkpoint {t} failed to load ({e!r}) — "
                         "falling back to an older checkpoint")
            failures.append(f"{t}: load failed: {e!r}")
            continue
        expected = requested or pointer
        if expected is not None and t != expected:
            logger.warning(f"resumed from {t} (newest valid checkpoint) "
                           f"instead of {expected}")
        return result
    raise CheckpointIntegrityError(
        f"no valid checkpoint under {load_dir} (tried {len(order)} tag(s)): "
        + "; ".join(failures))


def _validate_tag(engine, meta: Dict) -> None:
    """Reference: ``_checkpoint_tag_validation``."""
    mode = engine.config.checkpoint.tag_validation.lower()
    if mode == "ignore":
        return
    if meta.get("zero_stage") != 0:
        msg = (f"checkpoint zero_stage={meta.get('zero_stage')} != "
               "engine zero_stage=0 (universal layout: load proceeds; "
               "optimizer sharding is recomputed)")
        if mode == "fail":
            raise ValueError(msg)
        logger.warning(msg)


def _load_native(engine, ckpt_dir: str, load_optimizer_states: bool
                 ) -> Tuple[str, Dict]:
    with open(os.path.join(ckpt_dir, "engine_state.json")) as f:
        meta = json.load(f)
    _validate_tag(engine, meta)
    adapter_only = bool(meta.get("peft_adapter_only"))
    if adapter_only:
        if not getattr(engine, "peft_enabled", False):
            raise ValueError(
                f"{ckpt_dir} is an adapter-only (PEFT) checkpoint — it holds "
                "lora_a/lora_b only; load it into an engine with peft.lora "
                "enabled over the same base model")
        # the restored adapters go over the engine's frozen base, which
        # never round-trips through the file
        flat_params = _load_tree_flat(
            os.path.join(ckpt_dir, "adapter_model.safetensors"))
    else:
        flat_params = _load_tree_flat(
            os.path.join(ckpt_dir, "model.safetensors"))
    flat_opt = None
    if load_optimizer_states:
        flat_opt = _load_tree_flat(
            os.path.join(ckpt_dir, "optimizer.safetensors"))
    # a delayed update's pending gradients predate the load: applying them
    # to the restored parameters would corrupt the restore
    if getattr(engine, "_pending", False):
        engine._pending, engine._pending_lr = False, None
    engine.load_state_from(flat_params, flat_opt, meta, ckpt_dir,
                           adapter_only=adapter_only)
    if getattr(engine, "offloaded_optimizer", None) is not None:
        # the f32 master from the loaded parameters: a stale master would
        # overwrite them at the next step
        engine.offloaded_optimizer.reset_master(engine._leaves)
        if engine.zenflow_optimizer is not None:
            # stale hot columns and cold sums must not land on the restore
            engine.zenflow_optimizer.reset_after_load()
    logger.info(f"loaded checkpoint {ckpt_dir} (step {meta['step']})")
    return ckpt_dir, meta.get("client_state", {})
