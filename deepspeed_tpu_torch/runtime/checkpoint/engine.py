"""Checkpoint primitives — the part of
``deepspeed_tpu/runtime/checkpoint/engine.py`` that the serving cold tier
(``inference/v2/coldstore.py``) and the adapter registry
(``serving/adapters.py``) build on:

* the commit protocol: stage into ``<dir>.tmp/``, write a
  ``manifest.json`` (per-file size + digest + meta), fsync every file and
  the parent directory, then commit with one ``os.replace`` rename; and
  ``verify_checkpoint``, which checks a directory against its manifest;
* the tree files: :func:`_save_tree` writes a parameter tree as one
  safetensors file and :func:`_load_tree_flat` reads it back, in the
  reference's layout (slash-joined paths, tensors in the safetensors
  library's order, bf16 as a ``uint16`` view named in the ``bf16_keys``
  metadata), so a file is byte for byte the reference's;
* :func:`export_merged_weights` of a registry adapter and
  :func:`load_merged_params`.

The checkpoint engine itself (``save_checkpoint`` / ``load_checkpoint``,
the ``latest`` pointer, async saves, fallback to the newest valid tag) is
not ported yet: it arrives with ROADMAP.md queue A item A12; the export of
a training run's own LoRA weights arrives with A14.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional

import torch

from ...io.fast_writer import header_from_host, read_safetensors
from ...utils.logging import logger
from ...utils.tree_io import ST_DTYPES, host_array

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


# ---------------------------------------------------------------------------
# parameter trees as safetensors files
# ---------------------------------------------------------------------------

#: the safetensors library writes tensors sorted by dtype (this order,
#: widest first) and then by name; so does :func:`_save_tree`
_ST_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
             "I16", "I8", "U8", "BOOL")


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{slash/joined/path: leaf} of a nested dict (or list) tree, in the
    reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return flat


def _save_tree(tree: Any, path: str) -> None:
    """Write a parameter tree (tensors or numpy arrays) as one safetensors
    file, byte for byte what the reference's ``_save_tree`` writes for the
    same tree."""
    hosts: Dict[str, Any] = {}
    bf16_keys: List[str] = []
    for key, leaf in flatten_with_paths(tree).items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16_keys.append(key)
            leaf = leaf.detach().cpu().contiguous().view(torch.uint16)
        arr, _ = host_array(leaf)
        hosts[key] = (arr, ST_DTYPES[str(arr.dtype)])
    order = sorted(hosts, key=lambda k: (_ST_ORDER.index(hosts[k][1]), k))
    hosts = {k: hosts[k] for k in order}
    header, _, _ = header_from_host(
        hosts, {"bf16_keys": json.dumps(sorted(bf16_keys))})
    with open(path, "wb") as f:
        f.write(header)
        for arr, _ in hosts.values():
            f.write(arr.tobytes())


def _load_tree_flat(path: str) -> Dict[str, torch.Tensor]:
    """{path: CPU tensor} of a :func:`_save_tree` file (the reference's
    too); the ``bf16_keys`` come back as bf16."""
    with open(path, "rb") as f:
        payload = bytearray(f.read())  # writable: the tensors view it
    arrays, meta = read_safetensors(payload)
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
    if prefix not in flat:
        raise KeyError(f"checkpoint missing tensor {prefix!r}")
    return flat[prefix]


def merge_adapter_pack(params: Any, pack: Dict[str, Any]) -> Any:
    """A plain parameter tree with an adapter pack folded in: each targeted
    layer-stacked projection ``W (L, K, N)`` becomes ``W + A @ B`` (summed
    in f32, cast back to W's dtype; the pack's scaling is already in
    ``B``).  Every other leaf is shared with ``params``."""
    pack = dict(pack)
    found = set()

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in pack and isinstance(v, torch.Tensor) and v.dim() >= 2:
                a, b = (torch.as_tensor(x) for x in pack[k])
                if tuple(v.shape) != (a.shape[0], a.shape[1], b.shape[2]):
                    raise ValueError(
                        f"adapter pack target {k!r} wants a weight of shape "
                        f"{(a.shape[0], a.shape[1], b.shape[2])}, tree has "
                        f"{tuple(v.shape)}")
                delta = torch.einsum("lkr,lrn->lkn", a.float().to(v.device),
                                     b.float().to(v.device))
                out[k] = (v.float() + delta).to(v.dtype)
                found.add(k)
            else:
                out[k] = v
        return out

    merged = walk(params)
    missing = set(pack) - found
    if missing:
        raise ValueError(f"adapter pack targets {sorted(missing)} not found "
                         "in the parameter tree")
    return merged


def export_merged_weights(engine, save_dir: str, tag: str = "merged",
                          adapter_id: Optional[str] = None,
                          adapters: Any = None) -> str:
    """Fold a registry adapter into the serving engine's base weights and
    write the result as a plain full-model safetensors file: the artifact
    a tenant takes to a dedicated deployment.  ``adapters`` is the
    :class:`~deepspeed_tpu_torch.serving.adapters.AdapterRegistry` that
    holds ``adapter_id`` (its pack carries the scaling in ``lora_b``).
    Returns ``<save_dir>/<tag>``, holding ``model.safetensors`` and
    ``engine_state.json``."""
    params = getattr(engine, "params", None)
    if params is None:
        raise ValueError("export_merged_weights: engine has no params")
    if adapter_id is None:
        raise NotImplementedError(
            "exporting a training run's own LoRA weights arrives with PEFT "
            "(ROADMAP.md A14); pass adapter_id and the AdapterRegistry")
    if adapters is None:
        raise ValueError("export_merged_weights: adapter_id needs the "
                         "AdapterRegistry in `adapters`")
    merged = merge_adapter_pack(params, adapters.get_pack(adapter_id))
    out_dir = os.path.join(save_dir, tag)
    os.makedirs(out_dir, exist_ok=True)
    _save_tree(merged, os.path.join(out_dir, "model.safetensors"))
    from ... import __version__

    with open(os.path.join(out_dir, "engine_state.json"), "w") as f:
        json.dump({"merged_lora": True, "merged_adapter_id": adapter_id,
                   "framework_version": __version__}, f, indent=2)
    logger.info(f"exported merged adapter {adapter_id} -> {out_dir}")
    return out_dir


def load_merged_params(ckpt_dir: str, template: Any) -> Any:
    """A merged-weight export (or any full ``model.safetensors``) in the
    nesting of ``template``: CPU tensors."""
    flat = _load_tree_flat(os.path.join(ckpt_dir, "model.safetensors"))
    return _unflatten_like(template, flat)
