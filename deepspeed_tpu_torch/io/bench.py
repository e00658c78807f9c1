"""FastPersist against the native engine: the checkpoint write benchmark —
the port of ``deepspeed_tpu/io/bench.py``.

``python -m deepspeed_tpu_torch.io.bench [size_mb]`` writes a
checkpoint-shaped payload (a model tree and an optimizer tree, as
``save_checkpoint`` writes them) both ways and prints one JSON line with
the reference's fields:

* ``native``: the native engine's sequential writer of each tree
  (``runtime/checkpoint/engine._save_tree``);
* ``fast``: :class:`~deepspeed_tpu_torch.io.fast_writer.FastFileWriter`,
  every file's chunk writes in flight together through the AIO pool;

each in two regimes: **page-cache** (no fsync, the native engine's
durability) and **durable** (fsync before the clock stops, what a
checkpoint bound by the disk costs).  ``value`` is the durable speedup.
Both writers' files load back equal to the payload.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict

import numpy as np


def _tree(size_mb: int, seed: int) -> Dict[str, np.ndarray]:
    """Checkpoint-shaped: four big matrices and a tail of 32 small ones."""
    rng = np.random.default_rng(seed)
    total = size_mb << 20
    arrays: Dict[str, np.ndarray] = {}
    for i in range(4):
        n = total // 4 // 4
        arrays[f"layers/{i}/w"] = rng.standard_normal(
            (n // 2, 2), np.float32).astype(np.float32)
    for i in range(32):
        arrays[f"layers/{i}/ln"] = rng.standard_normal(256).astype(np.float32)
    return arrays


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _best(fn, paths, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(size_mb: int = 128) -> Dict[str, object]:
    from ..runtime.checkpoint.engine import _load_tree_flat, _save_tree
    from .fast_writer import FastFileWriter

    model = _tree(size_mb, 0)
    opt = _tree(2 * size_mb, 1)  # adam: master + 2 moments ~ 2x params
    nbytes = sum(a.nbytes for t in (model, opt) for a in t.values())
    out: Dict[str, object] = {"metric": "checkpoint_write_speedup",
                              "payload_mb": round(nbytes / 2**20, 1)}
    with tempfile.TemporaryDirectory(dir=".") as d:
        mp, op = os.path.join(d, "model.st"), os.path.join(d, "opt.st")

        def native(sync: bool):
            _save_tree(model, mp)
            _save_tree(opt, op)
            if sync:
                _fsync_path(mp)
                _fsync_path(op)

        def fast(writer):
            writer.write_safetensors(model, mp)
            writer.write_safetensors(opt, op)

        with FastFileWriter(use_direct=False, fsync=False) as w_nosync, \
                FastFileWriter(use_direct=False, fsync=True) as w_sync:
            t_native = _best(lambda: native(False), (mp, op))
            t_fast = _best(lambda: fast(w_nosync), (mp, op))
            # the fast files load back equal to the payload
            for tree, path in ((model, mp), (opt, op)):
                loaded = _load_tree_flat(path)
                for k, v in tree.items():
                    np.testing.assert_array_equal(loaded[k].numpy(), v)
            t_native_d = _best(lambda: native(True), (mp, op))
            t_fast_d = _best(lambda: fast(w_sync), (mp, op))

        out.update({
            "native_s": round(t_native, 3),
            "fast_s": round(t_fast, 3),
            "speedup_pagecache": round(t_native / t_fast, 2),
            "native_durable_s": round(t_native_d, 3),
            "fast_durable_s": round(t_fast_d, 3),
            "speedup_durable": round(t_native_d / t_fast_d, 2),
        })
        # the headline is the durable regime, where a checkpoint is bound
        # by the disk; page-cache writes are bound by memcpy
        out["value"] = out["speedup_durable"]
        out["unit"] = "x_vs_native_engine_durable"
    return out


def main() -> int:
    import sys

    size = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    print(json.dumps(run(size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
