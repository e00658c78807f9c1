"""NVMe benchmark and tuning CLI — the port of
``deepspeed_tpu/nvme/ds_io.py``.

    python -m deepspeed_tpu_torch.nvme.ds_io bench --path F --op write
    python -m deepspeed_tpu_torch.nvme.ds_io sweep --dir D
    python -m deepspeed_tpu_torch.nvme.ds_io qdsweep --dir D

The reference's DeepNVMe user tools (``deepspeed/nvme`` ``io_engine.py``,
``perf_run_sweep.py``, ``perf_generate_param.py``): one measurement, a grid
sweep distilled into the ``aio`` config block the offload tiers read, and
throughput against queue depth per backend.  They run over the port's
``nvme/aio_handle.py`` (the repository's ``csrc/aio/ds_aio.cpp``): the
swap tiers of ``runtime/zero`` move host memory to and from the disk, and
a tensor on the card reaches them through host memory, so the sweep tunes
host <-> NVMe only.  Results, fields and CLI are the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging import logger
from .aio_handle import AsyncIOHandle, aio_available


@dataclasses.dataclass
class IOBenchResult:
    op: str  # 'read' | 'write'
    gbps: float
    seconds: float
    size_bytes: int
    block_size: int
    queue_depth: int
    thread_count: int
    use_direct: bool
    backend: str = "threads"  # what actually ran ('io_uring' | 'threads')

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _make_file(path: str, nbytes: int) -> None:
    chunk = np.random.randint(0, 255, size=min(nbytes, 1 << 24),
                              dtype=np.uint8)
    with open(path, "wb") as f:
        left = nbytes
        while left > 0:
            f.write(chunk[:left].tobytes())
            left -= min(left, chunk.nbytes)


def run_bench(path: str, op: str = "read", size_mb: int = 256,
              block_size: int = 1 << 20, queue_depth: int = 8,
              thread_count: int = 4, use_direct: bool = False,
              keep_file: bool = False, overwrite: bool = False,
              backend: str = "threads", fsync: bool = False) -> IOBenchResult:
    """One measurement: stream ``size_mb`` through the AIO handle split into
    queue_depth in-flight slices (the reference's single-process ds_io job).
    ``fsync=True`` measures durable writes (what FastPersist competes on)."""
    nbytes = size_mb << 20
    handle = AsyncIOHandle(block_size=block_size, queue_depth=queue_depth,
                           thread_count=thread_count, use_direct=use_direct,
                           backend=backend)
    try:
        created = False
        if op == "read":
            if not os.path.exists(path):
                _make_file(path, nbytes)
                created = True
            elif os.path.getsize(path) < nbytes:
                # a smaller file would short-read past EOF and report fantasy
                # bandwidth; never overwrite a file we didn't create
                raise ValueError(
                    f"{path} is {os.path.getsize(path)} bytes but the bench "
                    f"needs {nbytes}; point --path at a missing file (it "
                    f"will be created) or lower --size_mb")
        elif os.path.exists(path) and not overwrite:
            raise ValueError(
                f"write bench refuses to overwrite existing {path}; point "
                f"--path at a missing file")
        buf = np.empty(nbytes, np.uint8)
        slices = max(queue_depth, 1)
        per = nbytes // slices
        t0 = time.perf_counter()
        reqs = []
        for i in range(slices):
            end = nbytes if i == slices - 1 else (i + 1) * per  # + remainder
            view = buf[i * per:end]
            if op == "read":
                reqs.append(handle.pread(path, view, file_offset=i * per))
            else:
                reqs.append(handle.pwrite(path, view, file_offset=i * per))
        handle.wait_all()
        if op == "write" and fsync:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        dt = time.perf_counter() - t0
        actual_backend = handle.backend
    finally:
        # sweeps tolerate per-point failures: the native pool/ring must not
        # outlive this measurement either way
        handle.close()
    if not keep_file and (op == "write" or created):
        try:
            os.unlink(path)
        except OSError:
            pass
    return IOBenchResult(op=op, gbps=nbytes / dt / 1e9, seconds=dt,
                         size_bytes=nbytes, block_size=block_size,
                         queue_depth=queue_depth, thread_count=thread_count,
                         use_direct=use_direct, backend=actual_backend)


def run_sweep(dir_path: str, op: str = "read", size_mb: int = 128,
              block_sizes: Sequence[int] = (1 << 18, 1 << 20, 1 << 22),
              queue_depths: Sequence[int] = (4, 8, 16),
              thread_counts: Sequence[int] = (1, 2, 4, 8),
              use_direct: bool = False) -> List[IOBenchResult]:
    """Grid sweep (reference: ``perf_run_sweep.py``); returns results sorted
    fastest-first."""
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, "dstpu_io_bench.dat")
    if op == "read":
        _make_file(path, size_mb << 20)
    results = []
    for bs, qd, tc in itertools.product(block_sizes, queue_depths,
                                        thread_counts):
        try:
            r = run_bench(path, op=op, size_mb=size_mb, block_size=bs,
                          queue_depth=qd, thread_count=tc,
                          use_direct=use_direct, keep_file=True,
                          overwrite=True)
        except OSError as e:  # e.g. O_DIRECT unsupported on this fs
            logger.warning(f"sweep point bs={bs} qd={qd} tc={tc} failed: {e}")
            continue
        results.append(r)
    try:
        os.unlink(path)
    except OSError:
        pass
    return sorted(results, key=lambda r: -r.gbps)


def queue_depth_sweep(dir_path: str, op: str = "read", size_mb: int = 128,
                      depths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                      block_size: int = 1 << 20,
                      backends: Sequence[str] = ("io_uring", "threads"),
                      use_direct: bool = False,
                      fsync: bool = False) -> List[IOBenchResult]:
    """Throughput vs queue depth, per backend (reference:
    ``csrc/aio/common/deepspeed_aio_common.cpp`` submits at configurable
    queue depth; this sweep is the evidence that depth actually buys
    bandwidth on the device at hand).  For the thread backend, thread count
    scales with depth (its only concurrency lever); io_uring keeps ONE
    submitter thread and scales in-kernel."""
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, "dstpu_io_qdsweep.dat")
    if op == "read":
        _make_file(path, size_mb << 20)
    results: List[IOBenchResult] = []
    for backend in backends:
        for qd in depths:
            tc = min(qd, 16) if backend == "threads" else 1
            try:
                r = run_bench(path, op=op, size_mb=size_mb,
                              block_size=block_size, queue_depth=qd,
                              thread_count=tc, use_direct=use_direct,
                              keep_file=True, overwrite=True,
                              backend=backend, fsync=fsync)
            except OSError as e:
                logger.warning(f"qd sweep point backend={backend} qd={qd} "
                               f"failed: {e}")
                continue
            results.append(r)
    try:
        os.unlink(path)
    except OSError:
        pass
    return results


def generate_aio_config(results: Sequence[IOBenchResult]) -> Dict:
    """Best sweep point → the ``aio`` config block the engine consumes
    (reference: ``perf_generate_param.py`` → ds_config['aio'])."""
    if not results:
        raise ValueError("empty sweep")
    best = results[0]
    return {
        "aio": {
            "block_size": best.block_size,
            "queue_depth": best.queue_depth,
            "thread_count": best.thread_count,
            "single_submit": False,
            "overlap_events": True,
        },
        "measured_GB_per_sec": round(best.gbps, 3),
        "op": best.op,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="dstpu_io",
        description="NVMe benchmark/tuner for ZeRO-Infinity swap paths")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="single measurement")
    b.add_argument("--path", default=os.path.join(tempfile.gettempdir(),
                                                  "dstpu_io_bench.dat"))
    b.add_argument("--op", choices=["read", "write"], default="read")
    b.add_argument("--size_mb", type=int, default=256)
    b.add_argument("--block_size", type=int, default=1 << 20)
    b.add_argument("--queue_depth", type=int, default=8)
    b.add_argument("--threads", type=int, default=4)
    b.add_argument("--direct", action="store_true")
    b.add_argument("--backend", choices=["threads", "io_uring", "auto"],
                   default="threads")

    s = sub.add_parser("sweep", help="grid sweep → recommended aio config")
    s.add_argument("--dir", default=tempfile.gettempdir())
    s.add_argument("--op", choices=["read", "write"], default="read")
    s.add_argument("--size_mb", type=int, default=128)
    s.add_argument("--direct", action="store_true")

    q = sub.add_parser("qdsweep",
                       help="throughput vs queue depth, io_uring vs threads")
    q.add_argument("--dir", default=tempfile.gettempdir())
    q.add_argument("--op", choices=["read", "write"], default="read")
    q.add_argument("--size_mb", type=int, default=128)
    q.add_argument("--block_size", type=int, default=1 << 20)
    q.add_argument("--direct", action="store_true")
    q.add_argument("--fsync", action="store_true",
                   help="durable writes (fsync inside the timed window)")

    args = p.parse_args(argv)
    if not aio_available():
        print("AIO library unavailable (g++ build failed?)", file=sys.stderr)
        return 1

    if args.cmd == "bench":
        r = run_bench(args.path, op=args.op, size_mb=args.size_mb,
                      block_size=args.block_size,
                      queue_depth=args.queue_depth,
                      thread_count=args.threads, use_direct=args.direct,
                      backend=getattr(args, "backend", "threads"))
        print(json.dumps(r.as_dict()))
        return 0

    if args.cmd == "qdsweep":
        results = queue_depth_sweep(args.dir, op=args.op,
                                    size_mb=args.size_mb,
                                    block_size=args.block_size,
                                    use_direct=args.direct, fsync=args.fsync)
        for r in results:
            print(f"  {r.backend:>8} qd={r.queue_depth:>3}: "
                  f"{r.gbps:6.2f} GB/s")
        print(json.dumps([r.as_dict() for r in results]))
        return 0

    results = run_sweep(args.dir, op=args.op, size_mb=args.size_mb,
                        use_direct=args.direct)
    if not results:
        print("every sweep point failed (O_DIRECT unsupported on this "
              "filesystem?) — retry without --direct", file=sys.stderr)
        return 1
    for r in results[:10]:
        print(f"  {r.gbps:6.2f} GB/s  bs={r.block_size:>8} "
              f"qd={r.queue_depth:>3} threads={r.thread_count}")
    print(json.dumps(generate_aio_config(results)))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
