"""FastPersist safetensors writer — the port of
``deepspeed_tpu/io/fast_writer.py``.

Bytes go to disk through the C++ AIO thread pool (``csrc/aio/ds_aio.cpp``,
bound by ``nvme/aio_handle.py``) instead of a single-threaded Python write
loop:

* the output file is a **valid safetensors file** — header built here,
  tensor bytes placed at their exact offsets;
* **buffered mode (default)**: zero-copy — each tensor's own host buffer is
  submitted directly to the AIO pool as chunked ``pwrite``s at its file
  offset on one shared fd per file;
* **O_DIRECT mode**: double-buffered — the logical byte stream is staged
  into page-aligned bounce buffers while the previous buffer's write is in
  flight, then the file is ftruncated back to the logical size.

Arrays are numpy arrays or torch tensors (``utils/tree_io.host_array``):
bf16 is written as its bits under the dtype ``"BF16"``, so a header and a
payload are byte for byte the reference's.  :func:`read_safetensors` is
the one reader of the format, for the KV payloads (``paging``) and the
tree files (``runtime/checkpoint``) alike.

O_DIRECT support is probed once per directory (overlay/tmpfs filesystems
reject it) and the writer falls back to buffered mode with a one-time log
line.  The checkpoint engine's ``fast`` engine
(``runtime/checkpoint/engine.py``) writes its tree files through
:func:`get_fast_writer`, the process's one writer.
"""

from __future__ import annotations

import ctypes
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import faults
from ..utils.logging import warning_once
from ..utils.tree_io import TORCH_DTYPES, host_arrays

_ALIGN = 4096


def header_from_host(hosts: Dict[str, Tuple[np.ndarray, str]],
                     metadata: Optional[Dict[str, str]] = None
                     ) -> Tuple[bytes, Dict[str, int], int]:
    """:func:`build_safetensors_header` over ``(host array, safetensors
    dtype)`` pairs (``utils/tree_io.host_arrays``)."""
    entries: Dict[str, Any] = {}
    if metadata:
        entries["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offsets: Dict[str, int] = {}
    pos = 0
    for name, (arr, st_dtype) in hosts.items():
        offsets[name] = pos
        entries[name] = {"dtype": st_dtype, "shape": list(arr.shape),
                         "data_offsets": [pos, pos + arr.nbytes]}
        pos += arr.nbytes
    blob = json.dumps(entries, separators=(",", ":")).encode()
    pad = (8 - (len(blob) + 8) % 8) % 8  # keep the data section 8-aligned
    blob += b" " * pad
    return len(blob).to_bytes(8, "little") + blob, offsets, pos


def read_safetensors(payload) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, str]]:
    """(arrays, metadata) of a safetensors payload: CPU tensors viewing
    ``payload`` (read-only memory for ``bytes``: copy them before writing
    into one) and the ``__metadata__`` map (empty when absent)."""
    hlen = int.from_bytes(payload[:8], "little")
    hdr = json.loads(bytes(payload[8:8 + hlen]).decode())
    base = 8 + hlen
    meta = hdr.pop("__metadata__", None) or {}
    out: Dict[str, torch.Tensor] = {}
    for name, ent in hdr.items():
        lo, hi = ent["data_offsets"]
        dtype = TORCH_DTYPES[ent["dtype"]]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(ent["shape"], dtype=dtype)
            continue
        with warnings.catch_warnings():
            # a bytes payload is immutable; the tensors only feed copies
            warnings.simplefilter("ignore", UserWarning)
            out[name] = torch.frombuffer(
                payload, dtype=dtype, count=count, offset=base + lo
            ).reshape(ent["shape"])
    return out, meta


def build_safetensors_header(arrays: Dict[str, Any],
                             metadata: Optional[Dict[str, str]] = None
                             ) -> Tuple[bytes, Dict[str, int], int]:
    """The 8-byte length + JSON header of the safetensors format, with
    contiguous data offsets in dict order.  Returns (header_bytes,
    {name: data_offset}, total_data_bytes)."""
    return header_from_host(host_arrays(arrays), metadata)


def _aligned_buffer(nbytes: int) -> np.ndarray:
    """Page-aligned uint8 buffer (O_DIRECT requires aligned addresses)."""
    raw = np.empty(nbytes + _ALIGN, np.uint8)
    shift = (-raw.ctypes.data) % _ALIGN
    return raw[shift:shift + nbytes]


_ODIRECT_CACHE: Dict[str, bool] = {}


def probe_o_direct(directory: str) -> bool:
    """Whether this filesystem accepts O_DIRECT (container overlayfs/tmpfs
    typically do not — and some accept the open but fail the first aligned
    write).  Result cached per directory; the probe's 1-thread pool lives
    only for the probe (a leaked pool per distinct directory adds up in
    long-running processes)."""
    directory = os.path.abspath(directory)
    cached = _ODIRECT_CACHE.get(directory)
    if cached is not None:
        return cached
    from ..nvme.aio_handle import AsyncIOHandle

    path = os.path.join(directory, f".odirect_probe_{os.getpid()}")
    ok = False
    with AsyncIOHandle(thread_count=1) as h:
        fd = None
        try:
            fd = h.open_write(path, use_direct=True)
            buf = _aligned_buffer(_ALIGN)
            req = h.fd_pwrite(fd, buf, _ALIGN, 0)
            h.wait(req)
            ok = True
        except OSError:
            ok = False
        finally:
            if fd is not None:
                try:
                    h.close_fd(fd, sync=False)
                except OSError:
                    pass
            try:
                os.unlink(path)
            except OSError:
                pass
    _ODIRECT_CACHE[directory] = ok
    return ok


class FastFileWriter:
    """Writes safetensors files through the AIO pool.  One instance owns a
    thread pool; reuse it across files."""

    def __init__(self, block_size: int = 8 << 20, queue_depth: int = 32,
                 thread_count: int = 8, use_direct: Optional[bool] = None,
                 stage_bytes: int = 32 << 20, fsync: bool = True):
        from ..nvme.aio_handle import AsyncIOHandle

        self._aio = AsyncIOHandle(block_size=block_size,
                                  queue_depth=queue_depth,
                                  thread_count=thread_count)
        self.thread_count = thread_count
        self.use_direct = use_direct  # None → probe per directory
        # round UP to a page multiple; a sub-page stage would floor to 0 and
        # the double-buffer fill loop could never make progress
        self.stage_bytes = max(_ALIGN,
                               (stage_bytes + _ALIGN - 1) // _ALIGN * _ALIGN)
        self.fsync = fsync
        self.last_stats: Dict[str, float] = {}

    def close(self) -> None:
        """Release the native thread pool; every writer must close."""
        self._aio.close()

    def __enter__(self) -> "FastFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- mode selection -------------------------------------------------
    def _direct_for(self, path: str) -> bool:
        if self.use_direct is not None:
            return self.use_direct
        directory = os.path.dirname(os.path.abspath(path))
        ok = probe_o_direct(directory)
        if not ok:
            warning_once(
                f"FastPersist: O_DIRECT unsupported under {directory} — "
                f"using buffered zero-copy writes")
        return ok

    # -- submission/drain helpers ---------------------------------------
    def _submit_file(self, fd: int, arrays: Dict[str, np.ndarray],
                     header: bytes, offsets: Dict[str, int],
                     data_bytes: int, out_reqs: List[int]) -> None:
        """Submit one file's header + zero-copy tensor segments, APPENDING
        request ids to ``out_reqs`` as they are issued — a returned list
        would be lost if submission raises partway, leaving the caller
        unable to drain the in-flight requests before closing the fd.
        Segment size spreads the payload over the pool but never drops
        below 8 MiB (tiny segments = syscall overhead, not parallelism)."""
        faults.maybe_fail("io.fast.submit")
        h = self._aio
        out_reqs.append(h.fd_pwrite(fd, np.frombuffer(header, np.uint8),
                                    len(header), 0))
        base = len(header)
        seg = max(8 << 20, data_bytes // max(self.thread_count, 1))
        for name, arr in arrays.items():
            if arr.nbytes == 0:
                continue
            file_off = base + offsets[name]
            addr = arr.ctypes.data
            for s in range(0, arr.nbytes, seg):
                n = min(seg, arr.nbytes - s)
                ptr = ctypes.c_void_p(addr + s)
                out_reqs.append(h.fd_pwrite(fd, ptr, n, file_off + s,
                                            pin=arr))

    def _drain_and_close(self, fds: List[int], reqs: List[int],
                         truncate_to: int = -1) -> None:
        """Wait out every request, then close.  On error, ALL in-flight
        requests are still drained BEFORE any fd closes — pool threads
        writing through a closed (and possibly reused) fd would corrupt
        whatever file the kernel hands that number to next."""
        faults.maybe_fail("io.fast.drain")
        err: Optional[BaseException] = None
        for r in reqs:
            try:
                self._aio.wait(r)
            except OSError as e:
                err = err or e
        for fd in fds:
            try:
                self._aio.close_fd(fd, sync=self.fsync and err is None,
                                   truncate_to=truncate_to)
            except OSError as e:
                err = err or e
        if err is not None:
            raise err

    # -- public API -----------------------------------------------------
    def write_safetensors(self, arrays: Dict[str, Any], path: str,
                          metadata: Optional[Dict[str, str]] = None) -> None:
        """Write ``arrays`` (numpy arrays or torch tensors) as a
        safetensors file; their host buffers are pinned until the write
        lands."""
        hosts = host_arrays(arrays)
        header, offsets, data_bytes = header_from_host(hosts, metadata)
        arrays = {k: a for k, (a, _) in hosts.items()}
        t0 = time.perf_counter()
        if self._direct_for(path):
            self._write_direct(arrays, path, header, data_bytes)
            mode = "o_direct"
        else:
            fd = self._aio.open_write(path, use_direct=False)
            reqs: List[int] = []
            try:
                self._submit_file(fd, arrays, header, offsets, data_bytes,
                                  reqs)
            except BaseException:
                # partial submission (interrupt/OOM): drain what made it
                # into the pool before the fd closes — same guard as
                # _write_direct
                self._drain_and_close([fd], reqs)
                raise
            self._drain_and_close([fd], reqs)
            mode = "buffered"
        dt = time.perf_counter() - t0
        total = len(header) + data_bytes
        self.last_stats = {"bytes": total, "seconds": round(dt, 4),
                           "mb_per_s": round(total / max(dt, 1e-9) / 2**20, 1),
                           "mode": mode}

    def _write_direct(self, arrays, path, header, data_bytes):
        """Double-buffered O_DIRECT: serialize the logical stream into two
        page-aligned staging buffers; buffer i's memcpy overlaps buffer
        1-i's in-flight write.  The file is truncated to the logical size
        at close (the last block is padded)."""
        h = self._aio
        logical = len(header) + data_bytes
        stage = self.stage_bytes
        bufs = [_aligned_buffer(stage), _aligned_buffer(stage)]
        inflight: List[Optional[int]] = [None, None]

        # the logical byte stream: header then tensors in offset order
        def stream_chunks():
            yield np.frombuffer(header, np.uint8)
            for name, arr in arrays.items():
                if arr.nbytes:
                    yield arr.reshape(-1).view(np.uint8)

        fd = h.open_write(path, use_direct=True)
        try:
            which = 0
            filled = 0       # bytes staged in the current buffer
            file_off = 0     # aligned offset of the current buffer's write
            for chunk in stream_chunks():
                pos = 0
                while pos < chunk.nbytes:
                    n = min(stage - filled, chunk.nbytes - pos)
                    bufs[which][filled:filled + n] = chunk[pos:pos + n]
                    filled += n
                    pos += n
                    if filled == stage:
                        # submit this buffer, switch, and wait out the OTHER
                        # buffer's in-flight write before refilling it — the
                        # memcpy into one buffer rides the disk write of the
                        # other (invariant: the buffer being filled never
                        # has an in-flight write)
                        inflight[which] = h.fd_pwrite(
                            fd, bufs[which], stage, file_off)
                        file_off += stage
                        which = 1 - which
                        if inflight[which] is not None:
                            h.wait(inflight[which])
                            inflight[which] = None
                        filled = 0
            if filled:
                padded = (filled + _ALIGN - 1) // _ALIGN * _ALIGN
                bufs[which][filled:padded] = 0
                inflight[which] = h.fd_pwrite(fd, bufs[which], padded, file_off)
        except BaseException:
            # drain whatever made it into the pool before the fd closes
            self._drain_and_close(
                [fd], [r for r in inflight if r is not None],
                truncate_to=logical)
            raise
        else:
            self._drain_and_close([fd], [r for r in inflight if r is not None],
                                  truncate_to=logical)


_WRITER: Optional[FastFileWriter] = None


def get_fast_writer() -> FastFileWriter:
    """The process's writer (one AIO thread pool), built at first use."""
    global _WRITER
    if _WRITER is None:
        _WRITER = FastFileWriter()
    return _WRITER
