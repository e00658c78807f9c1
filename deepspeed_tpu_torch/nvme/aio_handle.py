"""Python surface of the C++ async-IO library — the port of
``deepspeed_tpu/nvme/aio_handle.py``.

The library is the repository's unchanged ``csrc/aio/ds_aio.cpp``, built at
first use with ``g++`` into ``build/torch_kernels/`` at the root of the
checkout (git-ignored; the file name carries a digest of the source and
flags, so an edited source is rebuilt and a stale library never loaded),
and bound through ``ctypes``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.logging import logger

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "csrc" / "aio" / "ds_aio.cpp"
BUILD_DIR = _ROOT / "build" / "torch_kernels"
# ``-include string``: the source uses std::string without including
# <string>, which libstdc++ 12 pulls in through <functional> and 13 does
# not (the H100 machine's g++ 13.3 refuses the source without it)
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-include",
          "string")


def _build_library() -> str:
    """Compile ``ds_aio.cpp`` unless a library of this source and these
    flags is already built; several processes may race here, so each
    builds into its own temporary file and renames it into place."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libds_aio_{digest}.so"
    if so_path.exists():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libds_aio_{digest}.{os.getpid()}.so"
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    logger.info(f"building AIO library: {' '.join(cmd)}")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
    os.replace(tmp, so_path)
    return str(so_path)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_library())
            lib.aio_handle_new.restype = ctypes.c_void_p
            lib.aio_handle_new.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            lib.aio_handle_new2.restype = ctypes.c_void_p
            lib.aio_handle_new2.argtypes = [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
            lib.aio_handle_backend.restype = ctypes.c_int
            lib.aio_handle_backend.argtypes = [ctypes.c_void_p]
            lib.aio_handle_free.argtypes = [ctypes.c_void_p]
            for name in ("aio_pread", "aio_sync_pread"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            for name in ("aio_pwrite", "aio_sync_pwrite"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.aio_wait.restype = ctypes.c_int64
            lib.aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.aio_wait_all.restype = ctypes.c_int64
            lib.aio_wait_all.argtypes = [ctypes.c_void_p]
            lib.aio_alloc_aligned.restype = ctypes.c_void_p
            lib.aio_alloc_aligned.argtypes = [ctypes.c_int64, ctypes.c_int64]
            lib.aio_free_aligned.argtypes = [ctypes.c_void_p]
            # fd-based writer API (FastPersist)
            lib.aio_file_open_write.restype = ctypes.c_int64
            lib.aio_file_open_write.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                                ctypes.c_int]
            lib.aio_file_open_read.restype = ctypes.c_int64
            lib.aio_file_open_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.aio_file_close.restype = ctypes.c_int64
            lib.aio_file_close.argtypes = [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int64]
            lib.aio_fd_pwrite.restype = ctypes.c_int64
            lib.aio_fd_pwrite.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64]
            lib.aio_fd_pread.restype = ctypes.c_int64
            lib.aio_fd_pread.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64]
            _LIB = lib
    return _LIB


class AsyncIOHandle:
    """Reference: ``aio_handle`` (csrc/aio/py_lib/deepspeed_py_io_handle.cpp).

    Numpy-array based: a CPU tensor exposes its buffer through ``.numpy()``
    without a copy.
    """

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 8,
                 thread_count: int = 1, use_direct: bool = False,
                 backend: str = "threads"):
        """``backend``: ``"threads"`` (pthread pool), ``"io_uring"``
        (kernel submission queue at ``queue_depth`` — the reference's
        libaio queue-depth model, ``csrc/aio/common/deepspeed_aio_common
        .cpp``), or ``"auto"`` (io_uring when the kernel/container allows,
        thread pool otherwise).  ``self.backend`` reports what was
        actually constructed."""
        if backend not in ("threads", "io_uring", "auto"):
            raise ValueError(f"unknown aio backend {backend!r}")
        self._lib = _lib()
        want_uring = backend in ("io_uring", "auto")
        self._h = self._lib.aio_handle_new2(block_size, queue_depth,
                                            thread_count,
                                            1 if want_uring else 0)
        self.backend = ("io_uring"
                        if self._lib.aio_handle_backend(self._h) else "threads")
        if backend == "io_uring" and self.backend != "io_uring":
            logger.warning(
                "io_uring unavailable (kernel/seccomp) — using the thread "
                "pool backend")
        self.use_direct = use_direct
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        # keep buffers of in-flight requests alive
        self._pinned: dict[int, np.ndarray] = {}

    def close(self) -> None:
        """Join and release the C++ thread pool.  Idempotent — long-running
        processes that create ad-hoc handles (probes, benches) must call
        this (or use the handle as a context manager) so native threads
        don't accumulate."""
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            self._lib.aio_handle_free(h)
            self._pinned.clear()

    def __enter__(self) -> "AsyncIOHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- async ---------------------------------------------------------
    def pread(self, path: str, buffer: np.ndarray, file_offset: int = 0) -> int:
        assert buffer.flags["C_CONTIGUOUS"]
        req = self._lib.aio_pread(self._h, path.encode(),
                                  buffer.ctypes.data_as(ctypes.c_void_p),
                                  buffer.nbytes, file_offset,
                                  1 if self.use_direct else 0)
        self._pinned[req] = buffer
        return req

    def pwrite(self, path: str, buffer: np.ndarray, file_offset: int = 0) -> int:
        assert buffer.flags["C_CONTIGUOUS"]
        req = self._lib.aio_pwrite(self._h, path.encode(),
                                   buffer.ctypes.data_as(ctypes.c_void_p),
                                   buffer.nbytes, file_offset,
                                   1 if self.use_direct else 0)
        self._pinned[req] = buffer
        return req

    def wait(self, request_id: int) -> int:
        rc = self._lib.aio_wait(self._h, request_id)
        self._pinned.pop(request_id, None)
        if rc < 0:
            raise OSError(-rc, f"aio request {request_id} failed: {os.strerror(-rc)}")
        return rc

    def wait_all(self) -> int:
        rc = self._lib.aio_wait_all(self._h)
        self._pinned.clear()
        if rc < 0:
            raise OSError(-rc, f"aio wait_all failed: {os.strerror(-rc)}")
        return rc

    # -- fd-based API (FastPersist writer: open once, chunk writes at
    # offsets from the C++ thread pool, fsync+close once) --------------
    def open_write(self, path: str, use_direct: bool = False,
                   truncate: bool = True) -> int:
        fd = self._lib.aio_file_open_write(path.encode(),
                                           1 if use_direct else 0,
                                           1 if truncate else 0)
        if fd < 0:
            raise OSError(-fd, f"open {path}: {os.strerror(-fd)}")
        return fd

    def open_read(self, path: str, use_direct: bool = False) -> int:
        fd = self._lib.aio_file_open_read(path.encode(),
                                          1 if use_direct else 0)
        if fd < 0:
            raise OSError(-fd, f"open {path}: {os.strerror(-fd)}")
        return fd

    def close_fd(self, fd: int, sync: bool = True, truncate_to: int = -1) -> None:
        rc = self._lib.aio_file_close(fd, 1 if sync else 0, truncate_to)
        if rc < 0:
            raise OSError(-rc, f"close fd {fd}: {os.strerror(-rc)}")

    def fd_pwrite(self, fd: int, buffer, nbytes: int, file_offset: int,
                  pin=None) -> int:
        """Async write of a raw (address, nbytes) region.  ``buffer`` may be
        a numpy array (kept alive until wait) or a ctypes pointer — a bare
        pointer does NOT keep the addressed memory alive, so callers passing
        one MUST pass the owning object via ``pin``."""
        if isinstance(buffer, np.ndarray):
            addr = buffer.ctypes.data_as(ctypes.c_void_p)
        else:
            addr = buffer
            if pin is None:
                raise ValueError(
                    "fd_pwrite with a raw pointer requires pin= (the object "
                    "owning the memory) — without it the buffer can be "
                    "collected while a pool thread still reads it")
        req = self._lib.aio_fd_pwrite(self._h, fd, addr, nbytes, file_offset)
        self._pinned[req] = buffer if pin is None else (pin, buffer)
        return req

    def fd_pread(self, fd: int, buffer: np.ndarray, nbytes: int,
                 file_offset: int) -> int:
        req = self._lib.aio_fd_pread(
            self._h, fd, buffer.ctypes.data_as(ctypes.c_void_p), nbytes,
            file_offset)
        self._pinned[req] = buffer
        return req

    # -- sync convenience ---------------------------------------------
    def sync_pread(self, path: str, buffer: np.ndarray, file_offset: int = 0) -> int:
        rc = self._lib.aio_sync_pread(self._h, path.encode(),
                                      buffer.ctypes.data_as(ctypes.c_void_p),
                                      buffer.nbytes, file_offset,
                                      1 if self.use_direct else 0)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return rc

    def sync_pwrite(self, path: str, buffer: np.ndarray, file_offset: int = 0) -> int:
        rc = self._lib.aio_sync_pwrite(self._h, path.encode(),
                                       buffer.ctypes.data_as(ctypes.c_void_p),
                                       buffer.nbytes, file_offset,
                                       1 if self.use_direct else 0)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return rc


def aio_available() -> bool:
    try:
        _lib()
        return True
    except Exception as e:  # pragma: no cover
        logger.warning(f"AIO library unavailable: {e}")
        return False
