"""ctypes bindings for the native mmap tile-IO engine (``native/tileio.cpp``).

The port's copy of ``gemm_hls_tpu/utils/tileio.py``: the library is shared
with the JAX package by path, not by import, as ``utils/native.py`` shares
the oracle.  ``MatrixFile`` exposes disk-resident row-major matrices with
tile-granular read / write: the data loader of GEMMs whose operands exceed
host memory (disk -> host memory -> device memory, ``parallel/staging.py``).
Falls back to ``numpy.memmap`` when the native library is unavailable;
``MatrixFile.native`` says which path an open file took.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtileio.so"
_lock = threading.Lock()
_lib = None
_load_failed = False


def _get_lib():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _LIB_PATH.exists():
            try:
                subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                               capture_output=True, timeout=120)
            except (subprocess.SubprocessError, FileNotFoundError):
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _load_failed = True
            return None
        i64 = ctypes.c_int64
        lib.tileio_open.restype = ctypes.c_void_p
        lib.tileio_open.argtypes = [ctypes.c_char_p, i64, i64, i64,
                                    ctypes.c_int]
        lib.tileio_create.restype = ctypes.c_void_p
        lib.tileio_create.argtypes = [ctypes.c_char_p, i64, i64, i64]
        for fn in (lib.tileio_read_tile, lib.tileio_write_tile):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, i64, i64, i64, i64,
                           ctypes.c_void_p, ctypes.c_int]
        lib.tileio_close.restype = None
        lib.tileio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_tileio_available() -> bool:
    return _get_lib() is not None


class MatrixFile:
    """A disk-resident row-major matrix with tile read/write."""

    def __init__(self, path, rows: int, cols: int, dtype, *,
                 create: bool = False, writable: bool = False,
                 n_threads: int = 0):
        self.path = str(path)
        self.rows, self.cols = int(rows), int(cols)
        self.dtype = np.dtype(dtype)
        self.n_threads = n_threads
        self._handle = None
        self._mm: Optional[np.memmap] = None
        lib = _get_lib()
        if lib is not None:
            if create:
                self._handle = lib.tileio_create(
                    self.path.encode(), self.rows, self.cols,
                    self.dtype.itemsize)
            else:
                self._handle = lib.tileio_open(
                    self.path.encode(), self.rows, self.cols,
                    self.dtype.itemsize, int(writable or create))
            if not self._handle:
                raise OSError(f"tileio: cannot open {self.path}")
        else:  # numpy fallback
            mode = "w+" if create else ("r+" if writable else "r")
            self._mm = np.memmap(self.path, dtype=self.dtype, mode=mode,
                                 shape=(self.rows, self.cols))
        self.native = self._handle is not None

    @property
    def shape(self):
        return (self.rows, self.cols)

    def read_tile(self, r0: int, r1: int, c0: int, c1: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Rows [r0, r1) and columns [c0, c1), into ``out`` (a C-contiguous
        array of the tile's shape and dtype, such as a pinned staging
        buffer's view) when given, else into a new array."""
        shape = (r1 - r0, c1 - c0)
        if out is None:
            out = np.empty(shape, dtype=self.dtype)
        elif (out.shape != shape or out.dtype != self.dtype
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous {shape} "
                             f"{self.dtype} array, got {out.shape} {out.dtype}")
        if self._handle:
            rc = _get_lib().tileio_read_tile(
                self._handle, r0, r1, c0, c1,
                out.ctypes.data_as(ctypes.c_void_p), self.n_threads)
            if rc != 0:
                raise ValueError(f"tileio_read_tile failed ({rc}) for "
                                 f"[{r0}:{r1}, {c0}:{c1}] of {self.shape}")
        else:
            out[:] = self._mm[r0:r1, c0:c1]
        return out

    def write_tile(self, r0: int, c0: int, tile: np.ndarray):
        tile = np.ascontiguousarray(tile, dtype=self.dtype)
        r1, c1 = r0 + tile.shape[0], c0 + tile.shape[1]
        if self._handle:
            rc = _get_lib().tileio_write_tile(
                self._handle, r0, r1, c0, c1,
                tile.ctypes.data_as(ctypes.c_void_p), self.n_threads)
            if rc != 0:
                raise ValueError(f"tileio_write_tile failed ({rc}) for "
                                 f"[{r0}:{r1}, {c0}:{c1}] of {self.shape}")
        else:
            self._mm[r0:r1, c0:c1] = tile
            self._mm.flush()

    def close(self):
        if self._handle:
            _get_lib().tileio_close(self._handle)
            self._handle = None
        if self._mm is not None:
            self._mm.flush()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
