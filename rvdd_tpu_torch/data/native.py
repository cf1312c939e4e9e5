"""ctypes bindings of the host decode pool ``csrc/rvdd_io.cpp`` (port of
rvdd_tpu/data/native.py).

A C++ decoder for the TIFF subset of the datasets (classic, little-endian,
one page, uncompressed, chunky strips; uint8, uint16 or float32 samples,
1-4 a pixel) and a pthread pool that decodes a stack of frames in parallel
into one dense float32 array.  Values are divided by ``scale`` in float32,
so the result equals data/io.py's numpy reader bit for bit.

    loader = NativeLoader(workers=4)
    batch = loader.read_batch(paths, (h, w, c), scale=4095.0)

The library is built with g++ into ``_build/`` at first use (_build.py's
host route).  There is no fallback: a failed build raises with the
compiler's output, and a file outside the subset raises ``IOError``.
data/io.py:load_image_stack sends a stack here only when its first file's
header is in the subset.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np

from rvdd_tpu_torch import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_lib = None


def library() -> ctypes.CDLL:
    """``_build/librvdd_io.so``, built first if missing or stale."""
    global _lib
    if _lib is None:
        lib = _build.load_library("rvdd_io")
        lib.rvdd_read_image.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64, _I64P,
                                        ctypes.c_float]
        lib.rvdd_read_image.restype = ctypes.c_int
        lib.rvdd_pool_create.argtypes = [ctypes.c_int]
        lib.rvdd_pool_create.restype = ctypes.c_void_p
        lib.rvdd_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.rvdd_pool_destroy.restype = None
        lib.rvdd_pool_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F32P, _I64P,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int)]
        lib.rvdd_pool_read_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


#: the largest image read_image decodes: 64 M floats (4K x 4 channels)
READ_CAP = 64 << 20


def read_image(path: str, scale: float = 0.0) -> np.ndarray:
    """Decode one TIFF of the subset to float32 [H, W, C], divided by
    ``scale`` (0: the raw values).  Raises IOError for any other file."""
    buf = np.empty(READ_CAP, np.float32)
    shape = (ctypes.c_int64 * 3)()
    rc = library().rvdd_read_image(os.fsencode(path), buf.ctypes.data_as(_F32P), READ_CAP,
                                   shape, ctypes.c_float(scale))
    if rc != 0:
        raise IOError(f"native decoder failed on {path} (not in its TIFF subset, or unreadable)")
    h, w, c = shape
    return buf[: h * w * c].reshape(h, w, c).copy()


class NativeLoader:
    """The threaded batch decoder: every frame lands in one dense array."""

    def __init__(self, workers: int = 4):
        self.workers = workers
        self._lib = library()
        self._pool = self._lib.rvdd_pool_create(workers)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.rvdd_pool_destroy(self._pool)
            self._pool = None

    __del__ = close

    def read_batch(self, paths: Sequence[str], frame_shape: Tuple[int, int, int],
                   scale: float = 0.0) -> np.ndarray:
        """Decode ``len(paths)`` frames, each of ``frame_shape`` (h, w, c),
        to float32 [N, h, w, c]; raises IOError naming every file that
        failed (outside the subset, another shape, or unreadable)."""
        n = len(paths)
        h, w, c = frame_shape
        out = np.empty((n, h, w, c), np.float32)
        statuses = (ctypes.c_int * n)()
        names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        failures = self._lib.rvdd_pool_read_batch(
            self._pool, names, n, out.ctypes.data_as(_F32P), (ctypes.c_int64 * 3)(h, w, c),
            ctypes.c_float(scale), statuses)
        if failures:
            bad = [paths[i] for i in range(n) if statuses[i] != 1]
            raise IOError(f"native decoder failed on {len(bad)} of {n} files of shape "
                          f"{tuple(frame_shape)}: {bad}")
        return out
