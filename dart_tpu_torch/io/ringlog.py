"""ctypes binding of the native telemetry ring, `native/ringlog.cpp` (port
of `dart_tpu.io.ringlog`): a lock-free single-producer ring of fixed-size
records drained to disk by a C++ writer thread, dropping and counting
records when full.

    log = RingLogger(path, record_dtype, capacity_records=1 << 16)
    log.push(record_struct_array)     # non-blocking; drops when full
    log.close()
    arr = RingLogger.read(path, record_dtype)

The source is compiled with g++ at first use (`ops.kernels._build.
build_host`, into `build/dart_tpu_torch/<hash>/`). Where it cannot be
built, a pure-Python buffered writer takes its place; `is_native()` (and
`RingLogger.is_native`) tells which writer runs. Records are raw copies
of a numpy structured dtype, so the file is `np.fromfile`-readable.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from dart_tpu_torch.ops.kernels import _build

SOURCE = _build.PKG_DIR.parent / "native" / "ringlog.cpp"


@functools.lru_cache(maxsize=None)
def _load():
    """The built library with its entry points typed, or None where it
    cannot be built or loaded (no g++, no source)."""
    try:
        lib = ctypes.CDLL(str(_build.build_host(Path(SOURCE), "ringlog")))
    except (OSError, RuntimeError):
        return None
    lib.rl_create.restype = ctypes.c_void_p
    lib.rl_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_uint64]
    lib.rl_push.restype = ctypes.c_int
    lib.rl_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rl_flush.argtypes = [ctypes.c_void_p]
    lib.rl_stats.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.rl_close.argtypes = [ctypes.c_void_p]
    return lib


def is_native() -> bool:
    """Whether the native ring is built and loads here."""
    return _load() is not None


class RingLogger:
    def __init__(self, path: str, record_dtype: np.dtype,
                 capacity_records: int = 1 << 16):
        self.path = path
        self.dtype = np.dtype(record_dtype)
        self._lib = _load()
        self._handle = None
        self._fallback = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self._lib is not None:
            self._handle = self._lib.rl_create(
                path.encode(), self.dtype.itemsize, capacity_records)
        if not self._handle:
            self._fallback = open(path, "wb")

    @property
    def is_native(self) -> bool:
        return self._handle is not None and self._fallback is None

    def push(self, record) -> bool:
        """Queue one record or an array of them; False if any was dropped
        (ring full). The Python writer never drops."""
        rec = np.ascontiguousarray(np.asarray(record).astype(self.dtype,
                                                             copy=False))
        if self._fallback is not None:
            self._fallback.write(rec.tobytes())
            return True
        ok = True
        for r in rec.reshape(-1):
            ok &= bool(self._lib.rl_push(self._handle,
                                         ctypes.c_char_p(r.tobytes())))
        return ok

    def stats(self) -> dict:
        """{pushed, dropped, written, native}; the Python writer reports
        -1 for the counts it does not keep, as JAX's does."""
        if self._fallback is not None:
            return {"pushed": -1, "dropped": 0, "written": -1,
                    "native": False}
        out = (ctypes.c_uint64 * 3)()
        self._lib.rl_stats(self._handle, out)
        return {"pushed": int(out[0]), "dropped": int(out[1]),
                "written": int(out[2]), "native": True}

    def flush(self):
        if self._fallback is not None:
            self._fallback.flush()
        else:
            self._lib.rl_flush(self._handle)

    def close(self):
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None
        elif self._handle:
            self._lib.rl_close(self._handle)
            self._handle = None

    @staticmethod
    def read(path: str, record_dtype: np.dtype) -> np.ndarray:
        return np.fromfile(path, dtype=np.dtype(record_dtype))
