"""Build `dart_tpu_torch/csrc/*.cu` with nvcc at first use and load it.

The sources compile into one shared library with a plain C interface,
bound with ctypes (no PyTorch headers, so a build takes seconds). The
output lands in `build/dart_tpu_torch/<hash of sources and flags>/` beside
the package, so a changed source never loads a stale library. Only the
sources in the checkout and the installed CUDA toolkit are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "dart_tpu_torch"
LIB_NAME = "libdart_tpu_torch_kernels.so"
# Codes the C entry points return before launching (see csrc/*.cu).
BAD_HORIZON, BAD_BUDGET = -1, -2
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return str(path)


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the library if its build directory lacks it.
    Returns (library path, seconds spent compiling, nvcc's log)."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so",
                                     delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}\n{proc.stdout}")
        os.replace(tmp_path, lib)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    return lib, seconds, log


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name in ("pmpc_solve_f32", "pmpc_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_PTR] * 10 + [ctypes.c_int] * 4 + \
            [ctypes.c_double] * 3 + [_PTR]
        fn.restype = ctypes.c_int
    lib.dart_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dart_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return library().dart_cuda_error_string(code).decode()
