"""Build `dart_tpu_torch/csrc/*.cu` with nvcc at first use and load it.

Each source compiles to an object in its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, bound with ctypes (no PyTorch headers, so a build takes
seconds). The output lands in `build/dart_tpu_torch/<hash of sources and
flags>/` beside the package, so a changed source never loads a stale
library. Only the sources in the checkout and the installed CUDA toolkit
are used. `build_host` compiles a host-side C++ source (the telemetry
ring, `native/ringlog.cpp`) with g++ the same way.
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
# Codes the C entry points return before launching (csrc/lanes.cuh).
BAD_SHAPE, BAD_BUDGET = -1, -2
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


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
    cu = [s for s in _sources() if s.suffix == ".cu"]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(cu, objs)]
        logs = []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
        failed = [src.name for src, proc in zip(cu, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stderr}\n{link.stdout}")
        os.replace(tmp_lib, lib)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    log_path.write_text(log)
    return lib, seconds, log


HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def build_host(source: Path, name: str) -> Path:
    """Compile the host C++ `source` with g++ into `lib<name>.so` under
    `build/dart_tpu_torch/<hash of source and flags>/`, unless it is
    there already. Returns the library's path; raises if g++ is missing
    or fails."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(source.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the host library "
                           f"lib{name}.so cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib.name
        run = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp_lib),
                              str(source)], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name} (exit "
                               f"{run.returncode}):\n{run.stderr}")
        os.replace(tmp_lib, lib)
    return lib


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    signatures = {
        "pmpc_solve": [_PTR] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_double] * 3 + [_PTR],
        "riccati": [_PTR] * 13 + [ctypes.c_int] * 3 + [ctypes.c_double] * 4
        + [_PTR],
        "rmpc_solve": [_PTR] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_double] * 9 + [_PTR],
        "lmpc_solve": [_PTR] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_double] * 2 + [_PTR],
    }
    for base, argtypes in signatures.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, base + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for geometry in (lib.pmpc_solve_geometry, lib.riccati_geometry,
                     lib.rmpc_solve_geometry, lib.lmpc_solve_geometry):
        geometry.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4)
        geometry.restype = ctypes.c_int
    lib.dart_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dart_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(kernel: str, size: int, itemsize: int) -> dict:
    """Threads and lanes per block, dynamic shared bytes per block and the
    blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of `kernel`'s CUDA instance for `size` (the horizon N; the state size
    nz for `riccati`) and elements of `itemsize` bytes (4 or 8), from its C
    query `<kernel>_geometry`."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = getattr(library(), f"{kernel}_geometry")(
        size, itemsize, *(ctypes.byref(v) for v in vals))
    if err == BAD_SHAPE:
        raise NotImplementedError(f"no {kernel} instance for size {size}, "
                                  f"{itemsize}-byte elements")
    if err != 0:
        raise RuntimeError(f"{kernel} geometry query failed: "
                           f"{error_string(err)} (code {err})")
    return dict(zip(("threads", "lanes", "shared_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def error_string(code: int) -> str:
    return library().dart_cuda_error_string(code).decode()
