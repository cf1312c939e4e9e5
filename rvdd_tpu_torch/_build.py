"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>.so``, compiled for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

A library is built on first use in a process (or when its source, or any
header ``csrc/*.cuh``, is newer than the built file); ``build()`` starts
one nvcc per source at once, so a cold start costs the slowest source, not
the sum.  Nothing prebuilt is kept
in the repository.  Every C entry point returns ``cudaGetLastError()`` as an
int, and :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("warp_bicubic", "conv_chain", "convnext_chain")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per source: {"seconds": wall time of its nvcc, "ptxas": the -Xptxas -v
#: lines (registers, shared memory, spills per kernel) and ptxas's C75xx
#: notes (e.g. "wgmma ... serialized", printed as info)}
BUILD_INFO: dict = {}
_LIBS: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """A library is stale when it is missing or older than its source or
    any header in ``csrc/`` (every source may include every header)."""
    so = lib_path(name)
    if not so.exists():
        return True
    deps = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return any(so.stat().st_mtime < d.stat().st_mtime for d in deps)


def build(names=SOURCES) -> dict:
    """Compile the named sources, all nvcc processes started together;
    returns BUILD_INFO.  Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        ptxas = [ln.strip() for ln in out.splitlines()
                 if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln)) or "spill" in ln
                 or "(C75" in ln]
        BUILD_INFO[name] = {"seconds": secs, "ptxas": ptxas}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return BUILD_INFO


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (every library exports
    ``rvdd_cuda_error_string``)."""
    if rc != 0:
        fn = lib.rvdd_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()}) at launch")
