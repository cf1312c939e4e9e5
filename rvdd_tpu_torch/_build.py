"""Build the sources in ``csrc/`` and load them with ctypes.

Each source has a plain C interface and becomes ``_build/lib<name>.so``:

* a CUDA source ``csrc/<name>.cu``, compiled for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

* a host source ``csrc/<name>.cpp`` (no CUDA: the decode pool), compiled
  by ``$CXX`` (default ``g++``)::

    g++ -O3 -fPIC -std=c++17 -pthread -shared -o _build/lib<name>.so csrc/<name>.cpp

A library is built on first use in a process (or when its source, or any
header of its kind, ``csrc/*.cuh`` or ``csrc/*.h``, is newer than the
built file); ``build()`` starts one compiler per source at once, so a cold
start costs the slowest source, not the sum.  Each compiler writes a
temporary file of its process that replaces the library only when it
succeeds.  Nothing prebuilt is kept in the repository.  Every CUDA entry
point returns ``cudaGetLastError()`` as an int, and :func:`check` raises
when it is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
#: the CUDA sources (``csrc/<name>.cu``)
SOURCES = ("warp_bicubic", "conv_chain", "convnext_chain", "demosaic")
#: the host sources (``csrc/<name>.cpp``)
HOST_SOURCES = ("rvdd_io",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

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


def source_path(name: str) -> Path:
    """``csrc/<name>.cpp`` for a host source, else ``csrc/<name>.cu``."""
    cpp = CSRC_DIR / f"{name}.cpp"
    return cpp if cpp.exists() else CSRC_DIR / f"{name}.cu"


def _stale(name: str) -> bool:
    """A library is stale when it is missing or older than its source or
    any header of its kind in ``csrc/`` (every source may include every
    header: ``*.cuh`` for CUDA, ``*.h`` for host sources)."""
    so = lib_path(name)
    if not so.exists():
        return True
    src = source_path(name)
    deps = [src, *CSRC_DIR.glob("*.h" if src.suffix == ".cpp" else "*.cuh")]
    return any(so.stat().st_mtime < d.stat().st_mtime for d in deps)


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cpp":
        return [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", str(out), str(src)]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def _finish(proc: subprocess.Popen):
    out, _ = proc.communicate()
    return out, time.perf_counter()


def build(names=SOURCES) -> dict:
    """Compile the named sources, all compilers started together; returns
    BUILD_INFO.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        src = source_path(name)
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        jobs[name] = (_command(src, tmp), src, tmp)
    procs = {}
    for name, (cmd, src, tmp) in jobs.items():
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except FileNotFoundError as e:
            for started, *_ in procs.values():
                started.kill()
                started.wait()
            raise RuntimeError(f"build of {src.name}: compiler not found ({e})") from e
        procs[name] = (proc, src, tmp, time.perf_counter())
    # each compiler's output is drained by a thread of its own, so each
    # source's time ends when its compiler does
    with ThreadPoolExecutor(len(procs)) as pool:
        done = {name: pool.submit(_finish, proc) for name, (proc, *_) in procs.items()}
    failed = []
    for name, (proc, src, tmp, t0) in procs.items():
        out, t_end = done[name].result()
        secs = t_end - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {os.path.basename(proc.args[0])} {src.name} "
                          f"(rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        ptxas = [ln.strip() for ln in out.splitlines()
                 if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln)) or "spill" in ln
                 or "(C75" in ln]
        BUILD_INFO[name] = {"seconds": secs, "ptxas": ptxas}
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
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
