"""Build and load the CUDA kernels of `csrc/` (nvcc into a plain C shared
library, bound with ctypes).

Every source in `csrc/` is compiled for sm_90a by its own `nvcc`, all
started together, into `build/` beside this file (listed in .gitignore).
A library's file name carries a hash of its source, the shared headers
(`csrc/*.cuh`) and the flags, so a stale build is never loaded.  Nothing is built at import time: `load` builds on
first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}   # name -> loaded ctypes.CDLL (one per process)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels build only on a host with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: every `csrc/*.cu`), one nvcc
    each, in parallel.  Returns {name: {"path", "seconds", "log"}};
    "log" holds the compiler's output (ptxas register/shared-memory
    report).  Raises RuntimeError naming each source that failed."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            procs[name] = (out, None, None)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)        # atomic: concurrent builds agree
        results[name] = {"path": str(out),
                         "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
