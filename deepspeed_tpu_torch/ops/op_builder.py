"""Build the port's CUDA kernels from source and load them.

Counterpart of ``deepspeed_tpu/ops/op_builder`` (which wraps the JAX
package's host-side native ops): each ``csrc/<name>.cu`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, ``build/lib<name>.so``, and loaded with ``ctypes``; a source may
include shared headers ``csrc/*.cuh``. Building happens at first use,
never at import, so the CPU tests import every module without a CUDA
toolkit. A library newer than its source and every header is reused.

Host C++ (``HOST_SOURCES``: the async I/O engine of ``ops/aio.py`` and the
host Adam / Adagrad / Lion of ``ops/cpu_adam_native.py``) is not a kernel:
``load_host`` builds it with ``g++`` into the same ``build/``, outside the
``nvcc`` loop, so it builds on a machine with no CUDA toolkit. The host
Adam takes the JAX package's flags (``deepspeed_tpu/ops/op_builder/
__init__.py`` ``CPUAdamBuilder``), ``-fopenmp-simd`` standing for
``-fopenmp``: the same source and code generation give the same bits.
"""

import ctypes
import os
import platform
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# host libraries by name: their source under csrc/ and their own g++ flags
HOST_SOURCES = {"deepspeed_aio": "aio/deepspeed_aio.cpp", "cpu_adam": "adam/cpu_adam.cpp"}
# the host Adam: JAX's flags, with -fopenmp-simd for -fopenmp (the source uses
# OpenMP's simd directive only, which needs no OpenMP runtime; some hosts lack
# libgomp's spec file, and -fopenmp then fails to build)
HOST_FLAGS = {"deepspeed_aio": ["-pthread"],
              "cpu_adam": ["-fopenmp-simd"] + (["-march=native"]
                                               if platform.machine() == "x86_64" else [])}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# loaded libraries and the ptxas report of each build, by kernel name
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _headers(path: Path, found: set) -> set:
    """The ``csrc/*.cuh`` headers ``path`` includes, directly or through
    other headers."""
    for h in re.findall(r'^#include "(\w+\.cuh)"', path.read_text(), re.MULTILINE):
        header = CSRC / h
        if header not in found and header.exists():
            found.add(header)
            _headers(header, found)
    return found


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a header the
    source includes, directly or not."""
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    sources = [src, *_headers(src, set())]
    return not lib.exists() or lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: List[str] = None) -> Dict[str, float]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are
    missing or older than their source, one ``nvcc`` per source, all started
    together. Returns the wall seconds of each build (0.0 when reused);
    raises with the compiler's output when one fails."""
    names = kernel_names() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, _lib_path(name))   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def gxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found (set CXX): the port's host C++ "
                           "libraries are built from source at first use")
    return found


_HOST_LOCK = threading.Lock()


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (a key of ``HOST_SOURCES``), built
    by ``g++`` first when it is missing or older than its source. Threads
    of one process build it once (the staging file is named by the pid)."""
    with _HOST_LOCK:
        return _load_host(name)


def _load_host(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        src = CSRC / HOST_SOURCES[name]
        lib = _lib_path(name)
        if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            proc = subprocess.run([gxx(), *GXX_FLAGS, *HOST_FLAGS[name], "-o", str(tmp),
                                   str(src)],
                                  capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: g++ exit {proc.returncode}\n"
                                   f"{BUILD_LOGS[name]}")
            os.replace(tmp, lib)   # atomic: a reader never sees half a file
        _LIBS[name] = ctypes.CDLL(str(lib))
    return _LIBS[name]
