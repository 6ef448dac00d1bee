"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build_dir>/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of every shared header
(``csrc/*.cuh``), so an edited kernel or header is rebuilt and a stale
library never loaded. ``ptxas``'s report (registers, shared memory,
spills) is kept beside it as ``.log``. Nothing is built at import
time; a missing ``nvcc`` or a failed build raises with the compiler's
message.

Host helpers in C++ (``csrc/<name>.cpp``, a plain C interface) are built
the same way by ``g++`` (``load_host_lib``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}
_lock = threading.Lock()  # guards _name_locks
_name_locks: dict = {}  # one lock per kernel: builds of two kernels overlap
# name -> (seconds spent building in this process, ptxas report)
build_info: dict = {}


def build_dir() -> str:
    """Where native and CUDA builds go: ``$SMORE_TPU_TORCH_BUILD_DIR`` or
    the package's own ``_build/`` (listed in ``.gitignore``)."""
    d = os.environ.get("SMORE_TPU_TORCH_BUILD_DIR") or os.path.join(
        _PKG, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of smore_tpu_torch are built at first use and need "
        "the CUDA toolkit"
    )


def _digest(src: str) -> str:
    """Hash of a source and, for a kernel, every header it may include."""
    h = hashlib.sha256()
    headers = (sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
               if src.endswith(".cu") else [])
    for path in [src] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def load_kernel_lib(name: str) -> ctypes.CDLL:
    """Build (once per source revision) and load ``csrc/<name>.cu``. Calls
    for different kernels from different threads build in parallel."""
    return _load(name, ".cu", lambda: [_nvcc(), *NVCC_FLAGS])


def load_host_lib(name: str) -> ctypes.CDLL:
    """Build (once per source revision) and load the host library
    ``csrc/<name>.cpp`` with ``g++``."""
    return _load(name, ".cpp", lambda: ["g++", *GXX_FLAGS])


def loaded_lib(name: str):
    """The library of ``csrc/<name>.*`` if this process loaded it, else
    None."""
    return _libs.get(name)


def _load(name: str, ext: str, compiler) -> ctypes.CDLL:
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}{ext}")
        digest = _digest(src)
        so = os.path.join(build_dir(), f"lib{name}-{digest}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            tmp = f"{so}.build.{os.getpid()}"
            cmd = [*compiler(), "-o", tmp, src]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"{cmd[0]} failed to build {src} (exit {r.returncode}):"
                    f"\n{' '.join(cmd)}\n{r.stdout}\n{r.stderr}"
                )
            with open(so[:-3] + ".log", "w") as f:
                f.write(r.stdout + r.stderr)
            os.replace(tmp, so)
        log = so[:-3] + ".log"
        report = ""
        if os.path.exists(log):
            with open(log) as f:
                report = f.read()
        lib = ctypes.CDLL(so)
        build_info[name] = (time.perf_counter() - t0, report)
        _libs[name] = lib
        return lib
