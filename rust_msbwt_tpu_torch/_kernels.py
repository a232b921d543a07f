"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/libmsbwt_kernels.so csrc/*.cu

The library goes to the git-ignored ``rust_msbwt_tpu_torch/_build/``. It is
built at first use and rebuilt when a source is newer than it. Nothing here
runs at import time: a machine without ``nvcc`` imports every module and
only fails when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libmsbwt_kernels.so")

_lock = threading.Lock()
_lib = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> str:
    """Compile the kernel library if it is missing or stale.

    Returns the compiler's output (``-Xptxas -v``: registers, shared memory
    and spills of every kernel), or ``""`` when the library was up to date.
    """
    srcs = _sources()
    if os.path.isfile(LIB_PATH) and all(
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in srcs
    ):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, *srcs,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {res.returncode}):\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.msbwt_merge_insert_scratch_len.restype = i64
            lib.msbwt_merge_insert_scratch_len.argtypes = [i64]
            lib.msbwt_merge_insert.restype = ctypes.c_int
            lib.msbwt_merge_insert.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp]
            _lib = lib
        return _lib
