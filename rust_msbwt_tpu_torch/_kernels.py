"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, all of them at once, and the objects are linked into one shared
library with a plain C interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libmsbwt_kernels.so _build/*.o

The library goes to the git-ignored ``rust_msbwt_tpu_torch/_build/``. It is
built at first use and rebuilt when a source or a shared header
(``csrc/*.cuh``) is newer than it. Nothing here
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
    """The sources nvcc compiles (``csrc/*.cu``)."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _inputs() -> list[str]:
    """Every file the library is built from: the sources and the headers
    they include (``csrc/*.cuh``)."""
    return _sources() + sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


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
    if os.path.isfile(LIB_PATH) and all(
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in _inputs()
    ):
        return ""
    srcs = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o") for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-c",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", o, s],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = f"{LIB_PATH}.{tag}"
    try:
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} (rc {p.returncode}):\n{log}")
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                              "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs) + res.stdout + res.stderr


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            for name in ("msbwt_merge_tile", "msbwt_lf_pair_bucket"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = []
            lib.msbwt_lf_pair_tile.restype = ctypes.c_int
            lib.msbwt_lf_pair_tile.argtypes = [i64, i64]
            lib.msbwt_merge_insert_scratch_len.restype = i64
            lib.msbwt_merge_insert_scratch_len.argtypes = [i64, i64]
            lib.msbwt_merge_insert.restype = ctypes.c_int
            lib.msbwt_merge_insert.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, vp]
            lib.msbwt_lf_pair_work_len.restype = i64
            lib.msbwt_lf_pair_work_len.argtypes = [i64, i64]
            lib.msbwt_lf_group_work_len.restype = i64
            lib.msbwt_lf_group_work_len.argtypes = [i64, i64]
            lib.msbwt_lf_group_cluster_max_n.restype = i64
            lib.msbwt_lf_group_cluster_max_n.argtypes = []
            i32 = ctypes.c_int
            for name, args in (
                ("msbwt_lf_stage", [vp] * 12 + [i64, i32, i32, vp]),
                ("msbwt_lf_pair", [vp] * 14 + [i64, i64, i32, i32, vp]),
                ("msbwt_lf_group", [vp] * 18 + [i64, i32, i32, i32, i32, vp]),
                ("msbwt_lf_walk_cyclic", [vp] * 6 + [i64, i64, i32, vp]),
                ("msbwt_lf_walk_lengths", [vp] * 5 + [i64, i64, vp]),
                ("msbwt_lf_walk_extract", [vp] * 5 + [i64, i32, vp]),
                ("msbwt_lf_walk_locate", [vp] * 6 + [i64, i64, i32, vp]),
                ("msbwt_kmer_ranges_packed", [vp] * 8 + [i64, i32, i32, i32, vp]),
                ("msbwt_kmer_counts_pair", [vp] * 8 + [i64, i64, i32, i32, i32, vp]),
            ):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = args
            _lib = lib
        return _lib
