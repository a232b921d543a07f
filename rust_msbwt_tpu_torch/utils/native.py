"""ctypes bindings to the native host runtime (``csrc/msbwt_host.cpp`` and
the sequential reference baseline ``csrc/msbwt_baseline.cpp``).

The port builds the SAME C++ sources as the JAX package's ``utils.native``,
with the same g++ flags, into its own git-ignored build directory
(``rust_msbwt_tpu_torch/_build/``) on first use, and rebuilds when a source
is newer than the library. Every entry point has a pure-Python fallback
(returns ``None``), so the package works without a toolchain; with it, FASTX
parsing, RLE decode, the read sort and the stage view run at native speed.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("rust_msbwt_tpu_torch")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(os.path.dirname(_PKG), "csrc")
_SRCS = [
    os.path.join(_CSRC, "msbwt_host.cpp"),
    os.path.join(_CSRC, "msbwt_baseline.cpp"),
]
_LIB_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(_LIB_DIR, "libmsbwt_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    srcs = [s for s in _SRCS if os.path.isfile(s)]
    if not srcs:
        return False
    if os.path.isfile(_LIB) and all(
        os.path.getmtime(_LIB) >= os.path.getmtime(s) for s in srcs
    ):
        return True
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           *srcs, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native host library unavailable (%s); using Python paths", e)
        return False
    os.replace(tmp, _LIB)  # atomic: concurrent builders never see a torn file
    return True


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.msbwt_parse_fastx.restype = ctypes.c_int
        lib.msbwt_parse_fastx.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(u8p), i64p, ctypes.POINTER(i64p), i64p,
        ]
        lib.msbwt_free.restype = None
        lib.msbwt_free.argtypes = [ctypes.c_void_p]
        lib.msbwt_rle_decode.restype = ctypes.c_int64
        lib.msbwt_rle_decode.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.msbwt_rle_encode.restype = ctypes.c_int64
        lib.msbwt_rle_encode.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.msbwt_sort_rows.restype = ctypes.c_int
        lib.msbwt_sort_rows.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.msbwt_reads_to_cols.restype = ctypes.c_int
        lib.msbwt_reads_to_cols.argtypes = [
            u8p, i32p, i32p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.msbwt_baseline_build.restype = ctypes.c_int64
        lib.msbwt_baseline_build.argtypes = [
            u8p, i64p, ctypes.c_int64, ctypes.c_int, u8p,
        ]
        lib.msbwt_baseline_count_kmers.restype = ctypes.c_int
        lib.msbwt_baseline_count_kmers.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, u8p, i32p,
            ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_fastx_native(path: str):
    """Parse a FASTX file natively -> list of int-encoded reads, or None."""
    lib = get_lib()
    if lib is None:
        return None
    seq_p = ctypes.POINTER(ctypes.c_uint8)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    total = ctypes.c_int64()
    n_reads = ctypes.c_int64()
    rc = lib.msbwt_parse_fastx(
        path.encode(), ctypes.byref(seq_p), ctypes.byref(total),
        ctypes.byref(offs_p), ctypes.byref(n_reads),
    )
    if rc != 0:
        raise ValueError(f"{path}: FASTX parse failed (code {rc})")
    try:
        n, t = n_reads.value, total.value
        if n == 0:  # no records: the library may hand back NULL buffers
            return []
        seq = np.ctypeslib.as_array(seq_p, shape=(max(t, 1),))[:t].copy()
        offs = np.ctypeslib.as_array(offs_p, shape=(n + 1,)).copy()
    finally:
        lib.msbwt_free(seq_p)
        lib.msbwt_free(offs_p)
    return [seq[offs[i]:offs[i + 1]] for i in range(n)]


def rle_decode_native(rle: np.ndarray):
    """Decode RLE bytes to symbols natively, or None."""
    lib = get_lib()
    if lib is None:
        return None
    rle = np.ascontiguousarray(rle, dtype=np.uint8)
    total = lib.msbwt_rle_decode(_ptr(rle, ctypes.c_uint8), rle.size, None)
    out = np.empty(total, dtype=np.uint8)
    lib.msbwt_rle_decode(_ptr(rle, ctypes.c_uint8), rle.size,
                         _ptr(out, ctypes.c_uint8))
    return out


def rle_encode_native(syms: np.ndarray):
    """Encode decoded symbols to RLE bytes natively, or None."""
    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    n_bytes = lib.msbwt_rle_encode(_ptr(syms, ctypes.c_uint8), syms.size, None)
    out = np.empty(n_bytes, dtype=np.uint8)
    lib.msbwt_rle_encode(_ptr(syms, ctypes.c_uint8), syms.size,
                         _ptr(out, ctypes.c_uint8))
    return out


def sort_rows_native(reads: np.ndarray):
    """Lexicographic (stable) argsort of fixed-width uint8 rows, or None."""
    lib = get_lib()
    if lib is None:
        return None
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    n, l = reads.shape
    order = np.empty(n, dtype=np.int32)
    lib.msbwt_sort_rows(_ptr(reads, ctypes.c_uint8), n, l,
                        _ptr(order, ctypes.c_int32))
    return order


def reads_to_cols_native(reads: np.ndarray, lengths: np.ndarray,
                         order: np.ndarray | None = None):
    """Fused gather-by-order + ``[L+2, N]`` column-major stage view, or None."""
    lib = get_lib()
    if lib is None:
        return None
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, l = reads.shape
    cols = np.empty((l + 2, n), dtype=np.uint8)
    order_p = None
    if order is not None:
        order = np.ascontiguousarray(order, dtype=np.int32)
        order_p = _ptr(order, ctypes.c_int32)
    lib.msbwt_reads_to_cols(_ptr(reads, ctypes.c_uint8),
                            _ptr(lengths, ctypes.c_int32), order_p, n, l,
                            _ptr(cols, ctypes.c_uint8))
    return cols


# --- native CPU baseline (csrc/msbwt_baseline.cpp): the reference's exact
# sequential algorithms, used as an independent oracle ------------------------


def baseline_build_native(reads: list, sorted_insert: bool = True):
    """Sequential reference-shape build (B+-tree insertion) -> decoded BWT,
    or None without a toolchain. ``reads``: list of int-encoded arrays."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.zeros(len(reads) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(r) for r in reads])
    seq = np.ascontiguousarray(
        np.concatenate([np.asarray(r, dtype=np.uint8) for r in reads])
        if reads else np.zeros(0, dtype=np.uint8)
    )
    out = np.empty(int(offsets[-1]) + len(reads), dtype=np.uint8)
    n = lib.msbwt_baseline_build(
        _ptr(seq, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), len(reads),
        1 if sorted_insert else 0, _ptr(out, ctypes.c_uint8),
    )
    return out[:n]


def baseline_count_kmers_native(rle_bytes: np.ndarray, kmers: np.ndarray,
                                lengths=None, bin_power: int = 8,
                                threads: int = 1):
    """The reference's query loop (occ-bin seed + linear RLE decode) over a
    batch of right-aligned k-mers, or None without a toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    rle_bytes = np.ascontiguousarray(rle_bytes, dtype=np.uint8)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.empty(B, dtype=np.int64)
    rc = lib.msbwt_baseline_count_kmers(
        _ptr(rle_bytes, ctypes.c_uint8), rle_bytes.size, bin_power,
        _ptr(kmers, ctypes.c_uint8), _ptr(lengths, ctypes.c_int32), B, K,
        _ptr(out, ctypes.c_int64), threads,
    )
    if rc != 0:
        raise RuntimeError(f"baseline count_kmers failed (code {rc})")
    return out
