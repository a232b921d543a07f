"""Tracing, timing and roofline accounting on ``torch.profiler`` (port of the
JAX package's ``utils.profiling``).

* ``trace(dir)`` — a ``torch.profiler.profile`` region (CPU, and CUDA when
  a card is present) whose Chrome trace is written into ``dir``.
* ``annotate(name)`` — a named region inside a trace (``record_function``).
* ``timed(fn)`` — wall seconds of one call, fenced with
  ``torch.cuda.synchronize()`` once CUDA is in use (the device runs behind
  the host) and with nothing on the CPU.
* ``timeit(fn, reps=, warmup=)`` — the mean of ``reps`` back-to-back calls
  after ``warmup``: between two CUDA events once CUDA is in use (device
  time; the host's launch cost shows only where it starves the device),
  on the host clock on the CPU.
* ``session_health`` — three probes that tell a slow session from a slow
  program before a long run: dispatch round trip, bf16 matmul rate, memory
  rate.
* ``query_roofline`` / ``pair_query_roofline`` / ``build_roofline`` — byte
  models of the hot paths: the least time the memory allows, so a measured
  time reads as a share of it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

# device memory rate, bytes/s: NVIDIA H100 SXM 80 GB HBM3 (NVIDIA's data
# sheet, at its 700 W power limit); pass another card's as ``hbm_bw``
DEFAULT_HBM_BW = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (CPU activity, and CUDA kernels when a card is
    present) and write its Chrome trace into ``log_dir``; yields the
    ``torch.profiler.profile`` object (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_us(evt) -> float:
    """A ``key_averages()`` event's own device microseconds
    (``self_device_time_total`` from torch 2.4 on, ``self_cuda_time_total``
    before; 0 for an event with neither)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def annotate(name: str):
    """Named region inside an active trace."""
    return torch.profiler.record_function(name)


def fence() -> None:
    """Wait for the device once CUDA is in use; nothing on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args):
    """``(seconds, result)`` of one call of ``fn(*args)``, fenced before and
    after."""
    fence()
    t0 = time.perf_counter()
    out = fn(*args)
    fence()
    return time.perf_counter() - t0, out


def timeit(fn, *args, reps: int = 5, warmup: int = 1) -> float:
    """Steady-state seconds per call: the mean over ``reps`` back-to-back
    calls after ``warmup`` calls. Once CUDA is in use they run between two
    events on the current stream (for host-only work the idle stream records
    each event as it is issued, so that is the wall time); on the CPU
    between two reads of the host clock.

    >>> timeit(lambda: sum(range(10)), reps=3) >= 0
    True
    """
    for _ in range(warmup):
        fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def session_health(mxu_n: int = 8192, hbm_mwords: int = 128, device=None) -> dict:
    """Three micro-probes that classify a slow session before a big run:
    the round trip of one tiny op and its ``.item()`` (dispatch), the bf16
    rate of a chain of 8 ``mxu_n``-square ``torch.matmul`` products, and the
    memory rate of 8 elementwise passes over ``hbm_mwords`` Mi int32 words
    (512 MiB at the default; each pass is one kernel that reads them and
    writes as many). Normal rates
    with a slow dispatch point at the host; low rates at the card (clocks,
    power limit, neighbours). ``device`` defaults to ``cuda`` when a card is
    present; the size knobs let the CPU tests smoke the probe."""
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    (x + 1)[0].item()
    t0 = time.perf_counter()
    for _ in range(20):
        (x + 1)[0].item()
    dispatch_ms = (time.perf_counter() - t0) / 20 * 1e3

    a = torch.full((mxu_n, mxu_n), 1.0 / mxu_n, dtype=torch.bfloat16, device=dev)

    def chain():
        acc = a
        for _ in range(8):
            acc = torch.matmul(acc, a)
        return acc[0, 0].item()

    chain()  # warm-up (library handles, clocks)
    t0 = time.perf_counter()
    chain()
    tflops = 8 * 2 * mxu_n**3 / (time.perf_counter() - t0) / 1e12

    big = torch.ones(hbm_mwords * 2**20, dtype=torch.int32, device=dev)

    def passes():
        acc = big
        for i in range(8):
            acc = acc + i  # one kernel a pass (``acc * 3 + i`` would be two)
        return acc[0].item()

    passes()
    t0 = time.perf_counter()
    passes()
    gbps = 8 * 2 * big.numel() * 4 / (time.perf_counter() - t0) / 1e9
    del a, big
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": name, "dispatch_roundtrip_ms": round(dispatch_ms, 3),
            "matmul_tflops_bf16": round(tflops, 1), "mem_gbps": round(gbps, 1)}


@dataclass
class Roofline:
    bytes_touched: int
    seconds_at_light: float
    measured_seconds: float

    @property
    def fraction_of_light(self) -> float:
        return self.seconds_at_light / max(self.measured_seconds, 1e-12)


def query_roofline(n_queries: int, k: int, measured_seconds: float,
                   hbm_bw: float = DEFAULT_HBM_BW, cache_k: int = 0) -> Roofline:
    """Bytes model for batched ``count_kmer`` on the packed index: per LF
    step, two ranks, each ONE 128-byte packed row gather
    (``ops.packed_rank``); a prefix cache skips the first ``cache_k`` steps
    for one 8-byte lookup.

    >>> r = query_roofline(1_000_000, k=21, measured_seconds=0.1, hbm_bw=800e9)
    >>> r.bytes_touched            # 21 steps x 2 ranks x 128 B per query
    5376000000
    >>> 0 < r.fraction_of_light < 1
    True
    """
    steps = max(k - cache_k, 0)
    bytes_touched = n_queries * (steps * 2 * 128 + (8 if cache_k else 0))
    return Roofline(bytes_touched, bytes_touched / hbm_bw, measured_seconds)


def pair_query_roofline(n_queries: int, k: int, measured_seconds: float,
                        cache_k: int = 0, row_bytes: int = 240,
                        hbm_bw: float = DEFAULT_HBM_BW) -> Roofline:
    """Bytes model for batched ``count_kmer`` on the pair index
    (``ops.pair_rank``): each round consumes two pattern symbols with two
    row gathers (both range ends), plus one round for an odd tail, i.e.
    ``ceil((k - cache_k) / 2)`` rounds x 2 gathers x ``row_bytes`` (the
    240 B row), and a prefix cache seeds the first ``cache_k`` symbols with
    one 8-byte lookup. Random row gathers run well below the streaming
    rate, so a share well below 1 is expected.

    >>> r = pair_query_roofline(1_000_000, k=21, measured_seconds=0.1,
    ...                         cache_k=9, hbm_bw=800e9)
    >>> r.bytes_touched        # ceil(12/2)=6 rounds x 2 x 240 B + 8 B
    2888000000
    """
    rounds = -(-max(k - cache_k, 0) // 2)
    bytes_touched = n_queries * (rounds * 2 * row_bytes + (8 if cache_k else 0))
    return Roofline(bytes_touched, bytes_touched / hbm_bw, measured_seconds)


def build_roofline(n_symbols: int, max_read_len: int, measured_seconds: float, *,
                   n_reads: int, radix: int = 1,
                   hbm_bw: float = DEFAULT_HBM_BW) -> Roofline:
    """Bytes model for the port's stage loop: stage 1 and the ``L`` columns
    as merge passes over the full ``n_symbols`` buffer (an upper bound:
    capacity buckets make early passes shorter). A pass of k inserts moves
    3n + 6k bytes: the old buffer read and the new one written (n each), its
    packed table written (128 B a 128-symbol bin), and each insert's slot,
    symbol and flag read (4 + 1 + 1 B). Radix 1 is ``L + 1`` passes of N
    inserts; radix 2 is stage 1, ``L // 2`` pair passes of 2N inserts and,
    for odd ``L``, one pass of N.

    >>> build_roofline(1000, 9, 1.0, n_reads=100).bytes_touched  # 10 x (3000 + 600)
    36000
    >>> build_roofline(1000, 9, 1.0, n_reads=100, radix=2).bytes_touched  # 2 x 3600 + 4 x 4200
    24000
    """
    n, N, L = n_symbols, n_reads, max_read_len
    if radix == 1:
        bytes_touched = (L + 1) * (3 * n + 6 * N)
    elif radix == 2:
        bytes_touched = (1 + L % 2) * (3 * n + 6 * N) + (L // 2) * (3 * n + 12 * N)
    else:
        raise ValueError(f"radix must be 1 or 2, got {radix}")
    return Roofline(bytes_touched, bytes_touched / hbm_bw, measured_seconds)
