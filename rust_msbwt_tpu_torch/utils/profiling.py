"""Tracing and timing on ``torch.profiler`` (port of the JAX package's
``utils.profiling``).

* ``trace(dir)`` — a ``torch.profiler.profile`` region (CPU, and CUDA when
  a card is present) whose Chrome trace is written into ``dir``.
* ``annotate(name)`` — the port's span: a named region on the profiler's
  timeline (``record_function``) while a profiler is active, and a shared
  no-op context otherwise.
* ``timed(fn)`` — wall seconds of one call, fenced with
  ``torch.cuda.synchronize()`` once CUDA is in use (the device runs behind
  the host) and with nothing on the CPU.
* ``timeit(fn, reps=, warmup=)`` — the mean of ``reps`` back-to-back calls
  after ``warmup``: between two CUDA events once CUDA is in use (device
  time; the host's launch cost shows only where it starves the device),
  on the host clock on the CPU.
* ``session_health`` — two probes that tell a slow session from a slow
  program before a long run: dispatch round trip, memory rate.
"""

from __future__ import annotations

import contextlib
import os
import time

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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The span ``name``: ``record_function(name)`` while a profiler is
    active, so it sits on the profiler's clock beside the device events it
    encloses; else one shared no-op context, which costs one flag read
    where ``record_function`` would cost microseconds an enter and exit."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
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


def session_health(hbm_mwords: int = 128, device=None) -> dict:
    """Two micro-probes that classify a slow session before a big run: the
    round trip of one tiny op and its ``.item()`` (dispatch), and the
    memory rate of 8 elementwise passes over ``hbm_mwords`` Mi int32 words
    (512 MiB at the default; each pass is one kernel that reads them and
    writes as many). A normal rate with a slow dispatch points at the host;
    a low rate at the card (clocks, power limit, neighbours). ``device``
    defaults to ``cuda`` when a card is present; the size knob lets the CPU
    tests smoke the probe."""
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    (x + 1)[0].item()
    t0 = time.perf_counter()
    for _ in range(20):
        (x + 1)[0].item()
    dispatch_ms = (time.perf_counter() - t0) / 20 * 1e3

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
    del big
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": name, "dispatch_roundtrip_ms": round(dispatch_ms, 3),
            "mem_gbps": round(gbps, 1)}
