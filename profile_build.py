#!/usr/bin/env python3
"""Time breakdown of the port's 505M-symbol build and 1M-query batch on one
NVIDIA card.

    python3 profile_build.py [--reps 4] [--top 25] [--no-profile]

Uses ``chip_smoke.py``'s main-path read set (5M x 100 bp reads from a
random 4.6 Mbase genome, seed 0xEC011; 1M 21-mer queries). The CUDA context
is created and the kernel library built and loaded before anything is
timed. Then:

1. ``--reps`` back-to-back builds in one process, with no warm-up build.
   Each rep times the host prep (``ops.bcr._prepare_build``: native read
   sort + stage view), then the device stage loop on that prep
   (``ops.bcr._build_device``, stage-view upload included), then the whole
   entry point ``build_msbwt_with_index``. The first rep shows what the
   first build in a process costs over the later ones.
2. Unless ``--no-profile``: one device stage loop and one 1M-query
   ``count_kmers_packed`` batch (6^8 cache) under ``torch.profiler``. For
   each: wall seconds, summed device seconds, the device's idle share of
   the wall time, and the top device kernels and copies by device time.

Host timers wrap ``torch.cuda.synchronize()``. The card's name and power
limit are printed first; the last line is one JSON object holding every
number printed. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def _device_us(evt) -> float:
    # torch >= 2.4 names it self_device_time_total; older releases self_cuda_
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(torch, fn, label: str, top: int) -> dict:
    """Run ``fn()`` once under ``torch.profiler``; print and return its wall
    time, summed device time and top device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them carry the same time again
    evts = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    evts.sort(key=_device_us, reverse=True)
    dev_s = sum(_device_us(e) for e in evts) * 1e-6
    log(f"[{label}] wall {wall:.4f} s, device {dev_s:.4f} s, "
        f"device idle {100 * (1 - dev_s / wall):.1f}% of the wall time")
    rows = []
    for e in evts[:top]:
        ms = _device_us(e) * 1e-3
        rows.append({"name": e.key[:100], "count": e.count, "ms": ms})
        log(f"[{label}]   {ms:10.3f} ms  x{e.count:<5d} {e.key[:100]}")
    if not evts:
        log(f"[{label}] the profiler recorded no device time")
    return {"wall_s": wall, "device_s": dev_s, "top": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4,
                    help="back-to-back builds in one process (default 4)")
    ap.add_argument("--top", type=int, default=25,
                    help="device events listed per profile (default 25)")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the torch.profiler runs")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")

    import torch

    if not torch.cuda.is_available():
        print("profile_build: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from chip_smoke import N_READS, READ_LEN, card_line, ecoli_config
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops.bcr import (
        _build_device,
        _prepare_build,
        build_msbwt_with_index,
    )
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache

    smi = card_line()
    log(smi)
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.load()
    log(f"[setup] kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    reads, lengths, kmers = ecoli_config(np)
    log(f"[setup] {N_READS} x {READ_LEN} bp reads made in {time.perf_counter() - t0:.2f} s")
    n_bases = int(lengths.sum())

    reps = []
    idx = packed = None
    for i in range(args.reps):
        del idx, packed  # one build's state on the card at a time
        t0 = time.perf_counter()
        p = _prepare_build(reads, lengths, True, None)
        prep_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _build_device(p, dev, merge_insert)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        del out, p
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        reps.append({"prep_s": prep_s, "loop_s": loop_s, "build_s": build_s,
                     "mbases_per_s": n_bases / build_s / 1e6, "peak_bytes": peak})
        log(f"[rep {i}] host prep {prep_s:.4f} s, device loop {loop_s:.4f} s; "
            f"build_msbwt_with_index {build_s:.4f} s ({n_bases / build_s / 1e6:.2f} "
            f"Mbases/s), peak {peak / 2**30:.2f} GiB")

    result = {"card": smi, "symbols": idx.n, "reps": reps}
    if not args.no_profile:
        p = _prepare_build(reads, lengths, True, None)
        result["build_loop"] = profiled(
            torch, lambda: _build_device(p, dev, merge_insert), "build loop", args.top)
        del p
        cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
        count_kmers_packed(packed, kmers, cache=cache, cache_k=8)  # warm-up
        result["query"] = profiled(
            torch, lambda: count_kmers_packed(packed, kmers, cache=cache, cache_k=8),
            "1M queries", args.top)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
