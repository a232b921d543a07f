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
2. Unless ``--no-profile``: one device stage loop, one 1M-query
   ``count_kmers_packed`` batch (6^8 cache) and one 1M-query
   ``count_kmers_pair`` batch (6^9 cache: the tier ``RleBWT`` picks at this
   size; the pair index build is profiled and the cache build timed
   first); then the last batch of the streamed build (1M reads onto the
   404M-symbol BWT of the first 4M): its terminator walk alone
   (``_terminator_positions_impl`` on the stage view,
   lengths and step counts already on the card, as the build runs it), its
   device stage loop (walk included) and its whole entry point
   (``build_msbwt_with_index`` with the base's index and bound given). Each
   runs once unprofiled, for its wall time; all but the entry point run once
   more under ``torch.profiler``, for the summed device time, the device's
   idle share of the unprofiled wall time, the device events per call and
   the top device kernels and copies. The walk's share of the stage loop
   and of the entry point comes from the unprofiled walls of this process.
3. Unless ``--no-profile``: one round of ``chip_smoke.py`` phase 11a's
   doubling merge (``ops.merge._doubling_round``: the sorted reads in four
   groups, each built on the card, merged at 505M symbols), from the state
   ``_doubling_init`` leaves: once unprofiled, once profiled, with the share
   of the round's device time spent in sort kernels.

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


def wall_time(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(torch, fn, label: str, top: int, share_of: str | None = None) -> dict:
    """Run ``fn()`` once unprofiled (its wall time: the profiler's CPU
    tracing slows every launch) and once under ``torch.profiler`` (its
    summed device time, device events and top events); print and return
    them. ``share_of``: also the share of the device time in events whose
    name holds that word (any case)."""
    from torch.profiler import ProfilerActivity, profile

    wall = wall_time(torch, fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall = wall_time(torch, fn)
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them carry the same time again
    evts = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    evts.sort(key=_device_us, reverse=True)
    dev_s = sum(_device_us(e) for e in evts) * 1e-6
    n_events = sum(e.count for e in evts)
    log(f"[{label}] wall {wall:.4f} s ({prof_wall:.4f} s profiled), device "
        f"{dev_s:.4f} s in {n_events} events, device idle "
        f"{100 * (1 - dev_s / wall):.1f}% of the unprofiled wall time")
    rows = []
    for e in evts[:top]:
        ms = _device_us(e) * 1e-3
        rows.append({"name": e.key[:100], "count": e.count, "ms": ms})
        log(f"[{label}]   {ms:10.3f} ms  x{e.count:<5d} {e.key[:100]}")
    if not evts:
        log(f"[{label}] the profiler recorded no device time")
    out = {"wall_s": wall, "profiled_wall_s": prof_wall, "device_s": dev_s,
           "device_events": n_events, "top": rows}
    if share_of:
        part = sum(_device_us(e) for e in evts if share_of in e.key.lower()) * 1e-6
        out[f"{share_of}_share"] = part / dev_s if dev_s else None
        log(f"[{label}] '{share_of}' kernels: {part:.4f} s, "
            f"{100 * part / dev_s if dev_s else 0:.1f}% of the device time")
    return out


def profile_merge_round(torch, np, dev, reads, lengths, top: int) -> dict:
    """One doubling round of chip_smoke.py phase 11a's four-part merge at
    505M symbols, from the state ``_doubling_init`` leaves."""
    from chip_smoke import N_PARTS, N_READS
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.ops.merge import _doubling_init, _doubling_round
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    order = sort_rows_native(reads)
    nl = -(-N_READS // N_PARTS)
    parts = [build_msbwt(reads[order[g * nl: (g + 1) * nl]], lengths[order[g * nl: (g + 1) * nl]],
                         device=dev, device_out=True) for g in range(N_PARTS)]
    syms = torch.cat(parts)
    sizes = [int(p.numel()) for p in parts]
    del parts
    init_s = wall_time(torch, lambda: _doubling_init(syms, sizes, False))
    rank, succ = _doubling_init(syms, sizes, False)
    out = profiled(torch, lambda: _doubling_round(rank, succ, False), "doubling round", top,
                   share_of="sort")
    out["init_s"] = init_s
    log(f"[doubling round] {syms.numel()} symbols in {N_PARTS} parts: init (psi sort + "
        f"first ranks) {init_s:.4f} s; one round {out['wall_s']:.4f} s")
    return out


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
        _cyclic_steps,
        _prepare_build,
        _terminator_positions_impl,
        build_msbwt_with_index,
    )
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
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
        p = _prepare_build(reads, lengths, True)
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
        p = _prepare_build(reads, lengths, True)
        result["build_loop"] = profiled(
            torch, lambda: _build_device(p, dev, merge_insert), "build loop", args.top)
        del p
        cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
        count_kmers_packed(packed, kmers, cache=cache, cache_k=8)  # warm-up
        result["query"] = profiled(
            torch, lambda: count_kmers_packed(packed, kmers, cache=cache, cache_k=8),
            "1M queries", args.top)
        del cache
        result["pair_index"] = profiled(torch, lambda: build_pair_index(idx),
                                        "pair index build", args.top)
        pair = build_pair_index(idx)
        cache9_s = wall_time(torch, lambda: build_kmer_cache(idx.bwt, idx.occ, idx.starts,
                                                             idx.n, 9))
        cache9 = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 9)
        log(f"[setup] 6^9 cache {cache9_s:.4f} s")
        count_kmers_pair(pair, kmers, cache=cache9, cache_k=9)  # warm-up
        result["query_pair"] = profiled(
            torch, lambda: count_kmers_pair(pair, kmers, cache=cache9, cache_k=9),
            "1M queries, pair + 6^9", args.top)
        result["query_pair"]["cache9_s"] = cache9_s
        del pair, cache9, idx, packed
        # the streamed build's last batch: 1M reads onto the first 4M's BWT
        n0_reads = N_READS - 1_000_000
        base, bpacked = build_msbwt_with_index(reads[:n0_reads], lengths[:n0_reads],
                                               device=dev)
        last = slice(n0_reads, N_READS)
        p = _prepare_build(reads[last], lengths[last], True, base.n, n0_reads)
        cols = torch.from_numpy(p["cols"]).to(dev)
        lens = torch.from_numpy(p["lengths"]).to(dev)
        steps, n_steps = _cyclic_steps(p["lengths"], READ_LEN + 1, p["L"])
        steps = torch.from_numpy(steps).to(dev)
        walk = profiled(
            torch, lambda: _terminator_positions_impl(bpacked.table, bpacked.starts,
                                                      base.n, cols, lens, steps, n_steps),
            "terminator walk", args.top)
        walk["steps"] = n_steps
        del cols, lens, steps
        loop = profiled(
            torch, lambda: _build_device(p, dev, merge_insert, base.bwt[: base.n],
                                         bpacked, READ_LEN + 1),
            "extend loop", args.top)
        del p
        entry_s = wall_time(torch, lambda: build_msbwt_with_index(
            reads[last], lengths[last], True, base.bwt[: base.n], n0_reads,
            READ_LEN + 1, device=dev, base_index=bpacked))
        log(f"[terminator walk] {n_steps} LF steps: "
            f"{1e3 * walk['wall_s'] / n_steps:.3f} ms wall, "
            f"{1e3 * walk['device_s'] / n_steps:.3f} ms device, "
            f"{walk['device_events'] / n_steps:.1f} device events a step; "
            f"{100 * walk['wall_s'] / loop['wall_s']:.1f}% of the extend loop, "
            f"{100 * walk['wall_s'] / entry_s:.1f}% of the whole extend build "
            f"({entry_s:.4f} s, host prep included)")
        result.update(terminator_walk=walk, extend_loop=loop, extend_build_s=entry_s)
        del base, bpacked
        result["merge_round"] = profile_merge_round(torch, np, dev, reads, lengths, args.top)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
