#!/usr/bin/env python3
"""Time breakdown of the port's 505M-symbol build and 1M-query batch on one
NVIDIA card.

    python3 profile_build.py [--reps 4] [--top 25] [--no-profile] [--sweep-only]
                             [--queries] [--parent DIR]

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
   (``ops.lf.lf_walk_cyclic`` on the stage view,
   lengths and step counts already on the card, as the build runs it), its
   device stage loop (walk included) and its whole entry point
   (``build_msbwt_with_index`` with the base's index and bound given). Each
   runs once unprofiled, for its wall time; all but the entry point run once
   more under ``torch.profiler``, for the summed device time, the device's
   idle share of the unprofiled wall time, the device events per call and
   the top device kernels and copies, and for stage loops the device events
   a column. The walk's share of the stage loop
   and of the entry point comes from the unprofiled walls of this process.
   Each query batch also reports the device time and events of the query
   kernels (``kmer_ranges_packed`` / ``kmer_counts_pair``), and its host
   front split apart (median of three, each part fenced): the alphabet
   check, the upload of the k-mers and lengths, the search on the card,
   the download and the int64 cast, beside three walls of the entry point;
   then its device leg: the search alone on k-mers and lengths already on
   the card, 20 searches inside one CUDA-event window, as the JAX bench's
   ``query_qps_device`` (queries a second on the device, apart from the
   host front).
   Then ``chip_smoke.py`` phase 10's correction (10,000 reads with one
   substitution each, ``correct_reads(k=21, tau=2)``) through pair + 6^9:
   its wall and the share of it spent in the batched counts.
3. Unless ``--no-profile``: one round of ``chip_smoke.py`` phase 11a's
   doubling merge (``ops.merge._doubling_round``: the sorted reads in four
   groups, each built on the card, merged at 505M symbols), from the state
   ``_doubling_init`` leaves: once unprofiled, once profiled, with the share
   of the round's device time spent in sort kernels.
4. Unless ``--no-profile`` (alone with ``--sweep-only``): the radix sweep.
   Read sets of ~500M symbols at L = 250 (2M reads), 500 (1M) and 1,000
   (500k) from the same genome, and appends of 100k x 100 bp reads onto
   bases of 0.1M, 0.4M, 1M and 4M 100 bp reads (each base built on the card
   first, its index and bound given as the benchmark's append gives them:
   about 202, 505, 1,111 and 4,141 buffer symbols a new read, with the
   radix ``build_radix`` picks there); on each, the device stage loop at radix 1
   and radix 2 (``MSBWT_TPU_RADIX``) in turns for three rounds, the order
   flipped each round, and the median of the per-round ratios; then one
   profiled loop per radix (device time, idle share, device events a
   column), with radix 2's ``lf_pair`` kernels timed apart in the loop, and
   ``lf_pair`` alone on the last column pair's inputs: its device ms and
   device events a call by kernel (``chip_smoke.pair_split``) beside the
   bytes its function must move there (``chip_smoke.pair_bytes``) at
   3.35 TB/s, and the share of that bound. With ``--parent DIR`` (a ``git
   archive`` of the parent commit), the parent's radix-2 step too, on the
   same inputs: equal to this commit's ``lf_pair``, exactly, its event time
   and device time by kernel in turns with it (``chip_smoke.pair_turns``).

``--queries`` runs one build and step 2's two query batches only (with
``--reps 1``, about a minute): the run PERF.md's query numbers come from,
in turns with the parent commit's own ``profile_build.py --reps 1`` from a
``git archive`` of it, whose step 2 profiles the same two batches.

Host timers wrap ``torch.cuda.synchronize()`` (``utils.profiling.timed``).
The card's name and power limit are printed first; the last line is one
JSON object holding every number printed. Exits 2 without a CUDA card.
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


def wall_time(fn) -> float:
    """Wall seconds of one fenced call (``utils.profiling.timed``)."""
    from rust_msbwt_tpu_torch.utils.profiling import timed

    return timed(fn)[0]


def device_events(prof) -> list:
    """``prof.key_averages()``'s device-side events (kernels, copies, fills):
    not the CPU ops that launched them, nor the device-side copies of the
    port's ``msbwt.*`` spans, which carry the same time again."""
    from rust_msbwt_tpu_torch.utils.profiling import device_us

    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("msbwt.")]


def profiled(torch, fn, label: str, top: int, groups: dict | None = None,
             columns: int = 0) -> dict:
    """Run ``fn()`` once unprofiled (its wall time: the profiler's CPU
    tracing slows every launch) and once under ``torch.profiler`` (its
    summed device time, device events and top events); print and return
    them. ``groups``: ``{label: predicate}`` on lower-case event names;
    also the device time and share of each group. ``columns``: the BCR
    columns ``fn`` runs; also the device events a column."""
    from torch.profiler import ProfilerActivity, profile

    from rust_msbwt_tpu_torch.utils.profiling import device_us

    wall = wall_time(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall = wall_time(fn)
    evts = device_events(prof)
    evts.sort(key=device_us, reverse=True)
    dev_s = sum(device_us(e) for e in evts) * 1e-6
    n_events = sum(e.count for e in evts)
    log(f"[{label}] wall {wall:.4f} s ({prof_wall:.4f} s profiled), device "
        f"{dev_s:.4f} s in {n_events} events, device idle "
        f"{100 * (1 - dev_s / wall):.1f}% of the unprofiled wall time")
    rows = []
    for e in evts[:top]:
        ms = device_us(e) * 1e-3
        rows.append({"name": e.key[:100], "count": e.count, "ms": ms})
        log(f"[{label}]   {ms:10.3f} ms  x{e.count:<5d} {e.key[:100]}")
    if not evts:
        log(f"[{label}] the profiler recorded no device time")
    out = {"wall_s": wall, "profiled_wall_s": prof_wall, "device_s": dev_s,
           "device_events": n_events, "idle_share": 1 - dev_s / wall, "top": rows}
    if columns:
        out["events_a_column"] = n_events / columns
        log(f"[{label}] {n_events / columns:.1f} device events a column over {columns} "
            "columns")
    for name, pred in (groups or {}).items():
        part = sum(device_us(e) for e in evts if pred(e.key.lower())) * 1e-6
        n_part = sum(e.count for e in evts if pred(e.key.lower()))
        out[f"{name}_s"] = part
        out[f"{name}_share"] = part / dev_s if dev_s else None
        log(f"[{label}] {name} kernels: {part:.4f} s in {n_part} events, "
            f"{100 * part / dev_s if dev_s else 0:.1f}% of the device time")
    return out


QUERY_KERNELS = {"query": lambda k: "kmer_ranges_packed" in k or "kmer_counts_pair" in k}


def query_split(torch, np, dev, impl, kmers, cache, cache_k, entry, reps: int = 3) -> dict:
    """``ops.rank.count_batch``'s parts for one batch of full-length
    k-mers, each fenced and timed apart (median of ``reps``): the alphabet
    check, the upload of the k-mers and lengths, ``impl`` (the search on the
    card), the download and the int64 cast; and ``reps`` walls of the entry
    point ``entry()``."""
    from statistics import median

    from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
    from rust_msbwt_tpu_torch.utils.checks import validate_kmers
    from rust_msbwt_tpu_torch.utils.profiling import timed

    lengths = np.full(kmers.shape[0], kmers.shape[1], np.int32)
    parts = {k: [] for k in ("check", "upload", "search", "download", "int64", "entry")}
    for _ in range(reps):
        parts["check"].append(timed(lambda: (bool(np.all(kmers < VC_LEN)),
                                             validate_kmers(kmers, lengths)))[0])
        s, (km, ln) = timed(lambda: (torch.tensor(kmers, device=dev),
                                     torch.tensor(lengths, device=dev)))
        parts["upload"].append(s)
        s, out = timed(lambda: impl(km, ln, cache, cache_k))
        parts["search"].append(s)
        s, host = timed(lambda: out.cpu().numpy())
        parts["download"].append(s)
        parts["int64"].append(timed(lambda: host.astype(np.int64))[0])
        parts["entry"].append(timed(entry)[0])
    return {k: median(v) for k, v in parts.items()} | {"runs": parts}


def device_leg(torch, dev, impl, kmers, cache, cache_k, label: str, reps: int = 20) -> dict:
    """The search alone, as the JAX bench's ``query_qps_device``: ``impl``
    on k-mers and lengths already on the card, ``reps`` calls back to back
    inside one CUDA-event window (``utils.profiling.timeit``, one warm-up
    call): device seconds a batch and queries a second."""
    from rust_msbwt_tpu_torch.utils.profiling import timeit

    km = torch.tensor(kmers, device=dev)
    ln = torch.full((kmers.shape[0],), kmers.shape[1], dtype=torch.int32, device=dev)
    s = timeit(lambda: impl(km, ln, cache, cache_k), reps=reps)
    log(f"[{label}] device leg: {reps} searches on resident tensors, {s * 1e3:.4f} ms a batch "
        f"-> {kmers.shape[0] / s:.0f} q/s on the device")
    return {"device_s": s, "device_qps": kmers.shape[0] / s, "reps": reps}


def profile_correction(np, reads, count) -> dict:
    """``correct_reads(k=21, tau=2)`` of ``chip_smoke.py`` phase 10's
    10,000 reads with one substitution each, through an engine whose
    ``count_kmers`` is ``count(kmers, lengths)``: the wall, and the calls,
    k-mers and seconds spent in ``count`` (the batched searches, their host
    front included; the rest is the corrector's own host work)."""
    from chip_smoke import K, substituted_reads
    from rust_msbwt_tpu_torch.apps.correct import correct_reads
    from rust_msbwt_tpu_torch.models.core import BWTBase
    from rust_msbwt_tpu_torch.utils.profiling import timed

    calls = []

    class Engine(BWTBase):
        def count_kmers(self, kmers, lengths=None):
            s, out = timed(count, kmers, lengths)
            calls.append((s, len(kmers)))
            return out

    orig, bad = substituted_reads(np, reads)
    wall, (fixed, _) = timed(correct_reads, Engine(), bad, K, 2)
    count_s = sum(s for s, _ in calls)
    out = {"wall_s": wall, "reads_per_s": len(bad) / wall, "count_calls": len(calls),
           "count_kmers": sum(n for _, n in calls), "count_s": count_s,
           "count_share": count_s / wall,
           "equal_reads": int((fixed == orig).all(axis=1).sum())}
    log(f"[correction] correct_reads(k={K}, tau=2) of {len(bad)} reads: {wall:.3f} s -> "
        f"{out['reads_per_s']:.0f} reads/s; {len(calls)} count_kmers calls of "
        f"{out['count_kmers']} k-mers in all, {count_s:.3f} s ({out['count_share']:.1%} of "
        f"the wall); {out['equal_reads']} reads equal to their originals")
    return out


def profile_queries(torch, np, dev, idx, packed, kmers, top: int, reads=None) -> dict:
    """Step 2's query batches: 1M 21-mers through ``count_kmers_packed``
    with a 6^8 cache and through ``count_kmers_pair`` with a 6^9 cache (the
    pair index build profiled, the cache build timed first), each warmed,
    profiled and split (``query_split``); with ``reads``, the correction
    of 10,000 of them through pair + 6^9 (``profile_correction``)."""
    from rust_msbwt_tpu_torch.ops.packed_rank import _count_kmers_packed_impl, count_kmers_packed
    from rust_msbwt_tpu_torch.ops.pair_rank import (
        _count_kmers_pair_impl,
        build_pair_index,
        count_kmers_pair,
    )
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache

    out = {}
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
    count_kmers_packed(packed, kmers, cache=cache, cache_k=8)  # warm-up
    out["query"] = profiled(
        torch, lambda: count_kmers_packed(packed, kmers, cache=cache, cache_k=8),
        "1M queries", top, QUERY_KERNELS)
    out["query"]["split"] = query_split(
        torch, np, dev,
        lambda km, ln, c, ck: _count_kmers_packed_impl(packed.table, packed.starts, packed.n,
                                                       km, ln, cache=c, cache_k=ck),
        kmers, cache, 8, lambda: count_kmers_packed(packed, kmers, cache=cache, cache_k=8))
    out["query"]["device"] = device_leg(
        torch, dev, lambda km, ln, c, ck: _count_kmers_packed_impl(
            packed.table, packed.starts, packed.n, km, ln, cache=c, cache_k=ck),
        kmers, cache, 8, "1M queries")
    del cache
    out["pair_index"] = profiled(torch, lambda: build_pair_index(idx), "pair index build", top)
    pair = build_pair_index(idx)
    cache9_s = wall_time(lambda: build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 9))
    cache9 = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 9)
    log(f"[setup] 6^9 cache {cache9_s:.4f} s")
    count_kmers_pair(pair, kmers, cache=cache9, cache_k=9)  # warm-up
    out["query_pair"] = profiled(
        torch, lambda: count_kmers_pair(pair, kmers, cache=cache9, cache_k=9),
        "1M queries, pair + 6^9", top, QUERY_KERNELS)
    out["query_pair"]["cache9_s"] = cache9_s
    out["query_pair"]["split"] = query_split(
        torch, np, dev,
        lambda km, ln, c, ck: _count_kmers_pair_impl(pair.table2, pair.starts, pair.dmat,
                                                     pair.n, km, ln, cache=c, cache_k=ck),
        kmers, cache9, 9, lambda: count_kmers_pair(pair, kmers, cache=cache9, cache_k=9))
    out["query_pair"]["device"] = device_leg(
        torch, dev, lambda km, ln, c, ck: _count_kmers_pair_impl(
            pair.table2, pair.starts, pair.dmat, pair.n, km, ln, cache=c, cache_k=ck),
        kmers, cache9, 9, "1M queries, pair + 6^9")
    if reads is not None:
        out["correction"] = profile_correction(
            np, reads, lambda km, ln: count_kmers_pair(pair, km, ln, cache=cache9, cache_k=9))
    for key, label in (("query", "1M queries"), ("query_pair", "1M queries, pair + 6^9")):
        sp = out[key]["split"]
        log(f"[{label}] host split (median of 3): alphabet check {sp['check'] * 1e3:.3f} ms, "
            f"upload {sp['upload'] * 1e3:.3f} ms, search {sp['search'] * 1e3:.3f} ms, "
            f"download {sp['download'] * 1e3:.3f} ms, int64 cast {sp['int64'] * 1e3:.3f} ms; "
            f"entry point {sp['entry'] * 1e3:.3f} ms -> {kmers.shape[0] / sp['entry']:.0f} q/s; "
            f"device leg {out[key]['device']['device_s'] * 1e3:.4f} ms -> "
            f"{out[key]['device']['device_qps']:.0f} q/s")
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
    init_s = wall_time(lambda: _doubling_init(syms, sizes, False))
    rank, succ = _doubling_init(syms, sizes, False)
    out = profiled(torch, lambda: _doubling_round(rank, succ, False), "doubling round", top,
                   groups={"sort": lambda k: "sort" in k})
    out["init_s"] = init_s
    log(f"[doubling round] {syms.numel()} symbols in {N_PARTS} parts: init (psi sort + "
        f"first ranks) {init_s:.4f} s; one round {out['wall_s']:.4f} s")
    return out


# (L, new reads, base reads): one-shot builds of ~500M symbols, then 100k x
# 100 bp appends onto bases of 100 bp reads
SWEEP = ((250, 2_000_000, 0), (500, 1_000_000, 0), (1_000, 500_000, 0),
         *((100, 100_000, b) for b in (100_000, 400_000, 1_000_000, 4_000_000)))
SWEEP_ROUNDS = 3
# radix 2's column pairs among the device kernels: lf_pair's eight kernels
# (csrc/lf.cu pair_*_kernel) and its memset
PAIR_KERNELS = {"lf_pair": lambda k: "pair_" in k}


def last_pair(torch, dev, p, L: int, **onto):
    """One device stage loop at radix 2 on ``p`` (onto the base ``onto``
    gives ``_build_device``, if any), keeping the last column pair's
    ``lf_pair`` inputs (columns L and L + 1, or L - 1 and L for odd L);
    ``chip_smoke.pair_split`` then profiles ``lf_pair`` on them."""
    from chip_smoke import capture, radix_env
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    last = L - (L % 2)
    with radix_env(2), capture(bcr, "lf_pair", keep=lambda j, *a: j == last) as kept:
        bcr._build_device(p, dev, merge_insert, **onto)
    return kept.pop()


def radix_sweep(torch, np, dev, top: int) -> list:
    """Step 4: the device stage loop at radix 1 and radix 2 on each shape of
    ``SWEEP`` from the flagship genome (a one-shot build, or an append onto
    a base built first), one host prep each, with the radix the rule
    picks. ``SWEEP_ROUNDS`` rounds in turns, the order flipped each
    round; the median of the per-round ratios (radix 1 / radix 2), then one
    profiled loop per radix (device time, idle share, events a column, at
    radix 2 ``lf_pair``'s kernels timed apart) and ``lf_pair`` alone on the
    last pair's inputs (device ms and events a call, by kernel)."""
    from statistics import median

    from chip_smoke import genome_reads, loop_pair, pair_bytes, pair_split, pair_turns, radix_env
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW
    from rust_msbwt_tpu_torch.ops.bcr import (_build_device, _prepare_build,
                                              build_msbwt_with_index, build_radix)
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    rows = []
    for L, n_reads, n_base in SWEEP:
        reads, lengths = genome_reads(np, n_base + n_reads, L, 0x5EED + L + n_base)
        onto, n0 = {}, 0
        if n_base:
            base, bpacked = build_msbwt_with_index(reads[:n_base], lengths[:n_base],
                                                   device=dev)
            n0 = base.n
            onto = {"base": base.bwt[:n0], "base_index": bpacked, "base_rot_max": L + 1}
            del base
        p = _prepare_build(reads[n_base:], lengths[n_base:], True, n0, n_base)
        del reads, lengths

        def loop():
            return _build_device(p, dev, merge_insert, **onto)

        loops = {1: [], 2: []}
        for rnd in range(SWEEP_ROUNDS):
            for radix in ((1, 2) if rnd % 2 == 0 else (2, 1)):
                with radix_env(radix):
                    loops[radix].append(wall_time(loop))
        ratios = [a / b for a, b in zip(loops[1], loops[2])]
        row = {"L": L, "reads": n_reads, "base_reads": n_base, "symbols": p["n_cap"],
               "rule_radix": build_radix(p["n_cap"], n_reads), "loop_s": loops,
               "ratios": ratios, "median_ratio": median(ratios)}
        for radix in (1, 2):
            with radix_env(radix):
                row[f"profile_radix{radix}"] = profiled(
                    torch, loop, f"L={L} onto {n_base} reads, radix {radix}", top,
                    PAIR_KERNELS if radix == 2 else None, columns=L)
        args = last_pair(torch, dev, p, L, **onto)
        del p, onto
        label = f"L={L} onto {n_base} reads, columns {args[0]} and {args[0] + 1}"
        pair = loop_pair(dev)
        split = row["pair_a_call"] = pair_split(torch, label, pair, args)
        bound_bytes, rows_read = pair_bytes(torch, args)
        bound_ms = bound_bytes / DEFAULT_HBM_BW * 1e3
        row["pair_bound"] = {"bytes": bound_bytes, "rows": rows_read, "bound_ms": bound_ms,
                             "share": bound_ms / split["device_ms"]}
        log(f"[sweep] {label}: lf_pair device {split['device_ms']:.4f} ms in "
            f"{split['events']:.1f} events against its {bound_ms:.4f} ms bound ({bound_bytes} B: "
            f"{rows_read} distinct rows; {bound_ms / split['device_ms']:.1%} of it)")
        row["pair_parent"] = pair_turns(torch, label, pair, args)
        del args
        log(f"[sweep] L={L} ({n_reads} reads onto {n_base}, {row['symbols']} symbols, "
            f"{row['symbols'] / n_reads:.0f} a new read, the rule's radix "
            f"{row['rule_radix']}): device loop radix 1 "
            + " / ".join(f"{t:.4f}" for t in loops[1]) + " s, radix 2 "
            + " / ".join(f"{t:.4f}" for t in loops[2]) + " s; per-round ratios "
            + " / ".join(f"{r:.3f}" for r in ratios)
            + f", median {row['median_ratio']:.3f} (> 1: radix 2 faster)")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4,
                    help="back-to-back builds in one process (default 4)")
    ap.add_argument("--top", type=int, default=25,
                    help="device events listed per profile (default 25)")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the torch.profiler runs")
    ap.add_argument("--sweep-only", action="store_true",
                    help="run only step 4, the radix sweep")
    ap.add_argument("--queries", action="store_true",
                    help="run one build and step 2's query batches only")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): step 4 holds its "
                         "radix-2 step against lf_pair and times both in turns")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")

    import torch

    if not torch.cuda.is_available():
        print("profile_build: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke
    from chip_smoke import N_READS, READ_LEN, card_line, ecoli_config
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops.bcr import (
        _build_device,
        _cyclic_steps,
        _prepare_build,
        build_msbwt_with_index,
    )
    from rust_msbwt_tpu_torch.ops.lf import lf_walk_cyclic
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    smi = card_line()
    log(smi)
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.load()
    log(f"[setup] kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    if args.parent:
        parent_lib = chip_smoke.load_parent_kernels(args.parent)
        chip_smoke.PARENT_STEP2 = chip_smoke.load_parent_step2(
            args.parent, chip_smoke.load_parent_lf(args.parent, parent_lib))
    if args.sweep_only:
        print(json.dumps({"card": smi, "radix_sweep": radix_sweep(torch, np, dev, args.top)}))
        return 0
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
    if args.queries:
        result.update(profile_queries(torch, np, dev, idx, packed, kmers, args.top, reads))
    elif not args.no_profile:
        p = _prepare_build(reads, lengths, True)
        result["build_loop"] = profiled(
            torch, lambda: _build_device(p, dev, merge_insert), "build loop", args.top,
            columns=READ_LEN)
        del p
        result.update(profile_queries(torch, np, dev, idx, packed, kmers, args.top, reads))
        del idx, packed
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
            torch, lambda: lf_walk_cyclic(bpacked.table, bpacked.starts, base.n, cols, lens,
                                          steps, n_steps),
            "terminator walk", args.top)
        walk["steps"] = n_steps
        del cols, lens, steps
        loop = profiled(
            torch, lambda: _build_device(p, dev, merge_insert, base.bwt[: base.n],
                                         bpacked, READ_LEN + 1),
            "extend loop", args.top, columns=READ_LEN)
        del p
        entry_s = wall_time(lambda: build_msbwt_with_index(
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
        del reads, lengths, kmers
        result["radix_sweep"] = radix_sweep(torch, np, dev, args.top)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
