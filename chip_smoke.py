#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rust_msbwt_tpu_torch/csrc`` and drives
its main path — build with index, then k-mer counting — at the repo's
flagship size (5M x 100 bp reads from a 4.6 Mbase random genome, 505M BWT
symbols, 1M 21-mer queries). It never falls back to the CPU and catches no
failure: any phase that fails ends the run with a traceback and a non-zero
exit code, and no result line.

Phases:
  1. card check (``nvidia-smi`` name and power limit; no CUDA -> exit 2)
  2. kernel build (time + ``-Xptxas -v``)
  3. merge-insert kernel against its plain PyTorch twin on the card, exact,
     at small shapes and at one 505M-symbol pass with 5M inserts; times both
  4. golden bytes: ``test_data/two_string.fa`` through the port's build CLI
     on ``cuda`` must give ``test_data/two_string.npy``
  5. 10k x 100 bp build on ``cuda``, byte-identical to the native reference
     builder (``csrc/msbwt_baseline.cpp``)
  6. the 505M main path: build with index through the kernel (launch counts
     reset just before), 6^8 prefix cache, 1M x 21-mer counts; the same
     build with the plain merge on the card must give the same BWT and
     table; 20k counts must equal the native reference query loop
  7. one JSON line of kernel results, then ``{"ok": true, "device": ...}``
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_READS, READ_LEN, K, N_QUERIES, N_CHECK = 5_000_000, 100, 21, 1_000_000, 20_000


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def make_reads(n_reads, read_len, seed):
    """10k-read config: reads from a random 200 kbase genome (bench.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 6, size=200_000).astype(np.uint8)
    starts = rng.integers(0, genome.size - read_len, n_reads)
    reads = np.stack([genome[s: s + read_len] for s in starts])
    return reads, np.full(n_reads, read_len, dtype=np.int32)


def ecoli_config(np):
    """The flagship read set: 5M x 100 bp reads from a random 4.6 Mbase
    genome (seed 0xEC011, bench.py's large leg), and 1M 21-mer queries drawn
    from the reads. Returns ``(reads, lengths, kmers)``."""
    rng = np.random.default_rng(0xEC011)
    genome = rng.integers(1, 6, size=4_600_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - READ_LEN, N_READS)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    lengths = np.full(N_READS, READ_LEN, np.int32)
    rows = rng.integers(0, N_READS, N_QUERIES)
    offs = rng.integers(0, READ_LEN - K + 1, N_QUERIES)
    kmers = reads[rows[:, None], offs[:, None] + np.arange(K)[None, :]]
    return reads, lengths, kmers


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def merge_case(n_old, n_ins, seed, frac_active=1.0, clustered=False, extra=0):
    """Inputs of one merge pass, made on the host from a seed: old buffer
    (PAD past n_old), insert slots q (distinct, valid where active), v."""
    import numpy as np

    rng = np.random.default_rng(seed)
    active = rng.random(n_ins) < frac_active
    m = int(active.sum())
    if clustered:
        q = n_old // 3 + np.arange(n_ins)
    else:  # sorted insertion points + rank: distinct slots, as a stage makes
        q = np.sort(rng.integers(0, n_old + 1, n_ins)) + np.arange(n_ins)
        q = np.where(active, q - np.cumsum(~active), q)  # pack the actives
    n_cap = n_old + m + extra
    old = np.full(n_cap, 7, np.uint8)
    old[:n_old] = rng.integers(0, 6, n_old)
    v = rng.integers(0, 6, n_ins).astype(np.uint8)
    return old, q.astype(np.int32), v, active


def phase_kernel(torch, dev):
    """Phase 3: kernel == plain on the card; times at the 505M stage shape."""
    from rust_msbwt_tpu_torch.ops.merge_insert import (
        insert_maps,
        merge_insert,
        merge_insert_plain,
    )

    shapes = [
        ("sparse", dict(n_old=1_000_000, n_ins=10_000, seed=1, extra=37)),
        ("masked", dict(n_old=1_000_000, n_ins=20_000, seed=2, frac_active=0.5)),
        ("clustered", dict(n_old=300_000, n_ins=40_000, seed=3, clustered=True)),
        ("tiny", dict(n_old=50, n_ins=7, seed=4)),
        ("505M", dict(n_old=N_READS * READ_LEN, n_ins=N_READS, seed=5)),
    ]
    max_err = 0
    times = {}
    for name, kw in shapes:
        old, q, v, active = merge_case(**kw)
        n = old.size
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        old_t = t(old)
        ins, tmap, m = insert_maps(n, t(q), t(v), t(active))
        ins = ins[:n]
        new_k, tab_k = merge_insert(old_t, ins, tmap)
        new_p, tab_p = merge_insert_plain(old_t, ins, tmap)
        torch.cuda.synchronize()
        err = max(int((new_k.int() - new_p.int()).abs().max()),
                  int((tab_k.long() - tab_p.long()).abs().max()))
        max_err = max(max_err, err)
        log(f"[kernel] {name}: n={n} (n % 128 = {n % 128}) inserts="
            f"{int(m)} max_abs_err={err}")
        check(err == 0 and int(m) == int(active.sum()), f"kernel != plain ({name})")
        if name == "505M":
            out, tab = torch.empty_like(new_k), torch.empty_like(tab_k)
            del new_k, new_p, tab_k, tab_p
            times["ms"] = cuda_ms(lambda: merge_insert(old_t, ins, tmap, out=out,
                                                       table=tab), 20)
            times["plain_ms"] = cuda_ms(lambda: merge_insert_plain(
                old_t, ins, tmap, out=out, table=tab), 3)
            times["prep_ms"] = cuda_ms(lambda: insert_maps(n, t(q), t(v), t(active)), 3)
            gbs = 8 * n / (times["ms"] * 1e-3) / 1e9
            log(f"[kernel] 505M pass: kernel {times['ms']:.4f} ms "
                f"(~8 B/position -> {gbs:.1f} GB/s), plain {times['plain_ms']:.4f} ms, "
                f"prep (insert maps, torch ops, incl. upload) {times['prep_ms']:.4f} ms")
        del old_t, ins, tmap
    torch.cuda.empty_cache()
    return max_err, times


def phase_golden(dev_name):
    """Phase 4: golden bytes through the port's build CLI on the card."""
    from rust_msbwt_tpu_torch.cli.build import main as build_main

    fa = os.path.join(HERE, "test_data", "two_string.fa")
    want = open(os.path.join(HERE, "test_data", "two_string.npy"), "rb").read()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.npy")
        rc = build_main(["--device", dev_name, "-o", out, fa])
        got = open(out, "rb").read()
    check(rc == 0 and got == want, "golden two_string.npy bytes")
    log("[golden] two_string.fa -> two_string.npy bytes identical")


def phase_10k(np, dev):
    """Phase 5: 10k x 100 bp on the card == the native reference builder."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.utils.native import baseline_build_native

    reads, lengths = make_reads(10_000, 100, 0xBEEF)
    t0 = time.perf_counter()
    got = build_msbwt(reads, lengths, device=dev)
    dt = time.perf_counter() - t0
    want = baseline_build_native(list(reads), sorted_insert=True)
    check(want is not None, "native reference builder unavailable")
    check(np.array_equal(got, want), "10k build != native reference builder")
    log(f"[10k] build {dt:.3f} s on the card, {got.size} symbols, "
        "byte-identical to csrc/msbwt_baseline.cpp")


def phase_main(torch, np, dev):
    """Phase 6: the 505M main path through the kernel, then checks."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_plain
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache
    from rust_msbwt_tpu_torch.utils.native import (
        baseline_count_kmers_native,
        rle_encode_native,
    )

    reads, lengths, kmers = ecoli_config(np)
    n_bases = int(lengths.sum())

    # --- the main path: counts reset just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_insert.launches = 0
    t0 = time.perf_counter()
    idx, packed = build_msbwt_with_index(reads, lengths, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    q_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        counts = count_kmers_packed(packed, kmers, cache=cache, cache_k=8)
        q_times.append(time.perf_counter() - t0)
    launches = merge_insert.launches
    # --- end of the main path ---

    q_s = sorted(q_times)[1]
    log(f"[main] build+index {build_s:.3f} s for {idx.n} symbols -> "
        f"{n_bases / build_s / 1e6:.2f} Mbases/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; merge kernel launches {launches}")
    log(f"[main] 6^8 cache {cache_s:.3f} s; 1M x {K}-mer counts median "
        f"{q_s:.3f} s -> {N_QUERIES / q_s:.0f} q/s (host in/out included); "
        f"mean count {counts.mean():.2f}")
    check(launches > 0, "the main path launched no merge kernel")
    check(idx.n == n_bases + N_READS, "BWT length")
    check(counts.shape == (N_QUERIES,) and counts.min() >= 1,
          "every query k-mer occurs in the reads")

    t0 = time.perf_counter()
    idx_p, packed_p = build_msbwt_with_index(reads, lengths, device=dev,
                                             merge=merge_insert_plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(torch.equal(idx.bwt, idx_p.bwt) and torch.equal(packed.table, packed_p.table),
          "505M build: kernel != plain merge")
    log(f"[main] same build with the plain merge on the card: {plain_s:.3f} s; "
        "BWT and packed table identical")
    del idx_p, packed_p

    bwt_host = idx.bwt[: idx.n].cpu().numpy()
    rle = rle_encode_native(bwt_host)
    check(rle is not None, "native RLE encoder unavailable")
    t0 = time.perf_counter()
    want = baseline_count_kmers_native(rle, kmers[:N_CHECK])
    base_s = time.perf_counter() - t0
    check(np.array_equal(counts[:N_CHECK], want),
          f"{N_CHECK} counts != native reference query loop")
    log(f"[main] {N_CHECK} counts equal csrc/msbwt_baseline.cpp "
        f"({base_s:.2f} s incl. its index build)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        from rust_msbwt_tpu_torch import _kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    smi = card_line()
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}; {kind}")
    log(smi)

    t0 = time.perf_counter()
    ptxas = _kernels.build()
    _kernels.load()
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")
    log(ptxas.strip() or "(library up to date: not rebuilt)")

    max_err, times = phase_kernel(torch, dev)
    phase_golden("cuda")
    phase_10k(np, dev)
    launches = phase_main(torch, np, dev)

    print(json.dumps({"kernels": [{
        "name": "merge_insert",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/merge_insert.cu",
        "replaces": "rust_msbwt_tpu/ops/pallas_merge.py:159",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
