#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``rust_msbwt_tpu_torch/csrc`` and drives
its paths at the repo's flagship size (5M x 100 bp reads from a 4.6 Mbase
random genome, 505M BWT symbols, 1M 21-mer queries): the one-shot build
with index and k-mer counting, the streamed build, load-and-extend, read
recovery and the query side. It never falls back to the CPU and catches no
failure: any phase that fails ends the run with a traceback and a non-zero
exit code, and no result line.

Phases:
  1. card check (``nvidia-smi`` name and power limit; no CUDA -> exit 2)
  2. kernel build (time + ``-Xptxas -v``)
  3. merge-insert kernel against its plain PyTorch version on the card,
     exact, at small shapes, at the tile edge shapes of
     ``tests/test_torch_gpu.py`` and at one 505M-symbol pass with 5M
     inserts; times both (the kernel's prep included) against the pass's
     byte bound; with ``--parent DIR`` (a ``git archive`` of the parent
     commit) also the parent's Form 1 prep + kernel, in turns
  4. golden bytes: ``test_data/two_string.fa`` through the port's build CLI
     on ``cuda`` must give ``test_data/two_string.npy``
  5. 10k x 100 bp build on ``cuda``, byte-identical to the native reference
     builder (``csrc/msbwt_baseline.cpp``); then 10k reads extended by
     another 10k, once through the kernel and once through the plain merge:
     identical, and byte-identical to the native builder over all 20k
  6. the 505M main path: build with index through the kernel (launch counts
     reset just before), 6^8 prefix cache, 1M x 21-mer counts; the same
     build with the plain merge on the card must give the same BWT and
     table; 20k counts must equal the native reference query loop
  7. the streamed path: the same 5M reads in 5 batches of 1M through
     ``StreamingBuilder`` (counts reset just before), checkpointed after 4;
     the BWT must equal phase 6's
  8. the load-and-extend path: ``DynamicBWT.load_numpy_file`` of the
     404M-symbol checkpoint + ``insert_strings`` of the last 1M reads
     (counts reset just before) must equal phase 6's BWT; then the parts
     (index, read-length walk, terminator walk, extend build) timed apart
  9. recovery on phase 6's index: 100k reads extracted must equal those
     rows of the sorted reads; every hit of 1,000 located 21-mers must be
     where it says, with as many hits per query as phase 6 counted
 10. query tiers on phase 6's index and reads: the pair index, 6^9 and
     6^11 prefix caches and the run tier (from phase 6's RLE bytes), each
     built and timed; the 1M 21-mers counted through pair + 6^8, pair +
     6^9, pair + 6^11, run + 6^8 and packed + 6^9 must equal phase 6's
     counts. Then ``RleBWT.load_numpy_file`` of phase 6's BWT (counts reset
     just before) must pick pair + 6^9 by itself, launch the merge kernel
     and give the same counts; its query pack saved and loaded into a fresh
     engine gives them again. Last, 10,000 reads with one substitution each
     (an A, C, G or T turned into another of the four) must all come back
     equal to the originals from ``correct_reads(k=21, tau=2)`` on the card
 11. the H-M merge and the multi-device layer (``parallel/``), on phase 6's
     reads and BWT: (a) the sorted reads cut into 4 contiguous groups, as
     ``build_msbwt_sharded`` cuts them for D = 4, each built on the card
     through the kernel (counts reset just before), then
     ``multiway_bwt_merge`` of the four with sources: equal to phase 6's
     BWT byte for byte (wall time, rounds, peak device memory, merged
     symbols/s); (b) two 1M-read partials (101M symbols each):
     ``pairwise_bwt_merge`` == ``multiway_bwt_merge`` == ``kway_merge``
     under ``MSBWT_TPU_MERGE=tree`` == a build of their 2M reads (rounds and
     time of each); (c) phase 6's reads as FASTA through ``python -m
     torch.distributed.run --nproc-per-node 1 -m
     rust_msbwt_tpu_torch.cli.build --distributed`` (NCCL, world size 1):
     its npy bytes == phase 6's BWT saved with ``save_bwt_runs``; (d) 50,000
     of the reads on 4 gloo ranks sharing ``cuda:0``
     (``tests/_torch_dist_worker.py``): ``build_msbwt_sharded`` (tree,
     sharded dense, sharded ragged), ``sharded_doubling_merge`` of the four
     groups' BWTs, ``count_kmers_sharded`` and ``count_kmers_partitioned``
     of 20,000 21-mers: every rank's result == the single-device build and
     counts on the card
 12. one JSON line of kernel results, then ``{"ok": true, "device": ...}``
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
BATCH, N_EXTRACT, N_LOCATE = 1_000_000, 100_000, 1_000
N_CORRECT = 10_000
N_PARTS, N_PAIR, N_GLOO, N_GLOO_KMERS = 4, 1_000_000, 50_000, 20_000  # phase 11
DEEP_K = 11  # the deepest prefix cache phase 10 builds


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
    perm = rng.permutation(n_ins)  # a stage's slots come in read order, not sorted
    return old, q[perm].astype(np.int32), v[perm], active[perm]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)


def load_parent_kernels(parent):
    """The parent commit's kernel library (the Form 1 pass: ``old, ins,
    tmap -> out, table``), built from ``parent``'s own sources into its own
    ``_build``; None when no parent checkout is given."""
    import importlib.util

    if not parent:
        return None
    path = os.path.join(parent, "rust_msbwt_tpu_torch", "_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod.load()


def phase_kernel(torch, dev, parent=None):
    """Phase 3: kernel == plain on the card, exact, at PR 1's shapes, the
    tile edge shapes and one 505M pass; times at the 505M stage shape, prep
    included (the inputs are on the card before the timed region). With a
    parent checkout, its Form 1 prep + kernel is timed in the same call, in
    turns (parent, new, new, parent)."""
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops.merge_insert import (
        insert_maps,
        merge_insert,
        merge_insert_slots,
    )

    from test_torch_gpu import EDGE_KINDS, _edge_case  # tests/ (on sys.path)

    tile = _kernels.load().msbwt_merge_tile()
    shapes = [
        ("sparse", lambda: merge_case(n_old=1_000_000, n_ins=10_000, seed=1, extra=37)),
        ("masked", lambda: merge_case(n_old=1_000_000, n_ins=20_000, seed=2, frac_active=0.5)),
        ("clustered", lambda: merge_case(n_old=300_000, n_ins=40_000, seed=3, clustered=True)),
        ("tiny", lambda: merge_case(n_old=50, n_ins=7, seed=4)),
        *[(f"edge {k}", lambda k=k: _edge_case(k, len(k), tile)) for k in EDGE_KINDS],
        ("505M", lambda: merge_case(n_old=N_READS * READ_LEN, n_ins=N_READS, seed=5)),
    ]
    parent_lib = load_parent_kernels(parent)
    max_err = 0
    times = {}
    for name, make in shapes:
        old, q, v, active = make()
        n, N = old.size, q.size
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        args = (t(old), t(q), t(v), t(active))
        del old
        new_k, tab_k, m_k = merge_insert(*args)
        new_p, tab_p, m_p = merge_insert_slots(*args)
        torch.cuda.synchronize()
        err = max(int((new_k.int() - new_p.int()).abs().max()) if n else 0,
                  int((tab_k.long() - tab_p.long()).abs().max()))
        max_err = max(max_err, err)
        log(f"[kernel] {name}: n={n} (n % 128 = {n % 128}, n % {tile} = {n % tile}) "
            f"inserts={int(m_k)} of {N} max_abs_err={err}")
        check(err == 0 and int(m_k) == int(m_p) == int(active.sum()),
              f"kernel != plain ({name})")
        if name == "505M":
            del new_p, tab_p
            times.update(time_505m(torch, args, new_k, tab_k, parent_lib, insert_maps,
                                   merge_insert, merge_insert_slots))
        del args, new_k, tab_k
    torch.cuda.empty_cache()
    return max_err, times


def time_505m(torch, args, new_k, tab_k, parent_lib, insert_maps, merge_insert,
              merge_insert_slots):
    """Times of the 505M pass: the kernel (prep included: it takes the slots),
    the plain version, and the parent's Form 1 prep + kernel in turns."""
    old_t, q_t, v_t, a_t = args
    n, N = old_t.shape[0], q_t.shape[0]
    out, tab = torch.empty_like(new_k), torch.empty_like(tab_k)
    nb = tab.shape[0] - 1
    bound_bytes = 2 * n + 6 * N + tab.numel() * 4  # old, q/v/active, new, table
    times = {"bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3}
    new_fn = lambda: merge_insert(*args, out=out, table=tab)  # noqa: E731
    turns = [("new", new_fn), ("new", new_fn)]
    if parent_lib is not None:
        ins = torch.empty(n + 1, dtype=torch.int8, device=old_t.device)
        tmap = torch.empty(n, dtype=torch.int32, device=old_t.device)
        scratch = torch.empty(parent_lib.msbwt_merge_insert_scratch_len(n),
                              dtype=torch.int32, device=old_t.device)
        stream = torch.cuda.current_stream(old_t.device).cuda_stream

        def parent_fn():  # PR 3's _build_device pass: insert_maps + Form 1 kernel
            insert_maps(n, q_t, v_t, a_t, ins=ins, tmap=tmap)
            err = parent_lib.msbwt_merge_insert(
                old_t.data_ptr(), ins.data_ptr(), tmap.data_ptr(), out.data_ptr(),
                tab.data_ptr(), scratch.data_ptr(), n, stream)
            check(err == 0, f"parent kernel launch: CUDA error {err}")

        parent_fn()
        torch.cuda.synchronize()
        check(torch.equal(out, new_k) and torch.equal(tab, tab_k),
              "parent Form 1 pass != the new pass")
        turns = [("parent", parent_fn), *turns, ("parent", parent_fn)]
    got = {"new": [], "parent": []}
    for who, fn in turns:
        got[who].append(cuda_ms(fn, 20))
    times["ms"] = sum(got["new"]) / len(got["new"])
    times["parent_ms"] = sum(got["parent"]) / 2 if got["parent"] else None
    times["plain_ms"] = cuda_ms(lambda: merge_insert_slots(*args, out=out, table=tab), 3)
    gbs = bound_bytes / (times["ms"] * 1e-3) / 1e9
    log(f"[kernel] 505M pass ({n} positions, {N} inserts, {nb} bins), prep included, "
        "inputs on the card: kernel " + " / ".join(f"{x:.4f}" for x in got["new"])
        + f" ms (mean {times['ms']:.4f}; bound {times['bound_ms']:.4f} ms for "
        f"{bound_bytes} B at 3.35 TB/s -> {times['bound_ms'] / times['ms']:.1%} of it, "
        f"{gbs:.1f} GB/s); plain {times['plain_ms']:.4f} ms")
    if got["parent"]:
        log("[kernel] parent Form 1 (insert_maps + kernel), turns parent/new/new/parent: "
            + " / ".join(f"{x:.4f}" for x in got["parent"])
            + f" ms (mean {times['parent_ms']:.4f}); new / parent = "
            f"{times['ms'] / times['parent_ms']:.3f}")
        check(times["ms"] < times["parent_ms"], "the new pass is not faster than Form 1")
    return times


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


def phase_extend_10k(torch, np, dev):
    """Phase 5b: 10k reads extended by another 10k (one 20k draw split in
    two, so the halves share a genome), kernel == plain == native."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_slots
    from rust_msbwt_tpu_torch.utils.native import baseline_build_native

    reads, lengths = make_reads(20_000, 100, 0xE17E)
    out = {}
    for name, merge in (("kernel", merge_insert), ("plain", merge_insert_slots)):
        before = merge_insert.launches
        base, _ = build_msbwt_with_index(reads[:10_000], lengths[:10_000],
                                         device=dev, merge=merge)
        t0 = time.perf_counter()
        out[name] = build_msbwt_with_index(reads[10_000:], lengths[10_000:], True,
                                           base.bwt[: base.n], 10_000,
                                           device=dev, merge=merge)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = merge_insert.launches - before
        log(f"[extend-10k] {name}: extend of 10k onto {base.n} symbols "
            f"{dt:.3f} s, merge kernel launches {launched}")
        check(launched > 0 if name == "kernel" else launched == 0,
              f"extend-10k ({name}): kernel launches {launched}")
    (idx_k, pk), (idx_p, pp) = out["kernel"], out["plain"]
    check(torch.equal(idx_k.bwt, idx_p.bwt) and torch.equal(pk.table, pp.table),
          "10k extend: kernel != plain merge")
    want = baseline_build_native(list(reads), sorted_insert=True)
    check(np.array_equal(idx_k.bwt[: idx_k.n].cpu().numpy(), want),
          "10k + 10k extend != native reference builder over 20k")
    log(f"[extend-10k] {idx_k.n} symbols: kernel == plain, byte-identical to "
        "csrc/msbwt_baseline.cpp over all 20k reads")


def median_s(torch, fn, reps=3):
    """Median wall seconds of ``fn()`` over ``reps`` calls (each ends in a
    host copy of its result, so no extra synchronize is needed)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def phase_main(torch, np, dev, reads, lengths, kmers):
    """Phase 6: the 505M main path through the kernel, then checks."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_slots
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache
    from rust_msbwt_tpu_torch.utils.native import (
        baseline_count_kmers_native,
        rle_encode_native,
    )

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
    q_s, counts = median_s(torch, lambda: count_kmers_packed(packed, kmers, cache=cache,
                                                             cache_k=8))
    launches = merge_insert.launches
    # --- end of the main path ---

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
                                             merge=merge_insert_slots)
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
    return launches, idx, packed, counts, cache, rle


def phase_stream(torch, np, dev, reads, lengths, idx, ckpt):
    """Phase 7: the streamed path, 5 x 1M batches; checkpoint after 4."""
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder

    n_batches = N_READS // BATCH
    builder = StreamingBuilder(device=dev)
    # --- the streamed path: counts reset just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_insert.launches = 0
    batch_s = []
    for b in range(n_batches):
        t0 = time.perf_counter()
        builder.add_batch(reads[b * BATCH: (b + 1) * BATCH],
                          lengths[b * BATCH: (b + 1) * BATCH])
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        if b == n_batches - 2:  # not timed: the load-and-extend phase's input
            t0 = time.perf_counter()
            builder.checkpoint(ckpt)
            ckpt_s = time.perf_counter() - t0
    launches = merge_insert.launches
    peak = torch.cuda.max_memory_allocated()
    # --- end of the streamed path ---
    stream_s = sum(batch_s)
    n_bases = int(lengths.sum())
    log(f"[stream] {n_batches} x {BATCH} reads: {stream_s:.3f} s -> "
        f"{n_bases / stream_s / 1e6:.2f} Mbases/s; per batch "
        + ", ".join(f"{t:.3f}" for t in batch_s)
        + f" s; peak device memory {peak / 2**30:.2f} GiB; merge kernel "
        f"launches {launches}")
    log(f"[stream] checkpoint after {n_batches - 1} batches: {ckpt_s:.3f} s, "
        f"{os.path.getsize(ckpt)} bytes")
    check(launches > 0, "the streamed path launched no merge kernel")
    got = builder.finish(device_out=True)
    check(torch.equal(got, idx.bwt[: idx.n]), "streamed BWT != one-shot BWT")
    log("[stream] BWT identical to the one-shot build")
    return launches


def phase_load_extend(torch, np, dev, reads, lengths, idx, ckpt):
    """Phase 8: load the 404M checkpoint, extend it by the last 1M reads."""
    from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.ops.rle import decode_symbols_device
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native
    from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes

    last = slice(N_READS - BATCH, N_READS)
    # --- the load-and-extend path: counts reset just before, read after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge_insert.launches = 0
    t0 = time.perf_counter()
    dyn = DynamicBWT(device=dev)
    dyn.load_numpy_file(ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dyn.insert_strings(list(reads[last]), True)
    got = dyn.device_index
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t0
    launches = merge_insert.launches
    peak = torch.cuda.max_memory_allocated()
    # --- end of the load-and-extend path ---
    log(f"[load-extend] load {load_s:.3f} s (npy read + device decode of "
        f"{dyn.get_total_size() - int(lengths[last].sum()) - BATCH} symbols); "
        f"insert {BATCH} reads + materialize {extend_s:.3f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB; merge kernel launches {launches}")
    check(launches > 0, "the load-and-extend path launched no merge kernel")
    check(got.n == idx.n and torch.equal(got.bwt[: got.n], idx.bwt[: idx.n]),
          "load + extend BWT != one-shot BWT")
    log("[load-extend] BWT identical to the one-shot build")
    del dyn, got

    # the same extend's parts, timed apart on a fresh load
    n_strings = N_READS - BATCH
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return res

    rle = timed("npy_read", lambda: load_bwt_bytes(ckpt))
    base = timed("device_decode", lambda: decode_symbols_device(rle, device=dev))
    bidx, bpacked = timed("index", lambda: bcr.index_from_symbols(base))
    rl = timed("read_lengths", lambda: bcr.read_lengths_from_bwt(bidx, n_strings, bpacked))
    check(rl.shape == (n_strings,) and int(rl.min()) == int(rl.max()) == READ_LEN,
          "recovered read lengths")
    timed("encode_reads", lambda: bcr.encode_reads(list(reads[last])))
    order = sort_rows_native(reads[last])
    tp = timed("terminator_positions", lambda: bcr.terminator_positions(
        bidx, reads[last][order], lengths[last][order], READ_LEN + 1, bpacked))
    check(tp.shape == (BATCH,) and bool((tp[1:] >= tp[:-1]).all()),
          "terminator ranks of sorted reads are sorted")
    ext = timed("extend_build", lambda: bcr.build_msbwt_with_index(
        reads[last], lengths[last], True, base, n_strings, READ_LEN + 1,
        device=dev, base_index=bpacked))
    check(torch.equal(ext[0].bwt[: ext[0].n], idx.bwt[: idx.n]),
          "extend build (known index and bound) != one-shot BWT")
    log("[load-extend] parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + " (encode_reads: the host packing insert_strings does; "
        "terminator_positions includes the host stage view of 1M reads; "
        "extend_build includes its own terminator walk)")
    return launches


def phase_recovery(torch, np, dev, reads, idx, packed, kmers, counts):
    """Phase 9: extract 100k reads and locate 1,000 21-mers on phase 6's index."""
    from rust_msbwt_tpu_torch.ops.bcr import read_lengths_from_bwt
    from rust_msbwt_tpu_torch.ops.extract import extract_reads, locate_kmers
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    sorted_reads = reads[sort_rows_native(reads)]
    ids = np.random.default_rng(0x1D5).integers(0, N_READS, N_EXTRACT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_max = int(read_lengths_from_bwt(idx, N_READS, packed).max())
    rl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = extract_reads(idx, ids, N_READS, l_max=l_max, packed=packed)
    ex_s = time.perf_counter() - t0
    check(l_max == READ_LEN and np.array_equal(np.stack(got), sorted_reads[ids]),
          "extracted reads != the sorted reads' rows")
    log(f"[recovery] read-length walk over {N_READS} strings {rl_s:.3f} s; "
        f"extract {N_EXTRACT} reads {ex_s:.3f} s -> {N_EXTRACT / ex_s:.0f} reads/s "
        "(host out included); equal to the sorted reads")
    q_kmers = kmers[:N_LOCATE]
    t0 = time.perf_counter()
    q, rid, off = locate_kmers(idx, q_kmers, N_READS, l_max=l_max, packed=packed)
    loc_s = time.perf_counter() - t0
    where = sorted_reads[rid[:, None], off[:, None] + np.arange(K)[None, :]]
    check(bool((where == q_kmers[q]).all()), "a located hit is not its k-mer")
    check(np.array_equal(np.bincount(q, minlength=N_LOCATE), counts[:N_LOCATE]),
          "hits per query != phase 6 counts")
    log(f"[recovery] locate {N_LOCATE} x {K}-mers: {q.size} hits in {loc_s:.3f} s "
        f"-> {q.size / loc_s:.0f} hits/s (host in/out included); every hit "
        "checked, hits per query == phase 6 counts")


def phase_query_tiers(torch, np, dev, reads, idx, packed, kmers, counts, cache8, rle, d):
    """Phase 10: the query side at 505M on phase 6's index and reads."""
    from rust_msbwt_tpu_torch.apps.correct import correct_reads
    from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache
    from rust_msbwt_tpu_torch.ops.run_rank import (
        build_kmer_cache_runs,
        build_run_index_from_bytes,
        count_kmers_runs,
    )
    from rust_msbwt_tpu_torch.utils.npy import save_bwt_bytes

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    torch.cuda.reset_peak_memory_stats()
    pair_s, pair = timed(lambda: build_pair_index(idx))
    c9_s, cache9 = timed(lambda: build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 9))
    c11_s, cache11 = timed(lambda: build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n,
                                                    DEEP_K))
    run_s, run = timed(lambda: build_run_index_from_bytes(rle, device=dev))
    rc8_s, rcache8 = timed(lambda: build_kmer_cache_runs(run, 8))
    check(torch.equal(rcache8.lo, cache8.lo) and torch.equal(rcache8.hi, cache8.hi),
          "run-tier 6^8 cache != occ-index 6^8 cache")
    log(f"[tiers] pair index {pair_s:.3f} s ({nbytes(pair.table2) / 2**30:.3f} GiB); "
        f"6^9 cache {c9_s:.3f} s ({nbytes(cache9.lo, cache9.hi) / 2**30:.3f} GiB); "
        f"6^{DEEP_K} cache {c11_s:.3f} s ({nbytes(cache11.lo, cache11.hi) / 2**30:.3f} GiB); "
        f"run tier {run_s:.3f} s from {rle.size} RLE bytes ({run.device_bytes() / 2**30:.3f} "
        f"GiB, {int(run.table.shape[0]) - 2} rows); run-tier 6^8 cache {rc8_s:.3f} s "
        f"(== the occ-index 6^8 cache); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    legs = [
        ("pair + 6^8", lambda: count_kmers_pair(pair, kmers, cache=cache8, cache_k=8)),
        ("pair + 6^9", lambda: count_kmers_pair(pair, kmers, cache=cache9, cache_k=9)),
        (f"pair + 6^{DEEP_K}", lambda: count_kmers_pair(pair, kmers, cache=cache11,
                                                        cache_k=DEEP_K)),
        ("run + 6^8", lambda: count_kmers_runs(run, kmers, cache=rcache8, cache_k=8)),
        ("packed + 6^9", lambda: count_kmers_packed(packed, kmers, cache=cache9, cache_k=9)),
    ]
    qps = {}
    for name, fn in legs:
        s, got = median_s(torch, fn)
        check(np.array_equal(got, counts), f"{name} counts != phase 6 counts")
        qps[name] = N_QUERIES / s
        log(f"[tiers] 1M x {K}-mer counts, {name}: median {s:.4f} s -> {qps[name]:.0f} q/s "
            "(host in/out included); equal to phase 6")
    del cache11, run, rcache8

    # RleBWT from disk: the tier policy picks pair + 6^9 by itself
    npy = os.path.join(d, "bwt505.npy")
    save_bwt_bytes(rle, npy)
    torch.cuda.synchronize()
    merge_insert.launches = 0
    t0 = time.perf_counter()
    bwt = RleBWT(device=dev)
    bwt.load_numpy_file(npy)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = bwt.count_kmers(kmers)
    first_s = time.perf_counter() - t0
    launches = merge_insert.launches
    tier_ok = bwt._pair_index is not None and bwt._cache_k == 9 and bwt._run_index is None
    log(f"[tiers] RleBWT.load_numpy_file {load_s:.3f} s (npy read + the host pass over "
        f"the RLE bytes); first count_kmers {first_s:.3f} s (device decode, index, pair "
        f"index, 6^9 cache, 1M counts); tier pair + 6^{bwt._cache_k}; merge kernel "
        f"launches {launches}")
    check(tier_ok, "RleBWT did not pick pair + 6^9 at 505M")
    check(launches >= 1, "RleBWT's load launched no merge kernel")
    check(np.array_equal(got, counts), "RleBWT counts != phase 6 counts")
    s, got = median_s(torch, lambda: bwt.count_kmers(kmers))
    check(np.array_equal(got, counts), "RleBWT counts != phase 6 counts")
    log(f"[tiers] RleBWT.count_kmers warm: median {s:.4f} s -> {N_QUERIES / s:.0f} q/s")
    pack = os.path.join(d, "bwt505.pack")
    save_s, _ = timed(lambda: bwt.save_query_indexes(pack))
    del bwt
    fresh = RleBWT(device=dev)
    fresh.load_numpy_file(npy)
    pack_s, _ = timed(lambda: fresh.load_query_indexes(pack))
    got = fresh.count_kmers(kmers)
    check(fresh._device_index is None, "the pack load re-derived the device index")
    check(np.array_equal(got, counts), "counts after the pack load != phase 6 counts")
    log(f"[tiers] query pack {os.path.getsize(pack)} bytes: save {save_s:.3f} s, "
        f"load {pack_s:.3f} s (after the npy load); counts equal phase 6")

    # correction: one substitution in each of 10,000 reads
    rng = np.random.default_rng(0xC0EC7)
    orig = reads[:N_CORRECT].copy()
    bad = orig.copy()
    dna = np.array([1, 2, 3, 5], np.uint8)
    for i in range(N_CORRECT):
        p = rng.choice(np.flatnonzero(orig[i] != 4))
        bad[i, p] = rng.choice(dna[dna != orig[i, p]])
    t0 = time.perf_counter()
    fixed, n_fixed = correct_reads(fresh, bad, k=K, tau=2)
    corr_s = time.perf_counter() - t0
    n_equal = int((fixed == orig).all(axis=1).sum())
    log(f"[tiers] correct_reads(k={K}, tau=2) of {N_CORRECT} reads: {corr_s:.3f} s -> "
        f"{N_CORRECT / corr_s:.0f} reads/s; {n_fixed} bases fixed, {n_equal} reads equal "
        "to their originals")
    check(n_equal == N_CORRECT, "a corrected read differs from its original")
    return launches


def phase_merge_parts(torch, np, dev, reads, lengths, idx):
    """Phase 11a: the sorted reads in four groups, built through the kernel
    (launches counted), merged in one doubling run == phase 6's BWT."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.ops.merge import multiway_bwt_merge
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    order = sort_rows_native(reads)
    s_reads, s_lengths = reads[order], lengths[order]
    nl = -(-N_READS // N_PARTS)
    # --- the parts' builds: counts reset just before, read just after ---
    torch.cuda.synchronize()
    merge_insert.launches = 0
    t0 = time.perf_counter()
    parts = [build_msbwt(s_reads[g * nl: (g + 1) * nl], s_lengths[g * nl: (g + 1) * nl],
                         device=dev, device_out=True) for g in range(N_PARTS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = merge_insert.launches
    # --- end of the parts' builds ---
    del s_reads, s_lengths
    check(launches > 0, "the parts' builds launched no merge kernel")
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    merged, srcs = multiway_bwt_merge(parts, return_sources=True, stats=stats)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(merged, idx.bwt[: idx.n]), "4-part merge != phase 6's BWT")
    sizes = [int(p.numel()) for p in parts]
    check(srcs.dtype == torch.int32
          and torch.bincount(srcs.long(), minlength=N_PARTS).tolist() == sizes,
          "merged source ids do not count the parts' sizes")
    log(f"[merge-parts] {N_PARTS} groups of sorted reads built in {build_s:.3f} s "
        f"({sizes} symbols; merge kernel launches {launches}); multiway_bwt_merge "
        f"{merge_s:.3f} s, {stats['rounds']} rounds -> {idx.n / merge_s / 1e6:.1f}M merged "
        f"symbols/s; peak device memory {peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.2f} "
        f"GiB above the {resident / 2**30:.2f} GiB resident); equal to phase 6's BWT, "
        "source ids count the parts")
    return launches


def phase_pairwise(torch, np, dev, reads, lengths):
    """Phase 11b: two 1M-read partials: H-M == doubling == the H-M tree ==
    a build of their 2M reads."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.ops.merge import kway_merge, multiway_bwt_merge, pairwise_bwt_merge

    halves = [build_msbwt(reads[i * N_PAIR: (i + 1) * N_PAIR],
                          lengths[i * N_PAIR: (i + 1) * N_PAIR], device=dev, device_out=True)
              for i in range(2)]
    want = build_msbwt(reads[: 2 * N_PAIR], lengths[: 2 * N_PAIR], device=dev, device_out=True)

    def tree(st):
        os.environ["MSBWT_TPU_MERGE"] = "tree"
        try:
            return kway_merge(halves, stats=st)
        finally:
            del os.environ["MSBWT_TPU_MERGE"]

    out = {}
    for name, fn in (("pairwise_bwt_merge", lambda st: pairwise_bwt_merge(*halves, stats=st)),
                     ("multiway_bwt_merge", lambda st: multiway_bwt_merge(halves, stats=st)),
                     ("kway_merge (tree)", tree)):
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(st)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "rounds": st["rounds"]}
        check(torch.equal(got, want), f"{name} of two 1M-read partials != their build")
    log(f"[pairwise] two partials of {[int(h.numel()) for h in halves]} symbols: "
        + "; ".join(f"{k} {v['s']:.3f} s, {v['rounds']} rounds" for k, v in out.items())
        + "; all equal to the build of the 2M reads")
    return out


def write_fasta(np, reads, path):
    """The reads (fixed length, symbols 1..5) as FASTA records ``>r``."""
    n, width = reads.shape
    rec = np.empty((n, width + 4), np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rec[:, 3: 3 + width] = np.frombuffer(b"$ACGNT", np.uint8)[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def phase_distributed_cli(np, idx, reads, d):
    """Phase 11c: ``msbwt2-build --distributed`` under torchrun, NCCL, world
    size 1, at full width: its npy == phase 6's BWT through save_bwt_runs."""
    import re

    from rust_msbwt_tpu_torch.ops.rle import runs_from_symbols
    from rust_msbwt_tpu_torch.utils.npy import save_bwt_runs
    from _torch_dist_worker import free_port  # tests/ (on sys.path)

    fa, out, want = (os.path.join(d, f) for f in ("reads.fa", "dist.npy", "want.npy"))
    write_fasta(np, reads, fa)
    save_bwt_runs(*runs_from_symbols(idx.bwt[: idx.n].cpu().numpy()), want)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "rust_msbwt_tpu_torch.cli.build", "--distributed", "-o", out, fa]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stderr[-4000:], file=sys.stderr)
    check(res.returncode == 0, f"torchrun --distributed build exited {res.returncode}")
    found = re.search(r"over (\w+) .*\n(?s:.*)merge kernel launches (\d+)", res.stderr)
    check(found is not None, "the distributed build logged no backend or launch count")
    backend, launches = found.group(1), int(found.group(2))
    same = open(out, "rb").read() == open(want, "rb").read()
    check(same, "distributed build npy != phase 6's BWT")
    check(backend == "nccl" and launches > 0,
          f"distributed build: backend {backend}, merge kernel launches {launches}")
    # the child's own log clock: its start, group joined, records parsed,
    # BWT built and merged, file written
    marks = ["Input parameters", "torch.distributed: rank", "records [", "symbols merged",
             "Processes successfully finished"]
    stamps = []
    for mark in marks:
        line = next(ln for ln in res.stderr.splitlines() if mark in ln)
        stamps.append(time.mktime(time.strptime(line[1:20], "%Y-%m-%d %H:%M:%S"))
                      + int(line[21:24]) / 1e3)
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    log(f"[distributed] torchrun --nproc-per-node 1 ... cli.build --distributed on "
        f"{os.path.getsize(fa)} bytes of FASTA: child wall {wall:.3f} s (its log: group "
        f"join {steps[0]:.3f} s, FASTA parse {steps[1]:.3f} s, build + merge {steps[2]:.3f} s, "
        f"RLE + write {steps[3]:.3f} s), backend {backend}, world size 1, merge kernel "
        f"launches {launches}; npy ({os.path.getsize(out)} bytes) identical to phase 6's BWT")
    return launches, wall


def phase_gloo_ranks(torch, np, dev, reads, lengths, d):
    """Phase 11d: 4 gloo ranks sharing cuda:0 on 50,000 reads: every
    parallel/ path == the single-device build and counts on the card."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt, build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native
    from _torch_dist_worker import run_ranks  # tests/ (on sys.path)

    reads, lengths = reads[:N_GLOO], lengths[:N_GLOO]
    rng = np.random.default_rng(0x610)
    rows = rng.integers(0, N_GLOO, N_GLOO_KMERS)
    offs = rng.integers(0, READ_LEN - K + 1, N_GLOO_KMERS)
    kmers = reads[rows[:, None], offs[:, None] + np.arange(K)[None, :]]
    idx, packed = build_msbwt_with_index(reads, lengths, device=dev)
    dec = idx.bwt[: idx.n].cpu().numpy()
    counts = count_kmers_packed(packed, kmers)
    order = sort_rows_native(reads)
    nl = -(-N_GLOO // N_PARTS)
    parts = [build_msbwt(reads[order[g * nl: (g + 1) * nl]], lengths[order[g * nl: (g + 1) * nl]],
                         device=dev) for g in range(N_PARTS)]
    inputs = dict(reads=reads, lengths=lengths, kmers=kmers,
                  klens=np.full(N_GLOO_KMERS, K, np.int32), decoded=dec,
                  parts=np.concatenate(parts), part_sizes=np.array([p.size for p in parts]))
    cases = ["build_tree", "build_dense", "build_ragged", "doubling", "sharded_index",
             "partitioned"]
    t0 = time.perf_counter()
    ranks = run_ranks(N_PARTS, cases, inputs, d, device=str(dev), timeout_s=300)
    wall = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        for case in ("build_tree", "build_dense", "build_ragged", "doubling"):
            check(np.array_equal(out[f"{case}.bwt"], dec), f"gloo rank {r}: {case} != the build")
        for case in ("sharded_index", "partitioned"):
            check(np.array_equal(out[f"{case}.counts"], counts),
                  f"gloo rank {r}: {case} counts != the single-device counts")
    log(f"[gloo] backend gloo, {N_PARTS} ranks sharing {dev} (no collective staged through "
        f"the host): {N_GLOO} reads ({dec.size} symbols), {N_GLOO_KMERS} {K}-mers; "
        f"build_msbwt_sharded tree / sharded dense / sharded ragged, sharded_doubling_merge, "
        f"count_kmers_sharded and count_kmers_partitioned on every rank equal the "
        f"single-device build and counts; {wall:.3f} s with the ranks' start")
    return wall


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): phase 3 "
                         "also times its Form 1 merge pass, in turns with this one")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))  # the edge shapes, the gloo ranks
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

    max_err, times = phase_kernel(torch, dev, args.parent)
    phase_golden("cuda")
    phase_10k(np, dev)
    phase_extend_10k(torch, np, dev)
    reads, lengths, kmers = ecoli_config(np)
    launches, idx, packed, counts, cache8, rle = phase_main(torch, np, dev, reads,
                                                            lengths, kmers)
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "stream_ckpt.npy")
        launches_stream = phase_stream(torch, np, dev, reads, lengths, idx, ckpt)
        launches_load_extend = phase_load_extend(torch, np, dev, reads, lengths,
                                                 idx, ckpt)
    phase_recovery(torch, np, dev, reads, idx, packed, kmers, counts)
    with tempfile.TemporaryDirectory() as d:
        launches_query = phase_query_tiers(torch, np, dev, reads, idx, packed, kmers,
                                           counts, cache8, rle, d)
    del cache8, rle, packed
    launches_parts = phase_merge_parts(torch, np, dev, reads, lengths, idx)
    torch.cuda.empty_cache()
    phase_pairwise(torch, np, dev, reads, lengths)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        launches_dist, _ = phase_distributed_cli(np, idx, reads, d)
    with tempfile.TemporaryDirectory() as d:
        phase_gloo_ranks(torch, np, dev, reads, lengths, d)

    print(json.dumps({"kernels": [{
        "name": "merge_insert",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/merge_insert.cu",
        "replaces": "rust_msbwt_tpu/ops/pallas_merge.py:159",
        "launches": launches,
        "launches_stream": launches_stream,
        "launches_load_extend": launches_load_extend,
        "launches_query": launches_query,
        "launches_merge_parts": launches_parts,
        "launches_distributed": launches_dist,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "prep_included": True,
        "parent_ms": times["parent_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
