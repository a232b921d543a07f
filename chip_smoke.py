#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``rust_msbwt_tpu_torch/csrc`` and drives
its paths at the repo's flagship size (5M x 100 bp reads from a 4.6 Mbase
random genome, 505M BWT symbols, 1M 21-mer queries): the one-shot build
with index and k-mer counting, the streamed build, load-and-extend, read
recovery, the query side and the merges; then long reads (500k x 1,000 bp)
at radix 1 and 2 and the query-tier budget at 1.515G symbols. Every path
runs through the merge-insert kernel and the LF-step kernels (``lf_stage``
a column, ``lf_pair`` a radix-2 column pair, ``lf_walk`` a walk), and every
k-mer search through the query
kernels (``kmer_ranges_packed``, ``kmer_counts_pair``: one a batch); each
path resets every kernel's launch count just before it and reads them just
after. It never falls back to the CPU and catches no
failure: any phase that fails ends the run with a traceback and a non-zero
exit code, and no result line.

Phases:
  1. card check (``nvidia-smi`` name and power limit; no CUDA -> exit 2)
  2. kernel build (time + ``-Xptxas -v``), then ``session_health`` (dispatch
     round trip, memory rate)
  3. merge-insert kernel against its plain PyTorch version on the card,
     exact, at small shapes, at the tile edge shapes of
     ``tests/test_torch_gpu.py`` and at one 505M-symbol pass with 5M
     inserts; times both (the kernel's prep included) against the pass's
     byte bound; with ``--parent DIR`` (a ``git archive`` of the parent
     commit) also the parent's own merge pass (its kernel library, built
     from its sources, called by the Form 2 contract), in turns
  3b. the LF-step kernels against their plain twins on the card, exact:
     ``lf_stage`` at the edge shapes of ``tests/test_torch_gpu.py`` (N = 1,
     every read inactive, P == n with n % 128 == 0, the last bin, ragged,
     N = 1.1M past the grid cap), ``lf_pair`` at its column-pair cases
     (slots on tile edges, full and empty tiles, tiles at their bucket's
     edges, clustered and many overfull tiles, N = 1, m2 = 0, ragged, 1.1M
     reads) and the four ``lf_walk`` walks on its two walk cases; the query
     kernels against their twins, exact, at the query
     edge shapes of ``tests/test_torch_gpu.py`` (B = 1, B = 0, every query
     absent, n % 128 == 0, ragged lengths, caches 6^8 / 6^9 / 6^11, 1.1M
     queries, warps mixing early stops, full queries and tails, batch sizes
     at the lane-group, warp and block edges), both tiers; with
     ``--parent``, the parent's query kernels on the same tensors too, exact
  4. golden bytes: ``test_data/two_string.fa`` through the port's build CLI
     on ``cuda`` must give ``test_data/two_string.npy``
  5. 10k x 100 bp build on ``cuda``, byte-identical to the native reference
     builder (``csrc/msbwt_baseline.cpp``); then 10k reads extended by
     another 10k, once through the kernels and once through the plain merge
     and LF step (no kernel launched): identical, and byte-identical to the
     native builder over all 20k
  6. the 505M main path: build with index through the kernels (launch counts
     reset just before), 6^8 prefix cache, 1M x 21-mer counts; the same
     build with the plain merge and LF step on the card must give the same
     BWT and table; 20k counts must equal the native reference query loop;
     100 ``lf_stage`` launches and no walk; the three 1M-count batches
     three ``kmer_ranges_packed`` launches and no ``kmer_counts_pair``
  6b. ``lf_stage`` at full size: phase 6's reads built once more with the
     inputs of columns 50 and 90 kept (the 505M loop's tables, 5M reads),
     kernel == plain on column 90's, both timed against the bytes the column
     must move
  6c. one card used by two callers at once: ``lf_stage`` on two streams,
     one a kept column, 32 launches a stream queued behind a spin kernel so
     that the grids overlap: every repetition == the twin, with a scratch a
     stream (the stage loop's way) and a scratch a call (the wrapper's
     default); with ``--parent`` the parent's ``lf_stage`` on the same hold,
     its repetitions that differ logged, not checked. Then two one-shot
     505M builds at once from two threads, each under its own stream
     (counts reset just before): both BWTs == phase 6's, byte for byte
  7. the streamed path: the same 5M reads in 5 batches of 1M through
     ``StreamingBuilder`` (counts reset just before), checkpointed after 4;
     the BWT must equal phase 6's
  8. the load-and-extend path: ``DynamicBWT.load_numpy_file`` of the
     404M-symbol checkpoint + ``insert_strings`` of the last 1M reads
     (counts reset just before) must equal phase 6's BWT; then the parts
     (index, read-length walk, terminator walk, extend build) timed apart,
     and the terminator walk's inputs (1M walkers, the 404M base) through
     the ``lf_walk`` kernel == its plain twin, both timed against its bound;
     then the benchmark's append, 100k of those reads onto the 404M base at
     the automatic radix (2: 4,141 buffer symbols a new read; counts reset
     just before: 51 merge passes, 50 ``lf_pair`` calls, no ``lf_stage``)
     == the forced radix-1 append (BWT and table), and its last pair's
     ``lf_pair`` inputs held against ``lf_pair_plain`` (``hold_pair``)
  9. recovery on phase 6's index: 100k reads extracted must equal those
     rows of the sorted reads; every hit of 1,000 located 21-mers must be
     where it says, with as many hits per query as phase 6 counted; the
     read-length walk (5M walkers at 505M), the extract and the locate
     walks on those inputs through the kernel == the plain twin, timed
     against their bound and their access models, this commit's and the
     parent's (``walk_bytes``);
     the locate's range search is one ``kmer_ranges_packed`` launch, its
     inputs (1,000 21-mers from [0, n), no cache) kept and held against the
     twin, exact
 10. query tiers on phase 6's index and reads: the pair index, 6^9 and
     6^11 prefix caches and the run tier (from phase 6's RLE bytes), each
     built and timed; the 1M 21-mers counted through pair + 6^8, pair +
     6^9, pair + 6^11, run + 6^8 and packed + 6^9 must equal phase 6's
     counts. Both query kernels held against their twins on these 505M
     tensors (1M 21-mers: packed + 6^8, pair + 6^9), exact, timed against
     the bytes the search must move (each row it touches once) and its
     access model (one row a bound a step). Then ``RleBWT.load_numpy_file``
     of phase 6's BWT (counts reset just before) must pick pair + 6^9 by
     itself, launch the merge kernel and give the same counts, one
     ``kmer_counts_pair`` launch a batch, cold and warm; its query pack
     saved and loaded into a fresh engine gives them again. Last, 10,000
     reads with one substitution each (an A, C, G or T turned into another
     of the four) must all come back equal to the originals from
     ``correct_reads(k=21, tau=2)`` on the card (counts reset just before):
     one ``kmer_counts_pair`` launch a batch, each batch's inputs kept and
     held against the twin, exact
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
     its npy bytes == phase 6's BWT saved with ``save_bwt_runs``, and the
     child's log must show 100 ``lf_stage`` launches; (d) 50,000
     of the reads on 4 gloo ranks sharing ``cuda:0``
     (``tests/_torch_dist_worker.py``): ``build_msbwt_sharded`` (tree,
     sharded dense, sharded ragged), ``sharded_doubling_merge`` of the four
     groups' BWTs, ``count_kmers_sharded`` and ``count_kmers_partitioned``
     of 20,000 21-mers: every rank's result == the single-device build and
     counts on the card
 12. long reads and the query-tier budget: (a) 500,000 x 1,000 bp reads from
     the same genome (500.5M symbols) built with index at radix 1 and at
     radix 2 (``MSBWT_TPU_RADIX``, counts reset before each): equal BWTs
     and packed tables, 1,001 and 501 merge passes, 1,000 ``lf_stage``
     launches and 500 ``lf_pair`` calls; the entry point timed twice and
     the device loop three times for each, in turns; one loop at each radix
     under the profiler (device events a column); then one more device loop
     at each radix keeping column 1,000's ``lf_stage`` inputs at radix 1
     and the last pair's ``lf_pair`` inputs (columns 1,000 and 1,001) and
     last pass's at radix 2, and on those card tensors ``lf_stage`` == its
     twin (timed; its event time split from its kernel's device duration by
     the profiler), ``lf_pair`` == ``lf_pair_plain`` (timed against the
     bytes the pair must move, its device time by kernel from the profiler
     and its share of the bound; with ``--parent`` the parent's, its event
     and device time in turns)
     and the merge kernel == the plain pass; (b) 20,000 of them at radix 2
     through the plain pass and LF steps on the card == the kernels (500
     ``lf_pair`` calls); (c) the BWT of the first 400,000 loaded from RLE
     bytes and extended by the last 100,000 at the automatic radix (2, by
     the JAX package's rule; counts reset just before: 500 ``lf_pair``
     calls) == (a)'s BWT, and its terminator and read-length walks' inputs
     through ``lf_walk`` == the twins, timed; (d) phase 6 checks its 101
     passes (radix 1 at 100 bp);
     (e) 15M x 100 bp (1.515G symbols) built (counts reset just before;
     column 90's ``lf_stage`` inputs, slots past 2^30, kept and held
     against the twin) and encoded to RLE bytes in memory: ``RleBWT`` with
     its default budget (the card's) must pick pair + 6^9, with
     ``MSBWT_TPU_DEVICE_BUDGET_GB=12`` the run tier; their 1M counts == the
     packed tier's; each tier's peak memory;
     ``kmer_counts_pair`` held against its twin on the card-budget engine's
     pair table, 6^9 cache and 1M k-mers (positions past 2^30), exact, timed
 12f. column groups at the benchmark's long-read shape: ``ecoli-ont50x``'s
     15,472 read lengths over random bases built one-shot at the rule's
     radix (2; counts reset just before): its passes, pairs and groups those
     of ``group_schedule``, its BWT == the build with the pairs alone; the
     group holding column 30,000 held against ``lf_group_plain`` (timed
     against its byte bound, its device time by kernel) and against the
     pairs it replaces, replayed from the same buffer to the same buffer
     and table (the pairs' LF steps, their passes, the group's one)
 13. one JSON line of kernel results (``merge_insert``, ``lf_stage``,
     ``lf_pair``, ``lf_group``, ``lf_walk``, ``kmer_ranges_packed``,
     ``kmer_counts_pair``),
     then
     ``{"ok": true, "device": ...}``

With ``--parent DIR``, every query hold (phases 3b, 9, 10 and 12e, and the
correction's batches) also runs the parent's query kernel, through the same
C entry point of the parent's library, and every LF hold (phases 3b, 6b, 8,
9, 12a, 12c and 12e) the parent's ``lf_stage`` or ``lf_walk`` through the
parent's own ``ops/lf.py`` wrapper bound to its library (its C contract:
the walks take ``bwt``), and phase 12a's ``lf_pair`` the parent's radix-2
step (its ``lf_pair``, or before it its torch ``_stage_step2`` around
its ``lf_stage``), on the same card tensors: its output must equal this
commit's kernel's, exactly; the timed holds time both in turns
(parent, new, new, parent) and log the ratio. The merge pass of phase 3 is
timed the same way (its source is unchanged since the parent, so its ratio
reads the noise of the turns). The ratios are logged and not checked, so
noise cannot fail a run; the exactness is checked everywhere. At column
1,000 of phase 12a, ``lf_stage``'s event time a call is logged beside its
kernel's own device duration from ``torch.profiler`` (``stage_split``),
this commit's and the parent's, in turns. This commit's ``lf_stage`` is
timed as the stage loop calls it, with one scratch for every call
(``loop_stage``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_READS, READ_LEN, K, N_QUERIES, N_CHECK = 5_000_000, 100, 21, 1_000_000, 20_000
BATCH, N_EXTRACT, N_LOCATE = 1_000_000, 100_000, 1_000
APPEND = 100_000  # phase 8's append onto the 404M base, as the benchmark's
N_CORRECT = 10_000
N_PARTS, N_PAIR, N_GLOO, N_GLOO_KMERS = 4, 1_000_000, 50_000, 20_000  # phase 11
DEEP_K = 11  # the deepest prefix cache phase 10 builds
LONG_READS, LONG_LEN, LONG_SMALL, LONG_BASE = 500_000, 1_000, 20_000, 400_000  # phase 12
BIG_READS = 15_000_000  # phase 12e: 15M x 100 bp, 1.515G symbols
GROUP_COL = 30_000  # phase 12f: the column whose group is held, ~1,845 of 15,472 reads active
LF_COL = 90  # phase 6b: the late column whose lf_stage inputs are kept
STREAM_COLS, STREAM_REPS = (50, LF_COL), 32  # phase 6c: columns on two streams, launches a stream
HOST_ROUNDS, HOST_CALLS = 8, 1000  # stage_split: the host's time a call of lf_stage
PARENT = None  # --parent: the parent commit's loaded kernel library
PARENT_LF = None  # --parent: the parent commit's ops/lf.py on that library
PARENT_RACE_LF = None  # --parent: the same on a private copy of the library (phase 6c)
PARENT_STEP2 = None  # --parent: the parent commit's radix-2 step (its ops/bcr.py)


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
    return reads, lengths, draw_kmers(np, rng, reads)


def draw_kmers(np, rng, reads, n=N_QUERIES):
    """``n`` K-mers cut from the reads at random rows and offsets."""
    rows = rng.integers(0, reads.shape[0], n)
    offs = rng.integers(0, reads.shape[1] - K + 1, n)
    return reads[rows[:, None], offs[:, None] + np.arange(K)[None, :]]


def genome_reads(np, n_reads, read_len, seed):
    """``n_reads`` x ``read_len`` reads from the flagship's 4.6 Mbase genome
    (the first draw of seed 0xEC011) at starts drawn from ``seed``, cut in
    chunks of 16M symbols (no n x L int64 index at once)."""
    genome = np.random.default_rng(0xEC011).integers(1, 6, size=4_600_000, dtype=np.uint8)
    starts = np.random.default_rng(seed).integers(0, genome.size - read_len, n_reads)
    reads = np.empty((n_reads, read_len), np.uint8)
    ar = np.arange(read_len)
    step = max(1, 2**24 // read_len)
    for i in range(0, n_reads, step):
        reads[i: i + step] = genome[starts[i: i + step, None] + ar]
    return reads, np.full(n_reads, read_len, np.int32)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    launches after one warm-up, between two CUDA events."""
    from rust_msbwt_tpu_torch.utils.profiling import timeit

    return timeit(fn, reps=reps) * 1e3


def wrappers() -> tuple:
    """Every kernel wrapper: the merge kernel, ``lf_stage``, ``lf_pair``,
    ``lf_group``, the four ``lf_walk`` walks and the two query kernels."""
    from rust_msbwt_tpu_torch.ops import lf, query
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    return (merge_insert, lf.lf_stage, lf.lf_pair, lf.lf_group, *lf.LF_WALKS,
            *query.QUERY_KERNELS)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a path."""
    for w in wrappers():
        w.launches = 0


def path_counts() -> dict:
    """The launches since ``reset_counts``: each wrapper's, and ``lf_walk``
    summed over its four walks."""
    from rust_msbwt_tpu_torch.ops import lf

    return {"lf_walk": lf.lf_walk_launches(), **{w.__name__: w.launches for w in wrappers()}}


def lf_line(c: dict) -> str:
    return (f"lf_stage launches {c['lf_stage']}, lf_pair launches {c['lf_pair']}, "
            f"lf_walk launches {c['lf_walk']} "
            f"(cyclic {c['lf_walk_cyclic']}, lengths {c['lf_walk_lengths']}, "
            f"extract {c['lf_walk_extract']}, locate {c['lf_walk_locate']}), "
            f"kmer_ranges_packed launches {c['kmer_ranges_packed']}, kmer_counts_pair "
            f"launches {c['kmer_counts_pair']}")


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block, restored after."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def capture(module, name, keep=lambda *a: True, clone=True):
    """Inside the block ``module.name`` records the arguments of each call
    for which ``keep(*args)`` holds into the list it yields, and runs as
    before. Arguments given by keyword are recorded in their place in the
    signature. The tensors are cloned unless ``clone`` is false (for a
    function whose arguments nothing writes after the call). A kernel
    wrapper counts its launches on itself, so the capture goes on its
    caller's module, never on the wrapper's own."""
    import inspect

    import torch

    seen = []

    def recording(*args, **kw):
        full = inspect.signature(real).bind(*args, **kw).args if kw else args
        if keep(*full):
            seen.append(tuple(a.clone() if clone and isinstance(a, torch.Tensor) else a
                              for a in full))
        return real(*args, **kw)

    with swapped(module, name, recording) as real:
        yield seen


@contextlib.contextmanager
def plain_lf():
    """The build's LF step through the plain twins inside the block:
    ``ops.bcr``'s ``lf_stage``, ``lf_pair`` (their kernels' scratch
    dropped) and ``lf_group``, ``lf_walk_cyclic`` and ``lf_walk_lengths``."""
    from rust_msbwt_tpu_torch.ops import bcr, lf

    def stage_plain(*args, scratch=None):
        return lf.lf_stage_plain(*args)

    def pair_plain(*args, scratch=None):
        return lf.lf_pair_plain(*args)

    def group_plain(*args, order=None):
        return lf.lf_group_plain(*args, order)

    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(bcr, "lf_stage", stage_plain))
        stack.enter_context(swapped(bcr, "lf_pair", pair_plain))
        stack.enter_context(swapped(bcr, "lf_group", group_plain))
        for name in ("lf_walk_cyclic", "lf_walk_lengths"):
            stack.enter_context(swapped(bcr, name, getattr(lf, f"{name}_plain")))
        yield


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (a kernel held against its twin) are taken
    back out of every wrapper's count: only a path's own launches count."""
    before = {w: w.launches for w in wrappers()}
    try:
        yield
    finally:
        for w, n in before.items():
            w.launches = n


def agree(torch, name, kernel, plain, args, tag="lf") -> int:
    """A kernel against its plain twin on the same card tensors, every
    output exact (launches uncounted); logs and returns the max abs error."""
    def outs(o):
        return [torch.as_tensor(t) for t in (o if isinstance(o, tuple) else (o,))]

    with uncounted():
        got, want = outs(kernel(*args)), outs(plain(*args))
    torch.cuda.synchronize()
    check(len(got) == len(want) and all(g.shape == w.shape and g.dtype == w.dtype
                                        for g, w in zip(got, want)),
          f"{name}: kernel and plain outputs differ in shape or type")
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    check(err == 0, f"{name}: kernel != plain (max abs err {err})")
    log(f"[{tag}] {name}: kernel == plain on the card (max abs err {err})")
    return err


def hold(torch, name, kernel, plain, args, bound_bytes, reps=10, plain_reps=2, tag="lf"):
    """``agree``, then both timed between CUDA events (launches uncounted);
    the bound is ``bound_bytes`` at the data sheet's 3.35 TB/s."""
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW

    err = agree(torch, name, kernel, plain, args, tag)
    with uncounted():
        res = {"ms": cuda_ms(lambda: kernel(*args), reps),
               "plain_ms": cuda_ms(lambda: plain(*args), plain_reps),
               "bound_ms": bound_bytes / DEFAULT_HBM_BW * 1e3, "bound_bytes": bound_bytes,
               "max_abs_err": err}
    log(f"[{tag}] {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({bound_bytes} B at 3.35 TB/s -> "
        f"{res['bound_ms'] / res['ms']:.1%} of it)")
    return res


def hold_stage(torch, name, args, reps=20, plain_reps=3):
    """``hold`` for one kept ``lf_stage`` column. Its bound is the bytes the
    column must move for its data: 96 B of each distinct table row its reads
    rank in (counted here and logged), and 20 B of carry a read (v, lengths,
    P, prev_v in; q, active, P, prev_v out), counts in and out. With
    ``--parent``, the parent's ``lf_stage`` too (``parent_lf``)."""
    from rust_msbwt_tpu_torch.ops import lf

    j, tab, P = args[0], args[1], args[5]
    rows = int(torch.unique(P.long() >> 7).numel())
    label = (f"lf_stage, column {j} of {name} ({P.numel()} reads, max P {int(P.max())}, "
             f"{rows} distinct rows of the {tab.shape[0]}-row table)")
    stage = loop_stage(tab.device)
    res = hold(torch, label, stage, lf.lf_stage_plain, args,
               96 * rows + 20 * P.numel() + 48, reps=reps, plain_reps=plain_reps)
    res["rows"] = rows
    res.update(parent_lf(torch, label, "lf_stage", args, reps, kernel=stage))
    return res


def loop_stage(dev):
    """``lf_stage`` as the stage loop calls it: with one scratch of its own
    for every call (each launch leaves it zeroed), so no call adds a
    memset."""
    import functools

    from rust_msbwt_tpu_torch.ops import lf

    return functools.partial(lf.lf_stage, scratch=lf.stage_scratch(dev))


def loop_pair(dev):
    """``lf_pair`` as the stage loop calls it: with one scratch of its own
    for every call (each call leaves it zeroed)."""
    import functools

    from rust_msbwt_tpu_torch.ops import lf

    return functools.partial(lf.lf_pair, scratch=lf.stage_scratch(dev))


def pair_bytes(torch, args) -> tuple:
    """The bytes ``lf_pair``'s function must move for one pair's data, and
    the table rows they hold: 96 B of each distinct table row its two ranks
    read (column j's at the ``P`` of the reads active in column j, column
    j + 1's at the old positions of the reads active in both columns;
    counted here through the plain twin's own steps), 26 B a read (lengths,
    P, the two columns' symbols and prev_v in; the 2N slots and flags, P
    and prev_v out), and the counts in and out. The kernel's own
    intermediates (its slot tiles' counts and starts) are not the
    function's and are not counted."""
    from rust_msbwt_tpu_torch.ops import lf

    j, tab, cap, nst, cols, lengths, P, counts, prev_v = args
    q1, _, act1, *_ = lf.lf_stage_plain(j, tab, nst, cols, lengths, P, counts, prev_v)
    act2 = act1 & (j + 1 <= lengths + 1)
    old_pos = lf.pair_order(q1, act1, cap)[2]
    rows = int(torch.unique(torch.cat([P[act1].long() >> 7,
                                       old_pos[act2].long() >> 7])).numel())
    return 96 * rows + 26 * P.numel() + 48, rows


def pair_split(torch, label, fn, args, reps=20) -> dict:
    """``fn`` (``lf_pair``, this commit's or the parent's) over ``reps``
    calls under ``torch.profiler``: its device milliseconds and device
    events a call, by kernel (launches uncounted)."""
    import re

    from rust_msbwt_tpu_torch.utils.profiling import device_us, trace

    with uncounted(), tempfile.TemporaryDirectory() as d, trace(d) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and device_us(e) > 0:
            m = re.search(r"pair_\w+?_kernel|[Mm]emset", e.key)
            key = m.group(0) if m else e.key[:40]
            by[key] = by.get(key, 0.0) + device_us(e) * 1e-3 / reps
            by[key + " events"] = by.get(key + " events", 0) + e.count / reps
    res = {"device_ms": sum(v for k, v in by.items() if not k.endswith(" events")),
           "events": sum(v for k, v in by.items() if k.endswith(" events")), "kernels": by}
    log(f"[lf] lf_pair split, {label}: device {res['device_ms']:.4f} ms in "
        f"{res['events']:.1f} events a call ("
        + ", ".join(f"{k} {v:.4f}" for k, v in by.items() if not k.endswith(" events")) + ")")
    return res


def hold_pair(torch, name, args, reps=20, plain_reps=3):
    """``hold`` for one kept ``lf_pair`` column pair, called as the stage
    loop calls it (``loop_pair``), against ``lf_pair_plain``; its bound is
    ``pair_bytes``; then its device time by kernel (``pair_split``), its
    share of the bound, and, with ``--parent``, the parent's radix-2 step
    (``load_parent_step2``) == this commit's on the same card tensors, its
    event time and its device time by kernel in turns (``pair_turns``)."""
    from rust_msbwt_tpu_torch.ops import lf

    j, tab, cap, P = args[0], args[1], args[2], args[6]
    bound_bytes, rows = pair_bytes(torch, args)
    label = (f"lf_pair, columns {j} and {j + 1} of {name} ({P.numel()} reads, capacity "
             f"{cap}, {rows} distinct rows of the {tab.shape[0]}-row table)")
    pair = loop_pair(tab.device)
    res = hold(torch, label, pair, lf.lf_pair_plain, args, bound_bytes, reps=reps,
               plain_reps=plain_reps)
    res["rows"] = rows
    res["split"] = pair_split(torch, label, pair, args)
    res["device_share"] = res["bound_ms"] / res["split"]["device_ms"]
    log(f"[lf] {label}: device time {res['split']['device_ms']:.4f} ms, "
        f"{res['device_share']:.1%} of its {res['bound_ms']:.4f} ms bound; event time "
        f"{res['ms']:.4f} ms, {res['bound_ms'] / res['ms']:.1%}")
    res.update(pair_turns(torch, label, pair, args, reps))
    return res


def pair_turns(torch, label, pair, args, reps=20) -> dict:
    """With ``--parent``: the parent's radix-2 step (``load_parent_step2``,
    on a scratch of its own) == ``pair`` on ``args``, exactly, then both
    timed in turns, parent, new, new, parent: the event time a call
    (``parent_turns``) and the device time a call by kernel
    (``pair_split``); ``{}`` without a parent."""
    import functools

    from rust_msbwt_tpu_torch.ops import lf

    if PARENT_STEP2 is None:
        return {}
    parent = functools.partial(PARENT_STEP2, scratch=lf.stage_scratch(args[1].device))
    res = parent_turns(torch, label, pair, parent, [args], reps, "lf")
    split = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        split[who].append(pair_split(torch, f"{label}, {who}",
                                     parent if who == "parent" else pair, args, reps))
    dev = {who: [x["device_ms"] for x in runs] for who, runs in split.items()}
    res.update(parent_device_ms=dev["parent"], turn_device_ms=dev["new"],
               parent_events=split["parent"][0]["events"],
               parent_split=split["parent"][0]["kernels"])
    log(f"[lf] {label}: device time in turns parent / new / new / parent "
        f"{dev['parent'][0]:.4f} / {dev['new'][0]:.4f} / {dev['new'][1]:.4f} / "
        f"{dev['parent'][1]:.4f} ms ({split['parent'][0]['events']:.1f} / "
        f"{split['new'][0]['events']:.1f} device events a call) -> parent / new = "
        f"{sum(dev['parent']) / sum(dev['new']):.3f}")
    return res


def loop_events(torch, fn, columns: int) -> dict:
    """One ``fn()`` (a device stage loop) under ``torch.profiler``: its
    device seconds and device events, and the events a column."""
    from rust_msbwt_tpu_torch.utils.profiling import device_us, trace

    with uncounted(), tempfile.TemporaryDirectory() as d, trace(d) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    n_events = sum(e.count for e in evts)
    return {"device_s": sum(device_us(e) for e in evts) * 1e-6, "events": n_events,
            "events_a_column": n_events / columns}


def walk_bytes(torch, walk, args) -> dict:
    """Bytes a walk must move for this run's data, in two models, found by
    replaying the walk with torch ops. ``bound_bytes`` reads each table row
    its walkers touch once (96 B: the three sectors of a rank), each
    stage-view byte (the cyclic walk) or BWT symbol (the locate walk) it
    reads, and its other inputs and its outputs once. ``access`` is the
    kernels' access model, one row read a walker step (the step that meets
    '$' included; ``steps`` of them): this commit's (``access_bytes``) and
    the parent's (``parent_access_bytes``, whose walks but the cyclic also
    read a 32 B sector of the BWT a step). The cyclic walk reads 97 B a step
    (row and stage view) in both; the read-length walk now streams the table
    once (96 B a row), writes and reads 4 B of LF a position (``ceil(n /
    128) * 128`` of them) and reads one 32 B sector a step; the extract walk
    reads 96 B a step, the locate walk 128 B in both."""
    from rust_msbwt_tpu_torch.ops.packed_rank import lf_step

    table, starts = args[:2] if walk == "cyclic" else args[1:3]
    dev = table.device
    rows = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    steps = 0
    if walk == "cyclic":
        _, _, n, cols, lengths, steps_in, n_steps = args
        N = lengths.numel()
        pos = torch.full((N,), n, dtype=torch.int32, device=dev)
        m, col = lengths.long() + 1, torch.arange(N, device=dev)
        lim = steps_in.clamp(max=n_steps)
        for t in range(n_steps):
            act = t < lim
            rows[(pos.long() >> 7)[act]] = True
            pos = torch.where(act, lf_step(table, starts, cols[t % m + 1, col], pos), pos)
        steps = int(lim.sum())
        access = 97 * steps + 12 * N + 28
        return {"bound_bytes": 96 * int(rows.sum()) + int(torch.minimum(lim, m).sum()) + 12 * N
                + 28, "steps": steps, "access_bytes": access, "parent_access_bytes": access}
    bwt = args[0]
    sym_bytes = 0
    if walk == "locate":
        pos, n_strings, l_max = args[3:]
        syms = torch.zeros(bwt.numel(), dtype=torch.bool, device=dev)
        for _ in range(l_max + 1):
            live = pos >= n_strings
            rows[pos.long()[live] >> 7] = True
            syms[pos.long()[live]] = True
            steps += int(live.sum())
            pos = torch.where(live, lf_step(table, starts, torch.where(live, bwt[pos.long()], 0),
                                            pos), pos)
        io, sym_bytes = 12 * pos.numel() + 28, int(syms.sum())
    else:
        if walk == "lengths":  # from every '$' rotation until '$'
            n, n_strings = args[3:]
            pos, n_steps = torch.arange(n_strings, dtype=torch.int32, device=dev), n
            io = 4 * n_strings + 4 + 28
        else:  # extract: at most l_max + 1 steps
            ids, l_max = args[3:]
            pos, n_steps = ids.clone(), l_max + 1
            io = ids.numel() * (5 + l_max) + 28
        live = torch.ones(pos.numel(), dtype=torch.bool, device=dev)
        for _ in range(n_steps):
            if not bool(live.any()):
                break
            rows[pos.long()[live] >> 7] = True
            steps += int(live.sum())
            sym = bwt[pos.long()]
            live &= sym != 0
            pos = torch.where(live, lf_step(table, starts, torch.where(live, sym, 0), pos), pos)
    access = (128 if walk == "locate" else 96) * steps + io
    if walk == "lengths":
        n_lf = -(-args[3] // 128) * 128
        access = 96 * (n_lf // 128) + 8 * n_lf + 32 * steps + io
    return {"bound_bytes": 96 * int(rows.sum()) + sym_bytes + io, "steps": steps,
            "access_bytes": access, "parent_access_bytes": 128 * steps + io}


def hold_walk(torch, name, walk, kernel, plain, args, reps=10, plain_reps=2) -> dict:
    """``hold`` for one kept walk against its bound (``walk_bytes``), its
    access models logged apart; with ``--parent``, the parent's walk too
    (``parent_lf``)."""
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW

    by = walk_bytes(torch, walk, args)
    res = hold(torch, name, kernel, plain, args, by["bound_bytes"], reps=reps,
               plain_reps=plain_reps)
    res.update(steps=by["steps"], access_ms=by["access_bytes"] / DEFAULT_HBM_BW * 1e3,
               parent_access_ms=by["parent_access_bytes"] / DEFAULT_HBM_BW * 1e3)
    res.update(parent_lf(torch, name, kernel.__name__, args, reps))
    log(f"[lf] {name}: {by['steps']} walker steps; the access model {by['access_bytes']} B "
        f"-> {res['access_ms']:.4f} ms ({res['access_ms'] / res['ms']:.1%} of the kernel's "
        f"time); the parent's access model {by['parent_access_bytes']} B -> "
        f"{res['parent_access_ms']:.4f} ms"
        + (f" ({res['parent_access_ms'] / res['parent_ms']:.1%} of its time)"
           if "parent_ms" in res else ""))
    return res


def query_bytes(torch, tier, args, packed) -> dict:
    """Bytes a query batch must move for this run's data, in two models:
    ``bound_bytes`` reads each table row the search touches once, and
    ``access_bytes`` one row a bound a step (a round for the pair tier).
    A packed row counts 96 B (the three sectors ``rank_at`` reads), a pair
    row 128 B (its 96 B of planes and a sector of occurrence lanes); both
    models add the k-mers, lengths and distinct cache entries read once, the
    C array (and D) and the output written once. The rows are found by
    replaying the search with torch ops on ``packed`` (a pair round's range
    is the range after its two symbols; the pair search stops once a range
    is empty, as its kernel does)."""
    from rust_msbwt_tpu_torch.ops.packed_rank import rank_packed

    pair = tier == "pair"
    table = args[0]
    n, kmers, lengths, cache, ck = args[3:] if pair else args[2:]
    B, K = kmers.shape
    dev = kmers.device
    rows = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    io = B * K + 4 * B + (4 if pair else 8) * B + 28 + (144 if pair else 0)
    lo = torch.zeros(B, dtype=torch.int32, device=dev)
    hi = torch.full((B,), n, dtype=torch.int32, device=dev)
    if not (ck and K >= ck):
        ck = 0
    if ck:
        weights = 6 ** torch.arange(ck - 1, -1, -1, device=dev)
        code = (kmers[:, K - ck:].long() * weights).sum(1)
        lo, hi = cache.lo[code], cache.hi[code]
        io += 8 * int(torch.unique(code).numel())
    reads = 0
    for t in range(ck, K):
        act = t < lengths
        if not pair or (t - ck) % 2 == 0:
            live = act & (lo != hi) if pair else act
            for pos in (lo, hi):
                rows[(pos.long() >> 7).clamp(max=table.shape[0] - 1)[live]] = True
            reads += 2 * int(live.sum())
        s = torch.where(act, kmers[:, K - 1 - t].to(torch.int32), 0)
        c = packed.starts[s.long()]
        lo = torch.where(act, c + rank_packed(packed.table, s, lo), lo)
        hi = torch.where(act, c + rank_packed(packed.table, s, hi), hi)
    row_b = 128 if pair else 96
    n_rows = int(rows.sum())
    return {"bound_bytes": row_b * n_rows + io, "access_bytes": row_b * reads + io,
            "rows": n_rows, "row_reads": reads}


def hold_query(torch, name, tier, args, packed, reps=20, plain_reps=3) -> dict:
    """``hold`` for one query batch of ``tier`` (``"packed"``: the
    ``kmer_ranges_packed`` kernel, ``"pair"``: ``kmer_counts_pair``)
    against its bound, and its access model apart (``query_bytes``)."""
    from rust_msbwt_tpu_torch.ops import packed_rank, pair_rank, query
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW

    kernel, plain = ((query.kmer_counts_pair, pair_rank.kmer_counts_pair_plain) if tier == "pair"
                     else (query.kmer_ranges_packed, packed_rank.kmer_ranges_packed_plain))
    by = query_bytes(torch, tier, args, packed)
    res = hold(torch, f"{name} ({by['rows']} distinct rows of the {args[0].shape[0]}-row "
               f"table, {by['row_reads']} row reads)", kernel, plain, args, by["bound_bytes"],
               reps=reps, plain_reps=plain_reps, tag="query")
    res.update(rows=by["rows"], row_reads=by["row_reads"],
               access_ms=by["access_bytes"] / DEFAULT_HBM_BW * 1e3)
    log(f"[query] {name}: the access model (one row a bound a step, {by['access_bytes']} B) "
        f"{res['access_ms']:.4f} ms -> {res['access_ms'] / res['ms']:.1%} of it")
    res.update(parent_hold(torch, name, tier, kernel, [args], reps))
    return res


def batches_hold(torch, name, tier, kernel, batches, reps=10) -> dict:
    """A path's kept query batches through ``kernel`` back to back, timed as
    one between CUDA events (launches uncounted): the path's search time;
    with ``--parent``, against the parent's kernel (``parent_hold``)."""
    with uncounted():
        res = {"ms": cuda_ms(lambda: [kernel(*b) for b in batches], reps)}
    log(f"[query] {name}: {res['ms']:.4f} ms through the kernel")
    res.update(parent_hold(torch, name, tier, kernel, batches, reps))
    return res


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


def load_parent_lf(parent, lib):
    """The parent commit's ``ops/lf.py``, its launches made through the
    parent's library ``lib`` (its ``_launch``, bound to that library): the
    parent's wrappers, host code and C contract (the walks with ``bwt``).
    None when no parent checkout is given."""
    import importlib.util

    import torch

    if not parent:
        return None
    path = os.path.join(parent, "rust_msbwt_tpu_torch", "ops", "lf.py")
    spec = importlib.util.spec_from_file_location("parent_lf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def launch(fn_name, *args, dev):
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"parent {fn_name} launch: CUDA error {err}")

    mod._launch = launch
    return mod


def load_parent_step2(parent, parent_lf):
    """The parent commit's radix-2 step: its ``lf_pair`` on its own library
    where its ``ops/lf.py`` has one (``parent_lf``), else its
    ``ops/bcr.py``'s ``_stage_step2`` (torch corrections around its
    ``lf_stage``), with its ``lf_stage`` the parent's own. None when no
    parent checkout is given."""
    import importlib.util

    if not parent:
        return None
    if hasattr(parent_lf, "lf_pair"):
        return parent_lf.lf_pair
    path = os.path.join(parent, "rust_msbwt_tpu_torch", "ops", "bcr.py")
    spec = importlib.util.spec_from_file_location("parent_bcr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.lf_stage = parent_lf.lf_stage
    return mod._stage_step2


def private_copy(lib):
    """A second instance of the loaded library ``lib``: a copy of its file
    beside it, loaded anew, so any module-global device memory of its
    kernels is its own; ``msbwt_lf_stage`` typed as in ``lib``. Phase 6c
    races the parent's ``lf_stage`` on it, which leaves the parent's
    library itself as it was for the holds after it."""
    import ctypes
    import shutil

    path = lib._name
    copy = os.path.join(os.path.dirname(path), "private_" + os.path.basename(path))
    shutil.copyfile(path, copy)
    new = ctypes.CDLL(copy)
    new.msbwt_lf_stage.restype = lib.msbwt_lf_stage.restype
    new.msbwt_lf_stage.argtypes = lib.msbwt_lf_stage.argtypes
    return new


def load_parent_kernels(parent):
    """The parent commit's kernel library, built from ``parent``'s own
    sources into its own ``_build`` and loaded by its own
    ``_kernels.load()`` (which sets its C entry points' argument types);
    the query, LF and column-pair kernels' registers and spills of its
    build are logged.
    None when no parent checkout is given."""
    import importlib.util
    import re

    if not parent:
        return None
    path = os.path.join(parent, "rust_msbwt_tpu_torch", "_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = mod.build().splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"(kmer_ranges_packed|kmer_counts_pair|lf_stage|lf_walk|pair_\w+?)_kernel"
                      r"(ILi(\d)E)?", line)
        if "Compiling entry" in line and m:
            name = m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")
            log(f"[parent] {name}: " + "; ".join(x.split(":")[-1].strip() if "Used" in x
                                                 else x.strip() for x in lines[i + 1: i + 4]
                                                 if "Used" in x or "spill" in x))
    return mod.load()


def query_call(lib, tier):
    """A function of a query wrapper's arguments that makes the wrapper's
    launch through ``lib``'s C entry point (``msbwt_kmer_ranges_packed`` or
    ``msbwt_kmer_counts_pair``: the parent's library takes the same
    arguments) and returns the wrapper's outputs."""
    import torch

    from rust_msbwt_tpu_torch.ops.query import _batch

    def run(*args):
        pair = tier == "pair"
        if len(args) < (8 if pair else 7):  # no cache given
            args = (*args, None, 0)
        table, starts = args[:2]
        n, kmers, lengths, cache, ck = args[3:] if pair else args[2:]
        dev = table.device
        clo, chi, ck = _batch(dev, starts, n, kmers, lengths, cache, ck)
        B, K = kmers.shape
        out = torch.empty((1 if pair else 2, B), dtype=torch.int32, device=dev)
        if B:
            ptr = [None if t is None else t.data_ptr() for t in (clo, chi)]
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = (lib.msbwt_kmer_counts_pair(
                table.data_ptr(), starts.data_ptr(), args[2].data_ptr(), kmers.data_ptr(),
                lengths.data_ptr(), *ptr, out[0].data_ptr(), B, table.shape[0], K, ck, n, stream)
                if pair else lib.msbwt_kmer_ranges_packed(
                table.data_ptr(), starts.data_ptr(), kmers.data_ptr(), lengths.data_ptr(), *ptr,
                out[0].data_ptr(), out[1].data_ptr(), B, K, ck, n, stream))
            check(err == 0, f"parent {tier} query kernel launch: CUDA error {err}")
        return out[0] if pair else (out[0], out[1])

    return run


def turns(fns: dict, reps: int) -> dict:
    """Each of ``fns`` (``"parent"``, ``"new"``) timed between CUDA events in
    turns, parent, new, new, parent: ``{who: [ms, ms]}``."""
    got = {who: [] for who in fns}
    for who in ("parent", "new", "new", "parent"):
        got[who].append(cuda_ms(fns[who], reps))
    return got


def parent_turns(torch, name, kernel, parent, batches, reps, tag) -> dict:
    """``parent`` (the parent commit's kernel behind a wrapper's contract)
    on each of ``batches`` (argument tuples) == ``kernel``, every output
    exactly; then, unless ``reps`` is 0, the batches through each back to
    back, timed in turns (launches uncounted), the ratio logged, not
    checked."""
    def outs(o):
        return [torch.as_tensor(t) for t in (o if isinstance(o, tuple) else (o,))]

    with uncounted():
        for args in batches:
            got, want = outs(kernel(*args)), outs(parent(*args))
            check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: this kernel != the parent's")
        if not reps:
            return {}
        t = turns({who: lambda fn=fn: [fn(*args) for args in batches]
                   for who, fn in (("parent", parent), ("new", kernel))}, reps)
    res = {"parent_ms": sum(t["parent"]) / 2, "turn_ms": sum(t["new"]) / 2}
    log(f"[{tag}] {name}: == the parent's kernel; turns parent / new / new / parent "
        f"{t['parent'][0]:.4f} / {t['new'][0]:.4f} / {t['new'][1]:.4f} / {t['parent'][1]:.4f} ms"
        f" -> parent / new = {res['parent_ms'] / res['turn_ms']:.3f}")
    return res


def parent_hold(torch, name, tier, kernel, batches, reps) -> dict:
    """With ``--parent``: the parent's query kernel on each of ``batches``
    (a wrapper's argument tuples) against this commit's ``kernel``
    (``parent_turns``); ``{}`` without a parent."""
    if PARENT is None:
        return {}
    return parent_turns(torch, name, kernel, query_call(PARENT, tier), batches, reps, "query")


def parent_lf(torch, name, wrapper, args, reps, kernel=None) -> dict:
    """With ``--parent``: the parent's ``ops/lf.py`` wrapper of that name
    (its host code, its library, its C contract: the walks with ``bwt``)
    on ``args`` against this commit's (``parent_turns``; ``kernel`` in
    place of this commit's wrapper when given); ``{}`` without a parent."""
    from rust_msbwt_tpu_torch.ops import lf

    if PARENT_LF is None:
        return {}
    return parent_turns(torch, name, kernel or getattr(lf, wrapper),
                        getattr(PARENT_LF, wrapper), [args], reps, "lf")


def stage_split(torch, name, args, reps=50) -> dict:
    """``lf_stage`` at one kept column, split: the event time a call of
    ``10 * reps`` back-to-back wrapper calls (``cuda_ms``: the host's dispatch
    when it is slower than the device) and, from ``torch.profiler``
    (``utils/profiling.trace``) over ``reps`` calls, the device duration a
    call of the kernel and of its other device events; for this commit's
    wrapper, called as the stage loop calls it (``loop_stage``), and with
    ``--parent`` the parent's, in turns (parent, new, new, parent; each the
    mean of its two turns); then the host's microseconds a call of each, in
    HOST_ROUNDS alternating rounds of HOST_CALLS calls. Launches uncounted."""
    from rust_msbwt_tpu_torch.utils.profiling import device_us, trace

    fns = {"new": loop_stage(args[1].device)}
    order = ("new",)
    if PARENT_LF is not None:
        fns["parent"] = PARENT_LF.lf_stage
        order = ("parent", "new", "new", "parent")
    got = {who: [] for who in fns}
    with uncounted():
        for who in order:
            fn = fns[who]
            event_ms = cuda_ms(lambda: fn(*args), 10 * reps)  # host-bound: more calls
            with tempfile.TemporaryDirectory() as d, trace(d) as prof:
                for _ in range(reps):
                    fn(*args)
                torch.cuda.synchronize()
            evts = [e for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
            kernel = sum(device_us(e) for e in evts if "lf_stage_kernel" in e.key)
            other = sum(device_us(e) for e in evts) - kernel
            n_other = sum(e.count for e in evts if "lf_stage_kernel" not in e.key)
            got[who].append({"event_ms": event_ms, "kernel_ms": kernel / reps * 1e-3,
                             "other_ms": other / reps * 1e-3, "other_events": n_other / reps})
        # the host's microseconds a call: rounds of back-to-back calls with no
        # sync (the host is slower than this kernel), the order flipped each
        # round; the median of the rounds
        host = {who: [] for who in fns}
        for rnd in range(HOST_ROUNDS):
            for who in (sorted(fns) if rnd % 2 == 0 else sorted(fns, reverse=True)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fns[who](*args)
                host[who].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    res = {}
    for who, runs in got.items():
        r = res[who] = {k: sum(x[k] for x in runs) / len(runs) for k in runs[0]}
        r["turns_kernel_ms"] = [x["kernel_ms"] for x in runs]
        r["turns_event_ms"] = [x["event_ms"] for x in runs]
        r["host_us"] = sorted(host[who])[len(host[who]) // 2]
        r["host_us_rounds"] = host[who]
        log(f"[lf] lf_stage split, {name}, {who}: event time {r['event_ms']:.4f} ms a call "
            f"(turns {' / '.join(f'{t:.4f}' for t in r['turns_event_ms'])}); device: kernel "
            f"{r['kernel_ms']:.4f} ms (turns "
            f"{' / '.join(f'{t:.4f}' for t in r['turns_kernel_ms'])}), other events "
            f"{r['other_ms']:.4f} ms ({r['other_events']:.1f} a call); the host's share of the "
            f"event time {1 - (r['kernel_ms'] + r['other_ms']) / r['event_ms']:.1%}; the host "
            f"{r['host_us']:.2f} µs a call (median of {HOST_ROUNDS} rounds of {HOST_CALLS} "
            f"calls: {' / '.join(f'{t:.2f}' for t in host[who])})")
    if "parent" in res:
        log(f"[lf] lf_stage split, {name}: parent / new = "
            f"{res['parent']['kernel_ms'] / res['new']['kernel_ms']:.3f} (kernel), "
            f"{res['parent']['event_ms'] / res['new']['event_ms']:.3f} (event time), "
            f"{res['parent']['host_us'] / res['new']['host_us']:.3f} (the host a call)")
    return res


def phase_kernel(torch, dev):
    """Phase 3: kernel == plain on the card, exact, at PR 1's shapes, the
    tile edge shapes and one 505M pass; times at the 505M stage shape, prep
    included (the inputs are on the card before the timed region). With
    ``--parent``, the parent's pass is timed in the same call, in turns
    (parent, new, new, parent)."""
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_slots

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
            times.update(time_505m(torch, args, new_k, tab_k, merge_insert, merge_insert_slots))
        del args, new_k, tab_k
    torch.cuda.empty_cache()
    return max_err, times


def time_505m(torch, args, new_k, tab_k, merge_insert, merge_insert_slots):
    """Times of the 505M pass: the kernel (prep included: it takes the slots)
    and the plain version; with ``--parent``, the parent's pass by the same
    contract (``old, q, v, active -> out, table``) through its own library,
    equal to this one's and timed in turns (the ratio logged, not checked)."""
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW

    old_t, q_t, v_t, a_t = args
    n, N = old_t.shape[0], q_t.shape[0]
    out, tab = torch.empty_like(new_k), torch.empty_like(tab_k)
    nb = tab.shape[0] - 1
    bound_bytes = 2 * n + 6 * N + tab.numel() * 4  # old, q/v/active, new, table
    times = {"bound_ms": bound_bytes / DEFAULT_HBM_BW * 1e3, "parent_ms": None}
    new_fn = lambda: merge_insert(*args, out=out, table=tab)  # noqa: E731
    got = {"new": [cuda_ms(new_fn, 20), cuda_ms(new_fn, 20)]}
    if PARENT is not None:
        scratch = torch.empty(PARENT.msbwt_merge_insert_scratch_len(n, N),
                              dtype=torch.int32, device=old_t.device)
        stream = torch.cuda.current_stream(old_t.device).cuda_stream

        def parent_fn():
            err = PARENT.msbwt_merge_insert(
                old_t.data_ptr(), q_t.data_ptr(), v_t.data_ptr(), a_t.data_ptr(), out.data_ptr(),
                tab.data_ptr(), scratch.data_ptr(), n, N, stream)
            check(err == 0, f"parent kernel launch: CUDA error {err}")

        parent_fn()
        torch.cuda.synchronize()
        check(torch.equal(out, new_k) and torch.equal(tab, tab_k), "the parent's pass != this one")
        got = turns({"parent": parent_fn, "new": new_fn}, 20)
        times["parent_ms"] = sum(got["parent"]) / 2
    times["ms"] = sum(got["new"]) / len(got["new"])
    times["plain_ms"] = cuda_ms(lambda: merge_insert_slots(*args, out=out, table=tab), 3)
    gbs = bound_bytes / (times["ms"] * 1e-3) / 1e9
    log(f"[kernel] 505M pass ({n} positions, {N} inserts, {nb} bins), prep included, "
        "inputs on the card: kernel " + " / ".join(f"{x:.4f}" for x in got["new"])
        + f" ms (mean {times['ms']:.4f}; bound {times['bound_ms']:.4f} ms for "
        f"{bound_bytes} B at 3.35 TB/s -> {times['bound_ms'] / times['ms']:.1%} of it, "
        f"{gbs:.1f} GB/s); plain {times['plain_ms']:.4f} ms")
    if times["parent_ms"] is not None:
        log("[kernel] the parent's pass, turns parent / new / new / parent: "
            f"{got['parent'][0]:.4f} / {got['new'][0]:.4f} / {got['new'][1]:.4f} / "
            f"{got['parent'][1]:.4f} ms -> parent / new = "
            f"{times['parent_ms'] / times['ms']:.3f}")
    return times


def phase_lf_edges(torch, dev):
    """Phase 3b: the LF-step kernels == their plain twins on the card at the
    edge shapes of tests/test_torch_gpu.py, exact (and, with ``--parent``,
    == the parent's kernels): ``lf_stage``'s, the walks', and ``lf_pair``'s
    column-pair kinds (tile edges, full and empty tiles, tiles at their
    bucket's edges, clustered and many overfull tiles, m2 = 0, 1.1M
    reads)."""
    from rust_msbwt_tpu_torch.ops import lf

    from test_torch_gpu import (  # tests/ (on sys.path)
        LF_PAIR_KINDS,
        LF_STAGE_KINDS,
        LF_WALK_KINDS,
        _as_list,
        lf_pair_args,
        lf_pair_case,
        lf_stage_args,
        lf_stage_case,
        lf_walk_calls,
        lf_walk_case,
        pair_bucket,
        pair_tile,
    )

    cases = [(f"lf_stage {k}", lf.lf_stage, lf.lf_stage_plain,
              lf_stage_args(lf_stage_case(k, len(k)), dev)) for k in LF_STAGE_KINDS]
    cases.append(("lf_stage grid (N = 1,100,003)", lf.lf_stage, lf.lf_stage_plain,
                  lf_stage_args(lf_stage_case("ragged", 99, N=1_100_003), dev)))
    tile, bucket = pair_tile(), pair_bucket()
    cases += [(f"lf_pair {k}", lf.lf_pair, lf.lf_pair_plain,
               lf_pair_args(lf_pair_case(k, len(k), tile=tile, bucket=bucket), dev))
              for k in LF_PAIR_KINDS]
    cases.append(("lf_pair grid (N = 1,100,003)", lf.lf_pair, lf.lf_pair_plain,
                  lf_pair_args(lf_pair_case("ragged", 99, N=1_100_003, tile=tile,
                                            bucket=bucket), dev)))
    for k in LF_WALK_KINDS:
        cases += [(f"lf_walk {w} ({k})", *call)
                  for w, call in lf_walk_calls(lf_walk_case(k, len(k)), dev).items()]
    for name, kernel, plain, args in cases:
        got, want = _as_list(kernel(*args)), _as_list(plain(*args))
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: kernel != plain")
        parent_lf(torch, name, kernel.__name__, args, reps=0)
    torch.cuda.synchronize()
    log(f"[lf] edge shapes: {len(cases)} cases, kernel == plain on the card, exact: "
        + ", ".join(name for name, *_ in cases))


def phase_query_edges(torch, dev):
    """Phase 3b (queries): both query kernels == their plain twins on the
    card at the query edge shapes of tests/test_torch_gpu.py, exact."""
    from test_torch_gpu import QUERY_CASES, QUERY_SIZE_CASES, _as_list, query_calls, query_case

    names = []
    for kind, ck, B in ([(k, ck, None) for k, ck in QUERY_CASES]
                        + [("ragged", ck, B) for B, ck in QUERY_SIZE_CASES]):
        case = query_case(kind, ck, B=B)
        name = f"{kind}" + (f" + 6^{ck}" if ck else "")
        for tier, (kernel, plain, args) in query_calls(case, dev).items():
            got, want = _as_list(kernel(*args)), _as_list(plain(*args))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{tier} {name}: kernel != plain")
            parent_hold(torch, f"{tier} {name}", tier, kernel, [args], reps=0)
        names.append(f"{name} (B = {case['kmers'].shape[0]}, n = {case['dec'].size})")
    torch.cuda.synchronize()
    log(f"[query] edge shapes, packed and pair tiers: {len(names)} cases, kernel == plain on "
        "the card, exact: " + ", ".join(names))


def phase_lf_stage(torch, dev, reads, lengths, idx):
    """Phase 6b: phase 6's reads through the device stage loop once more,
    keeping the ``lf_stage`` inputs of columns STREAM_COLS (the 505M loop's
    own tables and carries, 5M reads; LF_COL among them); the loop's BWT ==
    phase 6's; the kernel == the plain twin on column LF_COL's inputs, both
    timed against the column's bound. Returns the hold and the kept
    columns' arguments."""
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    p = bcr._prepare_build(reads, lengths, True)
    with capture(bcr, "lf_stage", keep=lambda j, *a: j in STREAM_COLS) as seen:
        buf, _, _ = bcr._build_device(p, dev, merge_insert)
    check(torch.equal(buf[: idx.n], idx.bwt[: idx.n]), "505M stage loop != phase 6's BWT")
    del buf, p
    check(tuple(a[0] for a in seen) == STREAM_COLS, f"kept columns {[a[0] for a in seen]}")
    args = seen[STREAM_COLS.index(LF_COL)]
    res = hold_stage(torch, "the 505M loop", args)
    log(f"[lf] lf_stage: the access model (96 B of row + 20 B of carry a read) "
        f"{116 * args[5].numel() / 3.35e12 * 1e3:.4f} ms")
    torch.cuda.empty_cache()
    return res, seen


def two_stream_stage(torch, fns, kept, want, reps):
    """``fns[k]`` (an ``lf_stage`` wrapper) ``reps`` times on each of two
    streams, stream k on ``kept[k]`` (a column's arguments), the launches
    alternating with no sync between them; each stream first runs a spin
    kernel, so the launches queue up behind it and the two queues drain on
    the card together (launches uncounted). Returns, for each stream, how
    many of its repetitions differ from ``want[k]`` (the twin's outputs)
    and how many of those in ``counts_out``, and whether every launch was
    queued before the spin ended."""
    streams = [torch.cuda.Stream() for _ in kept]
    outs = [[] for _ in kept]
    gate = torch.cuda.Event()
    with uncounted():
        for k, s in enumerate(streams):  # each library's kernel loaded before the spins
            with torch.cuda.stream(s):
                fns[k](*kept[k])
        torch.cuda.synchronize()
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(2_000_000_000)  # ~1 s: longer than the launches' enqueue
        gate.record(streams[-1])
        for _ in range(reps):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[k].append(fns[k](*kept[k]))
        held = not gate.query()  # every launch queued while the spin ran
        torch.cuda.synchronize()
    bad = [[not all(torch.equal(g, w) for g, w in zip(o, want[k])) for o in outs[k]]
           for k in range(len(kept))]
    bad_counts = [sum(not torch.equal(o[4], want[k][4]) for o in outs[k])
                  for k in range(len(kept))]
    return [sum(b) for b in bad], bad_counts, held


def phase_two_streams(torch, dev, reads, lengths, idx, kept):
    """Phase 6c: concurrent use of one card. (a) ``lf_stage`` on two
    streams at once, stream k on column STREAM_COLS[k]'s kept 505M inputs,
    STREAM_REPS launches a stream: every repetition == the twin; with
    ``--parent`` the parent's ``lf_stage`` on the same hold (on a private
    copy of its library, ``private_copy``), its repetitions that differ
    logged, not checked (a race need not fire in every run). (b) two one-shot ``build_msbwt_with_index`` of phase 6's
    reads at once, from two threads each under its own stream (counts reset
    just before): both BWTs == phase 6's, byte for byte; their wall beside
    one build's on the default stream just before. The launch counters
    are plain ``+=`` and may lose increments under threads, so the builds
    are checked by their bytes and their counts only for being non-zero."""
    import threading

    from rust_msbwt_tpu_torch.ops import lf
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.utils.profiling import timed

    want = [lf.lf_stage_plain(*a) for a in kept]
    res = {"columns": list(STREAM_COLS), "reps": STREAM_REPS}
    holds = {"new, a scratch a stream": [loop_stage(dev) for _ in kept],  # the stage loop's way
             "new, a scratch a call": [lf.lf_stage] * len(kept)}
    if PARENT_RACE_LF is not None:
        holds["parent"] = [PARENT_RACE_LF.lf_stage] * len(kept)
    for who, fns in holds.items():
        bad, bad_counts, held = two_stream_stage(torch, fns, kept, want, STREAM_REPS)
        res[who] = {"differ": bad, "differ_in_counts": bad_counts, "queued_behind_spin": held}
        log(f"[streams] lf_stage ({who}) on two streams at columns {STREAM_COLS} of the 505M "
            f"loop, {STREAM_REPS} launches a stream (all queued behind the spin: {held}): "
            f"{bad} repetitions differ from the twin ({bad_counts} in counts_out)"
            + (" (logged, not checked)" if who == "parent" else ""))
        if who != "parent":
            check(sum(bad) == 0, f"lf_stage ({who}) on two streams != the twin: {bad}")
    del want
    torch.cuda.empty_cache()

    streams = [torch.cuda.Stream() for _ in range(2)]
    out, errors = [None, None], []
    gate = threading.Barrier(2)

    def run(k):
        try:
            with torch.cuda.stream(streams[k]):
                gate.wait()
                out[k] = build_msbwt_with_index(reads, lengths, device=dev)[0]
                streams[k].synchronize()
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    one_s, _ = timed(lambda: build_msbwt_with_index(reads, lengths, device=dev))
    torch.cuda.empty_cache()
    # --- the two-stream path: counts reset just before, read just after ---
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = path_counts()
    # --- end of the two-stream path ---
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    for k, got in enumerate(out):
        check(got.n == idx.n and torch.equal(got.bwt[: idx.n], idx.bwt[: idx.n]),
              f"build {k} of two on two streams != phase 6's BWT")
    check(launches["merge_insert"] > 0 and launches["lf_stage"] > 0,
          f"the two builds: merge kernel launches {launches['merge_insert']}, "
          + lf_line(launches))
    log(f"[streams] two 505M builds at once on two streams (two threads): {wall:.3f} s for "
        f"both (one build alone {one_s:.3f} s); both BWTs == phase 6's, byte for byte; "
        f"merge kernel launches {launches['merge_insert']} (2 x {READ_LEN + 1} if no "
        f"increment was lost), " + lf_line(launches))
    res.update({"builds_wall_s": wall, "one_build_s": one_s})
    del out
    torch.cuda.empty_cache()
    return res


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
        reset_counts()
        with plain_lf() if name == "plain" else contextlib.nullcontext():
            base, _ = build_msbwt_with_index(reads[:10_000], lengths[:10_000],
                                             device=dev, merge=merge)
            t0 = time.perf_counter()
            out[name] = build_msbwt_with_index(reads[10_000:], lengths[10_000:], True,
                                               base.bwt[: base.n], 10_000,
                                               device=dev, merge=merge)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launched = path_counts()
        log(f"[extend-10k] {name}: extend of 10k onto {base.n} symbols "
            f"{dt:.3f} s, merge kernel launches {launched['merge_insert']}, "
            + lf_line(launched))
        kernels = (launched["merge_insert"], launched["lf_stage"], launched["lf_walk_cyclic"],
                   launched["lf_walk_lengths"])
        check(min(kernels) > 0 if name == "kernel" else max(kernels) == 0,
              f"extend-10k ({name}): launches {launched}")
    (idx_k, pk), (idx_p, pp) = out["kernel"], out["plain"]
    check(torch.equal(idx_k.bwt, idx_p.bwt) and torch.equal(pk.table, pp.table),
          "10k extend: kernels != plain merge and LF step")
    want = baseline_build_native(list(reads), sorted_insert=True)
    check(np.array_equal(idx_k.bwt[: idx_k.n].cpu().numpy(), want),
          "10k + 10k extend != native reference builder over 20k")
    log(f"[extend-10k] {idx_k.n} symbols: kernels == plain, byte-identical to "
        "csrc/msbwt_baseline.cpp over all 20k reads")


def median_s(torch, fn, reps=3):
    """Median wall seconds of ``fn()`` over ``reps`` fenced calls, and the
    last call's result."""
    from rust_msbwt_tpu_torch.utils.profiling import timed

    runs = [timed(fn) for _ in range(reps)]
    return sorted(s for s, _ in runs)[len(runs) // 2], runs[-1][1]


def phase_main(torch, np, dev, reads, lengths, kmers):
    """Phase 6: the 505M main path through the kernel, then checks."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert_slots
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
    reset_counts()
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
    launches = path_counts()
    # --- end of the main path ---

    log(f"[main] build+index {build_s:.3f} s for {idx.n} symbols -> "
        f"{n_bases / build_s / 1e6:.2f} Mbases/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; merge kernel launches {launches['merge_insert']}, "
        + lf_line(launches))
    log(f"[main] 6^8 cache {cache_s:.3f} s; 1M x {K}-mer counts median "
        f"{q_s:.3f} s -> {N_QUERIES / q_s:.0f} q/s (host in/out included); "
        f"mean count {counts.mean():.2f}")
    check(launches["merge_insert"] == READ_LEN + 1,
          f"the main path launched {launches['merge_insert']} merge passes, not "
          f"{READ_LEN + 1} (radix 1)")
    check(launches["lf_stage"] == READ_LEN and launches["lf_walk"] == 0,
          f"the main path: {lf_line(launches)}, not {READ_LEN} columns and no walk")
    check(launches["kmer_ranges_packed"] == 3 and launches["kmer_counts_pair"] == 0,
          f"the main path's three count batches: {lf_line(launches)}")
    check(idx.n == n_bases + N_READS, "BWT length")
    check(counts.shape == (N_QUERIES,) and counts.min() >= 1,
          "every query k-mer occurs in the reads")

    reset_counts()
    t0 = time.perf_counter()
    with plain_lf():
        idx_p, packed_p = build_msbwt_with_index(reads, lengths, device=dev,
                                                 merge=merge_insert_slots)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = path_counts()
    check(torch.equal(idx.bwt, idx_p.bwt) and torch.equal(packed.table, packed_p.table),
          "505M build: kernels != plain merge and LF step")
    check(max(plain_launches.values()) == 0, f"505M plain build launched {plain_launches}")
    log(f"[main] same build with the plain merge and LF step on the card: {plain_s:.3f} s "
        "(no kernel launched); BWT and packed table identical")
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
    from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder

    n_batches = N_READS // BATCH
    builder = StreamingBuilder(device=dev)
    # --- the streamed path: counts reset just before, read just after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    launches = path_counts()
    peak = torch.cuda.max_memory_allocated()
    # --- end of the streamed path ---
    stream_s = sum(batch_s)
    n_bases = int(lengths.sum())
    log(f"[stream] {n_batches} x {BATCH} reads: {stream_s:.3f} s -> "
        f"{n_bases / stream_s / 1e6:.2f} Mbases/s; per batch "
        + ", ".join(f"{t:.3f}" for t in batch_s)
        + f" s; peak device memory {peak / 2**30:.2f} GiB; merge kernel "
        f"launches {launches['merge_insert']}, " + lf_line(launches))
    log(f"[stream] checkpoint after {n_batches - 1} batches: {ckpt_s:.3f} s, "
        f"{os.path.getsize(ckpt)} bytes")
    check(launches["merge_insert"] > 0, "the streamed path launched no merge kernel")
    check(launches["lf_stage"] == n_batches * READ_LEN
          and launches["lf_walk_cyclic"] == n_batches - 1,
          f"the streamed path: {lf_line(launches)}")
    got = builder.finish(device_out=True)
    check(torch.equal(got, idx.bwt[: idx.n]), "streamed BWT != one-shot BWT")
    log("[stream] BWT identical to the one-shot build")
    return launches


def phase_load_extend(torch, np, dev, reads, lengths, idx, ckpt):
    """Phase 8: load the 404M checkpoint, extend it by the last 1M reads;
    append ``APPEND`` of them onto the base at the automatic radix."""
    from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    from rust_msbwt_tpu_torch.ops import bcr, lf
    from rust_msbwt_tpu_torch.ops.rle import decode_symbols_device
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native
    from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes
    from rust_msbwt_tpu_torch.utils.profiling import timed

    last = slice(N_READS - BATCH, N_READS)
    # --- the load-and-extend path: counts reset just before, read after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    launches = path_counts()
    peak = torch.cuda.max_memory_allocated()
    # --- end of the load-and-extend path ---
    log(f"[load-extend] load {load_s:.3f} s (npy read + device decode of "
        f"{dyn.get_total_size() - int(lengths[last].sum()) - BATCH} symbols); "
        f"insert {BATCH} reads + materialize {extend_s:.3f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB; merge kernel launches {launches['merge_insert']}, "
        + lf_line(launches))
    check(launches["merge_insert"] > 0, "the load-and-extend path launched no merge kernel")
    check(launches["lf_stage"] == READ_LEN and launches["lf_walk_lengths"] == 1
          and launches["lf_walk_cyclic"] == 1, f"the load-and-extend path: {lf_line(launches)}")
    check(got.n == idx.n and torch.equal(got.bwt[: got.n], idx.bwt[: idx.n]),
          "load + extend BWT != one-shot BWT")
    log("[load-extend] BWT identical to the one-shot build")
    del dyn, got

    # the same extend's parts, timed apart on a fresh load
    n_strings = N_READS - BATCH
    parts = {}

    def part(name, fn):
        parts[name], res = timed(fn)
        return res

    rle = part("npy_read", lambda: load_bwt_bytes(ckpt))
    base = part("device_decode", lambda: decode_symbols_device(rle, device=dev))
    bidx, bpacked = part("index", lambda: bcr.index_from_symbols(base))
    rl = part("read_lengths", lambda: bcr.read_lengths_from_bwt(bidx, n_strings, bpacked))
    check(rl.shape == (n_strings,) and int(rl.min()) == int(rl.max()) == READ_LEN,
          "recovered read lengths")
    part("encode_reads", lambda: bcr.encode_reads(list(reads[last])))
    order = sort_rows_native(reads[last])
    with capture(bcr, "lf_walk_cyclic") as walk_args:
        tp = part("terminator_positions", lambda: bcr.terminator_positions(
            bidx, reads[last][order], lengths[last][order], READ_LEN + 1, bpacked))
    check(tp.shape == (BATCH,) and bool((tp[1:] >= tp[:-1]).all()),
          "terminator ranks of sorted reads are sorted")
    ext = part("extend_build", lambda: bcr.build_msbwt_with_index(
        reads[last], lengths[last], True, base, n_strings, READ_LEN + 1,
        device=dev, base_index=bpacked))
    check(torch.equal(ext[0].bwt[: ext[0].n], idx.bwt[: idx.n]),
          "extend build (known index and bound) != one-shot BWT")
    log("[load-extend] parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + " (encode_reads: the host packing insert_strings does; "
        "terminator_positions includes the host stage view of 1M reads; "
        "extend_build includes its own terminator walk)")
    append = phase_append(torch, dev, reads[last][:APPEND], lengths[last][:APPEND], base,
                          bpacked, n_strings)
    # the terminator walk through the kernel and its plain twin, on its inputs
    (args,) = walk_args
    del ext, rle, base, tp, walk_args
    walk = hold_walk(torch, f"terminator walk ({BATCH} walkers, {args[6]} steps, on the "
                     f"{bpacked.n}-symbol base)", "cyclic", lf.lf_walk_cyclic,
                     lf.lf_walk_cyclic_plain, args, plain_reps=1)
    walk["loop_steps"] = args[6]
    log(f"[lf] terminator walk: kernel {walk['ms'] / args[6]:.4f} ms a step, plain "
        f"{walk['plain_ms'] / args[6]:.3f} ms a step")
    return launches, walk, append


def phase_append(torch, dev, reads, lengths, base, bpacked, n_strings):
    """Phase 8's append: ``reads`` onto ``base`` (its index and bound
    given, as the benchmark's append), at the automatic radix, which must be
    2, with its launches counted (counts reset just before) and its last
    pair's ``lf_pair`` inputs kept; == the forced radix-1 append, BWT and
    table; then the kept pair held against the twin (``hold_pair``).
    Returns the launches and the hold."""
    from rust_msbwt_tpu_torch.ops import bcr

    N = reads.shape[0]
    n_cap = int(base.shape[0]) + int(lengths.sum()) + N
    radix = bcr.build_radix(n_cap, N)
    check(radix == 2, f"an append of {N} reads onto {base.shape[0]} symbols takes radix {radix}")

    def append():
        idx, packed = bcr.build_msbwt_with_index(reads, lengths, True, base, n_strings,
                                                 READ_LEN + 1, device=dev, base_index=bpacked)
        return idx.bwt, packed.table

    # --- the append at the automatic radix: counts reset just before ---
    torch.cuda.synchronize()
    reset_counts()
    with capture(bcr, "lf_pair", keep=lambda j, *a: j == READ_LEN) as kept:
        got = append()
    torch.cuda.synchronize()
    launches = path_counts()
    # --- end of the append ---
    log(f"[append] {N} reads onto the {base.shape[0]}-symbol base ({n_cap / N:.0f} buffer "
        f"symbols a new read, radix {radix}): merge kernel launches "
        f"{launches['merge_insert']}, " + lf_line(launches))
    check(launches["merge_insert"] == READ_LEN // 2 + 1 and launches["lf_pair"] == READ_LEN // 2
          and launches["lf_stage"] == 0, f"the append: {launches['merge_insert']} passes, "
          + lf_line(launches))
    with radix_env(1):
        want = append()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "the append at radix 2 != the forced radix-1 append")
    log("[append] BWT and table identical to the forced radix-1 append")
    del got, want
    check(len(kept) == 1, f"the append kept {len(kept)} column pairs")
    pair = hold_pair(torch, f"the {N}-read append onto {base.shape[0]} symbols (its last pair)",
                     kept.pop())
    return {"launches": launches, "pair": pair}


def phase_recovery(torch, np, dev, reads, idx, packed, kmers, counts):
    """Phase 9: extract 100k reads and locate 1,000 21-mers on phase 6's
    index (counts reset just before, read just after); then the read-length,
    extract and locate walks on those inputs through the kernel and the
    plain twin, and the locate's uncached range search through
    ``kmer_ranges_packed`` and its twin."""
    from rust_msbwt_tpu_torch.ops import extract, lf, query
    from rust_msbwt_tpu_torch.ops.bcr import read_lengths_from_bwt
    from rust_msbwt_tpu_torch.ops.packed_rank import kmer_ranges_packed_plain
    from rust_msbwt_tpu_torch.ops.extract import extract_reads, locate_kmers
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    sorted_reads = reads[sort_rows_native(reads)]
    ids = np.random.default_rng(0x1D5).integers(0, N_READS, N_EXTRACT)
    # --- the recovery path: counts reset just before, read just after ---
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    l_max = int(read_lengths_from_bwt(idx, N_READS, packed).max())
    rl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with capture(extract, "lf_walk_extract") as ex_args:
        got = extract_reads(idx, ids, N_READS, l_max=l_max, packed=packed)
    ex_s = time.perf_counter() - t0
    check(l_max == READ_LEN and np.array_equal(np.stack(got), sorted_reads[ids]),
          "extracted reads != the sorted reads' rows")
    log(f"[recovery] read-length walk over {N_READS} strings {rl_s:.3f} s; "
        f"extract {N_EXTRACT} reads {ex_s:.3f} s -> {N_EXTRACT / ex_s:.0f} reads/s "
        "(host out included); equal to the sorted reads")
    q_kmers = kmers[:N_LOCATE]
    t0 = time.perf_counter()
    with (capture(extract, "lf_walk_locate") as loc_args,
          capture(extract, "_kmer_ranges_packed_impl", clone=False) as range_args):
        q, rid, off = locate_kmers(idx, q_kmers, N_READS, l_max=l_max, packed=packed)
    loc_s = time.perf_counter() - t0
    launches = path_counts()
    # --- end of the recovery path ---
    where = sorted_reads[rid[:, None], off[:, None] + np.arange(K)[None, :]]
    check(bool((where == q_kmers[q]).all()), "a located hit is not its k-mer")
    check(np.array_equal(np.bincount(q, minlength=N_LOCATE), counts[:N_LOCATE]),
          "hits per query != phase 6 counts")
    log(f"[recovery] locate {N_LOCATE} x {K}-mers: {q.size} hits in {loc_s:.3f} s "
        f"-> {q.size / loc_s:.0f} hits/s (host in/out included); every hit "
        "checked, hits per query == phase 6 counts; " + lf_line(launches))
    check((launches["lf_walk_lengths"], launches["lf_walk_extract"], launches["lf_walk_locate"],
           launches["kmer_ranges_packed"]) == (1, 1, 1, 1),
          f"the recovery path: {lf_line(launches)}")
    walks = {}
    for name, kernel, plain, args in (
            ("lengths", lf.lf_walk_lengths, lf.lf_walk_lengths_plain,
             (idx.bwt, packed.table, packed.starts, packed.n, N_READS)),
            ("extract", lf.lf_walk_extract, lf.lf_walk_extract_plain, ex_args[0]),
            ("locate", lf.lf_walk_locate, lf.lf_walk_locate_plain, loc_args[0])):
        walkers = N_READS if name == "lengths" else args[3].numel()
        walks[name] = hold_walk(torch, f"{name} walk ({walkers} walkers at {packed.n} symbols)",
                                name, kernel, plain, args)
    (rargs,) = range_args
    check(len(rargs) == 5, "the locate's range search was given a cache")
    name = f"locate's range search ({rargs[3].shape[0]} x {K}-mers from [0, {rargs[2]}), no cache)"
    ranges = {"max_abs_err": agree(torch, name, query.kmer_ranges_packed,
                                   kmer_ranges_packed_plain, rargs, tag="query"),
              **parent_hold(torch, name, "packed", query.kmer_ranges_packed, [rargs], reps=20)}
    return launches, walks, ranges


def substituted_reads(np, reads):
    """The first ``N_CORRECT`` reads and a copy with one substitution in
    each (an A, C, G or T turned into another of the four), from seed
    0xC0EC7: ``(orig, bad)``."""
    rng = np.random.default_rng(0xC0EC7)
    orig = reads[:N_CORRECT].copy()
    bad = orig.copy()
    dna = np.array([1, 2, 3, 5], np.uint8)
    for i in range(N_CORRECT):
        p = rng.choice(np.flatnonzero(orig[i] != 4))
        bad[i, p] = rng.choice(dna[dna != orig[i, p]])
    return orig, bad


def phase_query_tiers(torch, np, dev, reads, idx, packed, kmers, counts, cache8, rle, d):
    """Phase 10: the query side at 505M on phase 6's index and reads."""
    from rust_msbwt_tpu_torch.apps.correct import correct_reads
    from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
    from rust_msbwt_tpu_torch.ops import pair_rank, query
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache
    from rust_msbwt_tpu_torch.ops.run_rank import (
        build_kmer_cache_runs,
        build_run_index_from_bytes,
        count_kmers_runs,
    )
    from rust_msbwt_tpu_torch.utils.npy import save_bwt_bytes
    from rust_msbwt_tpu_torch.utils.profiling import timed

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
    # both query kernels against their twins on the 505M tensors of a leg
    km = torch.tensor(kmers, device=dev)
    ln = torch.full((N_QUERIES,), K, dtype=torch.int32, device=dev)
    holds = {
        "packed_6^8": hold_query(torch, f"packed + 6^8, 1M x {K}-mers at {packed.n} symbols",
                                 "packed", (packed.table, packed.starts, packed.n, km, ln,
                                            cache8, 8), packed),
        "pair_6^9": hold_query(torch, f"pair + 6^9, 1M x {K}-mers at {pair.n} symbols", "pair",
                               (pair.table2, pair.starts, pair.dmat, pair.n, km, ln, cache9, 9),
                               packed)}
    del km, ln, pair, cache9

    # RleBWT from disk: the tier policy picks pair + 6^9 by itself
    npy = os.path.join(d, "bwt505.npy")
    save_bwt_bytes(rle, npy)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bwt = RleBWT(device=dev)
    bwt.load_numpy_file(npy)
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = bwt.count_kmers(kmers)
    first_s = time.perf_counter() - t0
    first = path_counts()
    above = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    tier_ok = bwt._pair_index is not None and bwt._cache_k == 9 and bwt._run_index is None
    log(f"[tiers] RleBWT.load_numpy_file {load_s:.3f} s (npy read + the host pass over "
        f"the RLE bytes); first count_kmers {first_s:.3f} s (device decode, index, pair "
        f"index, 6^9 cache, 1M counts); tier pair + 6^{bwt._cache_k}; merge kernel "
        f"launches {first['merge_insert']}, {lf_line(first)}; its peak "
        f"{above / 2**30:.3f} GiB above what stays resident (the headroom at 505M)")
    check(tier_ok, "RleBWT did not pick pair + 6^9 at 505M")
    check(first["merge_insert"] >= 1, "RleBWT's load launched no merge kernel")
    check(np.array_equal(got, counts), "RleBWT counts != phase 6 counts")
    s, got = median_s(torch, lambda: bwt.count_kmers(kmers))
    launches = path_counts()
    # --- end of the RleBWT query path (load, first batch, three warm ones) ---
    check(np.array_equal(got, counts), "RleBWT counts != phase 6 counts")
    check((first["kmer_counts_pair"], launches["kmer_counts_pair"],
           launches["kmer_ranges_packed"]) == (1, 4, 0),
          f"RleBWT's pair + 6^9 batches: first {lf_line(first)}; after three warm "
          f"{lf_line(launches)}")
    log(f"[tiers] RleBWT.count_kmers warm: median {s:.4f} s -> {N_QUERIES / s:.0f} q/s; "
        f"one kmer_counts_pair launch a batch ({launches['kmer_counts_pair']} in the path)")
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

    # --- the correction path: one substitution in each of 10,000 reads; counts
    # reset just before, read just after (its pair batches kept) ---
    orig, bad = substituted_reads(np, reads)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with capture(pair_rank, "_count_kmers_pair_impl", clone=False) as batches:
        fixed, n_fixed = correct_reads(fresh, bad, k=K, tau=2)
    corr_s = time.perf_counter() - t0
    correct = path_counts()
    # --- end of the correction path ---
    n_equal = int((fixed == orig).all(axis=1).sum())
    log(f"[tiers] correct_reads(k={K}, tau=2) of {N_CORRECT} reads: {corr_s:.3f} s -> "
        f"{N_CORRECT / corr_s:.0f} reads/s; {n_fixed} bases fixed, {n_equal} reads equal "
        f"to their originals; {lf_line(correct)}")
    check(n_equal == N_CORRECT, "a corrected read differs from its original")
    check(correct["kmer_counts_pair"] == len(batches) > 0 and correct["kmer_ranges_packed"] == 0,
          f"the correction path: {len(batches)} pair batches kept, {lf_line(correct)}")
    holds["correct"] = {"batches": len(batches), "max_abs_err": max(
        agree(torch, f"correction's pair batch {i} ({b[4].shape[0]} x {b[4].shape[1]}-mers, "
              f"6^{b[7]} cache)", query.kmer_counts_pair, pair_rank.kmer_counts_pair_plain, b,
              tag="query")
        for i, b in enumerate(batches)),
        **batches_hold(torch, f"the correction's {len(batches)} pair batches "
                       f"({sum(b[4].shape[0] for b in batches)} k-mers)", "pair",
                       query.kmer_counts_pair, batches)}
    del batches
    return launches, correct, holds


def phase_merge_parts(torch, np, dev, reads, lengths, idx):
    """Phase 11a: the sorted reads in four groups, built through the kernel
    (launches counted), merged in one doubling run == phase 6's BWT."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.ops.merge import multiway_bwt_merge
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    order = sort_rows_native(reads)
    s_reads, s_lengths = reads[order], lengths[order]
    nl = -(-N_READS // N_PARTS)
    # --- the parts' builds: counts reset just before, read just after ---
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    parts = [build_msbwt(s_reads[g * nl: (g + 1) * nl], s_lengths[g * nl: (g + 1) * nl],
                         device=dev, device_out=True) for g in range(N_PARTS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = path_counts()
    # --- end of the parts' builds ---
    del s_reads, s_lengths
    check(launches["merge_insert"] > 0, "the parts' builds launched no merge kernel")
    check(launches["lf_stage"] == N_PARTS * READ_LEN, f"the parts' builds: {lf_line(launches)}")
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
        f"({sizes} symbols; merge kernel launches {launches['merge_insert']}, "
        f"{lf_line(launches)}); multiway_bwt_merge "
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
    found = re.search(r"over (\w+) .*\n(?s:.*)merge kernel launches (\d+), lf_stage "
                      r"launches (\d+), lf_walk launches (\d+)", res.stderr)
    check(found is not None, "the distributed build logged no backend or launch counts")
    backend = found.group(1)
    launches = dict(zip(("merge_insert", "lf_stage", "lf_walk"), map(int, found.groups()[1:])))
    same = open(out, "rb").read() == open(want, "rb").read()
    check(same, "distributed build npy != phase 6's BWT")
    check(backend == "nccl" and launches["merge_insert"] > 0
          and launches["lf_stage"] == READ_LEN,
          f"distributed build: backend {backend}, launches {launches}")
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
        f"launches {launches['merge_insert']}, lf_stage launches {launches['lf_stage']}, "
        f"lf_walk launches {launches['lf_walk']}; npy ({os.path.getsize(out)} bytes) "
        "identical to phase 6's BWT")
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


@contextlib.contextmanager
def radix_env(radix):
    """``MSBWT_TPU_RADIX`` set to ``radix`` inside the block (None: unset,
    the automatic choice), restored after."""
    old = os.environ.pop("MSBWT_TPU_RADIX", None)
    if radix is not None:
        os.environ["MSBWT_TPU_RADIX"] = str(radix)
    try:
        yield
    finally:
        os.environ.pop("MSBWT_TPU_RADIX", None)
        if old is not None:
            os.environ["MSBWT_TPU_RADIX"] = old


def phase_long(torch, np, dev):
    """Phase 12a-c: 500k x 1,000 bp reads (500.5M symbols) built at radix 1
    and at radix 2 (counts reset before each): equal BWTs and tables, 1,001
    and 501 passes, 1,000 ``lf_stage`` launches and 500 ``lf_pair`` calls;
    entry points and device loops timed in turns, one loop at each radix
    profiled for its device events a column; column 1,000's ``lf_stage`` at
    radix 1, the last pair's ``lf_pair`` (columns 1,000 and 1,001) at radix
    2 and the last full-size radix-2 pass through the kernels == the plain
    twins; a 20k-read radix-2 build through the plain pass and LF steps ==
    the kernels'; a 400k + 100k load-and-extend at the automatic radix (2)
    == the one-shot BWT, its two walks through ``lf_walk`` == the twins."""
    from statistics import median

    from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    from rust_msbwt_tpu_torch.ops import bcr, lf
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_slots
    from rust_msbwt_tpu_torch.ops.rle import encode_symbols
    from rust_msbwt_tpu_torch.utils.profiling import DEFAULT_HBM_BW, timed

    from portbench.roofline import merge_pass_bytes

    reads, lengths = genome_reads(np, LONG_READS, LONG_LEN, 0x10C6)
    n = LONG_READS * (LONG_LEN + 1)
    out, builds = {}, {1: [], 2: []}
    for radix in (1, 2):
        with radix_env(radix):
            # --- the long-read path at this radix: counts reset just before ---
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            s, (idx, packed) = timed(lambda: bcr.build_msbwt_with_index(reads, lengths,
                                                                         device=dev))
            out[radix] = (idx, packed, path_counts(), torch.cuda.max_memory_allocated())
            # --- end of the long-read path ---
            builds[radix].append(s)
    (i1, p1, l1, peak1), (i2, p2, l2, peak2) = out[1], out[2]
    check(i1.n == i2.n == n, "long-read BWT length")
    check(torch.equal(i1.bwt, i2.bwt) and torch.equal(p1.table, p2.table),
          "500.5M long-read build: radix 2 != radix 1")
    check((l1["merge_insert"], l2["merge_insert"]) == (LONG_LEN + 1, LONG_LEN // 2 + 1),
          f"long-read passes {l1['merge_insert']} / {l2['merge_insert']}, not "
          f"{LONG_LEN + 1} / {LONG_LEN // 2 + 1}")
    check((l1["lf_stage"], l2["lf_stage"], l1["lf_pair"], l2["lf_pair"])
          == (LONG_LEN, 0, 0, LONG_LEN // 2),
          f"long-read lf_stage launches {l1['lf_stage']} / {l2['lf_stage']}, lf_pair "
          f"{l1['lf_pair']} / {l2['lf_pair']}")
    del i2, p2, out
    for radix in (2, 1):  # one more entry-point build each, the other order
        with radix_env(radix):
            builds[radix].append(timed(lambda: bcr.build_msbwt_with_index(
                reads, lengths, device=dev))[0])
    p = bcr._prepare_build(reads, lengths, True)
    loops = {1: [], 2: []}
    for rnd in range(3):  # device loops in turns, the order flipped each round
        for radix in ((1, 2) if rnd % 2 == 0 else (2, 1)):
            with radix_env(radix):
                loops[radix].append(timed(lambda: bcr._build_device(p, dev, merge_insert))[0])
    events = {}
    for radix in (1, 2):  # one profiled loop each: device events a column
        with radix_env(radix):
            events[radix] = loop_events(torch, lambda: bcr._build_device(p, dev, merge_insert),
                                        LONG_LEN)
        log(f"[long] radix {radix}: one profiled device loop, "
            f"{events[radix]['device_s']:.4f} s of device time in {events[radix]['events']} "
            f"device events, {events[radix]['events_a_column']:.2f} a column")
    # column LONG_LEN's lf_stage inputs at radix 1 (a column) and the
    # lf_pair inputs of the pair that starts there at radix 2 (the last
    # pair): the kernel == the plain twin on them
    def last_col(j, *args):
        return j == LONG_LEN

    with radix_env(1), capture(bcr, "lf_stage", keep=last_col) as stage1:
        bcr._build_device(p, dev, merge_insert)
    check(len(stage1) == 1, f"radix-1 loop kept {len(stage1)} columns")
    args1 = stage1.pop()
    stages = {1: hold_stage(torch, "the 500.5M loop at radix 1", args1)}
    stages[1]["split"] = stage_split(torch, f"column {LONG_LEN} of the 500.5M loop at radix 1",
                                     args1)
    del args1
    # the last radix-2 pass at full size (2N unsorted slots into the buffer
    # of n - 2N symbols): the kernel == the plain pass on those card tensors
    seen, calls = [], [0]

    def keep_last(old, q, v, active, **kw):
        if calls[0] == LONG_LEN // 2:  # pass 0 is stage 1, pass 500 the last pair
            seen.append(tuple(t.clone() for t in (old, q, v, active)))
        calls[0] += 1
        return merge_insert(old, q, v, active, **kw)

    with radix_env(2), capture(bcr, "lf_pair", keep=last_col) as pair2:
        bcr._build_device(p, dev, keep_last)
    del p
    check(calls[0] == LONG_LEN // 2 + 1 and len(seen) == 1, f"radix-2 run of {calls[0]} passes")
    check(len(pair2) == 1, f"radix-2 loop kept {len(pair2)} column pairs")
    pair = hold_pair(torch, "the 500.5M loop at radix 2 (its last pair)", pair2.pop())
    pair["events"] = events
    (old, q, v, act), = seen
    got, want = merge_insert(old, q, v, act), merge_insert_slots(old, q, v, act)
    check(q.numel() == 2 * LONG_READS and int(want[2]) == 2 * LONG_READS,
          f"last radix-2 pass: {q.numel()} slots, {int(want[2])} inserted")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and int(got[2]) == int(want[2]),
          "last 500.5M radix-2 pass: kernel != plain pass")
    log(f"[long] the last radix-2 pass ({old.numel()} buffer, {q.numel()} unsorted slots): "
        "the kernel == the plain pass (buffer, table, m)")
    del seen, old, q, v, act, got, want
    res = {}
    for radix, peak in ((1, peak1), (2, peak2)):
        loop = median(loops[radix])
        bound = merge_pass_bytes(0, lengths, LONG_LEN // 2 if radix == 2 else 0)
        res[radix] = {"build_s": median(builds[radix]), "loop_s": loop, "peak": peak}
        log(f"[long] radix {radix}: build_msbwt_with_index "
            + " / ".join(f"{t:.3f}" for t in builds[radix])
            + f" s (median {res[radix]['build_s']:.3f}); device loop "
            + " / ".join(f"{t:.3f}" for t in loops[radix])
            + f" s (median {loop:.3f}; the merge passes' byte bound {bound / DEFAULT_HBM_BW:.3f}"
            f" s for {bound} B); peak device memory {peak / 2**30:.2f} GiB; "
            f"merge kernel launches {(l1, l2)[radix - 1]['merge_insert']}, "
            f"lf_stage launches {(l1, l2)[radix - 1]['lf_stage']}, lf_pair calls "
            f"{(l1, l2)[radix - 1]['lf_pair']}")
    log(f"[long] {LONG_READS} x {LONG_LEN} bp ({n} symbols): BWT and table equal at radix "
        f"1 and 2; device loop radix 1 / radix 2 = "
        f"{res[1]['loop_s'] / res[2]['loop_s']:.3f}, per-round ratios "
        + " / ".join(f"{a / b:.3f}" for a, b in zip(loops[1], loops[2])))

    # (b) a small radix-2 build through the plain pass and LF steps on the card
    small = slice(0, LONG_SMALL)
    with radix_env(2):
        reset_counts()
        got = {"kernel": bcr.build_msbwt_with_index(reads[small], lengths[small], device=dev)}
        small_launches = path_counts()
        reset_counts()
        with plain_lf():
            got["plain"] = bcr.build_msbwt_with_index(reads[small], lengths[small], device=dev,
                                                      merge=merge_insert_slots)
        plain_launches = path_counts()
    check(torch.equal(got["kernel"][0].bwt, got["plain"][0].bwt)
          and torch.equal(got["kernel"][1].table, got["plain"][1].table),
          "20k long reads at radix 2: kernels != plain pass and LF step")
    check(max(plain_launches.values()) == 0, f"20k plain build launched {plain_launches}")
    check(small_launches["lf_pair"] == LONG_LEN // 2 and small_launches["lf_stage"] == 0,
          f"20k radix-2 build: {lf_line(small_launches)}")
    log(f"[long] {LONG_SMALL} x {LONG_LEN} bp at radix 2: the plain pass and LF steps on the "
        f"card (no kernel launched) == the kernels ({lf_line(small_launches)}; BWT and table)")
    del got

    # (c) load-and-extend at the automatic radix
    base, _ = bcr.build_msbwt_with_index(reads[:LONG_BASE], lengths[:LONG_BASE], device=dev)
    rle = encode_symbols(base.bwt[: base.n].cpu().numpy())
    del base
    with radix_env(None), capture(bcr, "lf_walk_cyclic") as cyc, \
            capture(bcr, "lf_walk_lengths") as lens:
        # --- the long-read extend: counts reset just before, read just after
        # (the walks' inputs kept: device copies of ~1 GB inside the time) ---
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dyn = DynamicBWT(device=dev)
        dyn.load_vector(rle)
        dyn.insert_strings(list(reads[LONG_BASE:]), True)
        ext = dyn.device_index
        torch.cuda.synchronize()
        ext_s = time.perf_counter() - t0
        launches_ext = path_counts()
        # --- end of the long-read extend ---
    radix = bcr.build_radix(n, LONG_READS - LONG_BASE)
    check(ext.n == n and torch.equal(ext.bwt[: ext.n], i1.bwt[: i1.n]),
          "long-read load + extend != the one-shot BWT")
    log(f"[long] load {LONG_BASE} reads' BWT from RLE bytes + extend by "
        f"{LONG_READS - LONG_BASE} reads (auto radix {radix}): {ext_s:.3f} s, merge kernel "
        f"launches {launches_ext['merge_insert']}, {lf_line(launches_ext)}; equal to the "
        "one-shot BWT")
    check(radix == 2 and launches_ext["lf_pair"] == LONG_LEN // 2
          and launches_ext["lf_stage"] == 0 and launches_ext["lf_walk_cyclic"] == 1
          and launches_ext["lf_walk_lengths"] == 1,
          f"long-read extend at radix {radix}: {lf_line(launches_ext)}")
    del dyn, ext
    (cargs,), (largs,) = cyc, lens
    errs, walks = [], {}
    for key, label, kernel, plain, args in (
            ("cyclic", f"terminator walk of the long extend ({cargs[4].numel()} walkers, "
             f"{cargs[6]} steps, on the {cargs[2]}-symbol base)",
             lf.lf_walk_cyclic, lf.lf_walk_cyclic_plain, cargs),
            ("lengths", f"lengths walk of the long extend ({largs[4]} walkers of {LONG_LEN} bp, "
             f"on the {largs[3]}-symbol base)", lf.lf_walk_lengths, lf.lf_walk_lengths_plain,
             largs)):
        errs.append(agree(torch, label, kernel, plain, args))
        with uncounted():
            walks[key] = {"ms": cuda_ms(lambda: kernel(*args), 5)}
        log(f"[lf] {label}: kernel {walks[key]['ms']:.4f} ms")
        walks[key].update(parent_lf(torch, label, kernel.__name__, args, reps=5))
    return l1, l2, launches_ext, res, stages, pair, max(errs), walks


def phase_budget(torch, np, dev):
    """Phase 12e: the query-tier budget at 1.515G symbols (15M x 100 bp):
    build (counts reset just before; column LF_COL's ``lf_stage`` inputs kept
    and held against the twin), RLE bytes in memory, ``RleBWT`` with
    its default budget (the card's) must pick pair + 6^9 and with
    ``MSBWT_TPU_DEVICE_BUDGET_GB=12`` the run tier; 1M counts of each ==
    the packed tier's; each tier's peak above what stays resident. After
    the card-budget batches, ``kmer_counts_pair`` is held against its twin
    on that engine's pair table, 6^9 cache and 1M k-mers (``hold_query``)."""
    from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from rust_msbwt_tpu_torch.ops.rle import encode_symbols
    from rust_msbwt_tpu_torch.utils.profiling import timed

    reads, lengths = genome_reads(np, BIG_READS, READ_LEN, 0x1515)
    kmers = draw_kmers(np, np.random.default_rng(0x1516), reads)
    n = BIG_READS * (READ_LEN + 1)
    # --- the 1.515G path: counts reset just before, read after the first batch
    # (column LF_COL's lf_stage inputs kept: ~3 GB of device copies in the build) ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with capture(bcr, "lf_stage", keep=lambda j, *a: j == LF_COL) as seen:
        build_s, (idx, _) = timed(lambda: bcr.build_msbwt_with_index(reads, lengths,
                                                                     device=dev))
    build_peak = torch.cuda.max_memory_allocated()
    build_launches = path_counts()
    del reads
    rle = encode_symbols(idx.bwt[: idx.n].cpu().numpy())
    del idx
    torch.cuda.empty_cache()
    log(f"[budget] {BIG_READS} x {READ_LEN} bp ({n} symbols): build {build_s:.3f} s, peak "
        f"device memory {build_peak / 2**30:.2f} GiB, merge kernel launches "
        f"{build_launches['merge_insert']}, {lf_line(build_launches)}; "
        f"{rle.size} RLE bytes")
    check(build_launches["merge_insert"] == READ_LEN + 1
          and build_launches["lf_stage"] == READ_LEN,
          f"1.515G build: {build_launches['merge_insert']} passes, {lf_line(build_launches)}")
    (args,) = seen
    del seen
    check(int(args[5].max()) >= 2**30, f"column {LF_COL} of the 1.515G build has no P >= 2^30")
    stage = hold_stage(torch, "the 1.515G build", args, reps=5, plain_reps=1)
    del args
    torch.cuda.empty_cache()

    tiers = {}
    for name, budget_env in (("card budget", None), ("MSBWT_TPU_DEVICE_BUDGET_GB=12", "12")):
        if budget_env is not None:
            os.environ["MSBWT_TPU_DEVICE_BUDGET_GB"] = budget_env
        try:
            bwt = RleBWT(device=dev)
            bwt.load_vector(rle)
            budget = bwt.device_budget_bytes()
            torch.cuda.reset_peak_memory_stats()
            first_s, got = timed(lambda: bwt.count_kmers(kmers))
            above = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
            resident = torch.cuda.memory_allocated()
            warm_s, got2 = timed(lambda: bwt.count_kmers(kmers))
        finally:
            os.environ.pop("MSBWT_TPU_DEVICE_BUDGET_GB", None)
        tier = ("run" if bwt._run_index is not None
                else "pair" if bwt._pair_index is not None else "packed")
        if budget_env is None:
            launches = path_counts()
            # --- end of the 1.515G path ---
            check(launches["lf_stage"] == READ_LEN and launches["lf_walk"] == 0
                  and launches["kmer_counts_pair"] == 2,
                  f"the 1.515G path: {lf_line(launches)}")
            check(tier == "pair" and bwt._cache_k == 9,
                  f"RleBWT at 1.515G with the card's budget picked {tier} + 6^{bwt._cache_k}")
            # the pair kernel against its twin on this engine's own tensors
            pidx, packed = bwt._pair_index, bwt.packed_index
            km = torch.tensor(kmers, device=dev)
            ln = torch.full((N_QUERIES,), K, dtype=torch.int32, device=dev)
            pair_hold = hold_query(
                torch, f"pair + 6^9, 1M x {K}-mers at {pidx.n} symbols", "pair",
                (pidx.table2, pidx.starts, pidx.dmat, pidx.n, km, ln, bwt._kmer_cache,
                 bwt._cache_k), packed, reps=10, plain_reps=2)
            want = count_kmers_packed(packed, kmers)
            del pidx, packed, km, ln
        else:
            check(tier == "run", f"RleBWT at 1.515G under a 12 GB budget picked {tier}")
        check(np.array_equal(got, want) and np.array_equal(got2, want),
              f"1.515G counts through {tier} != the packed tier's")
        tiers[name] = {"tier": tier, "peak_above": above, "resident": resident}
        log(f"[budget] {name}: budget {budget / 1e9:.3f} GB against 9 B x n = "
            f"{9 * n / 1e9:.3f} GB -> {tier} + 6^{bwt._cache_k}; first count_kmers "
            f"{first_s:.3f} s, warm {warm_s:.4f} s ({N_QUERIES / warm_s:.0f} q/s); resident "
            f"{resident / 2**30:.2f} GiB, peak {above / 2**30:.3f} GiB above it; counts == "
            "the packed tier's")
        del bwt
        torch.cuda.empty_cache()
    return launches, tiers, stage, pair_hold


def group_bytes(torch, args) -> tuple:
    """The bytes ``lf_group``'s function must move for one group's data, and
    the table rows they hold: 96 B of each distinct table row a column's
    ranks read (its reads' old positions in the buffer before the group,
    counted through the plain twin's own ranks), summed over the columns;
    7 B an insert (its symbol read from the view; its slot, symbol and flag
    written); 10 B a read (P and prev_v in and out) and the counts. The
    kernels' own intermediates (the sorted insert sets, the scan's words)
    are not the function's and are not counted."""
    from rust_msbwt_tpu_torch.ops import lf

    rows = 0
    real = lf.rank_packed

    def counting(tab, f, old):
        nonlocal rows
        rows += int(torch.unique(old.long() >> 7).numel())
        return real(tab, f, old)

    with swapped(lf, "rank_packed", counting), uncounted():
        lf.lf_group_plain(*args)
    return 96 * rows + 7 * int(sum(args[7])) + 10 * args[8].numel() + 48, rows


def group_split(torch, label, fn, args, reps=5) -> dict:
    """``fn`` (``lf_group``) over ``reps`` calls under ``torch.profiler``: its
    device milliseconds and device events a call, by kernel (launches
    uncounted)."""
    import re

    from rust_msbwt_tpu_torch.utils.profiling import device_us, trace

    with uncounted(), tempfile.TemporaryDirectory() as d, trace(d) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and device_us(e) > 0:
            m = re.search(r"group_kernel|[Mm]emset", e.key)
            key = m.group(0) if m else e.key[:40]
            by[key] = by.get(key, 0.0) + device_us(e) * 1e-3 / reps
            by[key + " events"] = by.get(key + " events", 0) + e.count / reps
    res = {"device_ms": sum(v for k, v in by.items() if not k.endswith(" events")),
           "events": sum(v for k, v in by.items() if k.endswith(" events")), "kernels": by}
    log(f"[lf] lf_group split, {label}: device {res['device_ms']:.4f} ms in "
        f"{res['events']:.1f} events a call ("
        + ", ".join(f"{k} {v:.4f}" for k, v in by.items() if not k.endswith(" events")) + ")")
    return res


def phase_group(torch, np, dev):
    """Phase 12f: ``lf_group`` at the benchmark's long-read shape:
    ``ecoli-ont50x``'s 15,472 read lengths (the gamma's quantiles,
    232,075,995 bases) over random bases, built one-shot on the card at the
    rule's radix (2; counts reset just before): its merge passes and its
    ``lf_pair``, ``lf_stage`` and ``lf_group`` calls and grouped columns
    those of ``group_schedule``, its BWT == the same build with the pairs
    alone (``pair_steps``). The group holding column GROUP_COL is kept and
    held against ``lf_group_plain`` (``hold``: its byte bound,
    ``group_bytes``), its device time by kernel (``group_split``); then the
    same columns replayed from the same buffer as the pairs it replaces
    (``lf_pair``, an odd last column ``lf_stage``, a merge pass each) to the
    buffer and table of the group's one pass, the pairs' LF steps and the
    replay timed against the group and the group with its pass."""
    from portbench.traffic.closed_loop_ragged import gamma_lengths
    from rust_msbwt_tpu_torch.ops import bcr, lf
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.ops.rank import PAD
    from rust_msbwt_tpu_torch.utils.profiling import timed

    r = np.random.default_rng(0x0E50)
    lengths = r.permutation(gamma_lengths(15472, 15000, 13000)).astype(np.int32)
    N, L = lengths.size, int(lengths.max())
    reads = np.zeros((N, L), np.uint8)
    for i, k in enumerate(lengths):
        reads[i, :k] = np.array([1, 2, 3, 5], np.uint8)[r.integers(0, 4, k)]
    n_cap = int(lengths.sum()) + N
    buckets = bcr.pair_buckets(bcr.bucket_schedule(0, N, L, n_cap, 128), L)
    steps = bcr.group_schedule(buckets, bcr.active_counts(lengths, L), N)
    ks = [k for _, k, _ in steps]
    kept = []
    real_group = bcr.lf_group

    def spy(*args, order=None):
        if args[0] <= GROUP_COL < args[0] + len(args[7]):
            kept.append((tuple(a.clone() if isinstance(a, torch.Tensor) and i != 4 else a
                               for i, a in enumerate(args)),  # the view (4) stays as it is
                         order.clone()))
        return real_group(*args, order=order)

    torch.cuda.synchronize()
    reset_counts()
    lf.lf_group.columns = 0
    with swapped(bcr, "lf_group", spy):
        build_s, (idx, packed) = timed(lambda: bcr.build_msbwt_with_index(reads, lengths,
                                                                          device=dev))
    c = path_counts()
    columns = lf.lf_group.columns
    log(f"[group] ecoli-ont50x's {N} read lengths ({n_cap} symbols, L = {L}): one-shot build "
        f"{build_s:.3f} s ({(n_cap - N) / build_s / 1e6:.2f} Mbases/s), merge kernel launches "
        f"{c['merge_insert']}, lf_group calls {c['lf_group']} carrying {columns} columns, "
        f"{lf_line(c)}")
    check((c["merge_insert"], c["lf_pair"], c["lf_stage"], c["lf_group"], columns)
          == (1 + len(ks), ks.count(2), ks.count(1), len(ks) - ks.count(1) - ks.count(2),
              sum(k for k in ks if k > 2)),
          f"the ragged build's calls are not its schedule's: {c}, {columns} columns")
    with swapped(bcr, "group_schedule", lambda b, a, n: bcr.pair_steps(b)), uncounted():
        pairs_s, (idx2, packed2) = timed(lambda: bcr.build_msbwt_with_index(reads, lengths,
                                                                           device=dev))
    check(torch.equal(idx.bwt, idx2.bwt) and torch.equal(packed.table, packed2.table),
          "the ragged build with groups != the same build with the pairs alone")
    log(f"[group] the same build with the pairs alone ({1 + len(bcr.pair_steps(buckets))} "
        f"passes): {pairs_s:.3f} s, BWT and table equal")
    del idx, packed, idx2, packed2, reads
    torch.cuda.empty_cache()

    (args, order), = kept
    j, tab, cap, nst, cols, lens, by_len, acts, P, counts, prev_v = args
    k = len(acts)
    bound, rows = group_bytes(torch, args)
    label = (f"lf_group, columns {j}..{j + k - 1} of the ragged build ({int(sum(acts))} "
             f"inserts of {N} reads, capacity {cap}, {rows} table rows)")
    group = functools.partial(lf.lf_group, order=order)
    res = hold(torch, label, group, lf.lf_group_plain, args, bound, reps=10, plain_reps=1)
    res["rows"], res["columns"] = rows, k
    res["split"] = group_split(torch, label, group, args)
    res["us_a_column"] = res["ms"] * 1e3 / k  # event time: the call's memset and kernel

    # the same columns as the pairs it replaces, from the same buffer
    n0 = int(counts.sum())
    old = torch.full((cap,), PAD, dtype=torch.uint8, device=dev)
    old[:n0] = lf.symbols_from_table(tab, torch.arange(n0, device=dev))
    scratch = lf.stage_scratch(dev)
    bufs = [torch.empty(cap, dtype=torch.uint8, device=dev) for _ in range(2)]
    tabs = [torch.empty_like(tab) for _ in range(2)]
    pair_args = []

    def replay(keep=False):
        src, t_, carry = old, tab, (P, counts, prev_v)
        for i, jj in enumerate(range(j, j + k, 2)):
            a = (jj, t_, cap, nst, cols, lens, *carry) if jj + 1 < j + k else \
                (jj, t_, nst, cols, lens, *carry)
            if keep:
                pair_args.append(a)
            step = lf.lf_pair if len(a) == 9 else lf.lf_stage
            q, v, active, *carry = step(*a, scratch=scratch)
            merge_insert(src, q, v, active, out=bufs[i % 2], table=tabs[i % 2])
            src, t_ = bufs[i % 2], tabs[i % 2]
        return src, t_

    with uncounted():
        got_buf, got_tab = replay(keep=True)
        q, v, active, *_ = group(*args)
        want_buf, want_tab, _ = merge_insert(old, q, v, active)
        torch.cuda.synchronize()
        check(torch.equal(got_buf, want_buf) and torch.equal(got_tab, want_tab),
              f"{label}: the pairs' passes != the group's pass")

        def group_pass():
            q, v, active, *_ = group(*args)
            merge_insert(old, q, v, active, out=bufs[0], table=tabs[0])

        pairs_ms = sum(cuda_ms(lambda a=a: (lf.lf_pair if len(a) == 9 else lf.lf_stage)(
            *a, scratch=scratch), 5) for a in pair_args)
        res.update({"pair_calls": len(pair_args), "pairs_ms": pairs_ms,
                    "replay_ms": cuda_ms(replay, 2), "group_pass_ms": cuda_ms(group_pass, 5)})
    log(f"[group] {label}: the group {res['ms']:.3f} ms against its {len(pair_args)} pair "
        f"calls' {pairs_ms:.3f} ms; with its one pass {res['group_pass_ms']:.3f} ms against "
        f"the pairs' {len(pair_args)} passes {res['replay_ms']:.3f} ms; "
        f"{res['us_a_column']:.2f} us a column")
    res.update({"build_s": build_s, "pairs_build_s": pairs_s, "launches": c["lf_group"],
                "columns_built": columns, "passes": c["merge_insert"]})
    return res


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): its merge pass, "
                         "LF-step and query kernels are held against this commit's and timed "
                         "in turns with them")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))  # the edge shapes, the gloo ranks
    try:
        import numpy as np

        from rust_msbwt_tpu_torch import _kernels
        from rust_msbwt_tpu_torch.utils.profiling import session_health
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
    log(f"[health] {json.dumps(session_health())}")

    global PARENT, PARENT_LF, PARENT_RACE_LF, PARENT_STEP2
    PARENT = load_parent_kernels(args.parent)
    PARENT_LF = load_parent_lf(args.parent, PARENT)
    PARENT_STEP2 = load_parent_step2(args.parent, PARENT_LF)
    if PARENT is not None:
        PARENT_RACE_LF = load_parent_lf(args.parent, private_copy(PARENT))
    max_err, times = phase_kernel(torch, dev)
    phase_lf_edges(torch, dev)
    phase_query_edges(torch, dev)
    phase_golden("cuda")
    phase_10k(np, dev)
    phase_extend_10k(torch, np, dev)
    reads, lengths, kmers = ecoli_config(np)
    main_path, idx, packed, counts, cache8, rle = phase_main(torch, np, dev, reads,
                                                             lengths, kmers)
    stage, kept = phase_lf_stage(torch, dev, reads, lengths, idx)
    phase_two_streams(torch, dev, reads, lengths, idx, kept)
    del kept
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "stream_ckpt.npy")
        stream = phase_stream(torch, np, dev, reads, lengths, idx, ckpt)
        load_extend, walk, append = phase_load_extend(torch, np, dev, reads, lengths, idx,
                                                      ckpt)
    recovery, walks, locate_ranges = phase_recovery(torch, np, dev, reads, idx, packed, kmers,
                                                    counts)
    with tempfile.TemporaryDirectory() as d:
        launches_query, correct, query_holds = phase_query_tiers(
            torch, np, dev, reads, idx, packed, kmers, counts, cache8, rle, d)
    del cache8, rle, packed
    parts = phase_merge_parts(torch, np, dev, reads, lengths, idx)
    torch.cuda.empty_cache()
    phase_pairwise(torch, np, dev, reads, lengths)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        launches_dist, _ = phase_distributed_cli(np, idx, reads, d)
    with tempfile.TemporaryDirectory() as d:
        phase_gloo_ranks(torch, np, dev, reads, lengths, d)
    del reads, lengths, kmers, counts, idx
    torch.cuda.empty_cache()
    long_r1, long_r2, long_ext, _, long_stages, long_pair, long_walk_err, long_walks = \
        phase_long(torch, np, dev)
    torch.cuda.empty_cache()
    budget, _, big_stage, big_pair = phase_budget(torch, np, dev)
    torch.cuda.empty_cache()
    group = phase_group(torch, np, dev)
    query_holds.update({"1515m_pair_6^9": big_pair, "recovery_locate": locate_ranges})

    paths = {"": main_path, "_stream": stream, "_load_extend": load_extend,
             "_append": append["launches"],
             "_recovery": recovery, "_query": launches_query, "_correct": correct,
             "_merge_parts": parts,
             "_distributed": launches_dist, "_long_radix1": long_r1,
             "_long_radix2": long_r2, "_long_extend": long_ext, "_budget": budget}

    def launches_of(kernel, skip=()):
        return {f"launches{k}": c[kernel] for k, c in paths.items() if k not in skip}

    def query_entry(name, source_line, hold_keys, **launches):
        # the first hold is the timed 505M batch; the others are holds at other paths' shapes
        res = query_holds[hold_keys[0]]
        return {"name": name, "route": "cuda",
                "source": "rust_msbwt_tpu_torch/csrc/query.cu",
                "replaces": source_line, **launches,
                "max_abs_err": max(query_holds[k]["max_abs_err"] for k in hold_keys),
                **{k: res[k] for k in ("ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes", "library_ms": None, "access_ms": res["access_ms"],
                "rows": res["rows"], "row_reads": res["row_reads"],
                "parent_ms": res.get("parent_ms"),
                "holds": {k: query_holds[k] for k in hold_keys[1:]}}

    columns = {"505m_col90": stage, "long_radix1_col1000": long_stages[1],
               "1515m_col90": big_stage}
    walk_err = max([walk["max_abs_err"], long_walk_err]
                   + [w["max_abs_err"] for w in walks.values()])
    print(json.dumps({"kernels": [{
        "name": "merge_insert",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/merge_insert.cu",
        "replaces": "rust_msbwt_tpu/ops/pallas_merge.py:159",
        **launches_of("merge_insert", skip=("_recovery", "_correct")),
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "prep_included": True,
        "parent_ms": times["parent_ms"],
    }, {
        "name": "lf_stage",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/lf.cu",
        "replaces": "rust_msbwt_tpu/ops/bcr.py:444",
        **launches_of("lf_stage", skip=("_recovery", "_correct")),
        "max_abs_err": max(c["max_abs_err"] for c in columns.values()),
        "ms": stage["ms"],
        "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parent_ms": stage.get("parent_ms"),
        "columns": {name: {k: c.get(k) for k in ("ms", "plain_ms", "bound_ms", "rows",
                                                  "parent_ms", "turn_ms", "split")}
                    for name, c in columns.items()},
    }, {
        "name": "lf_pair",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/lf.cu",
        "replaces": "rust_msbwt_tpu/ops/bcr.py:483",
        # its main path is the long-read build at radix 2 (the rule's pick)
        "launches": long_r2["lf_pair"],
        **launches_of("lf_pair", skip=("", "_recovery", "_correct", "_distributed")),
        "max_abs_err": max(long_pair["max_abs_err"], append["pair"]["max_abs_err"]),
        "ms": long_pair["ms"],
        "plain_ms": long_pair["plain_ms"],
        "bound_ms": long_pair["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parent_ms": long_pair.get("parent_ms"),
        "turn_ms": long_pair.get("turn_ms"),
        "rows": long_pair["rows"],
        "device_ms": long_pair["split"]["device_ms"],
        "device_events": long_pair["split"]["events"],
        "device_kernels": long_pair["split"]["kernels"],
        "bound_share_device": long_pair["device_share"],
        "bound_share_event": long_pair["bound_ms"] / long_pair["ms"],
        "parent_device_ms": long_pair.get("parent_device_ms"),
        "turn_device_ms": long_pair.get("turn_device_ms"),
        "parent_events": long_pair.get("parent_events"),
        "events_a_column": {f"radix{r}": e["events_a_column"]
                            for r, e in long_pair["events"].items()},
        # the benchmark's append: 100k x 100 bp onto 404M, its last pair
        "append": {k: append["pair"].get(k) for k in ("ms", "plain_ms", "bound_ms", "rows",
                                                       "device_share", "parent_ms", "turn_ms")}
        | {"device_ms": append["pair"]["split"]["device_ms"]},
    }, {
        "name": "lf_group",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/lf.cu",
        "replaces": None,  # no JAX kernel: the JAX package has no column groups
        # its main path is a ragged long-read build (phase 12f: ecoli-ont50x's lengths)
        "launches": group["launches"],
        "columns": group["columns_built"],
        "max_abs_err": group["max_abs_err"],
        **{k: group[k] for k in ("ms", "plain_ms", "bound_ms", "rows", "us_a_column",
                                 "pair_calls", "pairs_ms", "replay_ms", "group_pass_ms",
                                 "build_s", "pairs_build_s", "passes")},
        "bound_by": "bytes",
        "library_ms": None,
        "group_columns": group["columns"],
        "device_ms": group["split"]["device_ms"],
        "device_events": group["split"]["events"],
        "device_kernels": group["split"]["kernels"],
    }, {
        "name": "lf_walk",
        "route": "cuda",
        "source": "rust_msbwt_tpu_torch/csrc/lf.cu",
        "replaces": "rust_msbwt_tpu/ops/bcr.py:1048",
        # its main path is the streamed build's (the one-shot build walks nowhere)
        "launches": stream["lf_walk"],
        **launches_of("lf_walk", skip=("", "_stream")),
        "max_abs_err": walk_err,
        "ms": walk["ms"],
        "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parent_ms": walk.get("parent_ms"),
        "terminator_walk_steps": walk["loop_steps"],
        "access_ms": walk["access_ms"],
        "walks": {name: {k: w.get(k) for k in ("ms", "plain_ms", "bound_ms", "access_ms",
                                                "parent_access_ms", "parent_ms", "turn_ms")}
                  for name, w in [*walks.items(),
                                  *((f"long_{k}", w) for k, w in long_walks.items())]},
    }, query_entry("kmer_ranges_packed", "rust_msbwt_tpu/ops/packed_rank.py:122",
                   ("packed_6^8", "recovery_locate"),
                   **launches_of("kmer_ranges_packed", skip=("_distributed",))),
       # its main path is RleBWT's query path (the tier it picks at 505M)
       query_entry("kmer_counts_pair", "rust_msbwt_tpu/ops/pair_rank.py:363",
                   ("pair_6^9", "1515m_pair_6^9", "correct"),
                   launches=launches_query["kmer_counts_pair"],
                   **launches_of("kmer_counts_pair", skip=("", "_query", "_distributed")))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
