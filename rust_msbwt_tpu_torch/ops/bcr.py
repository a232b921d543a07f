"""Batched column-wise MSBWT construction (BCR) on the device, in torch.

Port of the JAX package's ``ops.bcr`` (its Pallas-engine path). All N reads
advance together, one suffix column per stage. Each stage does

1. one LF step per read off the packed rank table the previous pass
   emitted (``ops.lf.lf_stage``, one hand-written CUDA kernel a column on
   the card, its plain PyTorch twin on CPU tensors): the slot of every
   read's next symbol is ``q = C[f] + rank(f, P)`` for the read's previous
   symbol f at its previous slot P, with the carry and the symbol counts;
2. one merge-insert pass (``ops.merge_insert``) that writes the merged
   buffer and its rank table together — the hand-written CUDA kernel on the
   card, its plain PyTorch twin on CPU tensors.

Correctness contract (proved by the oracle and parity tests): sorted
insertion sorts the reads, then inserts column-wise with terminator ranks =
sorted read ranks, which is byte-identical to the reference's sorted
insertion (ref: src/dynamic_bwt.rs:515-525); chronological (``--unsorted``)
insertion uses arrival order as terminator ranks (ref:
src/dynamic_bwt.rs:350-351).

Extending an existing BWT (``base``, the load-and-add and streaming flows)
starts the same stage loop from the base instead of an empty buffer. Stage 1
puts every new read's last symbol at its terminator slot: after the
existing terminators for chronological inserts, and for sorted inserts at
the rank of the read's ``$`` rotation among the base's rotations, found by
a batched cyclic backward search (``terminator_positions``). That search
needs the base's longest rotation, which ``read_lengths_from_bwt``
recovers by LF walk when the caller does not know it. Both walks run in
one launch each on the card (``ops.lf.lf_walk_cyclic``,
``lf_walk_lengths``).

Capacity buckets. Early stages run on a nearly empty buffer, so the stage
loop runs in buckets whose capacity grows by ``MSBWT_TPU_BUCKET_GROWTH``
(default 1.3) as the buffer fills (``bucket_schedule``). Every bucket works
on a prefix VIEW of full-size buffers allocated once, so growing a bucket
copies nothing: positions past a bucket's capacity still hold PAD from the
initial fill.

Radix 2. ``build_radix`` picks how many columns one merge pass consumes:
radix 2 (``ops.lf.lf_pair``, the port of ``_pallas_stage_step2``: one
call of five device events a pair on the card) ranks two columns from one
table and inserts both through one pass of 2N slots, which halves the passes over the buffer
at the cost of N-sized work a pair. It pays only where N is small next to
the buffer: long reads, or a batch appended onto a large base. The rule
picks it from 1,000 buffer symbols a new read, the base counted; the JAX
package's rule leaves the base out, so there an append of short reads
stays at radix 1.

Column groups. Where reads of different lengths leave few of them active
(the tail of a long-read set), a radix-2 pass would stream the whole
buffer for a few inserts. ``group_schedule`` lets one pass carry as many
consecutive columns of a bucket as fit in the 2N slots of a pair, counted
from the read lengths (``active_counts``), and ``ops.lf.lf_group`` ranks
them (one host call a group); runs of one or two columns stay
``lf_stage`` / ``lf_pair``, so fixed-length reads run exactly the pairs.
The JAX package has no counterpart: the same bytes in fewer passes.

The JAX package's XLA scatter engine ``bcr_insert_core`` has no counterpart
of its own: the build functions' ``merge=`` takes the plain pass
``ops.merge_insert.merge_insert_slots``, which gives the same bytes on any
device.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.lf import (
    _bump_counts,
    lf_group,
    lf_pair,
    lf_stage,
    lf_walk_cyclic,
    lf_walk_lengths,
    stage_scratch,
)
from rust_msbwt_tpu_torch.ops.merge_insert import ROW, merge_insert
from rust_msbwt_tpu_torch.ops.packed_rank import PackedOccIndex
from rust_msbwt_tpu_torch.ops.rank import (
    BIN,
    PAD,
    OccIndex,
    starts_from_counts,
)
from rust_msbwt_tpu_torch.utils.profiling import annotate

_I32 = torch.int32


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------

def encode_reads(reads: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length int-encoded reads into ``([N, Lmax] u8, [N] i32)``.

    Rows are zero-padded; since ``$`` == 0, a zero-padded row compares exactly
    like ``s + '$'`` — plain row-wise sort is the sorted-insertion order.

    >>> r, l = encode_reads([np.array([1, 2], np.uint8), np.array([3], np.uint8)])
    >>> r.tolist(), l.tolist()
    ([[1, 2], [3, 0]], [2, 1])
    """
    arrs = [np.asarray(r, dtype=np.uint8) for r in reads]
    n = len(arrs)
    lengths = np.fromiter((a.size for a in arrs), dtype=np.int32, count=n)
    width = max(int(lengths.max()) if n else 0, 1)
    packed = np.zeros((n, width), dtype=np.uint8)
    if n:
        flat = np.concatenate(arrs)
        if flat.size and flat.min() == 0:
            raise ValueError("reads must not contain interior '$' (symbol 0)")
        # row-major mask order == concatenation order
        packed[np.arange(width)[None, :] < lengths[:, None]] = flat
    return packed, lengths


def sort_reads(reads: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stable lexicographic read sort (row-wise over the 0-padded matrix)."""
    L = reads.shape[1]
    keys = np.ascontiguousarray(reads).view(np.dtype((np.void, L))).ravel()
    order = np.argsort(keys, kind="stable")
    return reads[order], lengths[order]


_VIEW_BLOCK = 1 << 22  # view entries a block of columns gathers: bounds the temporaries


def reads_to_cols(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Column-major stage view: ``cols[j, i] = reads[i, lengths[i] - j]`` for
    ``1 <= j <= lengths[i]``, else 0 (``[L+2, N]`` uint8) — every stage reads
    one contiguous row. Ragged reads are gathered a block of columns at a
    time, so the temporaries stay near ``_VIEW_BLOCK`` entries whatever the
    shape (the native ``utils.native.reads_to_cols_native`` is the fast path).

    >>> reads_to_cols(np.array([[1, 2, 3]], np.uint8), np.array([3])).T.tolist()
    [[0, 3, 2, 1, 0]]
    >>> reads_to_cols(np.array([[1, 2, 3], [4, 0, 0]], np.uint8), np.array([3, 1])).T.tolist()
    [[0, 3, 2, 1, 0], [0, 4, 0, 0, 0]]
    """
    N, L = reads.shape
    cols = np.zeros((L + 2, N), dtype=np.uint8)
    if N == 0:
        return cols
    if np.all(lengths == L):
        cols[1: L + 1] = reads[:, ::-1].T
        return cols
    lengths = np.asarray(lengths, dtype=np.int64)
    rows = np.arange(N)[None, :]
    step = max(1, _VIEW_BLOCK // N)
    for a in range(1, L + 1, step):  # columns 0 and L + 1 stay 0
        js = np.arange(a, min(a + step, L + 1))[:, None]
        idx = lengths[None, :] - js               # [block, N]
        valid = idx >= 0
        np.clip(idx, 0, L - 1, out=idx)
        cols[a: a + js.shape[0]] = np.where(valid, reads[rows, idx], 0)
    return cols


def _prepare_build(reads, lengths, sorted_insert, n0=0, base_string_count=0):
    """Validation, read sort and stage view on the host, for a build onto a
    base of ``n0`` symbols and ``base_string_count`` strings. Returns a dict
    of what the device stage loop needs, or ``None`` when there are no
    reads."""
    from rust_msbwt_tpu_torch.utils.checks import validate_reads
    from rust_msbwt_tpu_torch.utils.native import reads_to_cols_native, sort_rows_native

    with annotate("msbwt.prep.sort"):
        reads = np.asarray(reads, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        validate_reads(reads, lengths)
        N = reads.shape[0]
        if N == 0:
            return None
        order = sort_rows_native(reads) if sorted_insert else None
        if sorted_insert and order is None:
            reads, lengths = sort_reads(reads, lengths)
    with annotate("msbwt.prep.view"):
        cols = None
        if order is not None:
            # native fused path: gather + column view in C++
            cols = reads_to_cols_native(reads, lengths, order)
            lengths = lengths[order]
        if cols is None:
            cols = reads_to_cols_native(reads, lengths)
        if cols is None:
            cols = reads_to_cols(reads, lengths)
    n_cap = n0 + int(lengths.sum()) + N
    if n_cap >= 2**31:
        raise ValueError("single-device build limited to 2^31-1 symbols")
    return {"cols": cols, "lengths": lengths, "N": N, "L": int(reads.shape[1]),
            "n0": n0, "n_cap": n_cap, "sorted": bool(sorted_insert),
            "base_strings": base_string_count,
            "n_strings_total": base_string_count + N}


def _base_symbols(base, device) -> torch.Tensor:
    """The base BWT as a uint8 tensor on ``device`` (host arrays are
    validated in debug mode and uploaded; device tensors stay put)."""
    from rust_msbwt_tpu_torch.utils.checks import validate_bwt

    if base is None:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    if isinstance(base, torch.Tensor):
        if base.dtype != torch.uint8 or base.dim() != 1:
            raise TypeError("base must be a 1-D uint8 tensor of symbols")
        return base.to(device)
    base = np.ascontiguousarray(base, dtype=np.uint8)
    validate_bwt(base)
    if not base.flags.writeable:  # e.g. a view of another framework's array
        base = base.copy()
    return torch.from_numpy(base).to(device)


# ---------------------------------------------------------------------------
# LF walks over the packed table (extend prep and read recovery)
# ---------------------------------------------------------------------------

def read_lengths_from_bwt(index: OccIndex, n_strings: int,
                          packed: PackedOccIndex | None = None) -> np.ndarray:
    """Recover each string's length from a BWT by LF-walking backwards from
    every terminator rotation (rows 0..n_strings-1) until the '$' closes the
    cycle. Vectorized over all strings on the index's device; ``packed`` is
    the index's packed table (derived when not given).

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.rank import build_occ_index
    >>> idx = build_occ_index(convert_stoi("TAC$GATCG$"), device="cpu")
    >>> read_lengths_from_bwt(idx, 2).tolist()  # ACGT, TGCA
    [4, 4]
    """
    packed = _packed_of(index, packed)
    return lf_walk_lengths(index.bwt, packed.table, packed.starts, packed.n, n_strings)


def _cyclic_steps(lengths: np.ndarray, base_rot_max: int, L: int):
    """Per-read LF step counts of the cyclic search (a whole number of
    cycles of ``'$' + S``, longer than the base's longest rotation plus the
    read's own period: Fine–Wilf) and the loop bound (host ints)."""
    m = lengths.astype(np.int64) + 1
    steps = (-(-int(base_rot_max) // m) + 1) * m
    t_total = int(base_rot_max) + 2 * (L + 1)
    return steps.astype(np.int32), min(int(steps.max()), t_total)


def terminator_positions(index: OccIndex, reads, lengths, base_rot_max: int,
                         packed: PackedOccIndex | None = None) -> torch.Tensor:
    """Terminator-rotation ranks (int32, on the index's device) of a batch of
    new reads (``[N, L]`` u8, ``[N]`` i32, host arrays) against an existing
    BWT. ``base_rot_max`` must be >= the longest rotation (read length + 1)
    present in the base.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.rank import build_occ_index
    >>> idx = build_occ_index(convert_stoi("TAC$GATCG$"), device="cpu")
    >>> reads, lens = encode_reads([convert_stoi("C"), convert_stoi("T")])
    >>> terminator_positions(idx, reads, lens, 5).tolist()  # both: $ACGT < . < $TGCA
    [1, 1]
    """
    from rust_msbwt_tpu_torch.utils.native import reads_to_cols_native

    packed = _packed_of(index, packed)
    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    cols = reads_to_cols_native(reads, lengths)
    if cols is None:
        cols = reads_to_cols(reads, lengths)
    dev = packed.table.device
    steps, n_steps = _cyclic_steps(lengths, base_rot_max, reads.shape[1])
    return lf_walk_cyclic(
        packed.table, packed.starts, packed.n, torch.from_numpy(cols).to(dev),
        torch.from_numpy(lengths).to(dev), torch.from_numpy(steps).to(dev), n_steps,
    )


# ---------------------------------------------------------------------------
# the stage loop
# ---------------------------------------------------------------------------

def _bucket_growth() -> float:
    """Capacity growth factor between stage buckets: ``MSBWT_TPU_BUCKET_GROWTH``,
    default 1.3 (the JAX package's, measured there), clamped to [1.05, 4].
    Each pass streams its bucket's whole capacity, so the mean capacity over
    a bucket is r ln(r) / (r - 1) of the symbols held: 1.14x at 1.3, 1.39x
    at 2; a smaller factor makes more, shorter buckets.

    >>> _bucket_growth()
    1.3
    """
    try:
        g = float(os.environ.get("MSBWT_TPU_BUCKET_GROWTH", "1.3"))
    except ValueError:
        g = 1.3
    return min(max(g, 1.05), 4.0)


def bucket_schedule(n0: int, N: int, L: int, n_cap: int, chunk: int,
                    growth: float | None = None) -> list[tuple[int, int, int]]:
    """Stage buckets ``(ja, jb, cap)``: run stages [ja, jb) at capacity
    ``cap`` (chunk-aligned, >= n0 + (jb-1)*N — stage j ends with at most
    n0 + j*N symbols), growing by ``growth`` (``_bucket_growth()`` when
    None). The last bucket runs at ``aligned(n_cap)``.

    >>> sched = bucket_schedule(0, 10, 20, 220, 16)
    >>> sched[0][0], sched[-1][1]  # covers stages [2, L+2) contiguously
    (2, 22)
    >>> all(c >= 0 + (jb - 1) * 10 for ja, jb, c in sched)  # capacity holds
    True
    """
    def aligned(x):
        return -(-x // chunk) * chunk

    if growth is None:
        growth = _bucket_growth()
    full_cap = aligned(n_cap)
    buckets = []
    ja = 2
    while ja < L + 2:
        need = n0 + ja * N
        cap = min(aligned(int(growth * need)), full_cap)
        if cap == full_cap:
            # the full-capacity bucket holds everything by n_cap's definition
            jb = L + 2
        else:
            # cap >= growth*need >= n0 + ja*N, so even a single-stage bucket
            # (jb = ja + 1) fits its last stage's output
            jb = max(min((cap - n0) // N + 1, L + 2), ja + 1)
        buckets.append((ja, jb, cap))
        ja = jb
    return buckets


def pair_buckets(buckets: list[tuple[int, int, int]], L: int) -> list[tuple[int, int, int]]:
    """The radix-2 schedule: every bucket but the last shrinks to an even
    number of stages (never extends: a pair ends at stage jb - 1, which its
    capacity holds); a bucket left with none goes, and its stages run in the
    next, larger one. So pairs start on even stages and only the last,
    full-capacity bucket may end on a single stage (L odd). The JAX package
    keeps its one-stage buckets instead, one pass more each.

    >>> pair_buckets([(2, 3, 32), (3, 4, 48), (4, 7, 64), (7, 12, 96)], 10)
    [(2, 4, 48), (4, 6, 64), (6, 12, 96)]
    """
    out, a = [], buckets[0][0]
    for _, b, cap in buckets:
        if b < L + 2:
            b = a + (b - a) // 2 * 2
            if b == a:
                continue
        out.append((a, b, cap))
        a = b
    return out


def active_counts(lengths: np.ndarray, L: int) -> np.ndarray:
    """Reads active in each column c of a build, ``A[c] = #{i : c <= len_i
    + 1}`` for c in [0, L + 2) (int64): a column's active reads are the
    first ``A[c]`` of ``length_order``.

    >>> active_counts(np.array([3, 1, 2]), 3).tolist()
    [3, 3, 3, 2, 1]
    """
    hist = np.bincount(np.asarray(lengths, dtype=np.int64) + 1, minlength=L + 2)[: L + 2]
    return np.cumsum(hist[::-1])[::-1]


def length_order(lengths: np.ndarray) -> np.ndarray:
    """The reads longest first, ties in read order (int32 [N]).

    >>> length_order(np.array([3, 1, 3, 2])).tolist()
    [0, 2, 3, 1]
    """
    return np.argsort(-np.asarray(lengths, dtype=np.int64), kind="stable").astype(np.int32)


def pair_steps(buckets: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
    """The passes of a radix-2 schedule (``pair_buckets``) as ``(j, k,
    cap)``: columns j..j+k-1 at capacity cap, a pair each, an odd last
    column alone.

    >>> pair_steps([(2, 4, 48), (4, 7, 64)])
    [(2, 2, 48), (4, 2, 64), (6, 1, 64)]
    """
    return [(j, min(2, b - j), cap) for a, b, cap in buckets for j in range(a, b, 2)]


def group_schedule(buckets: list[tuple[int, int, int]], active: np.ndarray,
                   N: int) -> list[tuple[int, int, int]]:
    """The radix-2 schedule's passes with column groups, as ``(j, k, cap)``.
    Inside each bucket of ``pair_buckets``, from its first column j, a pass
    takes the longest run j..j+k-1 whose active reads (``active``, from
    ``active_counts``) sum to at most 2N, the slots of one pair; a run of
    one or two columns stays a pair (``lf_pair``, or ``lf_stage`` for a
    bucket's last column alone), a longer one is a group (``ops.lf.lf_group``).
    A group never crosses a bucket, so the bucket's capacity holds its last
    column. With every read of one length every column has N active, so the
    passes are ``pair_steps(buckets)``.

    >>> b = [(2, 6, 64), (6, 11, 96)]
    >>> group_schedule(b, np.full(11, 4), 4) == pair_steps(b)
    True
    >>> group_schedule(b, np.array([4, 4, 4, 4, 3, 2, 2, 1, 1, 1, 1]), 4)
    [(2, 2, 64), (4, 2, 64), (6, 5, 96)]
    """
    steps = []
    for ja, jb, cap in buckets:
        j = ja
        while j < jb:
            k, held = 0, 0
            while j + k < jb and held + int(active[j + k]) <= 2 * N:
                held += int(active[j + k])
                k += 1
            if k <= 2:
                k = min(2, jb - j)
            steps.append((j, k, cap))
            j += k
    return steps


def build_radix(n_cap: int | None = None, n_reads: int | None = None) -> int:
    """Columns one merge pass consumes (1 or 2): 2 where the buffer holds at
    least 1,000 symbols a new read, ``n_cap / n_reads >= 1000`` with a
    base's symbols counted in ``n_cap`` (the pass saved streams the whole
    buffer, a pair's extra work is read-sized), else 1; an unknown shape
    stays at 1. ``MSBWT_TPU_RADIX=1|2`` forces either. With no base this is
    the JAX package's rule (the new batch's mean length + 1 from 1,000 on);
    onto a base the JAX rule subtracts the base's symbols and keeps an
    append of short reads at radix 1.

    On the H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md) the radix-2
    device loop over a 500M-symbol one-shot build ran 1.42-1.51x as fast
    as radix 1 at 1,000 bp reads, 1.30-1.33x at 500 bp and 1.10-1.17x at
    250 bp, with ``lf_pair`` at 0.13-0.14 ms a pair at 1,000 bp. An append
    of 100k x 100 bp reads ran 1.49x as fast at radix 2 onto a 404M-symbol
    base (4,141 symbols a new read) and 1.25x onto 101M (1,111), the whole
    entry point timed.

    >>> build_radix(505_000_000, 5_000_000)   # 100 bp short reads
    1
    >>> build_radix(500_500_000, 1_000_000)   # 500 bp
    1
    >>> build_radix(500_500_000, 500_000)     # 1,000 bp long reads
    2
    >>> build_radix(505_101_000, 1_000)       # 100 bp onto a 505M base
    2
    >>> build_radix(909_000, 1_000)           # 100 bp onto an 808k base
    1
    >>> build_radix()                         # unknown shape: stay at 1
    1
    """
    v = os.environ.get("MSBWT_TPU_RADIX", "auto")
    if v in ("1", "2"):
        return int(v)
    if n_cap and n_reads and n_cap / n_reads >= 1000:
        return 2
    return 1


def index_from_symbols(sym: torch.Tensor, *, merge=merge_insert
                       ) -> tuple[OccIndex, PackedOccIndex]:
    """Both query indexes of a decoded BWT on its device, through one merge
    pass with no inserts (the kernel on the card: it writes the packed table
    of the buffer it copies). Equal to ``build_occ_index`` + ``pack_index``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> idx, packed = index_from_symbols(torch.from_numpy(convert_stoi("TAC$GATCG$")))
    >>> idx.n, idx.starts.tolist(), tuple(packed.table.shape)
    (10, [0, 2, 4, 6, 8, 8, 10], (2, 32))
    """
    n = int(sym.shape[0])
    if n >= 2**31:
        raise ValueError("single-device index limited to 2^31-1 symbols")
    dev = sym.device
    old = torch.full((max(1, -(-n // BIN)) * BIN,), PAD, dtype=torch.uint8, device=dev)
    old[:n] = sym
    none = torch.zeros(0, dtype=_I32, device=dev)
    bwt, table, _ = merge(old, none, none.to(torch.uint8), none.bool())
    starts = starts_from_counts(table[-1, :VC_LEN])
    return (OccIndex(bwt=bwt, occ=table[:, :VC_LEN].contiguous(), starts=starts, n=n),
            PackedOccIndex(table=table, starts=starts, n=n))


def _packed_of(index: OccIndex, packed: PackedOccIndex | None) -> PackedOccIndex:
    """``packed`` when the caller holds it, else the index's packed table
    (through ``index_from_symbols``)."""
    if packed is not None:
        return packed
    return index_from_symbols(index.bwt[: index.n])[1]


def _stage1_slots(p: dict, cols, lengths, base, base_index, base_rot_max, merge):
    """Stage-1 slots (new coordinates) of every read's last symbol: each
    earlier read of the batch occupies one slot first."""
    N, n0 = p["N"], p["n0"]
    ar = torch.arange(N, dtype=_I32, device=cols.device)
    if not p["sorted"]:  # chronological: after every existing terminator
        return ar + p["base_strings"]
    if n0 == 0:  # sorted rank == read index after the host sort
        return ar
    if base_index is None:
        _, base_index = index_from_symbols(base, merge=merge)
    if base_rot_max is None:
        base_rot_max = int(lf_walk_lengths(base, base_index.table, base_index.starts,
                                           base_index.n, p["base_strings"]).max()) + 1
    steps, n_steps = _cyclic_steps(p["lengths"], base_rot_max, p["L"])
    base_pos = lf_walk_cyclic(
        base_index.table, base_index.starts, n0, cols, lengths,
        torch.from_numpy(steps).to(cols.device), n_steps,
    )
    return base_pos + ar


# Symbols the builds' merge passes stream: each pass reads and writes its
# bucket's whole capacity, and a build adds its passes' capacities once,
# after its sync. Read as ``.launches``, as the launch counters are.
merge_streamed = SimpleNamespace(launches=0)


def _build_device(p: dict, device, merge, base=None, base_index=None,
                  base_rot_max=None):
    """Run stage 1 and the bucketed stage loop on ``device``, onto ``base``
    (uint8 tensor of ``p["n0"]`` symbols; ``base_index`` its packed index
    when the caller holds it), one column a pass or, where ``build_radix``
    picks 2, two. Returns the final buffer (uint8 [aligned n_cap], PAD past
    n_cap), its packed table (int32 [aligned n_cap / 128 + 1, 32]) and the
    symbol counts. Where the radix-2 schedule groups columns
    (``group_schedule``), a group's pass takes ``lf_group``'s slots.
    Every ``lf_stage`` and ``lf_pair`` call gets the build's
    own scratch, so builds on two streams share no accumulator. A build
    adds the symbols its passes stream to ``merge_streamed`` once."""
    N, L, n0, n_cap = p["N"], p["L"], p["n0"], p["n_cap"]
    with annotate("msbwt.upload"):
        cols = torch.from_numpy(p["cols"]).to(device)
        lengths = torch.from_numpy(p["lengths"]).to(device)
    # the base's slots first: its index (when derived here) is freed before
    # the build's buffers are allocated
    with annotate("msbwt.stage1"):
        q1 = _stage1_slots(p, cols, lengths, base, base_index, base_rot_max, merge)
    with annotate("msbwt.buffers"):
        buckets = bucket_schedule(n0, N, L, n_cap, BIN)
        if build_radix(n_cap, N) == 2:
            buckets = pair_buckets(buckets, L)
            acts = active_counts(p["lengths"], L)
            steps = group_schedule(buckets, acts, N)
        else:
            steps = [(j, 1, cap) for ja, jb, cap in buckets for j in range(ja, jb)]
        by_len = None
        if any(k > 2 for _, k, _ in steps):  # reads longest first: one upload a build
            by_len = torch.from_numpy(length_order(p["lengths"])).to(device)
        full_cap = buckets[-1][2]
        bufs = [torch.full((full_cap,), PAD, dtype=torch.uint8, device=device)
                for _ in range(2)]
        table = torch.empty((full_cap // BIN + 1, ROW), dtype=_I32, device=device)
        counts = torch.zeros(VC_LEN, dtype=_I32, device=device)
        scratch = stage_scratch(device)
        if n0:
            bufs[0][:n0] = base
    if n0:
        with annotate("msbwt.base_counts"):
            # six compare-sums: no [n0]-sized int64 temporary
            counts = torch.stack([(base == s).sum(dtype=_I32) for s in range(VC_LEN)])

    streamed = 0

    def run_pass(src, cap, q, v, active):
        nonlocal streamed
        streamed += cap
        dst = 1 - src
        _, _, m = merge(bufs[src][:cap], q, v, active, out=bufs[dst][:cap],
                        table=table[: cap // BIN + 1])
        return dst, m

    # the passes are only enqueued here (the device's time shows at the sync)
    with annotate("msbwt.stage_loop"):
        # stage 1: every read's last symbol at its terminator slot
        cap = buckets[0][2]  # covers stage 1 too (n0 + N <= cap)
        prev_v = cols[1]
        active = lengths >= 0
        cur, m = run_pass(0, cap, q1, prev_v, active)
        n_valid = m + n0
        P = q1
        counts = _bump_counts(counts, prev_v, active)
        nst = p["n_strings_total"]
        order = None  # a group's reads in slot order, for the group after it
        for j, k, cap in steps:
            tab = table[: cap // BIN + 1]
            if k > 2:
                q, v, active, P, counts, prev_v, order = lf_group(
                    j, tab, cap, nst, cols, lengths, by_len, acts[j: j + k], P, counts,
                    prev_v, order=order)
            elif k == 2:
                q, v, active, P, counts, prev_v = lf_pair(
                    j, tab, cap, nst, cols, lengths, P, counts, prev_v, scratch=scratch)
                order = None
            else:
                q, v, active, P, counts, prev_v = lf_stage(
                    j, tab, nst, cols, lengths, P, counts, prev_v, scratch=scratch)
                order = None
            cur, m = run_pass(cur, cap, q, v, active)
            n_valid = n_valid + m
    with annotate("msbwt.sync"):  # the one host sync of the stage loop
        n_valid = int(n_valid)
    if n_valid != n_cap:
        raise RuntimeError(f"build inserted {n_valid} symbols, expected {n_cap}")
    merge_streamed.launches += streamed
    return bufs[cur], table, counts


def build_msbwt_with_index(reads: np.ndarray, lengths: np.ndarray,
                           sorted_insert: bool = True, base=None,
                           base_string_count: int = 0,
                           base_rot_max: int | None = None, *, device,
                           base_index: PackedOccIndex | None = None,
                           merge=merge_insert) -> tuple[OccIndex, PackedOccIndex]:
    """Construct (or extend) an MSBWT on ``device`` and return its query
    indexes without leaving the device: ``(OccIndex, PackedOccIndex)``.

    ``base`` is a decoded BWT to extend (host uint8 array or device tensor)
    holding ``base_string_count`` strings whose longest rotation (read
    length + 1) is ``base_rot_max`` (recovered by LF walk when ``None``);
    ``base_index`` is the base's packed index when the caller holds it (the
    sorted extend needs one and derives it otherwise). The packed table of
    the result IS the one the last merge pass wrote, so deriving both
    indexes is slicing: ``OccIndex.occ`` is the table's lanes 0..5 and
    ``OccIndex.bwt`` the final buffer. ``merge`` is the pass function
    (default: the kernel wrapper; ``ops.merge_insert.merge_insert_slots``
    runs the plain version on any device, for comparison).

    Under ``torch.profiler`` the call is the span ``msbwt.build``, holding
    one span a host step (``utils.profiling.annotate``): ``msbwt.prep.sort``,
    ``.prep.view``, ``.upload``, ``.stage1``, ``.buffers``, ``.base_counts``
    (onto a base), ``.stage_loop`` and ``.sync``; none a column or a pass.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> reads, lens = encode_reads([convert_stoi("ACGT"), convert_stoi("TGCA")])
    >>> idx, packed = build_msbwt_with_index(reads, lens, device="cpu")
    >>> idx.n, idx.bwt[: idx.n].tolist()
    (10, [5, 1, 2, 0, 3, 1, 5, 2, 3, 0])
    """
    with annotate("msbwt.build"):
        base = _base_symbols(base, device)
        p = _prepare_build(reads, lengths, sorted_insert, int(base.shape[0]),
                           base_string_count)
        if p is None:
            return index_from_symbols(base, merge=merge)
        buf, table, counts = _build_device(p, device, merge, base, base_index,
                                           base_rot_max)
        n = p["n_cap"]
        # the last bucket runs at aligned(n), so buf is [ceil(n/128) * 128] and
        # table is [ceil(n/128) + 1, 32] with the totals in its terminal row
        starts = starts_from_counts(counts)
        idx = OccIndex(bwt=buf, occ=table[:, :VC_LEN].contiguous(), starts=starts, n=n)
        return idx, PackedOccIndex(table=table, starts=starts, n=n)


def build_msbwt(reads: np.ndarray, lengths: np.ndarray, sorted_insert: bool = True,
                base=None, base_string_count: int = 0,
                base_rot_max: int | None = None, *, device,
                device_out: bool = False, base_index: PackedOccIndex | None = None):
    """Construct (or extend) an MSBWT on ``device``; returns the decoded BWT
    (host uint8 [n], or the device tensor with ``device_out=True``).
    ``sorted_insert=True`` == reference ``insert_string(s, true)`` batch;
    ``False`` == chronological insertion; ``base`` == a decoded BWT to
    extend (load-and-add flow), as in ``build_msbwt_with_index``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> reads, lens = encode_reads([convert_stoi("TGCA"), convert_stoi("ACGT")])
    >>> convert_itos(build_msbwt(reads, lens, device="cpu"))
    'TAC$GATCG$'
    >>> more, mlens = encode_reads([convert_stoi("CAT")])
    >>> convert_itos(build_msbwt(more, mlens, base=convert_stoi("TAC$GATCG$"),
    ...                          base_string_count=2, device="cpu"))
    'TTAC$CG$ATCGA$'
    """
    idx, _ = build_msbwt_with_index(reads, lengths, sorted_insert, base,
                                    base_string_count, base_rot_max,
                                    device=device, base_index=base_index)
    out = idx.bwt[: idx.n]
    return out if device_out else out.cpu().numpy()
