"""Batched column-wise MSBWT construction (BCR) on the device, in torch.

Port of the JAX package's ``ops.bcr`` (its Pallas-engine path). All N reads
advance together, one suffix column per stage. Each stage does

1. one rank per read off the packed rank table the previous pass emitted
   (``ops.packed_rank.rank_packed``): the slot of every read's next symbol
   is ``q = C[f] + rank(f, P)`` for the read's previous symbol f at its
   previous slot P;
2. one merge-insert pass (``ops.merge_insert``) that writes the merged
   buffer and its rank table together — the hand-written CUDA kernel on the
   card, its plain PyTorch twin on CPU tensors.

Correctness contract (proved by the oracle and parity tests): sorted
insertion sorts the reads, then inserts column-wise with terminator ranks =
sorted read ranks, which is byte-identical to the reference's sorted
insertion (ref: src/dynamic_bwt.rs:515-525); chronological (``--unsorted``)
insertion uses arrival order as terminator ranks (ref:
src/dynamic_bwt.rs:350-351).

Capacity buckets. Early stages run on a nearly empty buffer, so the stage
loop runs in buckets whose capacity grows by ``GROWTH`` as the buffer fills
(``bucket_schedule``). Every bucket works on a prefix VIEW of full-size
buffers allocated once, so growing a bucket copies nothing: positions past
a bucket's capacity still hold PAD from the initial fill.

Deferred (not ported yet): extending an existing BWT (``base``; the JAX
package's ``terminator_positions`` / ``read_lengths_from_bwt``) raises
``NotImplementedError``; the radix-2 stage (``_pallas_stage_step2``, which
the JAX package picks only at a mean read length >= 1000) is not ported;
nor is the XLA scatter engine ``bcr_insert_core`` — the port has one engine.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.merge_insert import ROW, merge_insert, merge_insert_slots
from rust_msbwt_tpu_torch.ops.packed_rank import PackedOccIndex, pack_index, rank_packed
from rust_msbwt_tpu_torch.ops.rank import (
    BIN,
    PAD,
    OccIndex,
    build_occ_index,
    starts_from_counts,
)

_I32 = torch.int32
GROWTH = 1.3  # capacity growth between stage buckets (JAX package default)


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
    n = len(reads)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    lmax = int(lengths.max()) if n else 0
    packed = np.zeros((n, max(lmax, 1)), dtype=np.uint8)
    for i, r in enumerate(reads):
        arr = np.asarray(r, dtype=np.uint8)
        if arr.size and arr.min() == 0:
            raise ValueError("reads must not contain interior '$' (symbol 0)")
        packed[i, : arr.size] = arr
    return packed, lengths


def sort_reads(reads: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stable lexicographic read sort (row-wise over the 0-padded matrix)."""
    L = reads.shape[1]
    keys = np.ascontiguousarray(reads).view(np.dtype((np.void, L))).ravel()
    order = np.argsort(keys, kind="stable")
    return reads[order], lengths[order]


def reads_to_cols(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Column-major stage view: ``cols[j, i] = reads[i, lengths[i] - j]`` for
    ``1 <= j <= lengths[i]``, else 0 (``[L+2, N]`` uint8) — every stage reads
    one contiguous row.

    >>> reads_to_cols(np.array([[1, 2, 3]], np.uint8), np.array([3])).T.tolist()
    [[0, 3, 2, 1, 0]]
    """
    N, L = reads.shape
    cols = np.zeros((L + 2, N), dtype=np.uint8)
    if N == 0:
        return cols
    if np.all(lengths == L):
        cols[1: L + 1] = reads[:, ::-1].T
    else:
        js = np.arange(L + 2)
        idx = lengths[None, :] - js[:, None]          # [L+2, N]
        valid = (idx >= 0) & (js[:, None] >= 1)
        np.clip(idx, 0, L - 1, out=idx)
        cols = np.where(valid, reads.T[idx, np.arange(N)[None, :]], 0).astype(np.uint8)
    return cols


def _prepare_build(reads, lengths, sorted_insert, base):
    """Validation, read sort and stage view on the host. Returns a dict of
    what the device stage loop needs, or ``None`` when there are no reads."""
    from rust_msbwt_tpu_torch.utils.checks import validate_reads
    from rust_msbwt_tpu_torch.utils.native import reads_to_cols_native, sort_rows_native

    if base is not None and len(base):
        raise NotImplementedError(
            "extending an existing BWT is not ported yet (JAX package: "
            "ops.bcr.terminator_positions / read_lengths_from_bwt)"
        )
    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    validate_reads(reads, lengths)
    N = reads.shape[0]
    if N == 0:
        return None
    cols = None
    if sorted_insert:
        order = sort_rows_native(reads)
        if order is not None:
            # native fused path: argsort + gather + column view in C++
            cols = reads_to_cols_native(reads, lengths, order)
            lengths = lengths[order]
        else:
            reads, lengths = sort_reads(reads, lengths)
    if cols is None:
        cols = reads_to_cols_native(reads, lengths)
    if cols is None:
        cols = reads_to_cols(reads, lengths)
    n_cap = int(lengths.sum()) + N
    if n_cap >= 2**31:
        raise ValueError("single-device build limited to 2^31-1 symbols")
    return {"cols": cols, "lengths": lengths, "N": N, "L": int(reads.shape[1]),
            "n_cap": n_cap}


# ---------------------------------------------------------------------------
# the stage loop
# ---------------------------------------------------------------------------

def _cvec(counts: torch.Tensor, n_strings_total: int) -> torch.Tensor:
    """C-array over rotation space: cvec[0] = 0; cvec[f>=1] counts every
    string's '$' rotation (n_strings_total, including not-yet-inserted
    terminators — the invariant that makes batched stages order-consistent)
    plus buffer occurrences of symbols 1..f-1."""
    cs = torch.cumsum(counts, 0, dtype=_I32)
    cvec = torch.zeros(VC_LEN, dtype=_I32, device=counts.device)
    cvec[1:] = n_strings_total + (cs[:-1] - counts[0])
    return cvec


def _bump_counts(counts, v, active):
    # compare+reduce instead of an N-element scatter-add (no host sync)
    ar6 = torch.arange(VC_LEN, device=v.device)
    return counts + ((v.long()[:, None] == ar6[None, :]) & active[:, None]).sum(
        0, dtype=_I32
    )


def bucket_schedule(n0: int, N: int, L: int, n_cap: int,
                    chunk: int) -> list[tuple[int, int, int]]:
    """Stage buckets ``(ja, jb, cap)``: run stages [ja, jb) at capacity
    ``cap`` (chunk-aligned, >= n0 + (jb-1)*N — stage j ends with at most
    n0 + j*N symbols), growing by ``GROWTH``. The last bucket runs at
    ``aligned(n_cap)``.

    >>> sched = bucket_schedule(0, 10, 20, 220, 16)
    >>> sched[0][0], sched[-1][1]  # covers stages [2, L+2) contiguously
    (2, 22)
    >>> all(c >= 0 + (jb - 1) * 10 for ja, jb, c in sched)  # capacity holds
    True
    """
    def aligned(x):
        return -(-x // chunk) * chunk

    full_cap = aligned(n_cap)
    buckets = []
    ja = 2
    while ja < L + 2:
        need = n0 + ja * N
        cap = min(aligned(int(GROWTH * need)), full_cap)
        if cap == full_cap:
            # the full-capacity bucket holds everything by n_cap's definition
            jb = L + 2
        else:
            # cap >= GROWTH*need >= n0 + ja*N, so even a single-stage bucket
            # (jb = ja + 1) fits its last stage's output
            jb = max(min((cap - n0) // N + 1, L + 2), ja + 1)
        buckets.append((ja, jb, cap))
        ja = jb
    return buckets


def _build_device(p: dict, device, merge):
    """Run stage 1 and the bucketed stage loop on ``device``. Returns the
    final buffer (uint8 [aligned n_cap], PAD past n_cap), its packed table
    (int32 [aligned n_cap / 128 + 1, 32]) and the symbol counts."""
    N, L, n_cap = p["N"], p["L"], p["n_cap"]
    buckets = bucket_schedule(0, N, L, n_cap, BIN)
    full_cap = buckets[-1][2]
    bufs = [torch.full((full_cap,), PAD, dtype=torch.uint8, device=device)
            for _ in range(2)]
    table = torch.empty((full_cap // BIN + 1, ROW), dtype=_I32, device=device)
    ins = torch.empty(full_cap + 1, dtype=torch.int8, device=device)
    tmap = torch.empty(full_cap, dtype=_I32, device=device)
    cols = torch.from_numpy(p["cols"]).to(device)
    lengths = torch.from_numpy(p["lengths"]).to(device)

    def run_pass(src, cap, q, v, active):
        dst = 1 - src
        _, _, m = merge_insert_slots(
            bufs[src][:cap], q, v, active, merge=merge, ins=ins, tmap=tmap,
            out=bufs[dst][:cap], table=table[: cap // BIN + 1],
        )
        return dst, m

    # stage 1: every read's last symbol at its terminator slot (arrival or
    # sorted rank == read index after the host sort)
    cap = buckets[0][2]  # covers stage 1 too (N <= cap)
    P = torch.arange(N, dtype=_I32, device=device)
    prev_v = cols[1]
    active = lengths >= 0
    cur, n_valid = run_pass(0, cap, P, prev_v, active)
    counts = _bump_counts(torch.zeros(VC_LEN, dtype=_I32, device=device), prev_v, active)
    for ja, jb, cap in buckets:
        tab = table[: cap // BIN + 1]
        for j in range(ja, jb):
            active = j <= lengths + 1
            v = cols[j]
            f = prev_v.long()
            q = _cvec(counts, N)[f] + rank_packed(tab, f, P)
            cur, m = run_pass(cur, cap, q, v, active)
            n_valid = n_valid + m
            P = torch.where(active, q, P)
            counts = _bump_counts(counts, v, active)
            prev_v = torch.where(active, v, prev_v)
    if int(n_valid) != n_cap:  # the one host sync of the build
        raise RuntimeError(f"build inserted {int(n_valid)} symbols, expected {n_cap}")
    return bufs[cur], table, counts


def build_msbwt_with_index(reads: np.ndarray, lengths: np.ndarray,
                           sorted_insert: bool = True, base=None, *, device,
                           merge=merge_insert) -> tuple[OccIndex, PackedOccIndex]:
    """Construct an MSBWT on ``device`` and return its query indexes without
    leaving the device: ``(OccIndex, PackedOccIndex)``.

    The packed table IS the one the last merge pass wrote, so deriving both
    indexes is slicing: ``OccIndex.occ`` is the table's lanes 0..5 and
    ``OccIndex.bwt`` the final buffer. ``merge`` is the pass function
    (default: the kernel wrapper; ``ops.merge_insert.merge_insert_plain``
    runs the plain twin on any device, for comparison).

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> reads, lens = encode_reads([convert_stoi("ACGT"), convert_stoi("TGCA")])
    >>> idx, packed = build_msbwt_with_index(reads, lens, device="cpu")
    >>> idx.n, idx.bwt[: idx.n].tolist()
    (10, [5, 1, 2, 0, 3, 1, 5, 2, 3, 0])
    """
    p = _prepare_build(reads, lengths, sorted_insert, base)
    if p is None:
        idx = build_occ_index(np.zeros(0, np.uint8), device=device)
        return idx, pack_index(idx)
    buf, table, counts = _build_device(p, device, merge)
    n = p["n_cap"]
    # the last bucket runs at aligned(n), so buf is [ceil(n/128) * 128] and
    # table is [ceil(n/128) + 1, 32] with the totals in its terminal row
    starts = starts_from_counts(counts)
    idx = OccIndex(bwt=buf, occ=table[:, :VC_LEN].contiguous(), starts=starts, n=n)
    return idx, PackedOccIndex(table=table, starts=starts, n=n)


def build_msbwt(reads: np.ndarray, lengths: np.ndarray, sorted_insert: bool = True,
                base=None, *, device) -> np.ndarray:
    """Construct an MSBWT on ``device``; returns the decoded BWT (host uint8
    [n]). ``sorted_insert=True`` == reference ``insert_string(s, true)``
    batch; ``False`` == chronological insertion.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> reads, lens = encode_reads([convert_stoi("TGCA"), convert_stoi("ACGT")])
    >>> convert_itos(build_msbwt(reads, lens, device="cpu"))
    'TAC$GATCG$'
    """
    idx, _ = build_msbwt_with_index(reads, lengths, sorted_insert, base,
                                    device=device)
    return idx.bwt[: idx.n].cpu().numpy()
