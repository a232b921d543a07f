"""The LF step over the packed rank table: hand-written CUDA kernels
(``csrc/lf.cu``) and their plain PyTorch twins.

The JAX package runs these as XLA fusions inside one compiled program
(``ops.bcr._pallas_stage_step`` in a ``fori_loop``, the walks' own
``fori_loop``s); the port ran them as eager torch ops, tens of kernels and
host launches a column or a walk step. Here each is one call:

* **lf_stage** — one BCR column of the stage loop: every read's slot
  ``q = C[f] + rank(f, P)`` for its previous symbol ``f = prev_v`` at its
  previous slot ``P``, off one table row; ``active = j <= len + 1``; the
  carry ``P``, ``prev_v`` and the symbol counts after the column; one
  kernel, the counts summed inside it in the caller's ``int32 [8]``
  scratch, which each launch leaves zeroed (no memset). ``lf_stage_plain``
  is the plain version.
* **lf_pair** — two BCR columns j, j + 1 for one merge pass (radix 2):
  column j as ``lf_stage``, column j + 1's slots from the same table, and
  column j's moved past them. Five device events a pair (a memset and four
  kernels, no sort: the slots are ranked by slot tile, each slot placed in
  its tile's bucket by the atomic that counts it), the counts summed in the
  same scratch. ``lf_pair_plain`` (``lf_stage_plain``, ``pair_order``,
  ``pair_slots``: argsorts and scans in torch) is the plain version.
* **lf_group** — k > 2 BCR columns for one merge pass (a column group of
  ``ops.bcr.group_schedule``, where ragged reads leave few active): each
  column's slots ranked over the buffer with the group's earlier inserts
  off the table before the group, every earlier insert moved past them;
  one kernel a group: while N is small enough (``lf_group_cluster_max_n``)
  one thread-block cluster with the group's insert set in its shared
  memory, else a cooperative grid with it in global memory; its columns in
  phases parted by barriers. ``lf_group_plain`` (``group_column`` a column:
  sorts and searches in torch) is the plain version.
* **lf_walk** — a batched LF walk run to its end inside one call. Four walks
  share the kernel file: ``lf_walk_cyclic`` (the extend's cyclic terminator
  search, symbols from the stage view) and ``lf_walk_extract`` (reads
  right-aligned, each step's symbol from the table row:
  ``symbols_from_table`` is the plain decode) serve a walker with four
  lanes of a warp; ``lf_walk_locate`` (rows to their read id and offset)
  one thread a walker, its symbols from the BWT; ``lf_walk_lengths`` (string
  lengths from the '$' rotations) writes LF of every position into a
  transient of 4 B a position, then chases it, and reads the host once,
  where the plain version checks the host every ``LF_BLOCK`` steps. Each
  has a ``*_plain`` twin, which reads the BWT.

On a CUDA tensor a wrapper launches its kernel on its tensors' card, on
that card's current stream (or raises); on a CPU tensor it runs the plain
version. The kernels keep no state across launches: two streams or host
threads may call the wrappers at once. Each wrapper counts its
calls that launch in ``.launches``. Every output is an integer and equal
between the two, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.merge_insert import ROW, _check
from rust_msbwt_tpu_torch.ops.packed_rank import lf_step, rank_packed
from rust_msbwt_tpu_torch.ops.rank import BIN

_I32 = torch.int32
_I32_MAX = torch.iinfo(torch.int32).max  # radix-2 sort sentinel: above every slot
LF_BLOCK = 32  # plain read-length walk: LF steps between two host checks
STAGE_SCRATCH = 8  # lf_stage's scratch: six counts, the kernel's ticket, a pad


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


def symbols_from_table(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The symbol at each position ``pos`` (int, ``[...]``) off the packed
    table's bit planes, as the walk kernels decode it: bit ``pos % 32`` of
    word ``pos % 128 // 32`` of planes 0..2 of row ``pos // 128``; uint8,
    7 (PAD) past the table's ``n`` in its last bin (a terminal row's zero
    planes read 0; no walk reads there). Plain torch ops on any device."""
    pos = pos.long()
    r = pos & (BIN - 1)
    lane = 8 + (r >> 5)
    row = table[pos >> 7]
    sym = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    for p in range(3):
        word = row.gather(-1, (lane + 4 * p).unsqueeze(-1)).squeeze(-1).long()
        sym |= ((word >> (r & 31)) & 1) << p
    return sym.to(torch.uint8)


def _device_of(table: torch.Tensor, lanes: int = ROW) -> torch.device | None:
    """None for a CPU table (the plain version runs); its CUDA device after
    checking it is a 16 B-aligned ``[rows, lanes]`` int32 table."""
    dev = table.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"table: expected a CPU or CUDA tensor, got {dev}")
    _check("table", table, _I32, (table.shape[0], lanes), dev, aligned=True)
    return dev


def _launch(fn_name: str, *args, dev: torch.device):
    """Call the library's ``fn_name`` with tensors as their data pointers,
    with ``dev`` the runtime's current device and on its current stream;
    raise if the launch failed."""
    from rust_msbwt_tpu_torch import _kernels

    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev.index):  # by index: a torch.device costs more host time
        err = getattr(_kernels.load(), fn_name)(*args,
                                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# lf_stage: one BCR column
# ---------------------------------------------------------------------------

def lf_stage_plain(j, tab, nst, cols, lengths, P, counts, prev_v):
    """One BCR column j: each read's slot ``q = C[f] + rank(f, P)`` from
    the current table ``tab`` (``nst`` strings in all). Returns the pass's
    ``(q, v, active)`` and the carry ``(P, counts, prev_v)`` after it."""
    active = j <= lengths + 1
    v = cols[j]
    q = lf_step(tab, _cvec(counts, nst), prev_v.long(), P)
    return (q, v, active, torch.where(active, q, P), _bump_counts(counts, v, active),
            torch.where(active, v, prev_v))


def stage_scratch(device) -> torch.Tensor:
    """A zeroed scratch for ``lf_stage`` on ``device``: int32 ``[8]``."""
    return torch.zeros(STAGE_SCRATCH, dtype=_I32, device=device)


def lf_stage(j: int, tab: torch.Tensor, nst: int, cols: torch.Tensor,
             lengths: torch.Tensor, P: torch.Tensor, counts: torch.Tensor,
             prev_v: torch.Tensor, *, scratch: torch.Tensor | None = None):
    """One BCR column j, as ``lf_stage_plain``: ``(q, v, active, P, counts,
    prev_v)``, every output a new tensor but ``v`` (the view ``cols[j]``).

    ``tab`` int32 ``[rows, 32]`` (the current packed table), ``cols`` uint8
    ``[L + 2, N]`` (the stage view), ``lengths`` / ``P`` int32 ``[N]``,
    ``prev_v`` uint8 ``[N]``, ``counts`` int32 ``[6]``; ``nst`` the strings
    in all. On CUDA tensors one kernel launch (it sums the new counts
    itself: no memset); no host sync.

    ``scratch`` (``stage_scratch``) holds the kernel's accumulators; each
    launch leaves it zeroed, so a caller that launches in order on one
    stream (the stage loop) passes one scratch to every column. Launches
    that may overlap (two streams) need a scratch each. Without one the
    call zeroes its own (one memset more). Unused on CPU tensors.
    """
    dev = _device_of(tab)
    if dev is None:
        return lf_stage_plain(j, tab, nst, cols, lengths, P, counts, prev_v)
    N = P.shape[0]
    if not 0 <= j < cols.shape[0]:
        raise ValueError(f"column {j} outside the stage view of {cols.shape[0]} rows")
    _check("cols", cols, torch.uint8, (cols.shape[0], N), dev)
    _check("lengths", lengths, _I32, (N,), dev)
    _check("P", P, _I32, (N,), dev)
    _check("prev_v", prev_v, torch.uint8, (N,), dev)
    _check("counts", counts, _I32, (VC_LEN,), dev)
    if scratch is None:
        scratch = stage_scratch(dev)
    else:
        _check("scratch", scratch, _I32, (STAGE_SCRATCH,), dev)
    if not 0 <= nst < 2**31:
        raise ValueError("lf_stage: the string count must fit int32")
    v = cols[j]
    q = torch.empty(N, dtype=_I32, device=dev)
    P_out = torch.empty(N, dtype=_I32, device=dev)
    flags = torch.empty((2, N), dtype=torch.uint8, device=dev)
    counts_out = torch.empty(VC_LEN, dtype=_I32, device=dev)
    active, prev_out = flags[0].view(torch.bool), flags[1]
    _launch("msbwt_lf_stage", tab, v, lengths, P, prev_v, counts, q, active, P_out,
            prev_out, counts_out, scratch, N, j, nst, dev=dev)
    lf_stage.launches += 1
    return q, v, active, P_out, counts_out, prev_out


lf_stage.launches = 0


# ---------------------------------------------------------------------------
# lf_pair: two BCR columns for one merge pass (radix 2)
# ---------------------------------------------------------------------------

def pair_order(q1: torch.Tensor, active1: torch.Tensor, cap: int):
    """Column j's slots ``q1`` (int32, distinct where ``active1``) in sorted
    order: ``(order1, inv1, old_pos)``. ``inv1[i]`` is the number of active
    slots below read i's (a stable argsort puts the inactive reads, masked
    to the int32 maximum, after every slot below 2^31 - 1), so
    ``old_pos = q1 - inv1``, clamped to [0, cap], is the slot's position in
    the buffer before column j's inserts."""
    order1 = torch.argsort(torch.where(active1, q1, _I32_MAX), stable=True)
    inv1 = torch.empty_like(q1)
    inv1[order1] = torch.arange(q1.shape[0], dtype=_I32, device=q1.device)
    return order1, inv1, (q1 - inv1).clamp_(0, cap)


def pair_slots(q1, v1, active1, active2, order1, inv1, base2):
    """The radix-2 slot math of one column pair, given column j's slots
    ``q1`` (in the buffer B1 = B0 + column j's inserts), ``pair_order``'s
    ``order1`` / ``inv1``, and ``base2 = cvec1[v1] + rank_B0(v1, old_pos)``
    (the C array after column j's inserts). Returns int32 ``(f1, q2)``:

    * ``q2 = base2 + inb``, column j+1's final slots, where ``inb[i]``
      counts the active reads whose ``q1`` lies below read i's with the same
      symbol ``v1``: ``rank_B1(v1, q1) = rank_B0(v1, old_pos) + inb``. It is
      one 1-D scan of the ``[6, N]`` one-hot of ``v1`` in q1 order, read at
      ``(v1, k)`` less the count of the rows before (a scan along the rows
      of the ``[6, N]`` view runs one block a row, ~0.65 ms at N = 500k on
      the H100);
    * ``f1 = q1 + #{k: sort(q2)_k - k <= q1}``, column j's slots moved past
      column j+1's (stable merge). Over the ``m2`` active slots
      ``sort(q2)_k - k`` is non-decreasing; the tail past them is set to
      the int32 maximum on the device (no host sync), so the array stays
      sorted for any q1 < 2^31 - 1 and a binary search is exact.

    Inactive reads get values that no pass reads."""
    dev = q1.device
    N = q1.shape[0]
    ar = torch.arange(N, dtype=_I32, device=dev)
    v_sorted = torch.where(active1, v1, VC_LEN)[order1]
    onehot = torch.arange(VC_LEN, dtype=torch.uint8, device=dev)[:, None] == v_sorted
    cs = torch.cumsum(onehot.view(-1), 0, dtype=_I32)  # row s after every row < s
    before = torch.cat([cs.new_zeros(1), cs.view(VC_LEN, N)[:-1, -1]])
    row = v_sorted.clamp(max=VC_LEN - 1).long()
    inb_sorted = cs[row * N + ar] - before[row] - 1
    q2 = base2 + inb_sorted[inv1.long()]
    q2s = torch.sort(torch.where(active2, q2, _I32_MAX)).values
    bk = torch.where(ar < active2.sum(), q2s - ar, _I32_MAX)
    f1 = q1 + torch.searchsorted(bk, q1, right=True, out_int32=True)
    return f1, q2


def lf_pair_plain(j, tab, cap, nst, cols, lengths, P, counts, prev_v):
    """Columns j and j + 1 through one pass, from the table ``tab`` before
    column j's inserts (``cap`` the pass's capacity, ``nst`` strings in
    all). Column j+1's rank over the buffer after column j's inserts:
    ``rank_B1(s, q1) = rank_B0(s, q1 - c) + #{same-symbol inserts below
    q1}`` (``pair_order``, ``pair_slots``). Reads inactive in column j+1
    (odd tails of ragged reads) insert only ``v1``. Returns the pass's
    ``(q, v, active)`` over 2N slots and the carry ``(P, counts, prev_v)``
    after it; no host sync."""
    q1, v1, active1, _, counts1, _ = lf_stage_plain(j, tab, nst, cols, lengths, P, counts,
                                                    prev_v)
    active2 = j + 1 <= lengths + 1  # implies active1
    v2 = cols[j + 1]
    order1, inv1, old_pos = pair_order(q1, active1, cap)
    v1l = v1.long()
    base2 = _cvec(counts1, nst)[v1l] + rank_packed(tab, v1l, old_pos)
    f1, q2 = pair_slots(q1, v1, active1, active2, order1, inv1, base2)
    q = torch.cat([torch.where(active1, f1, 0), torch.where(active2, q2, 0)])
    P = torch.where(active2, q2, torch.where(active1, f1, P))
    prev_v = torch.where(active2, v2, torch.where(active1, v1, prev_v))
    return (q, torch.cat([v1, v2]), torch.cat([active1, active2]), P,
            _bump_counts(counts1, v2, active2), prev_v)


def lf_pair(j: int, tab: torch.Tensor, cap: int, nst: int, cols: torch.Tensor,
            lengths: torch.Tensor, P: torch.Tensor, counts: torch.Tensor,
            prev_v: torch.Tensor, *, scratch: torch.Tensor | None = None):
    """Columns j and j + 1 for one merge pass, as ``lf_pair_plain``: the
    port of the JAX package's ``_pallas_stage_step2`` (``ops/bcr.py:483``),
    the stage loop's radix-2 step. Returns ``(q, v, active, P, counts,
    prev_v)``, ``q`` / ``v`` / ``active`` over 2N slots, every output a new
    tensor but ``v`` (the view ``cols[j:j + 2]`` flattened).

    The arguments are ``lf_stage``'s, with ``cap`` the pass's capacity
    (``tab`` must have more than ``cap // 128`` rows). On CUDA tensors one
    call of five device events and no host sync; it allocates a work array
    of its own (each column's tile buckets and their overflow chunks, and
    ``sort(q2) - k``: ~29 B a read and ~1.6 KB a slot tile, a tile of 128
    to 32K positions holding at most 64 slots on average). ``scratch`` is
    ``lf_stage``'s, used for
    both columns' counts and left zeroed, so the stage loop passes its one
    scratch to every ``lf_stage`` and ``lf_pair`` call; launches that may
    overlap need a scratch each. Unused on CPU tensors.
    """
    from rust_msbwt_tpu_torch import _kernels

    dev = _device_of(tab)
    if dev is None:
        return lf_pair_plain(j, tab, cap, nst, cols, lengths, P, counts, prev_v)
    N = P.shape[0]
    if not 0 <= j < cols.shape[0] - 1:
        raise ValueError(f"columns {j}, {j + 1} outside the stage view of {cols.shape[0]} rows")
    if not 0 <= cap < 2**31 or tab.shape[0] <= cap // BIN:
        raise ValueError(f"lf_pair: capacity {cap} over a table of {tab.shape[0]} rows")
    if not 0 <= nst < 2**31:
        raise ValueError("lf_pair: the string count must fit int32")
    _check("cols", cols, torch.uint8, (cols.shape[0], N), dev)
    _check("lengths", lengths, _I32, (N,), dev)
    _check("P", P, _I32, (N,), dev)
    _check("prev_v", prev_v, torch.uint8, (N,), dev)
    _check("counts", counts, _I32, (VC_LEN,), dev)
    if scratch is None:
        scratch = stage_scratch(dev)
    else:
        _check("scratch", scratch, _I32, (STAGE_SCRATCH,), dev)
    work = torch.empty(_kernels.load().msbwt_lf_pair_work_len(N, cap), dtype=_I32, device=dev)
    q = torch.empty(2 * N, dtype=_I32, device=dev)
    active = torch.empty(2 * N, dtype=torch.bool, device=dev)
    P_out = torch.empty(N, dtype=_I32, device=dev)
    prev_out = torch.empty(N, dtype=torch.uint8, device=dev)
    counts_out = torch.empty(VC_LEN, dtype=_I32, device=dev)
    _launch("msbwt_lf_pair", tab, cols[j], cols[j + 1], lengths, P, prev_v, counts, q, active,
            P_out, prev_out, counts_out, scratch, work, N, cap, j, nst, dev=dev)
    lf_pair.launches += 1
    return q, cols[j: j + 2].view(-1), active, P_out, counts_out, prev_out


lf_pair.launches = 0


# ---------------------------------------------------------------------------
# lf_group: a run of k > 2 BCR columns for one merge pass (column groups)
# ---------------------------------------------------------------------------

def group_column(pos, sym, x, f, base):
    """One column of a group, over the group's inserts so far: ``pos``
    (int64 ``[m]``, distinct) their slots in the buffer B_t and ``sym``
    their symbols; ``x`` (int64 ``[A]``) the slot in B_t of each active
    read's last symbol and ``f`` that symbol; ``base(f, old)`` is ``C_t[f]
    + rank_B0(f, old)`` at a position ``old`` of B0, the buffer before the
    group. Returns int64 ``(q, moved)``:

    * ``q = base(f, x - #{pos < x}) + #{pos < x with symbol f}``, the
      column's slots in B_{t+1}: the rank over B_t at x split into the
      symbols of B0 below it and the inserts below it;
    * ``moved = pos + #{l : sort(q)_l - l <= pos}``, the inserts moved past
      the column's (the stable merge of ``pair_slots``).

    Both sides are searched over exactly their own entries, so no sentinel
    enters and every slot below 2^31 is exact."""
    below = torch.searchsorted(torch.sort(pos).values, x)
    same = torch.zeros_like(x)
    for s in range(VC_LEN):
        hit = f == s
        same[hit] = torch.searchsorted(torch.sort(pos[sym == s]).values, x[hit])
    q = base(f, x - below) + same
    ar = torch.arange(q.shape[0], device=q.device)
    moved = pos + torch.searchsorted(torch.sort(q).values - ar, pos, right=True)
    return q, moved


def lf_group_plain(j, tab, cap, nst, cols, lengths, by_len, acts, P, counts, prev_v,
                   order=None):
    """Columns j..j+k-1 through one pass, k = ``len(acts)``, from the table
    ``tab`` of B0, the buffer before the group (``cap`` the pass's
    capacity, ``nst`` strings in all). ``by_len`` (int ``[N]``) lists the
    reads longest first (``ops.bcr.length_order`` of ``lengths``) and
    ``acts[t]`` (host ints) counts the reads active in column j + t, so
    those are the first ``acts[t]`` of it; ``acts`` is non-increasing and
    sums to at most 2N. Column by column (``group_column``): column t's
    slots in B_{t+1} from the rank over B_t, then every earlier insert moved
    past them. ``lengths`` and ``order`` are ``lf_group``'s and unused
    here.

    Returns ``(q, v, active, P, counts, prev_v, order)``: ``q`` / ``v`` /
    ``active`` over 2N insert ids, column t's at ``off[t] + r`` for its
    r-th read, the ``sum(acts)`` active ids first; the carry after the
    group (a read's P the slot of its last insert in the buffer after the
    pass, P and prev_v unchanged for a read active in no column); and
    ``order``, int32 ``[acts[-1]]``, the last column's reads (their places
    in ``by_len``) in the order of their slots."""
    dev = P.device
    N, k = P.shape[0], len(acts)
    off = np.concatenate([[0], np.cumsum(acts)]).tolist()  # column t's ids: off[t] + r
    by = by_len.long()
    pos = torch.zeros(off[k], dtype=torch.int64, device=dev)
    sym = torch.zeros(off[k], dtype=torch.uint8, device=dev)
    for t in range(k):
        A, m = int(acts[t]), off[t]
        rr = by[:A]
        if t == 0:
            x, f = P[rr].long(), prev_v[rr]
        else:
            heads = off[t - 1] + torch.arange(A, device=dev)
            x, f = pos[heads], sym[heads]
        cvec = _cvec(counts, nst).long()

        def base(f, old, cvec=cvec):
            return cvec[f.long()] + rank_packed(tab, f, old).long()

        q, pos[:m] = group_column(pos[:m], sym[:m], x, f, base)
        v = cols[j + t][rr]
        pos[m: m + A], sym[m: m + A] = q, v
        counts = _bump_counts(counts, v, torch.ones(A, dtype=torch.bool, device=dev))
    q_out = torch.zeros(2 * N, dtype=_I32, device=dev)
    v_out = torch.zeros(2 * N, dtype=torch.uint8, device=dev)
    q_out[: off[k]], v_out[: off[k]] = pos.to(_I32), sym
    active = torch.arange(2 * N, device=dev) < off[k]
    P, prev_v = P.clone(), prev_v.clone()
    for t in range(k):  # reads r in [acts[t + 1], acts[t]) insert last in column t
        r = torch.arange(int(acts[t + 1]) if t + 1 < k else 0, int(acts[t]), device=dev)
        P[by[r]], prev_v[by[r]] = pos[off[t] + r].to(_I32), sym[off[t] + r]
    order = torch.argsort(pos[off[k - 1]:]).to(_I32)
    return q_out, v_out, active, P, counts, prev_v, order


def lf_group(j: int, tab: torch.Tensor, cap: int, nst: int, cols: torch.Tensor,
             lengths: torch.Tensor, by_len: torch.Tensor, acts, P: torch.Tensor,
             counts: torch.Tensor, prev_v: torch.Tensor, *,
             order: torch.Tensor | None = None):
    """Columns j..j+k-1 (k = ``len(acts)``, host ints) for one merge pass,
    as ``lf_group_plain``: the stage loop's step for a column group
    (``ops.bcr.group_schedule``). Returns ``(q, v, active, P, counts,
    prev_v, order)``, ``q`` / ``v`` / ``active`` over 2N slots with the
    group's ``sum(acts)`` inserts first.

    ``order`` lists the reads of column j (their places in ``by_len``) in
    the order of their slots P, as the last group returned it (that
    group's last column, a superset); without it the call sorts them
    first (one ``torch.argsort``: after a pair or a single column). On
    CUDA tensors one kernel launch, its columns in phases parted by
    barriers (``csrc/lf.cu``, ``msbwt_lf_group``; the kernel counts each
    column's active reads from ``lengths``, which ``acts`` must match), no
    host sync, a work array of ~56 B a read. The library picks the form by
    N alone: up to ``lf_group_cluster_max_n(dev)`` reads one thread-block
    cluster whose shared memory holds the group's inserts, else a memset
    and one cooperative grid over them in global memory. Unlike
    ``lf_stage`` and ``lf_pair`` it takes no scratch: its counts live in
    its work array. ``lf_group.launches`` counts calls,
    ``lf_group.columns`` the columns they carry and ``lf_group.cluster``
    the calls that took the cluster form, as the library reports the form
    it launched.
    """
    from rust_msbwt_tpu_torch import _kernels

    dev = _device_of(tab)
    if dev is None:
        return lf_group_plain(j, tab, cap, nst, cols, lengths, by_len, acts, P, counts, prev_v,
                              order)
    N, k = P.shape[0], len(acts)
    acts = np.ascontiguousarray(acts, dtype=np.int32)
    if k < 1 or not 0 <= j < cols.shape[0] - k + 1:
        raise ValueError(f"columns {j}..{j + k - 1} outside the stage view of {cols.shape[0]} rows")
    if (acts[0] > N or (acts < 0).any() or (np.diff(acts) > 0).any()
            or int(acts.sum(dtype=np.int64)) > 2 * N):
        raise ValueError("lf_group: active counts must fall, start at most N and sum to at most 2N")
    if not 0 <= cap < 2**31 or tab.shape[0] <= cap // BIN:
        raise ValueError(f"lf_group: capacity {cap} over a table of {tab.shape[0]} rows")
    if not 0 <= nst < 2**31 or N >= 2**26:
        raise ValueError("lf_group: the string count must fit int32 and N 2^26")
    _check("cols", cols, torch.uint8, (cols.shape[0], N), dev)
    _check("lengths", lengths, _I32, (N,), dev)
    _check("by_len", by_len, _I32, (N,), dev)
    _check("P", P, _I32, (N,), dev)
    _check("prev_v", prev_v, torch.uint8, (N,), dev)
    _check("counts", counts, _I32, (VC_LEN,), dev)
    if order is None:
        order = torch.argsort(P[by_len[: int(acts[0])].long()]).to(_I32)
    _check("order", order, _I32, (order.shape[0],), dev)
    if order.shape[0] < acts[0]:
        raise ValueError("lf_group: the order holds fewer reads than the first column")
    work = torch.empty(_kernels.load().msbwt_lf_group_work_len(N, k), dtype=_I32, device=dev)
    q = torch.empty(2 * N, dtype=_I32, device=dev)
    v = torch.empty(2 * N, dtype=torch.uint8, device=dev)
    active = torch.empty(2 * N, dtype=torch.bool, device=dev)
    P_out = torch.empty(N, dtype=_I32, device=dev)
    prev_out = torch.empty(N, dtype=torch.uint8, device=dev)
    counts_out = torch.empty(VC_LEN, dtype=_I32, device=dev)
    order_out = torch.empty(N, dtype=_I32, device=dev)
    form = np.zeros(1, np.int32)  # the library's answer: 1 for the cluster form
    _launch("msbwt_lf_group", tab, cols, lengths, by_len, P, prev_v, counts, order, q, v, active,
            P_out, prev_out, counts_out, order_out, work, acts.ctypes.data, form.ctypes.data, N,
            k, order.shape[0], j, nst, dev=dev)
    lf_group.launches += 1
    lf_group.columns += k
    lf_group.cluster += int(form[0])
    return q, v, active, P_out, counts_out, prev_out, order_out[: int(acts[-1])]


lf_group.launches = 0
lf_group.columns = 0
lf_group.cluster = 0


def lf_group_cluster_max_n(dev: torch.device) -> int:
    """The largest N (reads) for which ``lf_group`` on the CUDA device
    ``dev`` takes the cluster form, 0 if it never does there: the
    library's rule (``msbwt_lf_group_cluster_max_n``: the slices' thread
    limit, the card's shared memory a CTA, a cluster the card can place).
    ``lf_group`` does not ask it: the library picks the form and reports
    it; the card tests build at this limit."""
    from rust_msbwt_tpu_torch import _kernels

    with torch.cuda.device(dev.index):
        return int(_kernels.load().msbwt_lf_group_cluster_max_n())


# ---------------------------------------------------------------------------
# lf_walk: batched LF walks, each run to its end in one launch
# ---------------------------------------------------------------------------

def lf_walk_cyclic_plain(table, starts, n: int, cols, lengths, steps, n_steps: int):
    """The cyclic terminator search (``ops.bcr.terminator_positions``): N
    walkers from row ``n``; step t reads cycle index ``(len - t) mod (len +
    1)`` right to left, which in the stage view is ``cols[(t mod (len + 1))
    + 1, i]``; walker i stops after ``steps[i]`` steps. No host sync: the
    loop bound ``n_steps`` is a host int."""
    N = lengths.shape[0]
    dev = cols.device
    pos = torch.full((N,), n, dtype=_I32, device=dev)
    m = lengths.long() + 1
    col = torch.arange(N, device=dev)
    for t in range(n_steps):
        sym = cols[t % m + 1, col]
        new_pos = lf_step(table, starts, sym, pos)
        pos = torch.where(t < steps, new_pos, pos)
    return pos


def lf_walk_cyclic(table: torch.Tensor, starts: torch.Tensor, n: int, cols: torch.Tensor,
                   lengths: torch.Tensor, steps: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``lf_walk_cyclic_plain`` in one launch on CUDA tensors: int32 [N]
    end rows. ``cols`` uint8 ``[L + 2, N]``, ``lengths`` / ``steps`` int32
    ``[N]``, ``starts`` int32 ``[7]``; no host sync."""
    dev = _device_of(table)
    if dev is None:
        return lf_walk_cyclic_plain(table, starts, n, cols, lengths, steps, n_steps)
    N = lengths.shape[0]
    _check("starts", starts, _I32, (VC_LEN + 1,), dev)
    _check("cols", cols, torch.uint8, (cols.shape[0], N), dev)
    _check("lengths", lengths, _I32, (N,), dev)
    _check("steps", steps, _I32, (N,), dev)
    pos = torch.empty(N, dtype=_I32, device=dev)
    _launch("msbwt_lf_walk_cyclic", table, starts, cols, lengths, steps, pos, N, n, n_steps,
            dev=dev)
    lf_walk_cyclic.launches += 1
    return pos


def lf_walk_lengths_plain(bwt, table, starts, n: int, n_strings: int) -> np.ndarray:
    """LF walk from every terminator rotation (rows 0..n_strings-1) until the
    '$' closes the cycle; the step count is the string's length. The walk's
    length is what it measures, so the host checks for the end once every
    ``LF_BLOCK`` steps (the JAX package checks after every step)."""
    if n_strings == 0:
        return np.zeros(0, dtype=np.int32)
    dev = bwt.device
    pos = torch.arange(n_strings, dtype=_I32, device=dev)
    lengths = torch.zeros(n_strings, dtype=_I32, device=dev)
    done = torch.zeros(n_strings, dtype=torch.bool, device=dev)
    steps = 0
    while True:
        for _ in range(LF_BLOCK):
            sym = bwt[pos.long()]
            done |= sym == 0
            lengths += (~done).to(_I32)
            s = torch.where(done, 0, sym)
            new_pos = lf_step(table, starts, s, pos)
            pos = torch.where(done, pos, new_pos)
        steps += LF_BLOCK
        if bool(done.all()):
            return lengths.cpu().numpy()
        if steps > n:  # a cycle that never meets '$'
            raise ValueError("not a multi-string BWT: a terminator walk did not close")


def lf_walk_lengths(bwt: torch.Tensor, table: torch.Tensor, starts: torch.Tensor, n: int,
                    n_strings: int) -> np.ndarray:
    """``lf_walk_lengths_plain`` on CUDA tensors: the int32 lengths on the
    host. One call: LF of every position into a transient int32 array of
    ``ceil(n / 128) * 128`` entries, then two walkers a thread chasing it. A
    walker that takes ``n`` steps without meeting '$' sets a device flag;
    the host reads it with the lengths, once, and raises ``ValueError`` as
    the plain version does. The kernels read the table, not ``bwt``."""
    dev = _device_of(table)
    if dev is None:
        return lf_walk_lengths_plain(bwt, table, starts, n, n_strings)
    if n_strings == 0:
        return np.zeros(0, dtype=np.int32)
    _check("starts", starts, _I32, (VC_LEN + 1,), dev)
    rows = -(-n // BIN)
    if not n_strings <= n <= BIN * table.shape[0]:
        raise ValueError(f"lf_walk_lengths: {n_strings} strings in a BWT of {n} symbols "
                         f"over a table of {table.shape[0]} rows")
    lf = torch.empty(rows * BIN, dtype=_I32, device=dev)
    out = torch.empty(n_strings + 1, dtype=_I32, device=dev)  # lengths, then the flag
    _launch("msbwt_lf_walk_lengths", table, starts, lf, out, out[n_strings:], n_strings, n,
            dev=dev)
    lf_walk_lengths.launches += 1
    out = out.cpu().numpy()
    if out[-1]:
        raise ValueError("not a multi-string BWT: a terminator walk did not close")
    return out[:-1]


def lf_walk_extract_plain(bwt, table, starts, ids, l_max: int):
    """``l_max + 1`` LF steps from rows ``ids``: the read right-aligned in
    ``[B, l_max]`` (0-filled on the left) and whether each walk closed."""
    B = ids.shape[0]
    pos = ids.to(_I32)
    out = torch.zeros((B, l_max), dtype=torch.uint8, device=bwt.device)
    done = torch.zeros(B, dtype=torch.bool, device=bwt.device)
    for t in range(l_max + 1):
        sym = bwt[pos.long()]
        hit_end = sym == 0
        keep = ~done & ~hit_end
        # symbols arrive right-to-left: column l_max-1-t. The extra last
        # step lets length-l_max reads observe their terminator; it writes
        # nothing (keep is False there for every read that closes)
        col = min(max(l_max - 1 - t, 0), l_max - 1)
        out[:, col] = torch.where(keep, sym, out[:, col])
        new_pos = lf_step(table, starts, torch.where(keep, sym, 0), pos)
        pos = torch.where(keep, new_pos, pos)
        done |= hit_end
    return out, done


def lf_walk_extract(bwt: torch.Tensor, table: torch.Tensor, starts: torch.Tensor,
                    ids: torch.Tensor, l_max: int):
    """``lf_walk_extract_plain`` in one launch on CUDA tensors: ``(out u8
    [B, l_max], done bool [B])`` for int32 row ids ``ids``. The kernel takes
    each symbol from the table, not from ``bwt``."""
    dev = _device_of(table)
    if dev is None:
        return lf_walk_extract_plain(bwt, table, starts, ids, l_max)
    B = ids.shape[0]
    _check("starts", starts, _I32, (VC_LEN + 1,), dev)
    _check("ids", ids, _I32, (B,), dev)
    out = torch.zeros((B, l_max), dtype=torch.uint8, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    _launch("msbwt_lf_walk_extract", table, starts, ids, out, done, B, l_max, dev=dev)
    lf_walk_extract.launches += 1
    return out, done


def lf_walk_locate_plain(bwt, table, starts, pos, n_strings: int, l_max: int):
    """LF-walk every BWT row in ``pos`` backward until it enters the
    terminator block (rows < n_strings). Returns (read_id, offset): the
    terminator row IS the read's lexicographic id, and a row whose suffix
    starts at read offset j takes j+1 steps to reach it."""
    steps = torch.zeros(pos.shape, dtype=_I32, device=pos.device)
    for _ in range(l_max + 1):
        active = pos >= n_strings
        sym = bwt[pos.long()]
        new_pos = lf_step(table, starts, torch.where(active, sym, 0), pos)
        pos = torch.where(active, new_pos, pos)
        steps += active.to(_I32)
    return pos, steps - 1


def lf_walk_locate(bwt: torch.Tensor, table: torch.Tensor, starts: torch.Tensor,
                   pos: torch.Tensor, n_strings: int, l_max: int):
    """``lf_walk_locate_plain`` in one launch on CUDA tensors: int32
    ``(read_id, offset)`` for int32 rows ``pos``."""
    dev = _device_of(table)
    if dev is None:
        return lf_walk_locate_plain(bwt, table, starts, pos, n_strings, l_max)
    H = pos.shape[0]
    _check("starts", starts, _I32, (VC_LEN + 1,), dev)
    _check("bwt", bwt, torch.uint8, (bwt.shape[0],), dev)
    _check("pos", pos, _I32, (H,), dev)
    rid = torch.empty(H, dtype=_I32, device=dev)
    off = torch.empty(H, dtype=_I32, device=dev)
    _launch("msbwt_lf_walk_locate", table, starts, bwt, pos, rid, off, H, n_strings, l_max,
            dev=dev)
    lf_walk_locate.launches += 1
    return rid, off


lf_walk_cyclic.launches = 0
lf_walk_lengths.launches = 0
lf_walk_extract.launches = 0
lf_walk_locate.launches = 0

LF_WALKS = (lf_walk_cyclic, lf_walk_lengths, lf_walk_extract, lf_walk_locate)


def lf_walk_launches() -> int:
    """Launches of the ``lf_walk`` kernel, summed over its four walks."""
    return sum(w.launches for w in LF_WALKS)
