"""Holt–McMillan interleave merge and the D-way doubling merge (torch).

Port of the JAX package's ``ops.merge``: the combiner of partial BWTs built
apart (the data-parallel build of ``parallel.sharded_build``) and the engine
behind merging BWTs built elsewhere. Two formulations of one fixpoint:

* ``pairwise_bwt_merge`` / ``merge_interleave`` — the literal H-M
  refinement (ref: src/bwt_util.rs:21-141): a round rebuilds the merged
  symbol stream from the current interleave (an exclusive ``cumsum`` and two
  gathers), then stably sorts the interleave bits by symbol (a stable
  ``torch.sort`` of the uint8 symbols). One symbol of rotation depth a round,
  so at most max-rotation-period rounds (~101 for 100 bp reads); one host
  sync a round for the any-changed flag.
* ``multiway_bwt_merge`` — rank prefix-doubling over the union of all D
  sources' rotations (Manber–Myers applied to the merge): round r sorts by
  ``(rank_k, rank_k ∘ psi^k)``, doubling the resolved depth, so it converges
  in ceil(log2 max-period) + 1 rounds (~8 for 100 bp). psi (LF^-1 of every
  source) is one stable sort of the ``(source, symbol)`` key.

Ties (identical rotations across sources) keep source-major input order,
the order H-M converges to, so the merged BWT is canonical. JAX sorts with
several keys (``lax.sort(num_keys=2)``); torch has no multi-key sort, so
``_dense_ranks`` packs the two keys into one int64 (both below n < 2^31)
and sorts once, stably; in wide mode it runs two stable passes, least
significant key first. Either way the order is the JAX package's, bit for
bit. Positions are int32 below 2^31 merged symbols (``torch.sort``'s int64
indices are narrowed at once) and int64 ("wide") past it or with
``force_wide``.

Every function takes host arrays or uint8 tensors: tensors are merged on
their own device and the result stays there; host arrays go to ``device``
(default ``cuda``) and the result comes back as a host array.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_I32, _I64 = torch.int32, torch.int64


def _pos_dtype(wide: bool) -> torch.dtype:
    return _I64 if wide else _I32


def _as_parts(bwts, device) -> tuple[list[torch.Tensor], torch.device, bool]:
    """The parts as 1-D uint8 tensors on one device, that device, and
    whether the caller gave host arrays (then results go back to the host)."""
    host = not any(isinstance(b, torch.Tensor) for b in bwts)
    if host:
        dev = torch.device("cuda" if device is None else device)
        parts = [torch.from_numpy(np.array(b, dtype=np.uint8, copy=True).reshape(-1)).to(dev)
                 for b in bwts]
        return parts, dev, True
    if not all(isinstance(b, torch.Tensor) for b in bwts):
        raise TypeError("give the parts all as host arrays or all as tensors")
    devs = {b.device for b in bwts}
    if len(devs) != 1:
        raise ValueError(f"parts lie on several devices: {sorted(map(str, devs))}")
    if any(b.dtype != torch.uint8 or b.dim() != 1 for b in bwts):
        raise TypeError("parts must be 1-D uint8 tensors of symbols")
    return list(bwts), devs.pop(), False


def _out(t: torch.Tensor, host: bool):
    return t.cpu().numpy() if host else t


# ---------------------------------------------------------------------------
# pairwise H-M refinement
# ---------------------------------------------------------------------------

def _hm_merge(bwt0: torch.Tensor, bwt1: torch.Tensor, wide: bool):
    """The H-M fixpoint of two decoded BWTs on their device: ``(merged u8
    [n], interleave bool [n] (True == from bwt0), rounds)``. Port of the
    JAX package's ``_merge_impl``."""
    n0, n1 = bwt0.numel(), bwt1.numel()
    pd = _pos_dtype(wide)
    idx = torch.arange(n0 + n1, dtype=pd, device=bwt0.device)
    if n0 == 0 or n1 == 0:  # nothing to interleave
        return torch.cat([bwt0, bwt1]), idx < n0, 0

    def gather_syms(inter):
        c = inter.to(pd)
        c0 = torch.cumsum(c, 0, dtype=pd).sub_(c)  # bwt0 symbols before p
        pos0 = c0.clamp(0, n0 - 1)
        pos1 = (idx - c0).clamp_(0, n1 - 1)
        return torch.where(inter, bwt0[pos0], bwt1[pos1])

    def refine(inter):
        # the stable counting sort of the interleave bits by symbol
        return inter[torch.sort(gather_syms(inter), stable=True).indices]

    cur = idx < n0
    nxt = refine(cur)
    rounds = 1
    while bool((cur != nxt).any()):  # the one host sync of a round
        cur, nxt = nxt, refine(nxt)
        rounds += 1
    return gather_syms(nxt), nxt, rounds


def _wide(n0: int, n1: int, force_wide: bool) -> bool:
    return force_wide or (n0 + n1) >= 2**31


def pairwise_bwt_merge(bwt0, bwt1, force_wide: bool = False, *, device=None,
                       stats: dict | None = None):
    """Merge two decoded BWTs into the BWT of the union (the H-M fixpoint on
    the device). Positions switch to int64 past 2^31 merged symbols;
    ``force_wide`` takes that path on small data. ``stats``, when given,
    receives the round count under ``"rounds"``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> a = convert_stoi(naive_bwt(["ACGT"]))
    >>> b = convert_stoi(naive_bwt(["TGCA"]))
    >>> convert_itos(pairwise_bwt_merge(a, b, device="cpu")) == naive_bwt(["ACGT", "TGCA"])
    True
    """
    (b0, b1), _, host = _as_parts([bwt0, bwt1], device)
    merged, _, rounds = _hm_merge(b0, b1, _wide(b0.numel(), b1.numel(), force_wide))
    if stats is not None:
        stats["rounds"] = rounds
    return _out(merged, host)


def merge_interleave(bwt0, bwt1, force_wide: bool = False, *, device=None):
    """The converged interleave vector (True == element from bwt0)."""
    (b0, b1), _, host = _as_parts([bwt0, bwt1], device)
    _, inter, _ = _hm_merge(b0, b1, _wide(b0.numel(), b1.numel(), force_wide))
    return _out(inter, host)


# ---------------------------------------------------------------------------
# D-way rank prefix-doubling
# ---------------------------------------------------------------------------

def _dense_ranks(k1: torch.Tensor, k2: torch.Tensor | None, span: int, wide: bool):
    """Dense rank of every element by ``(k1, k2)`` and the sorting
    permutation (position dtype), both from one stable sort: ties keep input
    order. ``k2`` (``None`` == all 0) lies in ``[0, span)``. Narrow: one sort
    of the int64 key ``k1 * span + k2`` (below 2^62 for span <= 2^31); wide:
    two stable passes, ``k2`` first."""
    n = k1.numel()
    pd = _pos_dtype(wide)
    if wide:
        perm = (torch.sort(k2, stable=True).indices if k2 is not None
                else torch.arange(n, device=k1.device))
        perm = perm[torch.sort(k1[perm], stable=True).indices]
        k1s = k1[perm]
        neq = k1s[1:] != k1s[:-1]
        if k2 is not None:
            k2s = k2[perm]
            neq |= k2s[1:] != k2s[:-1]
    else:
        key = k1.to(_I64, copy=True)
        if k2 is not None:
            key.mul_(span).add_(k2)
        key, perm = torch.sort(key, stable=True)
        neq = key[1:] != key[:-1]
        del key
    perm = perm.to(pd)
    r_sorted = torch.zeros(n, dtype=pd, device=k1.device)
    torch.cumsum(neq, 0, dtype=pd, out=r_sorted[1:])
    rank = torch.empty(n, dtype=pd, device=k1.device)
    rank[perm] = r_sorted
    return rank, perm


def _doubling_init(syms: torch.Tensor, sizes: list[int], wide: bool):
    """The doubling merge's start: ``(rank, succ)``, the dense rank of every
    row by its first rotation symbol and psi, for ``syms`` ([n] u8, the
    source-major concatenation of the decoded BWTs, source j holding
    ``sizes[j]`` symbols).

    Rows of a BWT are its sorted rotations; row r's rotation spells
    ``F[r], F[psi(r)], F[psi^2(r)], ...`` where F = the sorted symbols and
    psi = LF^-1 = the stable counting-sort permutation of the BWT. Sorting
    the union of all sources' rows by that stream IS the merge; rank
    doubling resolves 2^r symbols after r rounds.
    """
    n = syms.numel()
    dev = syms.device
    # one stable sort of (source, symbol): psi and the F column per source
    combo = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=_I32, device=dev) * 8,
        torch.tensor(sizes, dtype=_I64, device=dev), output_size=n)
    combo += syms
    combo, psi = torch.sort(combo, stable=True)
    succ = psi.to(_pos_dtype(wide))
    del psi
    rank, _ = _dense_ranks(combo.remainder_(8), None, 1, wide)
    return rank, succ


def _doubling_round(rank: torch.Tensor, succ: torch.Tensor, wide: bool):
    """One doubling round: the rows sorted by ``(rank, rank o succ)``.
    Returns ``(new rank, sorting permutation, changed, next succ)``; no
    split (``changed`` False, one host sync) means the partition is
    shift-stable and no later round can split it either."""
    new_rank, perm = _dense_ranks(rank, rank[succ], rank.numel(), wide)
    changed = bool((new_rank != rank).any())
    return new_rank, perm, changed, (succ[succ] if changed else succ)


def _doubling_merge(syms: torch.Tensor, sizes: list[int], wide: bool):
    """D-way merge by rank prefix-doubling (port of ``_doubling_merge_impl``):
    ``(merged u8 [n], source id per merged position int32 [n], rounds)``."""
    rank, succ = _doubling_init(syms, sizes, wide)
    rounds, changed = 0, True
    while changed:
        rank, perm, changed, succ = _doubling_round(rank, succ, wide)
        rounds += 1
    del rank, succ
    # source of each merged position: the source whose range holds perm
    bounds = torch.cumsum(torch.tensor(sizes, dtype=_I64, device=syms.device), 0)
    srcs = torch.bucketize(perm, bounds.to(perm.dtype), right=True).to(_I32)
    return syms[perm], srcs, rounds


def multiway_bwt_merge(bwts, force_wide: bool = False, return_sources: bool = False,
                       *, device=None, stats: dict | None = None):
    """Merge D decoded BWTs in ONE doubling run (no pairwise tree).

    Equals ``kway_merge``'s pairwise-tree result in ceil(log2 max rotation
    period) + 2 rounds in all. ``return_sources`` also returns the source id
    (int32) of every merged position, the D-way form of the pairwise
    interleave vector. ``stats`` receives ``"rounds"``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> parts = [convert_stoi(naive_bwt([s])) for s in ("AC", "GG", "TA")]
    >>> convert_itos(multiway_bwt_merge(parts, device="cpu")) == naive_bwt(["AC", "GG", "TA"])
    True
    """
    parts, dev, host = _as_parts(list(bwts), device)
    sizes = [int(p.numel()) for p in parts]
    n = sum(sizes)
    if n == 0:
        merged = torch.zeros(0, dtype=torch.uint8, device=dev)
        srcs, rounds = torch.zeros(0, dtype=_I32, device=dev), 0
    else:
        syms = torch.cat(parts)
        merged, srcs, rounds = _doubling_merge(syms, sizes, force_wide or n >= 2**31)
    if stats is not None:
        stats["rounds"] = rounds
    if return_sources:
        return _out(merged, host), _out(srcs, host)
    return _out(merged, host)


def kway_merge(bwts, force_wide: bool = False, *, device=None, stats: dict | None = None):
    """Combine per-shard partial BWTs after a data-parallel build.

    The one-shot doubling merge (``multiway_bwt_merge``) by default;
    ``MSBWT_TPU_MERGE=tree`` (the JAX package's switch) selects the balanced
    binary tree of pairwise H-M merges, each pair going wide once its size
    requires. ``stats`` receives ``"rounds"`` (summed over the tree's merges)
    and, for the tree, ``"merges"``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> parts = [convert_stoi(naive_bwt([s])) for s in ("AC", "GG", "TA")]
    >>> convert_itos(kway_merge(parts, device="cpu")) == naive_bwt(["AC", "GG", "TA"])
    True
    """
    if os.environ.get("MSBWT_TPU_MERGE") != "tree":
        return multiway_bwt_merge(bwts, force_wide=force_wide, device=device, stats=stats)
    parts, dev, host = _as_parts(list(bwts), device)
    parts = [p for p in parts if p.numel()]
    rounds = merges = 0
    if not parts:
        parts = [torch.zeros(0, dtype=torch.uint8, device=dev)]
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            merged, _, r = _hm_merge(a, b, _wide(a.numel(), b.numel(), force_wide))
            nxt.append(merged)
            rounds, merges = rounds + r, merges + 1
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    if stats is not None:
        stats.update(rounds=rounds, merges=merges)
    return _out(parts[0], host)
