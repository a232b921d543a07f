"""Distributed D-way Holt–McMillan merge over the ranks of a process group.

Port of the JAX package's ``parallel.sharded_merge``. The pairwise
interleave refinement (ref: src/bwt_util.rs:21-141) generalized to D partial
BWTs merged at once, source j on rank j, with the interleave vector sharded
by merged position: rank i holds merged positions ``[i*blk, (i+1)*blk)``. A
refinement round:

1. every rank rebuilds the merged symbols of its block; cross-rank source
   offsets come from an ``all_gather`` of the ``[D, D]`` per-block
   source-count matrix;
2. the stable counting sort of the interleave by symbol takes an
   ``all_gather`` of per-block symbol counts (``[D, 6]``), which gives every
   element its global target position;
3. the elements move to their targets;
4. an any-changed flag summed over the ranks ends the loop: at most
   max-rotation-period rounds (ref fixpoint: src/bwt_util.rs:120-124).

The result equals ``ops.merge.kway_merge`` of the same parts. Two transports
implement steps 1 and 3:

* ``dense`` — every rank gathers all sources, and the targets travel as a
  full-length scatter plus ``all_reduce`` (O(n) bytes per rank per round);
* ``ragged`` — within a block, the elements drawn from source j are ONE
  contiguous run of source-j positions, and after the counting sort a
  block's elements bound for block i are ONE contiguous run of the
  target-sorted stream: both steps are one ``all_to_all_single`` with split
  lists, so a rank moves and holds O(n/D).

``"auto"`` is ragged: NCCL and gloo both have the primitive (the JAX
package defaults to dense because XLA:CPU lacks ``ragged_all_to_all`` and its
TPU lowering was not validated on a pod).
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.parallel import mesh

_PAD_SRC = 255  # interleave tail padding: never a source id
_PAD_SYM = 7    # symbol padding (symbols are 0..5)
_I32, _I64 = torch.int32, torch.int64


def group_ranks(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For keys in ``[0, k)`` (others ignored): each element's count of
    earlier elements with its key (int32, 0 for ignored ones) and the
    per-key totals (int32 [k]): the exclusive one-hot ``cumsum`` of the JAX
    package, one key at a time.

    >>> r, c = group_ranks(torch.tensor([1, 0, 1, 7, 1]), 2)
    >>> r.tolist(), c.tolist()
    ([0, 0, 1, 0, 2], [1, 3])
    """
    r = torch.zeros(keys.numel(), dtype=_I32, device=keys.device)
    counts = torch.zeros(k, dtype=_I32, device=keys.device)
    for j in range(k):
        m = keys == j
        c = torch.cumsum(m, 0, dtype=_I32)
        counts[j] = c[-1] if c.numel() else 0
        r = torch.where(m, c - 1, r)
    return r, counts


def _excl_rows(m: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum down axis 0 (``cumsum - m``)."""
    return torch.cumsum(m, 0, dtype=m.dtype) - m


def _targets(syms, pos_dtype, big):
    """Global target position of every element of my block in the stable
    counting sort by symbol (``big`` for padding): C[sym] + the symbol's
    count in earlier blocks + its rank in mine."""
    me, _ = mesh.world()
    r_loc, local = group_ranks(syms, VC_LEN)
    # a symbol's count over the earlier blocks may pass 2^31 in wide mode
    all_counts = mesh.all_gather(local).to(pos_dtype)          # [D, 6]
    totals = all_counts.sum(0)
    cvec = torch.cumsum(totals, 0) - totals
    my_start = _excl_rows(all_counts)[me]
    s = syms.long().clamp(max=VC_LEN - 1)
    tgt = cvec[s] + my_start[s] + r_loc
    return torch.where(syms == _PAD_SYM, big, tgt)


def _merge_block(my_part: torch.Tensor, lens: list[int], transport: str,
                 wide: bool) -> torch.Tensor:
    """This rank's block (u8 [blk], PAD past n) of the merge of the D
    sources of ``lens``, this rank holding source ``rank`` (``my_part``)."""
    me, d = mesh.world()
    dev = my_part.device
    pd = _I64 if wide else _I32
    n = sum(lens)
    blk = -(-n // d)
    big = d * blk
    offsets = torch.tensor(np.cumsum(lens), dtype=pd, device=dev)
    pos0 = me * blk
    gpos = pos0 + torch.arange(blk, dtype=pd, device=dev)
    valid = gpos < n
    pad_src = torch.tensor(_PAD_SRC, dtype=torch.uint8, device=dev)
    # initial interleave: position p draws from source j iff
    # offsets[j] <= p < offsets[j+1]
    init = torch.where(valid, torch.bucketize(gpos, offsets, right=True).to(torch.uint8),
                       pad_src)

    if transport == "dense":
        bmax = max(1, max(lens))
        mine = torch.full((bmax,), _PAD_SYM, dtype=torch.uint8, device=dev)
        mine[: my_part.numel()] = my_part
        flat = mesh.all_gather(mine).view(-1)                  # every source

        def reconstruct(inter):
            r_loc, local = group_ranks(inter, d)
            my_start = _excl_rows(mesh.all_gather(local))[me]  # [D sources]
            j = inter.long().clamp(max=d - 1)
            g = (j.to(pd) * bmax + (my_start[j] + r_loc).to(pd)).clamp_(0, d * bmax - 1)
            return torch.where(inter == _PAD_SRC, _PAD_SYM, flat[g])

        def refine(inter):
            tgt = _targets(reconstruct(inter), pd, big)
            routed = torch.zeros(big + 1, dtype=_I32, device=dev)  # slot big: dump
            routed[tgt] = inter.to(_I32) + 1
            routed = mesh.all_reduce_sum(routed[:big])
            return torch.where(valid, (routed[pos0: pos0 + blk] - 1).to(torch.uint8), pad_src)

    elif transport == "ragged":
        def reconstruct(inter):
            """Within my block the elements from source j are one run of
            source-j positions, so source j ships block i one chunk."""
            r_loc, local = group_ranks(inter, d)
            C = mesh.all_gather(local).tolist()              # [block, source]
            grouped = mesh.exchange(my_part, [C[i][me] for i in range(d)], C[me])
            grp_start = torch.tensor(np.cumsum([0] + C[me][:-1]), dtype=_I32, device=dev)
            buf = torch.full((blk,), _PAD_SYM, dtype=torch.uint8, device=dev)
            buf[: grouped.numel()] = grouped
            j = inter.long().clamp(max=d - 1)
            syms = buf[(grp_start[j] + r_loc).clamp_(0, blk - 1).long()]
            return torch.where(inter == _PAD_SRC, _PAD_SYM, syms)

        def refine(inter):
            tgt = _targets(reconstruct(inter), pd, big)
            # target-sort my elements: the run bound for each block is then
            # one chunk, and padding (big) sorts last and is not sent
            tgt_s, perm = torch.sort(tgt)
            send, recv = mesh.exchange_sizes(tgt_s // blk)
            tgt_r = mesh.exchange(tgt_s, send, recv)
            val_r = mesh.exchange(inter[perm], send, recv)
            placed = torch.full((blk,), _PAD_SRC, dtype=torch.uint8, device=dev)
            placed[(tgt_r - pos0).long()] = val_r
            return torch.where(valid, placed, pad_src)

    else:
        raise ValueError(f"unknown transport {transport!r}")

    cur, nxt = init, refine(init)
    while mesh.any_across(cur != nxt):
        cur, nxt = nxt, refine(nxt)
    return reconstruct(nxt)


def merge_parts(my_part: torch.Tensor, transport: str = "auto",
                force_wide: bool = False) -> torch.Tensor:
    """The D-way H-M merge of one part a rank (source id == rank; empty
    parts allowed), called by every rank: the whole merged BWT (u8 tensor on
    ``my_part``'s device) on every rank."""
    if transport == "auto":
        transport = "ragged"
    lens = mesh.all_gather(torch.tensor([my_part.numel()], dtype=_I64,
                                        device=my_part.device)).view(-1).tolist()
    n = sum(lens)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=my_part.device)
    d = len(lens)
    wide = force_wide or n >= 2**31 or d * -(-n // d) >= 2**31
    block = _merge_block(my_part, lens, transport, wide)
    return mesh.all_gather(block).view(-1)[:n]


def sharded_hm_merge(parts, transport: str = "auto", force_wide: bool = False, *,
                     device=None):
    """Merge up to D partial BWTs, part j on rank j, with the interleave
    sharded across the ranks; every rank passes the same list and gets the
    merged BWT (a host array for host parts; a tensor on the parts' device
    for tensor parts). Equals ``ops.merge.kway_merge(parts)``.
    ``transport``: ``"dense"``, ``"ragged"`` or ``"auto"`` (== ragged).

    Without a process group (world size 1) it takes one part:

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> a = convert_stoi(naive_bwt(["ACGT", "CCA", "TG"]))
    >>> convert_itos(sharded_hm_merge([a], device="cpu")) == naive_bwt(
    ...     ["ACGT", "CCA", "TG"])
    True
    """
    from rust_msbwt_tpu_torch.ops.merge import _as_parts, _out

    me, d = mesh.world()
    parts, dev, host = _as_parts(list(parts), device)
    if len(parts) > d:
        raise ValueError(f"at most {d} parts on a {d}-rank group")
    mine = parts[me] if me < len(parts) else torch.zeros(0, dtype=torch.uint8, device=dev)
    return _out(merge_parts(mine, transport, force_wide), host)
