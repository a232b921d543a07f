"""Distributed prefix-doubling D-way BWT merge over the ranks of a group.

Port of the JAX package's ``parallel.doubling_merge``. The sharded H-M merge
(``parallel.sharded_merge``) needs up to max-rotation-period rounds (~101 for
100 bp reads), each a full cross-rank exchange. This module runs the fixpoint
of ``ops.merge._doubling_merge`` — rank prefix-doubling over the union of
rotations — SPMD over the ranks, so it converges in ``ceil(log2 max-period)
+ 2`` rounds (~8 for 100 bp). Ties (identical rotations) keep source-major
input order, the order H-M converges to.

Layout: the source-major element stream (all sources' BWT rows
concatenated) is sharded by global element index into D blocks of ``blk``;
the number of sources is free. Every round is built from two primitives on
the ragged exchange (``mesh.exchange``, one ``all_to_all_single``):

* ``dist_scatter`` — route (global position, value) pairs to the position's
  owner block (the positions are permutation fragments, so a rank receives
  at most its own blk);
* ``sort_pass`` — a distributed stable sample sort (PSRS: local sort, D
  regular samples a rank, splitters, one exchange, a local re-sort), then
  position-style ranks through cross-rank group-start propagation.

psi (the successor-rotation map, LF^-1 of every source) comes from the
``[D, ns, 6]`` count cube without a global sort, inverted by one
``dist_scatter``. Sorting by ``(k1, k2, gid)`` packs ``k1, k2`` into one
int64 key (both below the sentinel ``BIG = D * blk`` < 2^31; ``gid`` is
ascending in block order, so a stable sort takes it as the last key); in
wide mode (``BIG`` >= 2^31, gated on the sentinel, not on n) it runs stable
passes, least significant key first.
"""

from __future__ import annotations

import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.parallel import mesh
from rust_msbwt_tpu_torch.parallel.sharded_merge import group_ranks

_PAD_SYM = 7
_I32, _I64 = torch.int32, torch.int64


def _lex_perm(keys: list[torch.Tensor], span: int | None) -> torch.Tensor:
    """The stable permutation that sorts by ``keys`` lexicographically
    (first key most significant; ties keep input order). With ``span`` (every
    key's values in ``[0, span)``, span^2 < 2^63) two keys pack into one
    int64 and one sort does; otherwise stable passes, last key first."""
    if span is not None and len(keys) == 2:
        return torch.sort(keys[0].to(_I64) * span + keys[1], stable=True).indices
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _doubling_block(syms_l, src_l, *, n: int, blk: int, ns: int, wide: bool):
    """This rank's block of the merged stream: ``syms_l`` (u8) and ``src_l``
    (int32) are [blk] slices of the source-major stream (pads: symbol 7,
    source ns). Returns ``(merged symbols u8 [blk], source ids int32
    [blk])`` of merged positions ``[rank*blk, (rank+1)*blk)``."""
    me, d = mesh.world()
    dev = syms_l.device
    pd = _I64 if wide else _I32
    BIG = d * blk                         # drop / fill sentinel
    span = None if wide else BIG + 1      # key range for packing (k <= BIG)
    pos0 = me * blk
    gid = pos0 + torch.arange(blk, dtype=pd, device=dev)
    valid = gid < n
    ranks_d = torch.arange(d, device=dev)

    def full(size, value, dtype):
        return torch.full((size,), value, dtype=dtype, device=dev)

    def dist_scatter(p, v, fill):
        """``out[p[i] - pos0] = v[i]`` on p[i]'s owner; p >= BIG dropped. p's
        valid entries are distinct, so a rank receives at most blk."""
        p_s, perm = torch.sort(p)
        send, recv = mesh.exchange_sizes(p_s // blk)
        p_r = mesh.exchange(p_s, send, recv)
        v_r = mesh.exchange(v[perm], send, recv)
        out = full(blk, fill, v.dtype)
        out[(p_r - pos0).long()] = v_r
        return out

    def dist_gather(q, vals, fill):
        """``out[i] = vals_global[q[i]]`` for valid i (q a permutation of the
        valid element ids): two scatters, the request and the reply."""
        req = dist_scatter(torch.where(valid, q, BIG), gid, BIG)
        return dist_scatter(req, vals, fill)

    # ---- prep: the (source, symbol) count cube -> fsym, rank0, psi ----
    # in-block rank of each element among its (source, symbol) group
    key = torch.where(valid, src_l.long() * VC_LEN + syms_l.long(), ns * VC_LEN)
    excl, local_cnt = group_ranks(key, ns * VC_LEN)
    cube = mesh.all_gather(local_cnt.view(ns, VC_LEN).to(pd))       # [D, ns, 6]
    dev_pref = (torch.cumsum(cube, 0) - cube)[me]                    # [ns, 6]
    totals = cube.sum(0)                                             # [ns, 6]
    zero = torch.zeros(ns, 1, dtype=pd, device=dev)
    src_csum = torch.cat([zero, torch.cumsum(totals, 1)], 1)         # [ns, 7]
    off = torch.cat([zero[:1, 0], torch.cumsum(totals.sum(1), 0)])   # [ns + 1]
    sym_pref = torch.cat([zero[:1, 0], torch.cumsum(totals.sum(0), 0)])  # [7]
    src_c = src_l.long().clamp(0, ns - 1)
    sym_c = syms_l.long().clamp(0, VC_LEN - 1)
    # F-column symbol of my rows: the in-source row f against C_s's bounds
    f = gid - off[src_c]
    fsym = (f[:, None] >= src_csum[src_c, 1:VC_LEN]).sum(1)
    rank = torch.where(valid, sym_pref[fsym], BIG)
    # LF(e) = off_s + C_s[sym] + global in-(source, symbol) rank
    lf = off[src_c] + src_csum[src_c, sym_c] + dev_pref[src_c, sym_c] + excl.to(pd)
    del key, excl, f, fsym, src_c, sym_c
    succ = torch.where(valid, dist_scatter(torch.where(valid, lf, BIG), gid, BIG), gid)

    def sort_pass(k1, k2, want_perm):
        """One distributed PSRS pass by ``(k1, k2, gid)``: the new
        position-style ranks and, with ``want_perm``, the merged-position
        permutation (merged slot of my block -> element id)."""
        k1m = torch.where(valid, k1, BIG)
        k2m = torch.where(valid, k2, BIG)
        o = _lex_perm([k1m, k2m], span)          # gid ascending: last key
        k1s, k2s, gs = k1m[o], k2m[o], gid[o]
        samp = (torch.arange(d, device=dev) * blk) // d
        S = mesh.all_gather(torch.stack([k1s[samp], k2s[samp], gs[samp]]))  # [D, 3, D]
        S = S.permute(1, 0, 2).reshape(3, -1)
        S = S[:, _lex_perm(list(S), None)]
        sp = S[:, torch.arange(1, d, device=dev) * d]                      # splitters
        le = ((sp[0] < k1s[:, None])
              | ((sp[0] == k1s[:, None])
                 & ((sp[1] < k2s[:, None])
                    | ((sp[1] == k2s[:, None]) & (sp[2] <= gs[:, None])))))
        send, recv = mesh.exchange_sizes(le.sum(1))
        got = [mesh.exchange(a, send, recv) for a in (k1s, k2s, gs)]
        # one BIG pad row keeps the last-key read in range on an empty rank
        k1r, k2r, gr = (torch.cat([a, full(1, BIG, pd)]) for a in got)
        if span is None:
            o = _lex_perm([k1r, k2r, gr], None)
        else:  # the received runs are not in gid order: sort by it first
            o = torch.sort(gr).indices
            o = o[_lex_perm([k1r[o], k2r[o]], span)]
        k1o, k2o, go = k1r[o], k2r[o], gr[o]
        cap = k1o.numel()
        nval = (k1o < BIG).sum()
        goff = (mesh.all_gather(nval.reshape(1)).view(-1)[:me]).sum()
        okm = torch.arange(cap, device=dev) < nval
        # group starts: (k1, k2) change points; at the block's edge, against
        # the last key of the previous rank that holds any
        last = (nval - 1).clamp(min=0)
        edge = mesh.all_gather(torch.stack([k1o[last], k2o[last], (nval > 0).to(pd)]))
        prev = torch.where((ranks_d < me) & (edge[:, 2] > 0), ranks_d, -1).max()
        pc = prev.clamp(min=0)
        first_new = (prev < 0) | (k1o[0] != edge[pc, 0]) | (k2o[0] != edge[pc, 1])
        neq = torch.cat([first_new.reshape(1),
                         (k1o[1:] != k1o[:-1]) | (k2o[1:] != k2o[:-1])])
        gpos = goff.to(pd) + torch.arange(cap, dtype=pd, device=dev)
        starts = torch.where(neq & okm, gpos, -1)
        run_start = torch.cummax(starts, 0).values
        LC = mesh.all_gather(starts.max().reshape(1)).view(-1)
        carry = torch.where(ranks_d < me, LC, -1).max()
        rank_sorted = torch.maximum(run_start, carry)
        new_rank = dist_scatter(torch.where(okm, go, BIG), rank_sorted, BIG)
        new_rank = torch.where(valid, new_rank, BIG)
        if not want_perm:
            return new_rank, None
        # merged slot gpos holds element go
        return new_rank, dist_scatter(torch.where(okm, gpos, BIG), go, BIG)

    while True:
        rank_ahead = dist_gather(succ, rank, BIG)
        new_rank, _ = sort_pass(rank, rank_ahead, False)
        changed = mesh.any_across((new_rank != rank) & valid)
        rank = new_rank
        if not changed:
            break
        succ = torch.where(valid, dist_gather(succ, succ, BIG), gid)
    # final order: by the converged rank, gid breaking ties (source-major)
    _, perm = sort_pass(rank, rank, True)
    perm = torch.where(valid, perm, gid)
    out_sym = dist_gather(perm, syms_l, _PAD_SYM)
    out_src = dist_gather(perm, src_l, ns)
    return (torch.where(valid, out_sym, _PAD_SYM).to(torch.uint8),
            torch.where(valid, out_src, ns).to(_I32))


def sharded_doubling_merge(parts, force_wide: bool = False, return_sources: bool = False,
                           *, device=None):
    """Merge partial BWTs across the ranks in O(log max-period) rounds.

    Every rank passes the same list of parts (any number of sources, empty
    ones too) and gets the merged BWT, equal to ``ops.merge.kway_merge``
    of them; ``return_sources`` also returns each merged position's source
    id (int32). Host parts give host arrays; tensor parts stay on their
    device. A rank works on O(n/D) of the merge.

    >>> import numpy as np
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> parts = [np.asarray(convert_stoi(naive_bwt(g)), np.uint8)
    ...          for g in (["ACGT", "TTT"], ["GGAA"])]
    >>> merged = sharded_doubling_merge(parts, device="cpu")
    >>> convert_itos(merged) == naive_bwt(["ACGT", "TTT", "GGAA"])
    True
    """
    from rust_msbwt_tpu_torch.ops.merge import _as_parts, _out

    me, d = mesh.world()
    parts, dev, host = _as_parts(list(parts), device)
    sizes = [int(p.numel()) for p in parts]
    ns, n = len(parts), sum(sizes)
    if n == 0:
        merged = torch.zeros(0, dtype=torch.uint8, device=dev)
        srcs = torch.zeros(0, dtype=_I32, device=dev)
    else:
        blk = -(-n // d)
        # my block of the source-major stream (every rank holds all parts)
        lo, hi = me * blk, min((me + 1) * blk, n)
        syms = torch.full((blk,), _PAD_SYM, dtype=torch.uint8, device=dev)
        src = torch.full((blk,), ns, dtype=_I32, device=dev)
        if hi > lo:
            syms[: hi - lo] = torch.cat(parts)[lo:hi]
            ids = torch.repeat_interleave(torch.arange(ns, dtype=_I32, device=dev),
                                          torch.tensor(sizes, device=dev))
            src[: hi - lo] = ids[lo:hi]
        wide = force_wide or d * blk >= 2**31
        out_sym, out_src = _doubling_block(syms, src, n=n, blk=blk, ns=ns, wide=wide)
        merged = mesh.all_gather(out_sym).view(-1)[:n]
        srcs = mesh.all_gather(out_src).view(-1)[:n]
    if return_sources:
        return _out(merged, host), _out(srcs, host)
    return _out(merged, host)
