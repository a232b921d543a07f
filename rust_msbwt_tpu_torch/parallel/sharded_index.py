"""Sharded rank index: the BWT and its occurrence checkpoints split across
the ranks, a global rank being the sum of per-shard partials.

Port of the JAX package's ``parallel.sharded_index``: the distributed form
of the reference's ``fm_index[bin] + local scan`` decomposition (ref:
src/rle_bwt.rs:204-214). A rank at global position p is the full counts of
every shard left of p's shard plus the in-shard rank; every rank computes
its part from local data and one ``all_reduce`` adds them. A k-mer batch
runs the backward search with two ``all_reduce``s a step (the lower and the
upper bound). Global positions are int64 ("wide") past 2^31 symbols; a
shard's own offsets stay int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.rank import BIN, PAD, OccIndex, rank
from rust_msbwt_tpu_torch.parallel import mesh

_I32, _I64 = torch.int32, torch.int64


class ShardedOccIndex(NamedTuple):
    bwt: torch.Tensor     # uint8 [S]: this rank's positions [rank*S, (rank+1)*S), PAD past n
    occ: torch.Tensor     # int32 [S / BIN + 1, 6]: counts within the shard before each bin
    starts: torch.Tensor  # the global C array, int64 when ``wide`` (else int32)
    n: int                # global BWT length
    shard_len: int        # S, a multiple of BIN
    rank: int             # this rank
    wide: bool = False    # int64 global positions (BWTs past 2^31 symbols)


def build_sharded_index(decoded, force_wide: bool = False, *, device=None) -> ShardedOccIndex:
    """Shard a decoded BWT over the ranks (every rank passes the whole BWT,
    a host array or a tensor) and index this rank's shard on ``device``
    (default ``cuda``; a tensor's own device) through one merge pass with
    no inserts (``ops.bcr.index_from_symbols``: on a card, the kernel). The
    shard length S is BIN-aligned.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
    >>> idx = build_sharded_index(convert_stoi(naive_bwt(["ACGT", "TGCA"])), device="cpu")
    >>> int(count_kmers_sharded(idx, convert_stoi("GT")[None, :])[0])
    1
    """
    from rust_msbwt_tpu_torch.ops.bcr import index_from_symbols

    me, d = mesh.world()
    if isinstance(decoded, torch.Tensor):
        dev = decoded.device
    else:
        dev = torch.device("cuda" if device is None else device)
        decoded = torch.from_numpy(np.array(decoded, dtype=np.uint8, copy=True))
    n = int(decoded.numel())
    wide = force_wide or n >= 2**31
    S = -(-max(n, 1) // (d * BIN)) * BIN
    shard = torch.full((S,), PAD, dtype=torch.uint8, device=dev)
    lo, hi = min(me * S, n), min((me + 1) * S, n)
    shard[: hi - lo] = decoded[lo:hi].to(dev)
    local, _ = index_from_symbols(shard)
    totals = mesh.all_reduce_sum(local.counts.to(_I64))
    starts = torch.zeros(VC_LEN + 1, dtype=_I64, device=dev)
    torch.cumsum(totals, 0, out=starts[1:])
    return ShardedOccIndex(bwt=local.bwt, occ=local.occ, starts=starts.to(_I64 if wide else _I32),
                           n=n, shard_len=S, rank=me, wide=wide)


def shard_local_pos(pos: torch.Tensor, shard_id: int, S: int) -> torch.Tensor:
    """Global positions clipped into shard ``shard_id``'s local ``[0, S]``
    (int32). The shard base ``shard_id * S`` is taken in ``pos``'s dtype: in
    the wide configurations it passes 2^31 (shard 3 of S = 805306368 maps
    3*S + 84080896 to 84080896).

    >>> shard_local_pos(torch.tensor([3 * 805306368 + 84080896, 0]), 3, 805306368).tolist()
    [84080896, 0]
    """
    return (pos - shard_id * S).clamp(0, S).to(_I32)


def count_kmers_sharded(index: ShardedOccIndex, kmers, lengths=None) -> np.ndarray:
    """Batched ``count_kmer`` over the sharded index, called by every rank
    with the same right-aligned k-mers (``[B, K]`` uint8; ``lengths``
    optional): counts (int32, int64 when wide) on every rank."""
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise ValueError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    dev = index.bwt.device
    pd = _I64 if index.wide else _I32
    km = torch.from_numpy(np.ascontiguousarray(kmers)).to(dev)
    ln = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(dev)
    local = OccIndex(bwt=index.bwt, occ=index.occ, starts=index.starts, n=index.shard_len)

    def rank_g(sym, pos):
        part = rank(local, sym, shard_local_pos(pos, index.rank, index.shard_len))
        # a shard's partial is int32 (< S); the global sum takes the wide dtype
        return mesh.all_reduce_sum(part.to(pd))

    lo = torch.zeros(B, dtype=pd, device=dev)
    hi = torch.full((B,), index.n, dtype=pd, device=dev)
    for t in range(K):
        active = t < ln
        sym = torch.where(active, km[:, K - 1 - t].to(_I32), 0)
        c = index.starts[sym.long()]
        lo = torch.where(active, c + rank_g(sym, lo), lo)
        hi = torch.where(active, c + rank_g(sym, hi), hi)
    return (hi - lo).cpu().numpy()
