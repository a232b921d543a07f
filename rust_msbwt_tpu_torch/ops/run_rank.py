"""Run-length-compressed device rank: memory scales with runs, not positions
(torch).

Port of the JAX package's ``ops.run_rank``. The reference's ``RleBWT`` holds
only the RLE bytes plus a sampled index (ref: src/rle_bwt.rs:14-24); this
tier keeps that memory scaling on the device, for indexes the decoded tiers
cannot hold.

* **Run rows** (``table`` int32 ``[NR + 2, 40]``): each row packs ``RB = 64``
  consecutive runs as u16 words (``len << 3 | sym``, two per int32 lane,
  lanes 8..39) behind a checkpoint: lanes 0..5 = occurrences of each symbol
  before the row, lane 6 = the row's first position. 2.5 B a run. Runs
  longer than 8191 (13-bit length) are split at build time. Two terminal
  rows hold the totals and ``n``.
* **Seek table** (``seek`` int32 ``[n // SP + 1]``): the row holding each
  ``SP = 64``-position boundary.

A rank is a seek gather, two adjacent row gathers (every full row covers
at least RB >= SP positions, so the row of ``pos`` is ``seek[pos // SP]``
or the next) and a fixed-width decode of 64 runs. The host build is O(runs)
in numpy; the device reads the u16 words with int32 masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.rank import KmerCache, _cache_seed, cache_levels, count_batch

RB = 64          # runs per row
SP = 64          # seek spacing in positions; must be <= RB (two-row rule)
MAX_RUN = 8191   # 13-bit run-length cap; longer runs are split at build
MAX_CACHE_K = 8  # deepest run-tier prefix cache
_META = 8        # meta lanes per row (occ 0..5, first position at 6)
LANES = _META + RB // 2  # 40 int32 lanes = 160 B a row
_I32 = torch.int32


class RunOccIndex(NamedTuple):
    """Device rank index over run-length-compressed symbols."""

    table: torch.Tensor   # int32 [NR + 2, LANES]
    seek: torch.Tensor    # int32 [n // SP + 1]
    starts: torch.Tensor  # int32 [VC_LEN + 1] C-array
    n: int

    @property
    def counts(self) -> torch.Tensor:
        return torch.diff(self.starts)

    def device_bytes(self) -> int:
        """Resident device bytes (table + seek), as the JAX package counts them."""
        return int(self.table.numel()) * 4 + int(self.seek.numel()) * 4


def _split_runs(syms: np.ndarray, lens: np.ndarray):
    """Split runs longer than MAX_RUN into <= MAX_RUN chunks (host)."""
    syms = np.asarray(syms, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    if lens.size and int(lens.min()) < 1:
        raise ValueError("run lengths must be >= 1")
    n_chunks = -(-lens // MAX_RUN) if lens.size else lens
    if lens.size == 0 or int(n_chunks.max()) == 1:
        return syms, lens
    total = int(n_chunks.sum())
    out_syms = np.repeat(syms, n_chunks)
    first = np.cumsum(n_chunks) - n_chunks          # first chunk of each run
    within = np.arange(total, dtype=np.int64) - np.repeat(first, n_chunks)
    last_len = lens - (n_chunks - 1) * MAX_RUN      # 1..MAX_RUN
    out_lens = np.where(within < np.repeat(n_chunks - 1, n_chunks), MAX_RUN,
                        np.repeat(last_len, n_chunks))
    return out_syms, out_lens


def build_run_index(syms, lens, *, device) -> RunOccIndex:
    """Build the run-tier index from maximal runs on the host (O(runs),
    numpy; the tables are bit-exact with the JAX package's) and upload it to
    ``device``.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.rle import runs_from_symbols
    >>> idx = build_run_index(*runs_from_symbols(convert_stoi("TAC$GATCG$")), device="cpu")
    >>> int(count_kmers_runs(idx, convert_stoi("ACGT"))[0])
    1
    """
    syms, lens = _split_runs(syms, lens)
    n = int(lens.sum()) if lens.size else 0
    if n >= 2**31:
        raise ValueError("single-device RunOccIndex limited to 2^31-1 symbols")
    r = int(syms.size)
    nr = -(-r // RB)
    pad = nr * RB - r
    if pad:
        syms = np.concatenate([syms, np.full(pad, 7, np.uint8)])
        lens = np.concatenate([lens, np.zeros(pad, np.int64)])
    words = ((lens.astype(np.uint32) << 3) | syms.astype(np.uint32)).reshape(nr, RB)
    packed = (words[:, 0::2] | (words[:, 1::2] << 16)).view(np.int32)
    row_lens = lens.reshape(nr, RB).sum(axis=1)
    pos0 = np.cumsum(row_lens) - row_lens
    occ_rows = np.zeros((nr, VC_LEN), dtype=np.int64)
    totals = np.zeros(VC_LEN, dtype=np.int64)
    for s in range(VC_LEN):
        contrib = np.where(syms == s, lens, 0).reshape(nr, RB).sum(axis=1)
        totals[s] = int(contrib.sum())
        occ_rows[:, s] = np.cumsum(contrib) - contrib
    table = np.zeros((nr + 2, LANES), dtype=np.int32)
    table[:nr, :VC_LEN] = occ_rows
    table[:nr, 6] = pos0
    table[:nr, _META:] = packed
    # two terminal rows: rank(pos == n) resolves here; the second keeps the
    # unconditional `row + 1` gather in range
    table[nr:, :VC_LEN] = totals
    table[nr:, 6] = n
    boundaries = np.arange(n // SP + 1, dtype=np.int64) * SP
    pos0_all = np.concatenate([pos0, [n, n]])
    seek = (np.searchsorted(pos0_all, boundaries, side="right") - 1).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(totals)]).astype(np.int32)
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return RunOccIndex(table=up(table), seek=up(seek), starts=up(starts), n=n)


def build_run_index_from_bytes(rle_bytes, *, device) -> RunOccIndex:
    """Run-tier index straight from the compressed npy byte vector."""
    from rust_msbwt_tpu_torch.ops.rle import runs_from_bytes

    syms, counts = runs_from_bytes(rle_bytes)
    return build_run_index(syms, counts.astype(np.int64), device=device)


def rank_runs(table: torch.Tensor, seek: torch.Tensor, sym: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Batched rank: occurrences of ``sym[i]`` in ``bwt[0:pos[i]]`` (int32).
    One seek gather, two adjacent row gathers, a decode of the row's runs
    (the analogue of the reference's fm_index seed + run scan, ref:
    src/rle_bwt.rs:204-244). Gathers clamp their indexes (the JAX package's
    ``mode="clip"``)."""
    sym = sym.long()
    pos = pos.long()
    last = table.shape[0] - 1
    r0 = seek[(pos // SP).clamp(0, seek.shape[0] - 1)].long().clamp(0, last)
    row_a = table[r0]                                   # [B, LANES]
    row_b = table[(r0 + 1).clamp(max=last)]
    row = torch.where((pos >= row_b[:, 6])[:, None], row_b, row_a)
    occ_base = row[:, :VC_LEN].gather(1, sym[:, None])[:, 0]
    words = row[:, _META:]                              # [B, RB // 2]
    runs = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], dim=-1).view(-1, RB)
    rlen = runs >> 3
    cstart = torch.cumsum(rlen, 1, dtype=_I32) - rlen   # run start offsets
    rel = (pos - row[:, 6]).to(_I32)                    # in-row offset
    contrib = torch.minimum((rel[:, None] - cstart).clamp(min=0), rlen)
    hit = (runs & 7) == sym[:, None]
    return occ_base + torch.where(hit, contrib, 0).sum(1, dtype=_I32)


def constrain_range_runs(index: RunOccIndex, sym: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LF step over the run tier (result-equivalent to
    ref: src/rle_bwt.rs:202-287)."""
    B = lo.shape[0]
    both = rank_runs(index.table, index.seek, torch.cat([sym, sym]), torch.cat([lo, hi]))
    c = index.starts[sym.long()]
    return c + both[:B], c + both[B:]


def _count_kmers_runs_impl(index: RunOccIndex, kmers: torch.Tensor,
                           lengths: torch.Tensor, cache: KmerCache | None = None,
                           cache_k: int = 0) -> torch.Tensor:
    B, K = kmers.shape
    lo = torch.zeros(B, dtype=_I32, device=kmers.device)
    hi = torch.full((B,), index.n, dtype=_I32, device=kmers.device)
    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k
    for t in range(t_start, K):
        active = t < lengths
        s = torch.where(active, kmers[:, K - 1 - t].to(_I32), 0)
        new_lo, new_hi = constrain_range_runs(index, s, lo, hi)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    return hi - lo


def build_kmer_cache_runs(index: RunOccIndex, cache_k: int) -> KmerCache:
    """k-mer prefix cache from the run tier (``ops.rank.KmerCache``, level
    by level, ``ops.rank.cache_levels``); ``cache_k`` <= 8, as in the JAX
    package."""
    if cache_k > MAX_CACHE_K:
        raise ValueError(f"run-tier cache build supports cache_k <= {MAX_CACHE_K}")
    return cache_levels(lambda s, lo, hi: constrain_range_runs(index, s, lo, hi),
                        index.n, cache_k, index.table.device)


def count_kmers_runs(index: RunOccIndex, kmers, lengths=None, cache=None,
                     cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` over the run tier (result-equivalent to
    ``count_kmers_packed``; ref semantics: src/msbwt_core.rs:124-161)."""
    def impl(km, ln, c, ck):
        return _count_kmers_runs_impl(index, km, ln, cache=c, cache_k=ck)

    return count_batch(impl, index.table.device, kmers, lengths, cache, cache_k)
