"""Occurrence index, batched rank and the k-mer prefix-range cache (torch).

Port of the JAX package's ``ops.rank``: a decoded BWT on the device next to
occurrence checkpoints sampled every ``BIN`` positions answers a rank with
one row gather plus a fixed-width in-bin reduction (the reference's query
hot loop, ref: src/rle_bwt.rs:202-287, with the run decode replaced by a
vectorized window sum). Every function computes on the device of the
tensors it is given; the entry points that take host data take ``device``.

All positions and counts are int32; ``build_occ_index`` rejects BWTs with
2**31 symbols or more.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN

BIN = 128  # occurrence checkpoint spacing (positions)
PAD = 7  # padding symbol: never matches a real symbol (0..5)
_I32 = torch.int32


class OccIndex(NamedTuple):
    """Device rank index over a decoded BWT."""

    bwt: torch.Tensor     # uint8 [nb * BIN] decoded symbols, padded with 7
    occ: torch.Tensor     # int32 [nb + 1, 6] counts of each symbol before bin start
    starts: torch.Tensor  # int32 [VC_LEN + 1] C-array: starts[c] = # symbols < c
    n: int                # true BWT length

    @property
    def counts(self) -> torch.Tensor:
        return self.occ[-1]


def build_occ_index(decoded, n: int | None = None, *, device=None) -> OccIndex:
    """Build the occurrence index from decoded symbols, on ``device``
    (required for numpy input; a tensor's own device by default): reshape
    + compare + cumsum, one pass.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> idx = build_occ_index(convert_stoi("TAC$GATCG$"), device="cpu")
    >>> idx.n, idx.starts.tolist()
    (10, [0, 2, 4, 6, 8, 8, 10])
    """
    if isinstance(decoded, torch.Tensor):
        dec = decoded.to(device=device, dtype=torch.uint8)
    elif device is None:
        raise ValueError("host data needs an explicit device")
    else:
        dec = torch.from_numpy(np.ascontiguousarray(decoded, dtype=np.uint8)).to(device)
    if n is None:
        n = int(dec.shape[0])
    if n >= 2**31:
        raise ValueError("single-device OccIndex limited to 2^31-1 symbols")
    nb = max(1, -(-n // BIN))
    bwt = torch.full((nb * BIN,), PAD, dtype=torch.uint8, device=dec.device)
    bwt[:n] = dec[:n]
    bins = bwt.view(nb, BIN)
    per_bin = torch.stack(
        [(bins == s).sum(1, dtype=_I32) for s in range(VC_LEN)], dim=1
    )
    occ = torch.zeros((nb + 1, VC_LEN), dtype=_I32, device=bwt.device)
    torch.cumsum(per_bin, 0, dtype=_I32, out=occ[1:])
    return OccIndex(bwt=bwt, occ=occ, starts=starts_from_counts(occ[-1]), n=n)


def starts_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """C-array ``[0, c0, c0+c1, ...]`` (int32 [VC_LEN + 1]) from symbol totals."""
    starts = torch.zeros(VC_LEN + 1, dtype=_I32, device=counts.device)
    torch.cumsum(counts, 0, dtype=_I32, out=starts[1:])
    return starts


def rank(index: OccIndex, sym: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Batched rank: occurrences of ``sym[i]`` in ``bwt[0:pos[i]]`` (int32).

    One occ-checkpoint row gather plus a masked in-bin window reduction —
    the analogue of the reference's fm_index[bin] seed + linear run decode
    (ref: src/rle_bwt.rs:204-244).
    """
    sym = sym.long()
    pos = pos.long()
    b = pos // BIN
    nb = index.bwt.shape[0] // BIN
    # pos == n at a bin boundary reads occ row nb (the totals); its window
    # is masked off entirely, so the clamped row is never counted
    window = index.bwt.view(nb, BIN)[b.clamp(max=nb - 1)]       # [B, BIN] u8
    base = index.occ[b].gather(1, sym[:, None])[:, 0]            # [B] i32
    in_range = (
        torch.arange(BIN, device=pos.device)[None, :] < (pos - b * BIN)[:, None]
    )
    local = ((window == sym[:, None].to(torch.uint8)) & in_range).sum(1, dtype=_I32)
    return base + local


def constrain_range(
    index: OccIndex, sym: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LF step: [lo, hi) -> range of ``sym`` + k-mer
    (result-equivalent to ref: src/rle_bwt.rs:202-287)."""
    B = lo.shape[0]
    both = rank(index, torch.cat([sym, sym]), torch.cat([lo, hi]))
    c = index.starts[sym.long()]
    return c + both[:B], c + both[B:]


class KmerCache(NamedTuple):
    """Prefix-range cache as two flat ``[6^k]`` int32 tensors: entry ``code``
    holds the BWT range ``[lo, hi)`` of the length-k string whose base-6
    digits (most significant first) spell ``code``."""

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def table(self) -> torch.Tensor:
        """[6^k, 2] view (tests / inspection)."""
        return torch.stack([self.lo, self.hi], dim=1)


# A cache level extends its previous level's ranges in chunks of this many.
# A chunk is 12x as many ranks, and ``rank`` holds a [ranks, 128] byte
# window and masks of that shape: 6^7 keeps each of them near 0.4 GB.
_CACHE_LEVEL_CHUNK = 6**7


def _cache_seed(cache: KmerCache, kmers: torch.Tensor, K: int, cache_k: int):
    """Seed [lo, hi) from the last ``cache_k`` symbols (two flat gathers)."""
    weights = VC_LEN ** (
        cache_k - 1 - torch.arange(cache_k, dtype=_I32, device=kmers.device)
    )
    code = (kmers[:, K - cache_k:].to(_I32) * weights[None, :]).sum(1, dtype=torch.int64)
    return cache.lo[code], cache.hi[code]


def cache_levels(step, n: int, cache_k: int, device) -> KmerCache:
    """A prefix cache of depth ``cache_k`` through any tier's LF step
    ``step(sym, lo, hi) -> (lo, hi)``. Level l extends the 6^(l-1) ranges
    of level l-1: the range of ``sym`` + string ``rest`` lands at code
    ``sym * 6^(l-1) + rest``, computed ``_CACHE_LEVEL_CHUNK`` ranges at a
    time and written straight to its codes. Equal to the JAX package's
    fused form at every chunk size (its slots past 6^l only hold values it
    overwrites), at about 2.4 x 6^k ranks instead of 2k x 6^k."""
    if cache_k < 1:
        raise ValueError(f"cache_k must be >= 1, got {cache_k}")
    lo = torch.zeros(1, dtype=_I32, device=device)
    hi = torch.full((1,), n, dtype=_I32, device=device)
    for _ in range(cache_k):
        size = lo.shape[0]
        new_lo = torch.empty(VC_LEN * size, dtype=_I32, device=device)
        new_hi = torch.empty(VC_LEN * size, dtype=_I32, device=device)
        for c0 in range(0, size, _CACHE_LEVEL_CHUNK):
            c1 = min(size, c0 + _CACHE_LEVEL_CHUNK)
            sym = torch.arange(VC_LEN, dtype=_I32, device=device).repeat_interleave(c1 - c0)
            plo, phi = step(sym, lo[c0:c1].repeat(VC_LEN), hi[c0:c1].repeat(VC_LEN))
            new_lo.view(VC_LEN, size)[:, c0:c1] = plo.view(VC_LEN, c1 - c0)
            new_hi.view(VC_LEN, size)[:, c0:c1] = phi.view(VC_LEN, c1 - c0)
        lo, hi = new_lo, new_hi
    return KmerCache(lo, hi)


def build_kmer_cache(bwt, occ, starts, n: int, cache_k: int) -> KmerCache:
    """Ranges of every length-``cache_k`` string over the 6-symbol alphabet
    (the caching idea the reference sketches, ref: src/msbwt_core.rs:133-146),
    level by level over the occurrence index (``cache_levels``).

    >>> idx = build_occ_index(np.array([5, 1, 2, 0, 3, 1, 5, 2, 3, 0], np.uint8), device="cpu")
    >>> c = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 2)
    >>> int(c.hi[1 * 6 + 2] - c.lo[1 * 6 + 2])  # "AC" in {ACGT, TGCA}
    1
    """
    index = OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)
    return cache_levels(lambda s, lo, hi: constrain_range(index, s, lo, hi), n,
                        cache_k, bwt.device)


def fetch_counts(out: torch.Tensor) -> np.ndarray:
    """Copy device counts to host int64."""
    return out.cpu().numpy().astype(np.int64)


def count_batch(impl, device, kmers, lengths=None, cache: KmerCache | None = None,
                cache_k: int = 0) -> np.ndarray:
    """The host front every batched ``count_kmers_*`` shares: ``[B, K]``
    right-aligned uint8 k-mers (numpy) and their lengths in, int64 counts
    out (ref semantics: src/msbwt_core.rs:124-161). ``impl(kmers, lengths,
    cache, cache_k)`` counts one batch of device tensors. With a cache,
    queries shorter than ``cache_k`` take the uncached program."""
    from rust_msbwt_tpu_torch.utils.checks import validate_kmers

    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise ValueError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    validate_kmers(kmers, lengths)
    if cache is None or cache_k <= 0 or K < cache_k:
        cache, cache_k = None, 0
    short = lengths < cache_k
    if short.any():  # rare path: too short for the cache seed
        out = np.empty(B, dtype=np.int64)
        out[short] = count_batch(impl, device, kmers[short], lengths[short])
        out[~short] = count_batch(impl, device, kmers[~short], lengths[~short],
                                  cache, cache_k)
        return out
    # torch.tensor copies: sliding-window views of reads arrive read-only
    out = impl(torch.tensor(kmers, device=device), torch.tensor(lengths, device=device),
               cache, cache_k)
    return fetch_counts(out)
