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


MAX_CACHE_K = 8  # deeper (chunked-level) caches are not ported yet


def _cache_seed(cache: KmerCache, kmers: torch.Tensor, K: int, cache_k: int):
    """Seed [lo, hi) from the last ``cache_k`` symbols (two flat gathers)."""
    weights = VC_LEN ** (
        cache_k - 1 - torch.arange(cache_k, dtype=_I32, device=kmers.device)
    )
    code = (kmers[:, K - cache_k:].to(_I32) * weights[None, :]).sum(1, dtype=torch.int64)
    return cache.lo[code], cache.hi[code]


def build_kmer_cache(bwt, occ, starts, n: int, cache_k: int) -> KmerCache:
    """Ranges of every length-``cache_k`` string over the 6-symbol alphabet
    (the caching idea the reference sketches, ref: src/msbwt_core.rs:133-146).

    All levels run over fixed ``6^k`` buffers: level l computes, for EVERY
    slot c, ``extend(T[c mod 6^(l-1)], digit)``; slots past 6^l hold values
    that later levels overwrite and never read (the JAX package's fused
    form). ``cache_k`` is at most ``MAX_CACHE_K``.
    """
    if not 0 < cache_k <= MAX_CACHE_K:
        raise NotImplementedError(
            f"cache_k={cache_k}: the port builds prefix caches up to "
            f"6^{MAX_CACHE_K}"
        )
    index = OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)
    size = VC_LEN ** cache_k
    codes = torch.arange(size, dtype=_I32, device=bwt.device)
    lo = torch.zeros(size, dtype=_I32, device=bwt.device)
    hi = torch.full((size,), n, dtype=_I32, device=bwt.device)
    for level in range(1, cache_k + 1):
        p = VC_LEN ** (level - 1)
        rest = (codes % p).long()
        lo, hi = constrain_range(index, (codes // p) % VC_LEN, lo[rest], hi[rest])
    return KmerCache(lo, hi)


def fetch_counts(out: torch.Tensor) -> np.ndarray:
    """Copy device counts to host int64."""
    return out.cpu().numpy().astype(np.int64)
