"""The k-mer backward search of the query tiers: two hand-written CUDA
kernels (``csrc/query.cu``) and their plain PyTorch twins.

The JAX package runs these searches as XLA fusions inside one compiled
program (a ``fori_loop`` over the steps); the port ran them as eager torch
ops, tens of kernels and host launches a step. Here each batch is one
launch, one thread a query with its ``lo`` / ``hi`` in registers:

* **kmer_ranges_packed** — the packed tier's range search: every
  right-aligned k-mer's BWT row range ``[lo, hi)``, one rank a bound a
  step off the ``PackedOccIndex`` table (the rank the LF-step kernels
  take). The counts of ``count_kmers_packed``, the ranges ``locate_kmers``
  walks and the partitioned counts go through it. Its plain twin is
  ``ops.packed_rank.kmer_ranges_packed_plain``.
* **kmer_counts_pair** — the pair tier's counts, two symbols a round off
  one 60-lane pair row a bound (one symbol off the same row when one is
  left); a query stops once its range is empty. The counts of
  ``count_kmers_pair`` (``RleBWT``'s tier from 32M symbols) go through it.
  Its plain twin is ``ops.pair_rank.kmer_counts_pair_plain``.

Both take the optional prefix cache (``KmerCache`` of depth ``cache_k``)
as the plain versions do: the seed is the cache range of the last
``cache_k`` symbols, the search starts at step ``cache_k``. On a CUDA
tensor a wrapper checks its inputs and launches its kernel on their card's
current stream, with that card the current device (or raises); the query lengths are read per thread, so no host sync
comes before the caller's copy of the result. On a CPU tensor it runs the
plain twin. Each wrapper counts its kernel launches in ``.launches``; a
batch of no queries launches nothing. Every output is an integer and equal
between the two, bit for bit.
"""

from __future__ import annotations

import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.lf import _device_of, _launch
from rust_msbwt_tpu_torch.ops.merge_insert import _check
from rust_msbwt_tpu_torch.ops.packed_rank import kmer_ranges_packed_plain
from rust_msbwt_tpu_torch.ops.pair_rank import LANES, kmer_counts_pair_plain
from rust_msbwt_tpu_torch.ops.rank import KmerCache

_I32 = torch.int32


def _batch(dev: torch.device, starts, n: int, kmers, lengths, cache, cache_k: int):
    """Check a batch's tensors on ``dev``; returns the cache arguments the
    kernel takes, ``(lo, hi, cache_k)``, or ``(None, None, 0)`` where the
    plain version seeds from no cache."""
    _check("starts", starts, _I32, (VC_LEN + 1,), dev)
    if kmers.dim() != 2:
        raise ValueError(f"kmers: expected [B, K], got {list(kmers.shape)}")
    B, K = kmers.shape
    _check("kmers", kmers, torch.uint8, (B, K), dev)
    _check("lengths", lengths, _I32, (B,), dev)
    if not 0 <= n < 2**31:
        raise ValueError(f"the BWT length {n} must fit int32")
    if cache is None or cache_k <= 0 or K < cache_k:
        return None, None, 0
    for name, t in (("cache.lo", cache.lo), ("cache.hi", cache.hi)):
        _check(name, t, _I32, (VC_LEN ** cache_k,), dev)
    return cache.lo, cache.hi, cache_k


def kmer_ranges_packed(table: torch.Tensor, starts: torch.Tensor, n: int,
                       kmers: torch.Tensor, lengths: torch.Tensor,
                       cache: KmerCache | None = None, cache_k: int = 0):
    """``kmer_ranges_packed_plain`` in one launch on CUDA tensors: int32
    ``(lo, hi)`` [B]. ``table`` int32 ``[nb + 1, 32]`` (16 B-aligned),
    ``starts`` int32 ``[7]``, ``kmers`` uint8 ``[B, K]`` right-aligned with
    symbols 0..5 (the callers check them), ``lengths`` int32 ``[B]``."""
    dev = _device_of(table)
    if dev is None:
        return kmer_ranges_packed_plain(table, starts, n, kmers, lengths, cache, cache_k)
    cache_lo, cache_hi, ck = _batch(dev, starts, n, kmers, lengths, cache, cache_k)
    B, K = kmers.shape
    out = torch.empty((2, B), dtype=_I32, device=dev)
    if B:
        _launch("msbwt_kmer_ranges_packed", table, starts, kmers, lengths, cache_lo, cache_hi,
                out[0], out[1], B, K, ck, n, dev=dev)
        kmer_ranges_packed.launches += 1
    return out[0], out[1]


def kmer_counts_pair(table2: torch.Tensor, starts: torch.Tensor, dflat: torch.Tensor,
                     n: int, kmers: torch.Tensor, lengths: torch.Tensor,
                     cache: KmerCache | None = None, cache_k: int = 0) -> torch.Tensor:
    """``kmer_counts_pair_plain`` in one launch on CUDA tensors: int32
    counts [B]. ``table2`` int32 ``[nb, 60]`` (16 B-aligned), ``dflat``
    int32 ``[36]``, the rest as ``kmer_ranges_packed``."""
    dev = _device_of(table2, LANES)
    if dev is None:
        return kmer_counts_pair_plain(table2, starts, dflat, n, kmers, lengths, cache, cache_k)
    cache_lo, cache_hi, ck = _batch(dev, starts, n, kmers, lengths, cache, cache_k)
    _check("dmat", dflat, _I32, (VC_LEN * VC_LEN,), dev)
    nb = table2.shape[0]
    if nb < 1:
        raise ValueError("kmer_counts_pair: the pair table has no row")
    B, K = kmers.shape
    out = torch.empty(B, dtype=_I32, device=dev)
    if B:
        _launch("msbwt_kmer_counts_pair", table2, starts, dflat, kmers, lengths, cache_lo,
                cache_hi, out, B, nb, K, ck, n, dev=dev)
        kmer_counts_pair.launches += 1
    return out


kmer_ranges_packed.launches = 0
kmer_counts_pair.launches = 0

QUERY_KERNELS = (kmer_ranges_packed, kmer_counts_pair)
