"""Checkpoints of derived state: index caches, query-index packs and sharded
BWTs (port of the JAX package's ``utils.checkpoint``; same files, same
array keys, so either package reads what the other wrote).

* ``save_index_cache`` / ``load_index_cache``: an ``OccIndex`` as one npz.
* ``save_query_pack`` / ``load_query_pack``: the derived QUERY indexes
  (packed table, pair index, prefix cache) as one npz, format
  ``rust_msbwt_tpu.query_pack.v1``; a query service restarts from disk
  instead of re-deriving them.
* ``save_sharded`` / ``load_manifest`` / ``load_shard`` / ``load_sharded``:
  one BWT split into per-shard ``comp_msbwt.npy`` files plus a manifest
  (host numpy).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.rle import bytes_from_runs, decode_symbols, runs_from_symbols
from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes, save_bwt_bytes

QUERY_PACK_FORMAT = "rust_msbwt_tpu.query_pack.v1"


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _up(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # own copy


def save_index_cache(index, path: str) -> None:
    """Persist an ``ops.rank.OccIndex`` (npz sidecar next to the npy)."""
    np.savez_compressed(path, bwt=_np(index.bwt), occ=_np(index.occ),
                        starts=_np(index.starts), n=np.int64(index.n))


def load_index_cache(path: str, *, device):
    """Load a ``save_index_cache`` file onto ``device``."""
    from rust_msbwt_tpu_torch.ops.rank import OccIndex

    with np.load(path) as z:
        return OccIndex(bwt=_up(z["bwt"], device), occ=_up(z["occ"], device),
                        starts=_up(z["starts"], device), n=int(z["n"]))


def save_query_pack(path: str, *, packed=None, pair=None, cache=None,
                    cache_k: int = 0) -> None:
    """Persist derived query indexes as one ``.npz``: any of ``packed``
    (``PackedOccIndex``), ``pair`` (``PairIndex``) and ``cache``
    (``KmerCache`` with its ``cache_k``). The pack carries the BWT length
    and C array, which ``RleBWT.load_query_indexes`` checks.

    >>> import tempfile
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.bcr import index_from_symbols
    >>> from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    >>> _, packed = index_from_symbols(torch.from_numpy(convert_stoi("TAC$GATCG$")))
    >>> with tempfile.TemporaryDirectory() as td:
    ...     p = os.path.join(td, "pack.npz")
    ...     save_query_pack(p, packed=packed)
    ...     packed2, pair, cache, ck = load_query_pack(p, device="cpu")
    >>> int(count_kmers_packed(packed2, convert_stoi("ACGT"))[0]), pair, cache, ck
    (1, None, None, 0)
    """
    if packed is None and pair is None:
        raise ValueError("save_query_pack needs at least packed= or pair=")
    src = packed if packed is not None else pair
    arrays = {
        "format": np.asarray(QUERY_PACK_FORMAT),
        "n": np.int64(src.n),
        "starts": _np(src.starts),
    }
    if packed is not None:
        arrays["packed_table"] = _np(packed.table)
    if pair is not None:
        if int(pair.n) != int(src.n):
            raise ValueError("packed/pair index n mismatch")
        arrays["pair_table2"] = _np(pair.table2)
        arrays["pair_dmat"] = _np(pair.dmat)
    if cache is not None:
        if cache_k <= 0:
            raise ValueError("cache= requires cache_k > 0")
        arrays["cache_lo"] = _np(cache.lo)
        arrays["cache_hi"] = _np(cache.hi)
        arrays["cache_k"] = np.int64(cache_k)
    # a file handle writes to the exact name given (np.savez on a str path
    # would append ".npz" to a name without it)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_query_pack(path: str, *, device):
    """Load a ``save_query_pack`` file onto ``device``: ``(packed, pair,
    cache, cache_k)``, each ``None`` / 0 when the pack lacks it. A pair table
    of the JAX package's legacy 128-lane row raises ``OSError``: the port
    reads the 60-lane row only."""
    from rust_msbwt_tpu_torch.ops.packed_rank import PackedOccIndex
    from rust_msbwt_tpu_torch.ops.pair_rank import LANES, PairIndex
    from rust_msbwt_tpu_torch.ops.rank import KmerCache

    with np.load(path) as z:
        if str(z["format"]) != QUERY_PACK_FORMAT:
            raise IOError(f"not a query pack: {path!r} ({z['format']})")
        n = int(z["n"])
        starts = _up(z["starts"], device)
        packed = pair = cache = None
        cache_k = 0
        if "packed_table" in z:
            packed = PackedOccIndex(table=_up(z["packed_table"], device), starts=starts, n=n)
        if "pair_table2" in z:
            table2 = z["pair_table2"]
            if table2.ndim != 2 or table2.shape[1] != LANES:
                raise IOError(f"query pack {path!r}: pair table rows of "
                              f"{table2.shape[-1]} lanes (the port reads the "
                              f"{LANES}-lane row only)")
            pair = PairIndex(table2=_up(table2, device), starts=starts,
                             dmat=_up(z["pair_dmat"], device), n=n)
        if "cache_lo" in z:
            cache = KmerCache(lo=_up(z["cache_lo"], device), hi=_up(z["cache_hi"], device))
            cache_k = int(z["cache_k"])
    return packed, pair, cache, cache_k


def save_sharded(decoded: np.ndarray, directory: str, n_shards: int) -> None:
    """Split a decoded BWT into ``n_shards`` contiguous slices, each a
    standalone ``comp_msbwt.npy``, plus ``manifest.json`` with boundaries
    and global symbol totals.

    >>> import tempfile
    >>> d = np.array([5, 0, 1, 2, 3, 4], np.uint8)
    >>> with tempfile.TemporaryDirectory() as td:
    ...     save_sharded(d, td, n_shards=2)
    ...     m = load_manifest(td)
    ...     ok = np.array_equal(load_sharded(td), d)
    >>> (m["n_shards"], m["total_size"], ok)
    (2, 6, True)
    """
    decoded = np.asarray(decoded, dtype=np.uint8)
    os.makedirs(directory, exist_ok=True)
    n = int(decoded.size)
    bounds = [round(i * n / n_shards) for i in range(n_shards + 1)]
    for d in range(n_shards):
        syms, counts = runs_from_symbols(decoded[bounds[d]: bounds[d + 1]])
        save_bwt_bytes(bytes_from_runs(syms, counts), _shard_path(directory, d))
    manifest = {
        "format": "rust_msbwt_tpu.sharded_bwt.v1",
        "n_shards": n_shards,
        "total_size": n,
        "boundaries": bounds,
        "symbol_counts": np.bincount(decoded, minlength=VC_LEN)[:VC_LEN].tolist(),
    }
    with open(os.path.join(directory, "manifest.json"), "w") as fp:
        json.dump(manifest, fp, indent=1)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as fp:
        return json.load(fp)


def load_shard(directory: str, shard: int) -> np.ndarray:
    """Decoded symbols of one shard."""
    return decode_symbols(load_bwt_bytes(_shard_path(directory, shard)))


def load_sharded(directory: str) -> np.ndarray:
    """Reassemble the full decoded BWT from a sharded checkpoint."""
    m = load_manifest(directory)
    parts = [load_shard(directory, d) for d in range(m["n_shards"])]
    out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if out.size != m["total_size"]:
        raise IOError(f"sharded checkpoint corrupt: {out.size} != {m['total_size']}")
    return out


def _shard_path(directory: str, d: int) -> str:
    return os.path.join(directory, f"shard_{d:05d}.npy")
