"""Data-parallel MSBWT construction over the ranks of a process group.

Port of the JAX package's ``parallel.sharded_build``. The reads are sorted
globally and cut into D contiguous groups; every rank builds the BWT of its
group on its own device with ``ops.bcr.build_msbwt`` (on a card, through the
merge-insert kernel), with no collective during the build. The partial BWTs
are then combined by the Holt–McMillan merge. Sorted construction is
order-independent and the merge is exact on rotation order, so the result
equals a single-device build.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.bcr import build_msbwt, sort_reads
from rust_msbwt_tpu_torch.parallel import mesh


def my_group(reads: np.ndarray, lengths: np.ndarray):
    """This rank's contiguous group of the globally sorted reads: group r
    holds sorted reads ``[r * Nl, (r + 1) * Nl)`` with ``Nl = ceil(N / D)``
    (later groups may be short or empty)."""
    me, d = mesh.world()
    reads, lengths = sort_reads(np.asarray(reads, dtype=np.uint8),
                                np.asarray(lengths, dtype=np.int32))
    nl = -(-reads.shape[0] // d)
    mine = slice(me * nl, (me + 1) * nl)
    return reads[mine], lengths[mine]


def build_msbwt_sharded(reads: np.ndarray, lengths: np.ndarray, merge: str = "tree",
                        force_wide: bool = False, transport: str = "auto", *,
                        device=None) -> np.ndarray:
    """Sorted MSBWT of a read collection, built data-parallel over the ranks;
    every rank passes the same reads and gets the whole BWT (host uint8).

    ``merge="tree"`` gathers the partial BWTs to every rank and merges them
    there (``ops.merge.kway_merge``); ``merge="sharded"`` runs the
    distributed D-way H-M merge (``parallel.sharded_merge``, ``transport``
    as there). Each partial build stays int32 (< 2^31 symbols a group); the
    merge goes int64 once the total passes 2^31 (``force_wide`` takes that
    path on small data).

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.bcr import encode_reads
    >>> reads, lens = encode_reads([convert_stoi("ACGT"), convert_stoi("TGCA")])
    >>> convert_itos(build_msbwt_sharded(reads, lens, device="cpu"))
    'TAC$GATCG$'
    """
    from rust_msbwt_tpu_torch.ops.merge import kway_merge
    from rust_msbwt_tpu_torch.parallel.sharded_merge import merge_parts

    if merge not in ("tree", "sharded"):
        raise ValueError(f"unknown merge {merge!r}")
    dev = torch.device("cuda" if device is None else device)
    if np.asarray(reads).shape[0] == 0:
        return np.zeros(0, dtype=np.uint8)
    g_reads, g_lengths = my_group(reads, lengths)
    part = build_msbwt(g_reads, g_lengths, device=dev, device_out=True)
    if merge == "sharded":
        merged = merge_parts(part, transport, force_wide)
    else:
        merged = kway_merge(mesh.gather_parts(part), force_wide)
    return merged.cpu().numpy()
