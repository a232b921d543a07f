"""Multi-process entry point: ``msbwt2-build --distributed`` on
``torch.distributed``.

Port of the JAX package's ``parallel.multihost``. One process per device
(NCCL between cards, gloo on the CPU), every rank in one process group:

* ingestion — each rank parses the inputs and keeps its contiguous stripe of
  the records (``process_read_slice``); nothing is exchanged on the host;
* build — each rank sorts its stripe and builds its partial BWT on its own
  device (on a card, through the merge-insert kernel). The Holt–McMillan
  merge is exact on rotation order whatever the read distribution, so no
  global read sort is needed: the distributed D-way merge
  (``parallel.sharded_merge``, ragged transport) gives the canonical MSBWT;
* output — every rank gets the merged BWT; rank 0 writes the npy.

Launch, one process per card (torchrun sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

  torchrun --nproc-per-node 4 -m rust_msbwt_tpu_torch.cli.build \\
      --distributed -o out.npy reads.fq.gz

or with the JAX package's variables, one process per host (``LOCAL_RANK``,
if set, picks the card; else card 0)::

  MSBWT_COORDINATOR=host0:8476 MSBWT_NUM_PROCS=2 MSBWT_PROC_ID=0 \\
      python -m rust_msbwt_tpu_torch.cli.build --distributed -o out.npy reads.fq.gz

Without either, ``--distributed`` runs as world size 1 (no process group).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from rust_msbwt_tpu_torch.parallel import mesh

logger = logging.getLogger("rust_msbwt_tpu_torch")


def init_distributed(device="cuda", backend: str | None = None,
                     timeout_s: float = mesh.DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group the environment describes (idempotent).

    Priority: the ``MSBWT_COORDINATOR`` / ``MSBWT_NUM_PROCS`` /
    ``MSBWT_PROC_ID`` triple (``tcp://`` rendezvous at the coordinator), then
    torchrun's ``RANK`` / ``WORLD_SIZE`` (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``). Returns True when a group is active, False when the
    environment names none (world size 1). The backend follows ``device``
    (``mesh.backend_for``) unless given; ``timeout_s`` bounds the
    rendezvous and every collective, so a lost rank fails its peers.
    """
    if torch.distributed.is_initialized():
        return True
    env = os.environ
    if env.get("MSBWT_COORDINATOR"):
        init_method = f"tcp://{env['MSBWT_COORDINATOR']}"
        rank, world = int(env["MSBWT_PROC_ID"]), int(env["MSBWT_NUM_PROCS"])
    elif "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return False
    used = mesh.init_group(rank=rank, world_size=world, init_method=init_method,
                           device=device, backend=backend,
                           local_rank=int(env.get("LOCAL_RANK", 0)), timeout_s=timeout_s)
    logger.info("torch.distributed: rank %d/%d over %s (%s)", rank, world, used, init_method)
    return True


def process_read_slice(n_records: int, process_id: int | None = None,
                       num_processes: int | None = None) -> slice:
    """Contiguous stripe of record indices owned by this rank.

    >>> process_read_slice(10, 1, 3)
    slice(4, 8, None)
    """
    me, d = mesh.world()
    pid = me if process_id is None else process_id
    nproc = d if num_processes is None else num_processes
    per = -(-n_records // nproc)
    return slice(pid * per, min((pid + 1) * per, n_records))


def build_msbwt_multihost(reads: np.ndarray, lengths: np.ndarray, *, device=None) -> np.ndarray:
    """MSBWT of every rank's read stripe, called by every rank with its own
    stripe (sliced with ``process_read_slice``): this rank's partial BWT is
    built on ``device`` (default ``cuda``) and the distributed D-way H-M
    merge combines the partials. Returns the whole decoded BWT (host uint8)
    on every rank."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt
    from rust_msbwt_tpu_torch.parallel.sharded_merge import merge_parts

    dev = torch.device("cuda" if device is None else device)
    part = build_msbwt(reads, lengths, device=dev, device_out=True)
    return merge_parts(part).cpu().numpy()


def build_from_fastx_distributed(filenames, sorted_strings: bool = True, *,
                                 device="cuda") -> tuple[np.ndarray, bool]:
    """The ``msbwt2-build --distributed`` flow: join the group, parse and
    keep this rank's record stripe, build and merge. Returns
    ``(decoded_bwt, is_rank_zero)``; every rank gets the BWT, and only rank
    0 should write it."""
    from rust_msbwt_tpu_torch.models.dynamic import _fastx_records
    from rust_msbwt_tpu_torch.ops.bcr import encode_reads
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert

    init_distributed(device)
    if not sorted_strings:
        raise ValueError(
            "--distributed implies lexicographic (sorted) construction: the "
            "distributed merge canonicalizes order (chronological order is "
            "not preserved across processes)")
    seqs: list = []
    for filename in filenames:
        seqs.extend(_fastx_records(filename))
    me, d = mesh.world()
    sl = process_read_slice(len(seqs))
    logger.info("rank %d/%d: records [%d, %d) of %d", me, d, sl.start, sl.stop, len(seqs))
    reads, lengths = encode_reads(seqs[sl])
    launches = merge_insert.launches
    decoded = build_msbwt_multihost(reads, lengths, device=device)
    logger.info("rank %d/%d: %d symbols merged on %s; merge kernel launches %d", me, d,
                decoded.size, device, merge_insert.launches - launches)
    return decoded, me == 0
