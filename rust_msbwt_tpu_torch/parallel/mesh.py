"""Process-group helpers and the collectives of the multi-device layer.

Port of the JAX package's ``parallel.mesh``. The JAX layer runs one SPMD
program over a ``Mesh`` of devices (``shard_map``); PyTorch's idiom is one
process per device in a ``torch.distributed`` process group, so here a rank
is a process with one device, and every function of ``parallel/`` is called
by every rank of the default group with the same arguments. Without an
initialized group the layer runs as world size 1: one process, one device,
every collective the identity (the JAX package's ``default_mesh`` would
take all the local devices of the one process instead).

Backend: NCCL between cards, gloo on the CPU (``backend_for``); a caller
may pass ``backend="gloo"`` with ``cuda`` devices, for example to run
several ranks on one card, which NCCL refuses. The collectives the layer
uses, each on the default group:

* ``all_gather`` — the small count matrices (``[D, D]``, ``[D, 6]``,
  ``[D, ns, 6]``), PSRS samples, and the merged blocks at the end;
* ``all_reduce_sum`` / ``any_across`` — ``psum`` and the any-changed flag;
* ``exchange`` — the ragged all-to-all (``all_to_all_single`` with split
  lists). The JAX package needs ``ragged_all_to_all`` and a dense
  simulation of it on CPU meshes; its callers send each peer one chunk,
  consecutive, filling a prefix of the output, which is exactly what
  ``all_to_all_single`` does on NCCL and gloo alike.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600  # a lost rank fails its peers' collectives after this


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend_for(device) -> str:
    """NCCL for a ``cuda`` rank, gloo for a ``cpu`` one."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(*, rank: int, world_size: int, init_method: str, device="cuda",
               backend: str | None = None, local_rank: int = 0,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the default process group and return its backend. Under NCCL
    the rank takes card ``cuda:<local_rank>`` and raises when the machine
    has no such card: NCCL never shares a card between ranks. The timeout
    bounds the rendezvous and every collective."""
    backend = backend or backend_for(device)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise RuntimeError(
                f"rank {rank} has local rank {local_rank}, but this machine has "
                f"{cards} CUDA card(s): NCCL puts one rank on each card; start at "
                "most that many ranks a machine, or use backend='gloo'")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def shutdown() -> None:
    """Leave the default group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``[D, *t.shape]``: every rank's ``t``, in rank order."""
    _, d = world()
    if d == 1:
        return t.unsqueeze(0).clone()
    out = [torch.empty_like(t) for _ in range(d)]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor)."""
    t = t.clone()
    if world()[1] > 1:
        dist.all_reduce(t)
    return t


def any_across(flag: torch.Tensor) -> bool:
    """True if ``flag`` (a bool tensor) holds anywhere on any rank: the
    any-changed flag of a fixpoint loop (one host sync)."""
    return bool(all_reduce_sum(flag.any().to(torch.int32).reshape(1))[0] > 0)


def exchange(send: torch.Tensor, send_sizes: list[int], recv_sizes: list[int]) -> torch.Tensor:
    """The ragged all-to-all: ``send``'s consecutive chunks of
    ``send_sizes[i]`` elements go to rank i (what lies past them is not
    sent); returns the chunks sent here, concatenated in rank order
    (``recv_sizes[j]`` from rank j)."""
    total = sum(send_sizes)
    if world()[1] == 1:
        return send[:total].clone()
    out = torch.empty(sum(recv_sizes), dtype=send.dtype, device=send.device)
    dist.all_to_all_single(out, send[:total].contiguous(), recv_sizes, send_sizes)
    return out


def exchange_sizes(dest: torch.Tensor) -> tuple[list[int], list[int]]:
    """Split lists of an exchange whose elements go to ranks ``dest`` (sorted
    ascending; entries >= D are not sent): ``(send_sizes, recv_sizes)``, from
    one ``all_gather`` of the ``[D]`` send counts (one host sync)."""
    me, d = world()
    send = torch.bincount(dest[dest < d].long(), minlength=d)[:d]
    S = all_gather(send).tolist()  # [sender, dest]
    return S[me], [S[j][me] for j in range(d)]


def gather_parts(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's 1-D tensor ``t`` (lengths may differ), in rank order."""
    _, d = world()
    if d == 1:
        return [t]
    sizes = all_gather(torch.tensor([t.numel()], device=t.device)).view(-1).tolist()
    buf = torch.zeros(max(sizes), dtype=t.dtype, device=t.device)
    buf[: t.numel()] = t
    return [row[:s] for row, s in zip(all_gather(buf), sizes)]
