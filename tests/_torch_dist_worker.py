"""Multi-rank runner of the port's ``parallel/`` layer (imports no jax).

``run_ranks`` spawns ``world`` processes, one gloo rank each, on one device
(``cpu`` for the CPU tests; ``cuda:0`` shared by every rank on a card), and
every rank runs the named cases on the same inputs, collectively. Each rank
saves its results to ``<out_dir>/rank<r>.npz`` as ``<case>.<key>`` arrays;
``run_ranks`` returns them, one dict a rank, and raises if a rank failed or
did not finish within the timeout. Used by ``tests/test_torch_parallel.py``
and by ``chip_smoke.py`` (phase 11d).
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import time
import traceback

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parts(inputs):
    sizes = inputs["part_sizes"]
    return np.split(inputs["parts"], np.cumsum(sizes)[:-1]) if sizes.size else []


def _case(name, inputs, device):
    """One case on this rank: a dict of result arrays."""
    import torch

    from rust_msbwt_tpu_torch.parallel import mesh
    from rust_msbwt_tpu_torch.parallel.doubling_merge import sharded_doubling_merge
    from rust_msbwt_tpu_torch.parallel.multihost import (
        build_msbwt_multihost,
        process_read_slice,
    )
    from rust_msbwt_tpu_torch.parallel.partitioned import (
        build_partitioned,
        count_kmers_partitioned,
    )
    from rust_msbwt_tpu_torch.parallel.sharded_build import build_msbwt_sharded
    from rust_msbwt_tpu_torch.parallel.sharded_index import (
        build_sharded_index,
        count_kmers_sharded,
    )
    from rust_msbwt_tpu_torch.parallel.sharded_merge import sharded_hm_merge

    me, d = mesh.world()
    reads, lengths = inputs.get("reads"), inputs.get("lengths")
    kmers, klens = inputs.get("kmers"), inputs.get("klens")
    if name == "collectives":
        dev = torch.device(device)
        g = mesh.all_gather(torch.tensor([me, 10 * me], device=dev))
        s = mesh.all_reduce_sum(torch.tensor([me + 1], device=dev))
        # rank r sends j + 1 copies of r to rank j
        send = torch.cat([torch.full((j + 1,), me, device=dev) for j in range(d)])
        got = mesh.exchange(send, [j + 1 for j in range(d)], [me + 1] * d)
        parts = mesh.gather_parts(torch.arange(me, device=dev, dtype=torch.uint8))
        return {"gather": g.cpu().numpy(), "sum": s.cpu().numpy(),
                "exchange": got.cpu().numpy(),
                "parts": np.concatenate([p.cpu().numpy() for p in parts]),
                "any": np.array([mesh.any_across(torch.tensor([me == d - 1], device=dev)),
                                 mesh.any_across(torch.tensor([False], device=dev))])}
    if name.startswith("build_"):
        # build_tree[_wide|_pairwise], build_{dense,ragged}[_wide]
        words = name.split("_")[1:]
        merge = "tree" if words[0] == "tree" else "sharded"
        transport = "auto" if merge == "tree" else words[0]
        old = os.environ.get("MSBWT_TPU_MERGE")
        if "pairwise" in words:
            os.environ["MSBWT_TPU_MERGE"] = "tree"
        try:
            bwt = build_msbwt_sharded(reads, lengths, merge=merge, transport=transport,
                                      force_wide="wide" in words, device=device)
        finally:
            os.environ.pop("MSBWT_TPU_MERGE", None)
            if old is not None:
                os.environ["MSBWT_TPU_MERGE"] = old
        return {"bwt": bwt}
    if name.startswith("hm_"):
        transport, _, wide = name[3:].partition("_")
        return {"bwt": sharded_hm_merge(_parts(inputs)[:d], transport=transport,
                                        force_wide=wide == "wide", device=device)}
    if name.startswith("doubling"):
        bwt, src = sharded_doubling_merge(_parts(inputs), force_wide=name.endswith("wide"),
                                          return_sources=True, device=device)
        return {"bwt": bwt, "src": src}
    if name.startswith("sharded_index"):
        dec = inputs["decoded"]
        idx = build_sharded_index(dec, force_wide=name.endswith("wide"), device=device)
        return {"counts": count_kmers_sharded(idx, kmers, klens)}
    if name.startswith("partitioned"):
        idx = build_partitioned(reads, lengths, device=device)
        return {"counts": count_kmers_partitioned(idx, kmers, klens,
                                                  wide=True if name.endswith("wide") else None),
                "table": idx.table.cpu().numpy(), "size": np.array([idx.size])}
    if name == "multihost":
        sl = process_read_slice(reads.shape[0])
        return {"bwt": build_msbwt_multihost(reads[sl], lengths[sl], device=device)}
    raise ValueError(f"unknown case {name!r}")


def _rank_main(rank, world, port, device, cases, in_path, out_dir, timeout_s):
    sys.path.insert(0, _REPO)
    import torch

    torch.set_num_threads(1)
    from rust_msbwt_tpu_torch.parallel import mesh

    try:
        mesh.init_group(rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}",
                        device=device, backend="gloo", timeout_s=timeout_s)
        inputs = dict(np.load(in_path))
        out = {}
        for name in cases:
            for key, val in _case(name, inputs, device).items():
                out[f"{name}.{key}"] = np.asarray(val)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        mesh.shutdown()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def run_ranks(world: int, cases: list[str], inputs: dict, out_dir: str, *,
              device: str = "cpu", timeout_s: float = 240.0) -> list[dict]:
    """Run ``cases`` on ``world`` gloo ranks over ``device``; each rank's
    results, in rank order. Every rank has ``timeout_s`` for its
    rendezvous and each collective, and the whole run twice that."""
    in_path = os.path.join(out_dir, "inputs.npz")
    np.savez(in_path, **inputs)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device, cases, in_path, out_dir, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks exited with {codes} (None: killed at the timeout)")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]
