#!/usr/bin/env python3
"""Time the candidate forms of the port's two k-mer search kernels on one
NVIDIA card.

    python3 tools/query_forms.py [--parent DIR] [--reps 20]

Builds ``tools/query_forms.cu`` (the package's group kernels of
``csrc/query.cu``, whose groups step in lockstep, and their refill form,
whose persistent groups take a new query as soon as one is done, each at
one, two and four queries a group with their row loads through L1 or
allocating no L1 line, and the first form's one thread a query with lo's
and hi's shared row fetched once) three times, with every
launch bound at 1, 4 and 8 blocks an SM, into the git-ignored
``tools/_build/``, and prints each kernel's registers and spills. On
``chip_smoke.py``'s flagship index (5M x 100 bp, 505M symbols) it holds
every form against the package's kernel, exactly, on three batch sets:

* ``packed + 6^8``: 1M 21-mers through the packed tier (phase 10's leg);
* ``pair + 6^9``: the same through the pair tier;
* ``correction``: the pair batches of ``correct_reads(k=21, tau=2)`` on
  10,000 reads with one substitution each (phase 10's correction).

and times each set through each form, in turns (forward, then backward
over the forms, twice; the median of the four), beside the package's
kernel and, with ``--parent DIR`` (a ``git archive`` of the parent
commit), the parent's kernel from its own library. Then the ordering
step: each batch sorted by its reversed k-mer (3 bits a symbol, the last
symbol most significant), the key, sort and gathers timed apart from the
kept kernel's search of the sorted batch and the scatter of the results;
and the device's L2 fetch granularity hint at 32, 64 and 128 B under the
kept kernels (and the parent's). The card's name and power limit come
first; the last line is one JSON object of every number. Exits 2 without
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(HERE, "tools", "_build")
MIN_BLOCKS = (1, 4, 8)
# form codes of tools/query_forms.cu: 0 one thread a query, else 16 * kind
# + 2 * queries a group + (1 if the row loads go through L1)
KINDS = {1: "lockstep", 2: "refill"}
FORMS = {0: "thread", **{16 * kind + 2 * q + l1: f"{KINDS[kind]} q{q}{' L1' if l1 else ''}"
                         for kind in KINDS for q in (1, 2, 4) for l1 in (0, 1)}}
KERNEL_FORMS = {"kmer_ranges_packed": ("packed", 1), "kmer_counts_pair": ("pair", 1),
                "packed_refill": ("packed", 2), "pair_refill": ("pair", 2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def build() -> tuple[dict, dict]:
    """One library per launch bound, all compiled at once: ``({blocks:
    ctypes library}, {"<tier> <form>, <blocks> blocks": ptxas line})``."""
    from rust_msbwt_tpu_torch._kernels import _nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(HERE, "tools", "query_forms.cu")
    procs = {}
    for b in MIN_BLOCKS:
        so = os.path.join(BUILD_DIR, f"libquery_forms_{b}.so")
        procs[b] = (so, subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DFORMS_MIN_BLOCKS={b}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for b, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(kmer_ranges_packed|kmer_counts_pair|packed_refill|pair_refill)"
                          r"_kernelILi(\d)ELb(\d)E|(packed|pair)_thread_kernel", line)
            if "Compiling entry" not in line or not m:
                continue
            if m.group(1):
                tier, kind = KERNEL_FORMS[m.group(1)]
                form = FORMS[16 * kind + 2 * int(m.group(2)) + int(m.group(3))]
            else:
                tier, form = m.group(4), "thread"
            info = [x.split(":")[-1].strip() if "Used" in x else x.strip()
                    for x in lines[i + 1: i + 4] if "Used" in x or "spill" in x]
            regs[f"{tier} {form}, {b} blocks"] = "; ".join(info)
        lib = ctypes.CDLL(so)
        lib.forms_packed.restype = lib.forms_pair.restype = ctypes.c_int
        lib.forms_packed.argtypes = [i32] + [vp] * 8 + [i64, i32, i32, i32, vp]
        lib.forms_pair.argtypes = [i32] + [vp] * 8 + [i64, i64, i32, i32, i32, vp]
        lib.forms_l2_fetch.restype = ctypes.c_int
        lib.forms_l2_fetch.argtypes = [i32]
        libs[b] = lib
    for name, info in sorted(regs.items()):
        log(f"[build] {name}: {info}")
    return libs, regs


class _Form:
    """One form of ``lib`` under the C entry points' names, for
    ``chip_smoke.query_call``."""

    def __init__(self, lib, form: int):
        self.msbwt_kmer_ranges_packed = functools.partial(lib.forms_packed, form)
        self.msbwt_kmer_counts_pair = functools.partial(lib.forms_pair, form)


def batch_sets(torch, np, dev):
    """The flagship index's three batch sets as ``{name: (tier, [wrapper
    args, ...])}``, and the seconds they took to make."""
    from chip_smoke import K, N_QUERIES, capture, ecoli_config
    from profile_build import profile_correction
    from rust_msbwt_tpu_torch.ops import pair_rank
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
    from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache

    t0 = time.perf_counter()
    reads, lengths, kmers = ecoli_config(np)
    idx, packed = build_msbwt_with_index(reads, lengths, device=dev)
    pair = build_pair_index(idx)
    cache8 = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
    cache9 = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 9)
    del idx
    km = torch.tensor(kmers, device=dev)
    ln = torch.full((N_QUERIES,), K, dtype=torch.int32, device=dev)
    with capture(pair_rank, "_count_kmers_pair_impl", clone=False) as batches:
        profile_correction(np, reads, lambda k, n: count_kmers_pair(pair, k, n, cache=cache9,
                                                                    cache_k=9))
    sets = {"packed + 6^8": ("packed", [(packed.table, packed.starts, packed.n, km, ln,
                                          cache8, 8)]),
            "pair + 6^9": ("pair", [(pair.table2, pair.starts, pair.dmat, pair.n, km, ln,
                                     cache9, 9)]),
            "correction": ("pair", list(batches))}
    return sets, time.perf_counter() - t0


def in_turns(fns: dict, reps: int) -> dict:
    """Each of ``fns`` timed between CUDA events, forward then backward over
    them, twice: ``{name: [four ms]}``."""
    from chip_smoke import cuda_ms

    got = {name: [] for name in fns}
    order = list(fns)
    for name in (order + order[::-1]) * 2:
        got[name].append(cuda_ms(fns[name], reps))
    return got


def forms_of_set(torch, np, tier, batches, libs, parent, reps) -> dict:
    """Every form == the package's kernel on each batch, exactly; then the
    set through each form, in turns: ``{form: {"ms": [...], "median":
    ms}}``."""
    from chip_smoke import check, query_call
    from rust_msbwt_tpu_torch.ops import query

    package = query.kmer_ranges_packed if tier == "packed" else query.kmer_counts_pair
    calls = {"package": package}
    if parent is not None:
        calls["parent"] = query_call(parent, tier)
    for b, lib in libs.items():
        for form, name in FORMS.items():
            calls[f"{name}, {b} blocks"] = query_call(_Form(lib, form), tier)

    def outs(o):
        return list(o) if isinstance(o, tuple) else [o]

    for args in batches:
        want = outs(package(*args))
        for name, fn in calls.items():
            check(all(torch.equal(g, w) for g, w in zip(outs(fn(*args)), want)),
                  f"{tier} {name} != the package's kernel")
    fns = {name: (lambda fn=fn: [fn(*args) for args in batches]) for name, fn in calls.items()}
    return {name: {"ms": ts, "median": float(np.median(ts))}
            for name, ts in in_turns(fns, reps).items()}


def ordering(torch, np, tier, batches, reps) -> dict:
    """The ordering step on each batch of a set: the key (the reversed
    k-mer, 3 bits a symbol) and its sort, the gathers of the k-mers and
    lengths, the package's kernel on the sorted batch, the scatter of its
    results, all timed apart (summed over the set), and the unordered
    search in turns with the ordered one; the sorted results scattered
    back == the unordered ones."""
    from chip_smoke import check, cuda_ms
    from rust_msbwt_tpu_torch.ops import query

    package = query.kmer_ranges_packed if tier == "packed" else query.kmer_counts_pair
    at = 3 if tier == "packed" else 4  # the k-mers' place in the arguments

    def order(km):
        key = torch.zeros(km.shape[0], dtype=torch.int64, device=km.device)
        for c in range(km.shape[1] - 1, -1, -1):
            key = key * 8 + km[:, c]
        return torch.sort(key).indices

    res = {"sort_ms": 0.0, "gather_ms": 0.0, "search_sorted_ms": 0.0, "scatter_ms": 0.0}
    sorted_args = []
    for args in batches:
        km, ln = args[at], args[at + 1]
        res["sort_ms"] += cuda_ms(lambda: order(km), reps)
        perm = order(km)
        res["gather_ms"] += cuda_ms(lambda: (km[perm], ln[perm]), reps)
        sargs = (*args[:at], km[perm], ln[perm], *args[at + 2:])
        sorted_args.append(sargs)
        res["search_sorted_ms"] += cuda_ms(lambda: package(*sargs), reps)
        out = package(*sargs)
        out = out if tier == "pair" else out[1] - out[0]
        back = torch.empty_like(out)
        res["scatter_ms"] += cuda_ms(lambda: back.scatter_(0, perm, out), reps)
        back.scatter_(0, perm, out)
        want = package(*args)
        want = want if tier == "pair" else want[1] - want[0]
        check(torch.equal(back, want), f"{tier}: the ordered search != the unordered one")
    t = in_turns({"unordered": lambda: [package(*a) for a in batches],
                  "sorted batch": lambda: [package(*a) for a in sorted_args]}, reps)
    res.update(unordered_ms=float(np.median(t["unordered"])),
               sorted_search_ms=float(np.median(t["sorted batch"])))
    res["ordered_total_ms"] = (res["sort_ms"] + res["gather_ms"] + res["sorted_search_ms"]
                               + res["scatter_ms"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): its kernels too")
    ap.add_argument("--reps", type=int, default=20, help="launches a timing (default 20)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("query_forms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from chip_smoke import card_line, load_parent_kernels
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops import query

    smi = card_line()
    log(smi)
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    _kernels.load()
    libs, regs = build()
    parent = load_parent_kernels(args.parent)
    log(f"[setup] kernel libraries built in {time.perf_counter() - t0:.2f} s")
    sets, setup_s = batch_sets(torch, np, dev)
    log(f"[setup] flagship index, pair index, 6^8 and 6^9 caches, {len(sets['correction'][1])} "
        f"correction batches in {setup_s:.2f} s")
    result = {"card": smi, "registers": regs, "forms": {}, "ordering": {}, "l2_fetch": {}}
    for name, (tier, batches) in sets.items():
        res = forms_of_set(torch, np, tier, batches, libs, parent, args.reps)
        result["forms"][name] = res
        base = res["parent"]["median"] if parent is not None else res["package"]["median"]
        for form, r in sorted(res.items(), key=lambda kv: kv[1]["median"]):
            log(f"[{name}] {form}: " + " / ".join(f"{x:.4f}" for x in r["ms"])
                + f" ms (median {r['median']:.4f}; {'parent' if parent else 'package'} / this "
                f"{base / r['median']:.3f}); == the package's kernel")
    for name, (tier, batches) in sets.items():
        res = ordering(torch, np, tier, batches, args.reps)
        result["ordering"][name] = res
        log(f"[ordering] {name}: key + sort {res['sort_ms']:.4f} ms, gathers "
            f"{res['gather_ms']:.4f} ms, search of the sorted batch {res['sorted_search_ms']:.4f}"
            f" ms, scatter {res['scatter_ms']:.4f} ms: {res['ordered_total_ms']:.4f} ms ordered "
            f"against {res['unordered_ms']:.4f} ms unordered; equal results")
    lib = libs[MIN_BLOCKS[0]]
    default = lib.forms_l2_fetch(0)
    log(f"[l2 fetch] the device's hint: {default} B")
    try:
        for g in (32, 64, 128):
            check_g = lib.forms_l2_fetch(g)
            for name in ("packed + 6^8", "pair + 6^9"):
                tier, batches = sets[name]
                kernel = query.kmer_ranges_packed if tier == "packed" else query.kmer_counts_pair
                fns = {"package": lambda k=kernel, b=batches[0]: k(*b)}
                if parent is not None:
                    from chip_smoke import query_call

                    fns["parent"] = lambda f=query_call(parent, tier), b=batches[0]: f(*b)
                t = in_turns(fns, args.reps)
                result["l2_fetch"][f"{name}, {g} B"] = {k: float(np.median(v))
                                                        for k, v in t.items()}
                log(f"[l2 fetch] {g} B (read back {check_g}): {name}: "
                    + ", ".join(f"{k} {np.median(v):.4f} ms" for k, v in t.items()))
    finally:
        lib.forms_l2_fetch(default if default > 0 else 64)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
