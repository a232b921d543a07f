#!/usr/bin/env python3
"""Time the candidate forms of the port's radix-2 column pair (``lf_pair``)
on one NVIDIA card.

    python3 tools/pair_forms.py [--parent DIR] [--reps 20]

Builds ``tools/pair_forms.cu`` (the package's ``csrc/lf.cu`` included whole,
and the forms tried beside its kernels: ``pair_first`` at launch bounds of
64 and 32 registers, ``pair_rank1`` with and without its two candidate rows
loaded before the compare loop at several launch bounds, the tile scans at
the end of the counting kernels or as kernels of their own, and
``pair_rank1`` with a quad a slot) into the git-ignored ``tools/_build/``,
and prints every kernel's registers and spills. It makes the inputs of the
last column pair of the radix-2 stage loop on the read sets of
``profile_build.py``'s radix sweep (~500M symbols at L = 250, 500 and
1,000: 2M, 1M and 500k reads from the flagship genome; ``profile_build.
last_pair``), then on each: the package's ``lf_pair`` == ``lf_pair_plain``,
every form == the package's, exactly, and, with ``--parent DIR`` (a ``git
archive`` of the parent commit), so is the parent's radix-2 step through its
own ``ops/lf.py`` and library (``chip_smoke.load_parent_step2``). Each
shape is timed through every form in turns (forward, then backward over the
forms, twice; the median of the four event times a call, between CUDA
events), and once under ``torch.profiler``: each form's device time a call
by kernel (``chip_smoke.pair_split``). The card's name and power limit come
first; the last line is one JSON object of every number. Exits 2 without a
CUDA card.
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
LIB = os.path.join(BUILD_DIR, "libpair_forms.so")
# form codes of tools/pair_forms.cu: pair_first's launch bound (blocks an SM),
# pair_rank1's row prefetch ("rows-first") and launch bound, the tile scans at
# the counting kernels' end ("tail scans") or as kernels of their own ("scan
# kernels"), or pair_rank1's quad a slot
FORMS = {"package": 0, "rows-first": 1, "first4": 2, "first8": 3, "rank1 unbound": 4,
         "rank6": 5, "tail scans": 6, "scan kernels": 7, "quad": 11, "quad4": 14,
         "quad8": 18}


def log(msg: str) -> None:
    print(msg, flush=True)


def build() -> tuple:
    """The forms' library and ``{kernel: ptxas line}``."""
    from rust_msbwt_tpu_torch._kernels import _nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    res = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", LIB,
         os.path.join(HERE, "tools", "pair_forms.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n{res.stdout}")
    lines = res.stdout.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"_Z\w*?\d+((?:pair|forms)_\w*?_kernel)(I\w*?E)?E", line)
        if "Compiling entry" in line and m:
            name = m.group(1) + (m.group(2) or "")
            regs[name] = "; ".join(x.split(":")[-1].strip() if "Used" in x else x.strip()
                                   for x in lines[i + 1: i + 4] if "Used" in x or "spill" in x)
    lib = ctypes.CDLL(LIB)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.forms_lf_pair.restype = ctypes.c_int
    lib.forms_lf_pair.argtypes = [i32] + [vp] * 14 + [i64, i64, i32, i32, vp]
    lib.msbwt_lf_pair_work_len.restype = i64
    lib.msbwt_lf_pair_work_len.argtypes = [i64, i64]
    for name, info in sorted(regs.items()):
        log(f"[build] {name}: {info}")
    return lib, regs


def form_call(lib, form: int):
    """A function of ``lf_pair``'s arguments that runs form ``form`` of the
    tool's library (on a scratch of its own) and returns ``lf_pair``'s
    outputs."""
    import torch

    from chip_smoke import check

    def run(j, tab, cap, nst, cols, lengths, P, counts, prev_v):
        N, dev = P.shape[0], tab.device
        work = torch.empty(lib.msbwt_lf_pair_work_len(N, cap), dtype=torch.int32, device=dev)
        q = torch.empty(2 * N, dtype=torch.int32, device=dev)
        active = torch.empty(2 * N, dtype=torch.bool, device=dev)
        P_out = torch.empty(N, dtype=torch.int32, device=dev)
        prev_out = torch.empty(N, dtype=torch.uint8, device=dev)
        counts_out = torch.empty(6, dtype=torch.int32, device=dev)
        args = [tab, cols[j], cols[j + 1], lengths, P, prev_v, counts, q, active, P_out,
                prev_out, counts_out, run.scratch, work]
        err = lib.forms_lf_pair(form, *[a.data_ptr() for a in args], N, cap, j, nst,
                                torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"form {form} launch: CUDA error {err}")
        return q, cols[j: j + 2].view(-1), active, P_out, counts_out, prev_out

    run.scratch = None
    return run


def shapes(torch, np, dev) -> dict:
    """``{name: lf_pair args}``: the last column pair of each one-shot sweep
    set."""
    from chip_smoke import genome_reads
    from profile_build import SWEEP, last_pair
    from rust_msbwt_tpu_torch.ops.bcr import _prepare_build

    out = {}
    for L, n_reads in [(L, n) for L, n, n_base in SWEEP if not n_base]:
        t0 = time.perf_counter()
        reads, lengths = genome_reads(np, n_reads, L, 0x5EED + L)
        p = _prepare_build(reads, lengths, True)
        del reads, lengths
        args = last_pair(torch, dev, p, L)
        del p
        out[f"L={L} ({n_reads} reads), columns {args[0]} and {args[0] + 1}"] = args
        log(f"[shape] L={L}: inputs of columns {args[0]}-{args[0] + 1} kept in "
            f"{time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): its radix-2 step "
                         "is held and timed beside the forms")
    ap.add_argument("--reps", type=int, default=20, help="calls a timing (default 20)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("pair_forms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke
    from chip_smoke import card_line, check, cuda_ms, loop_pair, pair_split
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops import lf

    smi = card_line()
    log(smi)
    dev = torch.device("cuda:0")
    _kernels.load()
    t0 = time.perf_counter()
    lib, regs = build()
    log(f"[build] forms built in {time.perf_counter() - t0:.1f} s")
    fns = {name: form_call(lib, code) for name, code in FORMS.items()}
    for fn in fns.values():
        fn.scratch = lf.stage_scratch(dev)
    if args.parent:
        parent_lib = chip_smoke.load_parent_kernels(args.parent)
        step2 = chip_smoke.load_parent_step2(
            args.parent, chip_smoke.load_parent_lf(args.parent, parent_lib))
        fns["parent"] = functools.partial(step2, scratch=lf.stage_scratch(dev))
    result = {"card": smi, "registers": regs, "shapes": {}}
    for name, a in shapes(torch, np, dev).items():
        want = loop_pair(dev)(*a)
        plain = lf.lf_pair_plain(*a)
        check(all(torch.equal(g, w) for g, w in zip(want, plain)),
              f"{name}: the package's lf_pair != lf_pair_plain")
        for form, fn in fns.items():
            got = fn(*a)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: form {form} != the package's lf_pair")
        torch.cuda.synchronize()
        order = list(fns)
        times = {form: [] for form in order}
        for rnd in range(4):
            for form in (order if rnd % 2 == 0 else order[::-1]):
                times[form].append(cuda_ms(lambda fn=fns[form]: fn(*a), args.reps))
        res = {}
        for form in order:
            split = pair_split(torch, f"{name}, {form}", fns[form], a, args.reps)
            ms = sorted(times[form])
            res[form] = {"event_ms": (ms[1] + ms[2]) / 2, "event_turns": times[form],
                         "device_ms": split["device_ms"], "events": split["events"],
                         "kernels": split["kernels"]}
        base = res["package"]["device_ms"]
        for form in order:
            r = res[form]
            log(f"[forms] {name}, {form}: event {r['event_ms']:.4f} ms (turns "
                + " / ".join(f"{t:.4f}" for t in r["event_turns"])
                + f"), device {r['device_ms']:.4f} ms in {r['events']:.1f} events "
                f"(package / form {base / r['device_ms']:.3f})")
        result["shapes"][name] = res
        del a, want, plain
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
