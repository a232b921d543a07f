#!/usr/bin/env python3
"""Time the candidate forms of the port's two LF-step kernels on one NVIDIA
card.

    python3 tools/walk_forms.py [--parent DIR] [--reps 10]

Builds ``tools/walk_forms.cu`` (the package's ``csrc/lf.cu`` included
whole, and the forms tried beside its kernels: one thread a walker with the
symbol taken from the row, for every walk; two walkers a quad for the
terminator, extract and locate walks; a quad a walker for the locate walk
and, on the row, for the read-length walk, where the package writes and
chases an LF array; the read-length walk's first LF pass and one or four
walkers a chase thread; the locate walk with the symbol from the planes
through a short decode, where the package reads the BWT; a quad a read
and two or four reads a thread for ``lf_stage``) into the git-ignored
``tools/_build/``, and prints every kernel's registers and spills. It makes the walks' and
columns' inputs at the shapes of ``chip_smoke.py``'s paths:

* ``terminator 404M``: the cyclic search of the last 1M flagship reads
  (sorted) on the BWT of the first 4M (404M symbols; phase 8);
* ``lengths 505M`` and ``lengths 404M``: the read lengths of the flagship
  index (5M walkers, phase 9) and of that base (4M, phase 8's load);
* ``extract 505M``, ``locate 505M``: 100k reads extracted and 1,000 21-mers
  located on the flagship index (phase 9);
* ``terminator long``, ``lengths long``: the cyclic search of 100k long
  reads (1,000 bp, sorted) on the BWT of 400k of them (400.4M symbols) and
  that base's read lengths (phase 12c);
* ``lf_stage`` at column 90 of the 505M loop and column 1,000 of the 500.5M
  long-read loop at radix 1 (phases 6b and 12a);
* ``lengths 1515M``, ``lf_stage 1515M column 90``: the read lengths of the
  1.515G build of phase 12e (15M walkers) and its column 90.

Every form is held against the package's kernel, exactly, and, with
``--parent DIR`` (a ``git archive`` of the parent commit), so is the
parent's kernel, called through the parent's own ``ops/lf.py`` and library
(``chip_smoke.load_parent_lf``); each shape is timed through every form in
turns (forward, then backward over the forms, twice; the median of the
four), between CUDA events, and once under ``torch.profiler``: each form's
device time a call (its kernels, copies and fills) beside the event time,
so that a shape whose event time is the host's dispatch shows its kernels'
own time. Then the device time of each kernel of the package's read-length
walk (the LF pass, the chase, the copy out), and ``lf_stage``'s split at
each column (``chip_smoke.stage_split``: the event time a call beside the
kernel's own device duration, the package's and the parent's) and the
host's time a call of each wrapper (200 calls issued, then one sync). The card's name and
power limit come first; the last line is one JSON object of every number.
Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(HERE, "tools", "_build")
LIB = os.path.join(BUILD_DIR, "libwalk_forms.so")
# form codes of tools/walk_forms.cu
FORMS = {"cyclic": {"thread": 0, "quad2": 2},
         "lengths": {"thread": 0, "quad": 1, "pass1": 11, "pass2": 12, "scan1": 21,
                     "scan4": 24},
         "extract": {"thread": 0, "quad2": 2},
         "locate": {"thread": 0, "quad": 1, "quad2": 2, "row": 3},
         "stage": {"quad": 1, "reads2": 2, "reads4": 4}}


def log(msg: str) -> None:
    print(msg, flush=True)


def build() -> tuple:
    """The forms' library and ``{kernel: ptxas line}``."""
    from rust_msbwt_tpu_torch._kernels import _nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    res = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", LIB,
         os.path.join(HERE, "tools", "walk_forms.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n{res.stdout}")
    lines = res.stdout.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"_Z\w*?(\d+)([a-z][a-z0-9_]*?_kernel)(ILi(\d)E)?", line)
        if "Compiling entry" in line and m:
            name = m.group(2) + (f"<{m.group(4)}>" if m.group(4) else "")
            regs[name] = "; ".join(x.split(":")[-1].strip() if "Used" in x else x.strip()
                                   for x in lines[i + 1: i + 4] if "Used" in x or "spill" in x)
    lib = ctypes.CDLL(LIB)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, args in (("forms_walk_cyclic", [i32] + [vp] * 6 + [i64, i64, i32, vp]),
                       ("forms_walk_lengths", [i32] + [vp] * 5 + [i64, i64, vp]),
                       ("forms_walk_extract", [i32] + [vp] * 5 + [i64, i32, vp]),
                       ("forms_walk_locate", [i32] + [vp] * 6 + [i64, i64, i32, vp]),
                       ("forms_lf_stage", [i32] + [vp] * 12 + [i64, i32, i32, vp])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args
    for name, info in sorted(regs.items()):
        log(f"[build] {name}: {info}")
    return lib, regs


def form_call(lib, walk: str, form: int):
    """A function of the package wrapper's arguments (``lf_walk_<walk>``, or
    ``lf_stage``) that runs form ``form`` of the tool's library and returns
    the wrapper's outputs."""
    import torch

    from chip_smoke import check

    def launch(fn, *args, dev):
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = getattr(lib, fn)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{fn} launch: CUDA error {err}")

    def run(*args):
        if walk == "stage":
            j, tab, nst, cols, lengths, P, counts, prev_v = args
            N, dev = P.shape[0], tab.device
            q, P_out = (torch.empty(N, dtype=torch.int32, device=dev) for _ in range(2))
            flags = torch.empty((2, N), dtype=torch.uint8, device=dev)
            counts_out = torch.empty(6, dtype=torch.int32, device=dev)
            scratch = torch.zeros(8, dtype=torch.int32, device=dev)
            launch("forms_lf_stage", form, tab, cols[j], lengths, P, prev_v, counts, q, flags[0],
                   P_out, flags[1], counts_out, scratch, N, j, nst, dev=dev)
            return q, cols[j], flags[0].view(torch.bool), P_out, counts_out, flags[1]
        if walk == "cyclic":
            table, starts, n, cols, lengths, steps, n_steps = args
            pos = torch.empty(lengths.shape[0], dtype=torch.int32, device=table.device)
            launch("forms_walk_cyclic", form, table, starts, cols, lengths, steps, pos,
                   lengths.shape[0], n, n_steps, dev=table.device)
            return pos
        bwt, table, starts = args[:3]
        dev = table.device
        if walk == "lengths":
            n, n_strings = args[3:]
            out = torch.empty(n_strings + 1, dtype=torch.int32, device=dev)
            lf = torch.empty(-(-n // 128) * 128 if form >= 10 else 0, dtype=torch.int32,
                             device=dev)
            launch("forms_walk_lengths", form, table, starts, lf, out, out[n_strings:], n_strings,
                   n, dev=dev)
            out = out.cpu().numpy()
            check(out[-1] == 0, "a read-length walk did not close")
            return out[:-1]
        if walk == "extract":
            ids, l_max = args[3:]
            out = torch.zeros((ids.shape[0], l_max), dtype=torch.uint8, device=dev)
            done = torch.empty(ids.shape[0], dtype=torch.bool, device=dev)
            launch("forms_walk_extract", form, table, starts, ids, out, done, ids.shape[0],
                   l_max, dev=dev)
            return out, done
        pos, n_strings, l_max = args[3:]
        rid, off = (torch.empty(pos.shape[0], dtype=torch.int32, device=dev) for _ in range(2))
        launch("forms_walk_locate", form, table, starts, bwt, pos, rid, off, pos.shape[0],
               n_strings, l_max, dev=dev)
        return rid, off

    return run


def shapes(torch, np, dev) -> tuple:
    """The walks' and columns' inputs: ``({name: (walk, args)}, seconds)``."""
    from chip_smoke import (BATCH, BIG_READS, LF_COL, LONG_BASE, LONG_LEN, LONG_READS,
                            N_EXTRACT, N_LOCATE, N_READS, READ_LEN, capture, ecoli_config,
                            genome_reads, radix_env)
    from rust_msbwt_tpu_torch.ops import bcr, extract
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert
    from rust_msbwt_tpu_torch.utils.native import sort_rows_native

    t0 = time.perf_counter()
    out = {}
    reads, lengths, kmers = ecoli_config(np)
    with capture(bcr, "lf_stage", keep=lambda j, *a: j == LF_COL) as st:
        idx, packed = bcr.build_msbwt_with_index(reads, lengths, device=dev)
    out["lf_stage 505M column 90"] = ("stage", st[0])
    out["lengths 505M"] = ("lengths", (idx.bwt, packed.table, packed.starts, packed.n, N_READS))
    ids = np.random.default_rng(0x1D5).integers(0, N_READS, N_EXTRACT)
    with capture(extract, "lf_walk_extract") as ex:
        extract.extract_reads(idx, ids, N_READS, l_max=READ_LEN, packed=packed)
    with capture(extract, "lf_walk_locate") as loc:
        extract.locate_kmers(idx, kmers[:N_LOCATE], N_READS, l_max=READ_LEN, packed=packed)
    out["extract 505M"], out["locate 505M"] = ("extract", ex[0]), ("locate", loc[0])
    del idx, packed
    base = N_READS - BATCH
    bidx, bpacked = bcr.build_msbwt_with_index(reads[:base], lengths[:base], device=dev)
    out["lengths 404M"] = ("lengths", (bidx.bwt, bpacked.table, bpacked.starts, bpacked.n, base))
    order = sort_rows_native(reads[base:])
    with capture(bcr, "lf_walk_cyclic") as cyc:
        bcr.terminator_positions(bidx, reads[base:][order], lengths[base:][order], READ_LEN + 1,
                                 bpacked)
    out["terminator 404M"] = ("cyclic", cyc[0])
    del bidx, bpacked, reads, lengths, kmers
    reads, lengths = genome_reads(np, LONG_READS, LONG_LEN, 0x10C6)
    p = bcr._prepare_build(reads, lengths, True)
    with radix_env(1), capture(bcr, "lf_stage", keep=lambda j, *a: j == LONG_LEN) as st:
        bcr._build_device(p, dev, merge_insert)
    del p
    out[f"lf_stage long column {LONG_LEN}"] = ("stage", st[0])
    lidx, lpacked = bcr.build_msbwt_with_index(reads[:LONG_BASE], lengths[:LONG_BASE],
                                               device=dev)
    out["lengths long"] = ("lengths", (lidx.bwt, lpacked.table, lpacked.starts, lpacked.n,
                                       LONG_BASE))
    order = sort_rows_native(reads[LONG_BASE:])
    with capture(bcr, "lf_walk_cyclic") as cyc:
        bcr.terminator_positions(lidx, reads[LONG_BASE:][order], lengths[LONG_BASE:][order],
                                 LONG_LEN + 1, lpacked)
    out["terminator long"] = ("cyclic", cyc[0])
    del lidx, lpacked, reads, lengths
    reads, lengths = genome_reads(np, BIG_READS, READ_LEN, 0x1515)
    with capture(bcr, "lf_stage", keep=lambda j, *a: j == LF_COL) as st:
        gidx, gpacked = bcr.build_msbwt_with_index(reads, lengths, device=dev)
    out["lf_stage 1515M column 90"] = ("stage", st[0])
    out["lengths 1515M"] = ("lengths", (gidx.bwt, gpacked.table, gpacked.starts, gpacked.n,
                                        BIG_READS))
    torch.cuda.empty_cache()
    return out, time.perf_counter() - t0


def kernel_ms(torch, fn, reps: int) -> dict:
    """``{kernel name: device ms a call}`` of ``reps`` calls of ``fn`` under
    ``torch.profiler``."""
    from rust_msbwt_tpu_torch.utils.profiling import device_us, trace

    with tempfile.TemporaryDirectory() as d, trace(d) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: device_us(e) / reps * 1e-3 for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0}


def dispatch_parts(torch, args, parent) -> dict:
    """The host's microseconds a call of ``lf_stage``'s wrapper (this
    commit's and the parent's) and of its parts on ``args``: the checks, the
    outputs' allocation (one carved, or the parent's four), the library's
    lookup, the stream's handle, and the ctypes launch alone on ready
    pointers; each 2,000 times back to back, then one sync."""
    from chip_smoke import uncounted
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops import lf
    from rust_msbwt_tpu_torch.ops.merge_insert import _check

    j, tab, nst, cols, lengths, P, counts, prev_v = args
    N, dev = P.shape[0], tab.device
    i32, u8 = torch.int32, torch.uint8
    q, P_out = (torch.empty(N, dtype=i32, device=dev) for _ in range(2))
    flags = torch.empty((2, N), dtype=u8, device=dev)
    c_out = torch.empty(6, dtype=i32, device=dev)
    lib = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = lf.stage_scratch(dev)
    ptrs = [t.data_ptr() for t in (tab, cols[j], lengths, P, prev_v, counts, q, flags[0],
                                   P_out, flags[1], c_out, scratch)]

    def checks():
        lf._device_of(tab)
        _check("cols", cols, u8, (cols.shape[0], N), dev)
        _check("lengths", lengths, i32, (N,), dev)
        _check("P", P, i32, (N,), dev)
        _check("prev_v", prev_v, u8, (N,), dev)
        _check("counts", counts, i32, (6,), dev)

    def carve():
        words, fl = torch.empty(10 * N + 24, dtype=u8, device=dev).split((8 * N + 24, 2 * N))
        words.view(i32).split((N, N, 6))
        return fl[:N].view(torch.bool), fl[N:]

    fns = {"package wrapper": lambda: lf.lf_stage(*args, scratch=scratch), "checks": checks,
           "carved allocation": carve,
           "two allocations": lambda: (torch.empty(2 * N + 6, dtype=i32, device=dev).split(
               (N, N, 6)), torch.empty((2, N), dtype=u8, device=dev).unbind()),
           "four allocations": lambda: [torch.empty(N, dtype=i32, device=dev),
                                        torch.empty(N, dtype=i32, device=dev),
                                        torch.empty((2, N), dtype=u8, device=dev),
                                        torch.empty(6, dtype=i32, device=dev)],
           "library lookup": lambda: getattr(_kernels.load(), "msbwt_lf_stage"),
           "stream handle": lambda: torch.cuda.current_stream(dev).cuda_stream,
           "ctypes launch": lambda: lib.msbwt_lf_stage(*ptrs, N, j, nst, stream)}
    if parent is not None:
        fns["parent wrapper"] = lambda: parent(*args)
    out = {}
    with uncounted():
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            out[name] = (time.perf_counter() - t0) / 2000 * 1e6
            torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit (git archive): its kernels too")
    ap.add_argument("--reps", type=int, default=10, help="calls a timing (default 10)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("walk_forms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import numpy as np

    import chip_smoke
    from chip_smoke import card_line, check, load_parent_kernels, load_parent_lf, stage_split
    from query_forms import in_turns
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops import lf

    smi = card_line()
    log(smi)
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    log(_kernels.build().strip() or "(package library up to date)")
    _kernels.load()
    lib, regs = build()
    parent_lib = load_parent_kernels(args.parent)
    chip_smoke.PARENT_LF = parent = load_parent_lf(args.parent, parent_lib)
    log(f"[setup] kernel libraries built in {time.perf_counter() - t0:.2f} s")
    cases, setup_s = shapes(torch, np, dev)
    log(f"[setup] {len(cases)} shapes in {setup_s:.2f} s")
    result = {"card": smi, "registers": regs, "forms": {}, "split": {}}

    def outs(o):
        return [torch.as_tensor(t) for t in (o if isinstance(o, tuple) else (o,))]

    for name, (walk, wargs) in cases.items():
        wrapper = lf.lf_stage if walk == "stage" else getattr(lf, f"lf_walk_{walk}")
        calls = {"package": wrapper}
        if parent is not None:
            calls["parent"] = getattr(parent, wrapper.__name__)
        for form, code in FORMS[walk].items():
            calls[form] = form_call(lib, walk, code)
        want = outs(wrapper(*wargs))
        for who, fn in calls.items():
            got = outs(fn(*wargs))
            check(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: {who} != the package's kernel")
        t = in_turns({who: (lambda fn=fn: fn(*wargs)) for who, fn in calls.items()}, args.reps)
        res = {who: {"ms": ts, "median": float(np.median(ts)),
                     "device": kernel_ms(torch, lambda fn=calls[who]: fn(*wargs), args.reps)}
               for who, ts in t.items()}
        for r in res.values():
            r["device_ms"] = sum(r["device"].values())
            r["kernels_ms"] = sum(v for k, v in r["device"].items() if "Memcpy" not in k)
        result["forms"][name] = res
        base = res["parent"]["median"] if parent is not None else res["package"]["median"]
        for who, r in sorted(res.items(), key=lambda kv: kv[1]["median"]):
            log(f"[{name}] {who}: " + " / ".join(f"{x:.4f}" for x in r["ms"])
                + f" ms (median {r['median']:.4f}; {'parent' if parent else 'package'} / this "
                f"{base / r['median']:.3f}; device {r['device_ms']:.4f} ms a call, kernels "
                f"{r['kernels_ms']:.4f}); == the package's kernel")
        if walk == "lengths":
            split = kernel_ms(torch, lambda: wrapper(*wargs), args.reps)
            result["split"][name] = split
            log(f"[{name}] the package's kernels (profiler): "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        if walk == "stage":
            result["split"][name] = stage_split(torch, name, wargs)
            parts = dispatch_parts(torch, wargs, calls.get("parent"))
            result["split"][name]["host_us"] = parts
            log(f"[{name}] the host's time a call (2,000 calls issued, then one sync): "
                + ", ".join(f"{k} {v:.2f} us" for k, v in parts.items()))
    del cases
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
