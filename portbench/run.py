"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic mix and metrics are files under ``portbench/``
found by their names (see ``portbench/__init__.py``). One run:

1. set-up (``setup_s``, from this module's start): the traffic
   generator's session draws the inputs from ``--seed``, builds what the
   mix keeps on the card and runs one warm-up op of the window's shapes;
2. the window: ops back to back for ``--seconds`` (the op that crosses the
   end completes); with ``--trace 1`` under ``torch.profiler``;
3. the end-to-end metrics (``--trace 0``) or the per-layer ones
   (``--trace 1``), each read by its own file;
4. the check: the program's state is freed and the checked ops' outputs
   are compared with the plain reference (``portbench.check``).

The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, are the last lines of standard error.
Exit codes: 0 a result was printed; 2 no card (or fewer than the cell
asks for) or no port in the checkout; 3 JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "rust_msbwt_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_msbwt_tpu")


class ForbiddenImport(RuntimeError):
    pass


def load_file(path: str, name: str):
    """Import the module at ``path`` under ``name`` (a file of a name with
    dots or dashes is no package member)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    generator: object
    end_to_end: list   # [(BENCHMARK.json entry, module)]
    per_layer: list


def find_cell(name: str, bench: str | None = None, root: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` beside this
    package by default), with its files from ``root``: ``configs/<config>
    .json``, ``traffic/<traffic>.json`` and the generator it names,
    ``endtoend/<metric>.py`` and ``metrics/<metric>.py`` for the metrics
    that apply to the cell."""
    b = _json(bench or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config = _json(os.path.join(root, "configs", f"{w['config']}.json"))
    mix = _json(os.path.join(root, "traffic", f"{w['traffic']}.json"))
    gen = load_file(os.path.join(root, "traffic", f"{mix['generator']}.py"),
                    f"portbench_traffic_{mix['generator']}")

    def metrics(kind: str) -> list:
        out = []
        for m in b[kind]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            sub = "endtoend" if kind == "end_to_end" else "metrics"
            out.append((m, load_file(os.path.join(root, sub, f"{m['name']}.py"),
                                     f"portbench_{sub}_{m['name'].replace('.', '_')}")))
        return out

    return Cell(name, int(w["chips"]), config, mix, gen, metrics("end_to_end"),
                metrics("per_layer"))


@dataclass
class Window:
    start: float
    ops: list
    setup_s: float
    peak_bytes: int


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _counters(refs: dict) -> dict:
    out = {}
    for key, ref in refs.items():
        mod, fn = ref.split(":")
        out[key] = getattr(importlib.import_module(mod), fn).launches
    return out


def _power_limit_w() -> float | None:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(res.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _quantiles(x) -> str:
    import numpy as np

    if not len(x):
        return "none"
    q = np.percentile(x, [0, 5, 25, 50, 75, 95, 99, 100])
    return " ".join(f"{n} {v:.3f}" for n, v in zip(
        ("min", "p5", "p25", "p50", "p75", "p95", "p99", "max"), q))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
             control: bool = False, t_start: float = T_START) -> tuple[dict, list]:
    """One run of ``cell``: ``(result, compared lines)``. ``control`` runs
    the program's chronological insertion in place of its sorted one (the
    control, which has to come out as not correct)."""
    import numpy as np
    import torch

    from portbench import check
    from portbench.trace import OP_SPAN, Trace

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_session = time.perf_counter() - t_start
    session = cell.generator.Session(cell.config, cell.mix, seed, dev, control=control)
    _log(f"[{cell.name}] set-up phases: imports {t_session:.3f}, " + ", ".join(
        f"{k} {v:.3f}" for k, v in getattr(session, "phases", {}).items())
        + f"; session ready {time.perf_counter() - t_start:.3f} s after the start")
    refs = {}
    for _, mod in cell.per_layer:
        refs.update(getattr(mod, "COUNTERS", {}))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    before = _counters(refs) if trace else {}
    prof = nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    ops, failed = [], 0
    with prof:
        w0 = time.perf_counter()
        while True:
            span = torch.profiler.record_function(OP_SPAN) if trace else nullcontext()
            try:
                rec = session.op(len(ops), span)
            except Exception:  # an op that fails ends the window; the run is not correct
                traceback.print_exc()
                failed += 1
                break
            ops.append(rec)
            last = rec["end"] - w0 >= seconds
            session.after(len(ops) - 1, last)
            if last:
                break
    window_s = (ops[-1]["end"] if ops else time.perf_counter()) - w0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded after the window: {', '.join(found)}")
    win = Window(w0, ops, setup_s, peak)
    walls = np.array([op["end"] - op["start"] for op in ops]) * 1e3
    _log(f"[{cell.name}] seed {seed}: {len(ops)} ops in {window_s:.3f} s, setup "
         f"{setup_s:.3f} s, peak {peak / 2**30:.4f} GiB")
    _log(f"[{cell.name}] op wall ms over {len(walls)} ops: " + _quantiles(walls))
    metrics, extra = {}, {}
    if trace:
        after = _counters(refs)
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        t0 = time.perf_counter()
        tr = Trace.from_profiler(prof, name, window_s, ops,
                                 {k: after[k] - before[k] for k in refs})
        extra = {"busy_s": tr.busy_s, "window_s": window_s}
        for m, mod in cell.per_layer:
            v = mod.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        _log(f"[{cell.name}] trace: {len(tr.device)} device and {len(tr.cpu)} host "
             f"events read in {time.perf_counter() - t0:.3f} s; busy {tr.busy_s:.4f} s")
        _log(f"[{cell.name}] host prep ms an op: " + _quantiles(tr.host_prep_s() * 1e3))
        _log(f"[{cell.name}] device busy ms inside an op: " + _quantiles(tr.busy_in_spans() * 1e3))
        del tr, prof
    else:
        for m, mod in cell.end_to_end:
            v = mod.read(win)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t0 = time.perf_counter()
    checked = session.checked()
    del session
    totals = dict.fromkeys(check.LIMITS, 0)
    for i, out, parts in checked:
        numbers = check.compare(out, parts, dev)
        _log(f"[{cell.name}] op {i}: " + ", ".join(f"{k} {v}" for k, v in numbers.items()))
        for k, v in numbers.items():
            totals[k] += v
    _log(f"[{cell.name}] checked ops {[c[0] for c in checked]} in "
         f"{time.perf_counter() - t0:.3f} s")
    correct = (failed == 0 and bool(ops) and bool(checked)
               and all(totals[k] <= lim for k, lim in check.LIMITS.items()))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak),
                   **extra}
    if cuda:
        device_info["power_limit_w"] = _power_limit_w()
    result = {"correct": correct, "attempted": len(ops) + failed, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": totals[k], "limit": lim}
                          for k, lim in check.LIMITS.items()}
    lines = [f"compared {k}: {totals[k]} (limit {lim})" for k, lim in check.LIMITS.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PORT)):
        _log(f"no {PORT} beside {HERE}: nothing to measure")
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    try:
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    except ForbiddenImport as e:
        _log(str(e))
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        _log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
