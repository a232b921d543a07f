"""The harness end to end on the CPU at tiny sizes of the append cell's
shape and of a long-read build: a sound run is correct; the control and
each fault the cells can have is not; cells, configurations, mixes and metrics are found by name as files;
the command needs a card and the port; no module it imports is JAX's or
the JAX package's, and the reference imports nothing of the port."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import run

from .conftest import PB, REPO, SEED, tiny_root

CELLS = ["tiny-lr.build", "tiny-sr.tappend"]


def _run(tiny, name, **kw):
    bench, root = tiny
    cell = run.find_cell(name, bench, root)
    return run.run_cell(cell, SEED, 0.2, False, "cpu", t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res, lines = _run(tiny, name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    assert all(v == {"value": 0, "limit": 0} for v in res["compared"].values())
    bench, root = tiny
    want = {m["name"] for m, _ in run.find_cell(name, bench, root).end_to_end}
    assert set(res["metrics"]) == want - {"peak_device_gib"}  # no peak without a card
    assert ("append_p95_ms" in want) == ("append" in name)
    assert lines and all(re.match(r"compared \w+: \d+ \(limit 0\)$", ln) for ln in lines)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    res, _ = _run(tiny, name, control=True)
    assert not res["correct"] and res["compared"]["bwt_mismatch"]["value"] > 0


def _fault_altered(bcr, monkeypatch, appends):
    """One symbol of the result changed where the stage loop produces it."""
    orig = bcr._build_device

    def altered(*a, **k):
        buf, table, counts = orig(*a, **k)
        buf[0] = (int(buf[0]) + 1) % 6
        return buf, table, counts

    monkeypatch.setattr(bcr, "_build_device", altered)


def _fault_half(bcr, monkeypatch, appends):
    """Half of each op's reads left out (of an append's batch, not of the
    base it is set up on)."""
    orig = bcr._prepare_build

    def half(reads, lengths, sorted_insert, n0=0, base_string_count=0):
        if base_string_count or not appends:
            reads, lengths = reads[: len(reads) // 2], lengths[: len(lengths) // 2]
        return orig(reads, lengths, sorted_insert, n0, base_string_count)

    monkeypatch.setattr(bcr, "_prepare_build", half)


def _fault_unchanged(bcr, monkeypatch, appends):
    """A step that returns its state unchanged: each column's LF step gives
    back the positions, counts and symbols it was handed, and an append
    gives back its base's index."""
    for name in ("lf_stage", "lf_pair"):
        orig = getattr(bcr, name)

        def same(j, tab, *a, _orig=orig, **k):
            out = _orig(j, tab, *a, **k)
            P, counts, prev_v = a[-3:]
            return out[:3] + (P, counts, prev_v)

        monkeypatch.setattr(bcr, name, same)
    orig_build = bcr.build_msbwt_with_index

    def base_back(reads, lengths, sorted_insert=True, base=None, *a, **k):
        if base is None:
            return orig_build(reads, lengths, sorted_insert, base, *a, **k)
        return bcr.index_from_symbols(base)

    monkeypatch.setattr(bcr, "build_msbwt_with_index", base_back)


FAULTS = {"altered": _fault_altered, "half": _fault_half, "unchanged": _fault_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_faults_in_the_timed_path_are_not_correct(tiny, monkeypatch, name, fault):
    """The run with the timed path broken underneath (no card needed)."""
    from rust_msbwt_tpu_torch.ops import bcr

    bench, root = tiny
    cell = run.find_cell(name, bench, root)
    FAULTS[fault](bcr, monkeypatch, appends="append" in name)
    res, _ = run.run_cell(cell, SEED, 0.2, False, "cpu", t_start=time.perf_counter())
    assert not res["correct"]


def test_trace_run_reports_per_layer_metrics_only(tiny):
    bench, root = tiny
    cell = run.find_cell("tiny-sr.tappend", bench, root)
    res, _ = run.run_cell(cell, SEED, 0.2, True, "cpu", t_start=time.perf_counter())
    assert res["correct"]
    assert set(res["metrics"]) <= {m["name"] for m, _ in cell.per_layer}
    assert "busy_s" in res["device"] and "breakdown" in res and list(res)[-1] == "compared"


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    (and entries) are found by name, with no file of the harness edited."""
    bench = tiny_root(tmp_path)
    with open(tmp_path / "configs" / "tiny-sr.json") as f:
        cfg = json.load(f)
    cfg.update(name="other-sr", read_length=60, genome_seed=99)
    (tmp_path / "configs" / "other-sr.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "small.json").write_text(json.dumps(
        {"generator": "closed_loop", "op": "append", "base_reads": 50,
         "batch_reads": 7, "why": "tiny"}))
    (tmp_path / "metrics" / "ops_traced.py").write_text(
        'LAYER = "harness"\nUNIT = "ops"\nMOVES = "build_mbases_per_s"\n'
        "def read(trace):\n    return float(len(trace.ops))\n")
    b = json.loads(open(bench).read())
    b["workloads"].append({"name": "other-sr.small", "config": "other-sr", "traffic": "small",
                           "chips": 1, "why": "tiny"})
    b["per_layer"].append({"name": "ops_traced", "unit": "ops", "better": "higher",
                           "source": "program_counter", "layer": "harness",
                           "moves": "build_mbases_per_s", "workloads": ["other-sr.small"]})
    open(bench, "w").write(json.dumps(b))
    cell = run.find_cell("other-sr.small", bench, str(tmp_path))
    assert cell.config["read_length"] == 60 and cell.mix["batch_reads"] == 7
    assert [m["name"] for m, _ in cell.per_layer] == ["ops_traced"]
    res, _ = run.run_cell(cell, SEED, 0.1, True, "cpu", t_start=time.perf_counter())
    assert res["correct"] and res["metrics"]["ops_traced"]["value"] == res["attempted"]


def test_benchmark_json_matches_the_metric_files():
    """Every metric and file that BENCHMARK.json names exists, with its
    unit, layer and the end-to-end metric it moves, and every cell reports
    what the metrics that list it move."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert b["paths"] == ["portbench"] and b["command"][-1] == "portbench.run"
    name_re = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    cells = {w["name"]: w for w in b["workloads"]}
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json" and name_re.match(c["name"])
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        mod = run.load_file(os.path.join(PB, "endtoend", f"{m['name']}.py"), m["name"])
        assert mod.UNIT == m["unit"] and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        mod = run.load_file(os.path.join(PB, "metrics", f"{m['name']}.py"), m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        for w in m["workloads"]:
            want = e2e[m["moves"]].get("workloads", list(cells))
            assert w in cells and w in want
    for w in cells.values():
        assert name_re.match(w["name"]) and w["name"] == f"{w['config']}.{w['traffic']}"
        assert os.path.isfile(os.path.join(PB, "traffic", f"{w['traffic']}.json"))


def _cli(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_command_without_a_card_prints_no_result():
    res = _cli(["--workload", "ecoli-sr100.append", "--seed", str(SEED), "--seconds", "1",
                "--trace", "0"], REPO)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_command_without_the_port_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(["--workload", "ecoli-sr100.append", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_a_run_is_jax_or_the_jax_package(tmp_path):
    """A whole tiny run in a fresh process, then its ``sys.modules``
    compared by whole top-level names (``rust_msbwt_tpu_torch`` is the
    port, ``rust_msbwt_tpu`` the JAX package)."""
    bench = tiny_root(tmp_path)
    code = (
        "import sys, time, json\n"
        "from portbench import run\n"
        f"cell = run.find_cell('tiny-sr.tappend', {bench!r}, {str(tmp_path)!r})\n"
        f"res, _ = run.run_cell(cell, {SEED}, 0.1, True, 'cpu', t_start=time.perf_counter())\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([res['correct'], tops]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and "rust_msbwt_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "rust_msbwt_tpu"} & set(tops)
    for dirpath, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not {"jax", "jaxlib", "flax", "rust_msbwt_tpu"} & tops, f
                assert "benchmarks" not in tops and "bench" not in tops, f


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, json\nimport portbench.reference.msbwt\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"rust_msbwt_tpu_torch", "rust_msbwt_tpu", "jax", "jaxlib"} & tops
    ref_dir = os.path.join(PB, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert tops <= {"__future__", "torch", "numpy", "portbench"}, f
            assert not [m for m in _imports(os.path.join(ref_dir, f))
                        if m.startswith("portbench") and not m.startswith("portbench.reference")]


def test_window_records_cover_the_window(tiny):
    """Every op starts before the window's end and the last crosses it."""
    bench, root = tiny
    cell = run.find_cell("tiny-sr.tappend", bench, root)
    session = cell.generator.Session(cell.config, cell.mix, SEED, "cpu")
    ops = []
    w0 = time.perf_counter()
    from contextlib import nullcontext

    while True:
        rec = session.op(len(ops), nullcontext())
        ops.append(rec)
        last = rec["end"] - w0 >= 0.3
        session.after(len(ops) - 1, last)
        if last:
            break
    assert all(op["start"] - w0 < 0.3 for op in ops)
    assert np.all(np.diff([op["start"] for op in ops]) > 0)
    checked = session.checked()
    assert checked and checked[-1][0] == len(ops) - 1
