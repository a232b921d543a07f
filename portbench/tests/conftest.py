"""Shared pieces of the benchmark's tests: a copy of the harness's data
files with tiny cells added beside the real ones."""

from __future__ import annotations

import json
import os
import shutil

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def tiny_root(path) -> str:
    """A copy of ``configs/``, ``traffic/``, ``metrics/`` and ``endtoend/``
    under ``path`` with two tiny cells of the real cells' shapes added as
    files and entries: ``tiny-sr.tappend`` (100 bp reads appended onto a
    base, the real cell's shape) and ``tiny-lr.build`` (one-shot builds of
    1,000 bp reads: radix 2, so ``lf_pair``, whose metric it adds).
    Returns the path of its ``BENCHMARK.json``."""
    root = str(path)
    for d in ("configs", "traffic", "metrics", "endtoend"):
        shutil.copytree(os.path.join(PB, d), os.path.join(root, d), dirs_exist_ok=True)

    def derive(src, dst, **kw):
        with open(os.path.join(root, src)) as f:
            obj = json.load(f)
        obj.update(kw)
        with open(os.path.join(root, dst), "w") as f:
            json.dump(obj, f)

    derive("configs/ecoli-sr100.json", "configs/tiny-sr.json", genome_length=3000, reads=300)
    derive("configs/ecoli-sr100.json", "configs/tiny-lr.json", genome_length=5000, reads=12,
           read_length=1000, substitution_rate=0.01, n_rate=0.0)
    derive("traffic/append.json", "traffic/tappend.json", base_reads=200, batch_reads=30)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    builds = {"host_prep_ms", "device_idle_pct", "merge_pass_roofline"}
    b["workloads"] += [{"name": "tiny-lr.build", "config": "tiny-lr", "traffic": "build",
                        "chips": 1, "why": "tiny"},
                       {"name": "tiny-sr.tappend", "config": "tiny-sr", "traffic": "tappend",
                        "chips": 1, "why": "tiny"}]
    for m in b["end_to_end"] + b["per_layer"]:
        if "ecoli-sr100.append" in m.get("workloads", ()):
            m["workloads"] += ["tiny-sr.tappend"] + ["tiny-lr.build"] * (m["name"] in builds)
    b["per_layer"].append({"name": "lf_pair_us", "unit": "us", "better": "lower",
                           "source": "device_trace", "layer": "radix-2 column pair (ops/lf.lf_pair)",
                           "moves": "build_mbases_per_s", "workloads": ["tiny-lr.build"]})
    bench = os.path.join(root, "BENCHMARK.json")
    with open(bench, "w") as f:
        json.dump(b, f)
    return bench


@pytest.fixture
def tiny(tmp_path):
    """``(BENCHMARK.json path, root)`` of a tiny copy (``tiny_root``)."""
    return tiny_root(tmp_path), str(tmp_path)
