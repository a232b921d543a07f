"""The ragged build mix (``traffic/closed_loop_ragged.py``): the lengths of
``ecoli-ont50x`` are the gamma's quantiles, the same for every seed; its
reads are windows of the genome on both strands; and at a tiny ragged
configuration of the same gamma shape the whole harness on the CPU finds a
sound run correct, the control and an altered symbol not."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import data, run
from portbench.traffic import closed_loop_ragged as ragged

from .conftest import PB, SEED, tiny_root
from .test_portbench_harness import _fault_altered

CELL = "tiny-ont.build_ragged"
TINY = {"genome_length": 6000, "reads": 40,
        "read_lengths": {"model": "gamma", "mean": 150, "sd": 130}}


def _config(name="ecoli-ont50x"):
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_ont50x_lengths_are_the_gamma_quantiles():
    """N 15,472, 232,075,995 bases, 5 to 127,125 bp; mean and sd within a
    base of the model's (the quantile rule thins the far tail)."""
    cfg = _config()
    lengths = ragged.config_lengths(cfg)
    assert len(lengths) == cfg["reads"] == 15472
    assert int(lengths.sum()) == 232_075_995
    assert (int(lengths.min()), int(lengths.max())) == (5, 127_125)
    assert np.all(np.diff(lengths) >= 0)
    assert abs(lengths.mean() - 15000) < 1 and abs(lengths.std() - 13000) < 3


@pytest.mark.parametrize("other", [SEED + 1, 1])
def test_lengths_are_the_same_for_every_seed(other):
    cfg = dict(_config(), **TINY)
    codes = data.genome(cfg, "cpu")
    want = ragged.config_lengths(cfg)
    a, la = ragged.ragged_reads(codes, cfg, want, 2, data.stream(SEED, "inputs"))
    b, lb = ragged.ragged_reads(codes, cfg, want, 2, data.stream(SEED, "inputs"))
    c, lc = ragged.ragged_reads(codes, cfg, want, 2, data.stream(other, "inputs"))
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(a, c)
    for ln in (la, lc):
        for k in range(2):
            assert np.array_equal(np.sort(ln[k * 40:(k + 1) * 40].numpy()), want)
    assert a.shape == (80, int(want.max())) and a.dtype == torch.uint8


def test_reads_lie_in_the_genome_on_both_strands():
    """Without errors every read is a window of the genome or of its
    reverse complement, both strands occur, and the rows are zero past
    each read; with the configuration's 5% about that share differs."""
    cfg = dict(_config(), **TINY, substitution_rate=0.0)
    codes = data.genome(cfg, "cpu")
    lengths = ragged.config_lengths(cfg)
    r, ln = ragged.ragged_reads(codes, cfg, lengths, 2, data.stream(SEED, "x"))
    r, ln = r.numpy(), ln.numpy()
    sym = np.array([1, 2, 3, 5], np.uint8)[codes.numpy()]
    comp = np.array([0, 5, 3, 2, 4, 1], np.uint8)
    text, rc = sym.tobytes(), comp[sym[::-1]].tobytes()
    long = [i for i in range(len(ln)) if ln[i] >= 40]  # too long to match both by chance
    fw = sum(r[i, :ln[i]].tobytes() in text for i in long)
    bw = sum(r[i, :ln[i]].tobytes() in rc for i in long)
    assert fw + bw == len(long) and fw > 0 and bw > 0
    assert not r[np.arange(r.shape[1])[None, :] >= ln[:, None]].any()
    assert set(np.unique(r[r > 0])) <= {1, 2, 3, 5}
    noisy = dict(cfg, substitution_rate=0.05, reads=400)
    lengths = ragged.config_lengths(noisy)
    r2, ln2 = ragged.ragged_reads(codes, noisy, lengths, 1, data.stream(SEED, "x"))
    clean, _ = ragged.ragged_reads(codes, dict(noisy, substitution_rate=0.0), lengths, 1,
                                   data.stream(SEED, "x"))
    inside = np.arange(r2.shape[1])[None, :] < ln2.numpy()[:, None]
    share = (r2.numpy() != clean.numpy())[inside].mean()
    assert 0.03 < share < 0.07


def test_warm_up_takes_the_windows_path_in_few_passes():
    """``ecoli-ont50x``'s warm-up build: ragged, radix 2 as the window's,
    growing buckets, and under a twentieth of the window's passes."""
    from rust_msbwt_tpu_torch.ops import bcr

    def schedule(lengths):
        N, L = len(lengths), int(lengths.max())
        n_cap = int(lengths.sum()) + N
        radix = bcr.build_radix(n_cap, N)
        sched = bcr.bucket_schedule(0, N, L, n_cap, 128)
        if radix == 2:
            sched = bcr.pair_buckets(sched, L)
        return radix, len(sched), 1 + sum(-(-(b - a) // radix) for a, b, _ in sched)

    lengths = ragged.config_lengths(_config())
    lengths = lengths[np.random.default_rng(SEED).permutation(len(lengths))]
    rows = ragged.warm_rows(lengths)
    warm = lengths[rows]
    assert len(rows) == ragged.WARM_READS == len(np.unique(rows))
    assert warm.min() < 100 < 5000 < warm.max()
    radix, buckets, passes = schedule(warm)
    full = schedule(lengths)
    assert radix == full[0] == 2 and buckets > 10 and passes < full[2] / 20
    assert full[2] == 63_564


def test_staging_buffers_fit_the_windows_outputs():
    """The pinned buffers made in set-up have the shapes and dtypes of a
    window op's outputs, so the drawn op makes none."""
    from portbench.traffic import closed_loop

    cfg = dict(_config(), **TINY)
    mix = {"op": "build"}
    session = ragged.Session(cfg, mix, SEED, "cpu")
    reads, lengths = session.sets[0]
    outs = closed_loop._outputs(session.build(reads, lengths, device="cpu"))
    assert set(session.stage) == {k for k, v in outs.items() if isinstance(v, torch.Tensor)}
    for k, buf in session.stage.items():
        assert (buf.shape, buf.dtype) == (outs[k].shape, outs[k].dtype), k


@pytest.fixture
def tiny_ont(tmp_path):
    """A tiny copy of the harness's files (``tiny_root``) with the cell
    ``tiny-ont.build_ragged``: ``ecoli-ont50x`` cut to 40 reads of the same
    gamma shape at mean 150 on a 6,000-base genome, listed by the two
    stage-loop metrics."""
    bench = tiny_root(tmp_path)
    cfg = dict(_config(), **TINY)
    (tmp_path / "configs" / "tiny-ont.json").write_text(json.dumps(cfg))
    with open(bench) as f:
        b = json.load(f)
    b["workloads"].append({"name": CELL, "config": "tiny-ont", "traffic": "build_ragged",
                           "chips": 1, "why": "tiny"})
    for m in b["per_layer"]:
        if "ecoli-ont50x.build" in m["workloads"]:
            m["workloads"].append(CELL)
    with open(bench, "w") as f:
        json.dump(b, f)
    return bench, str(tmp_path)


def _run(tiny_ont, trace=False, **kw):
    bench, root = tiny_ont
    cell = run.find_cell(CELL, bench, root)
    return run.run_cell(cell, SEED, 0.2, trace, "cpu", t_start=time.perf_counter(), **kw)


def test_sound_run_is_correct(tiny_ont):
    res, _ = _run(tiny_ont)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(v == {"value": 0, "limit": 0} for v in res["compared"].values())
    assert set(res["metrics"]) == {"build_mbases_per_s", "setup_s"}  # no peak without a card


def test_control_is_not_correct(tiny_ont):
    res, _ = _run(tiny_ont, control=True)
    assert not res["correct"] and res["compared"]["bwt_mismatch"]["value"] > 0


def test_altered_symbol_is_not_correct(tiny_ont, monkeypatch):
    from rust_msbwt_tpu_torch.ops import bcr

    _fault_altered(bcr, monkeypatch, appends=False)
    res, _ = _run(tiny_ont)
    assert not res["correct"]


def test_traced_run_reads_the_stage_loop_counters(tiny_ont):
    """On the CPU the counters give ``stream_per_insert``; with no device
    time the roofline reads nothing."""
    res, _ = _run(tiny_ont, trace=True)
    assert res["correct"]
    assert res["metrics"]["stream_per_insert"]["value"] > 1
    assert "merge_stream_roofline" not in res["metrics"]
