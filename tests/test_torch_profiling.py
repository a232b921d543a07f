"""The port's ``utils.profiling`` (on ``torch.profiler``) on the CPU: the
timers, the trace, the session probe, and the build entry's spans, each
once a call under ``msbwt.build`` in the order the build runs them, with
``annotate`` a shared no-op while no profiler is active."""

import os

import numpy as np
import pytest
import torch

from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.utils import profiling as prof

from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

# the build entry's spans, in the order a call opens them
SPANS = ["msbwt.build", "msbwt.prep.sort", "msbwt.prep.view", "msbwt.upload", "msbwt.stage1",
         "msbwt.buffers", "msbwt.base_counts", "msbwt.stage_loop", "msbwt.sync"]


def test_default_bandwidth_is_the_h100s():
    assert prof.DEFAULT_HBM_BW == 3.35e12


def test_timers_on_cpu():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.ones(4) * x

    s = prof.timeit(fn, 3, reps=4, warmup=2)
    assert s >= 0 and calls == [3] * 6
    s, out = prof.timed(fn, 2)
    assert s >= 0 and out.tolist() == [2.0] * 4


def test_trace_and_annotate_on_cpu(tmp_path):
    d = str(tmp_path / "tr")
    with prof.trace(d) as p:
        with prof.annotate("msbwt_region"):
            torch.arange(1000).cumsum(0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "msbwt_region" in open(os.path.join(d, files[0])).read()
    assert any(e.key == "msbwt_region" for e in p.key_averages())


def test_session_health_smoke():
    out = prof.session_health(hbm_mwords=1, device="cpu")
    assert out["device"] == "cpu"
    assert set(out) == {"device", "dispatch_roundtrip_ms", "mem_gbps"}
    assert all(out[k] >= 0 for k in out if k != "device")


def test_annotate_off_is_a_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = prof.annotate("msbwt.build"), prof.annotate("msbwt.sync")
    assert first is second
    with first:
        pass


@pytest.fixture(scope="module")
def build_spans(tmp_path_factory):
    """The ``msbwt.*`` host events of a CPU build of 40 ragged reads and of
    a CPU append of 20 reads onto it (``base=`` / ``base_index=``), each
    traced alone: ``{path: [(name, start, end, parent name)]}``."""
    rng = np.random.default_rng(17)

    def reads(n, width):
        lengths = rng.integers(1, width + 1, n).astype(np.int32)
        out = np.zeros((n, width), np.uint8)
        for i, k in enumerate(lengths):
            out[i, :k] = rng.integers(1, 6, k)
        return out, lengths

    base_reads = reads(40, 13)
    idx, packed = bcr.build_msbwt_with_index(*base_reads, device="cpu")
    calls = {
        "build": lambda: bcr.build_msbwt_with_index(*base_reads, device="cpu"),
        "append": lambda: bcr.build_msbwt_with_index(
            *reads(20, 11), base=idx.bwt[: idx.n], base_string_count=40, base_rot_max=14,
            base_index=packed, device="cpu"),
    }
    out = {}
    for path, call in calls.items():
        with prof.trace(str(tmp_path_factory.mktemp(path))) as p:
            call()
        out[path] = sorted(((e.name, e.time_range.start, e.time_range.end,
                             e.cpu_parent.name if e.cpu_parent is not None else None)
                            for e in p.events() if e.name.startswith("msbwt.")),
                           key=lambda ev: ev[1])
    return out


# a build onto no base has no base counts
SPAN_CASES = [("append", s) for s in SPANS] + [
    ("build", s) for s in SPANS if s != "msbwt.base_counts"]


@pytest.mark.parametrize("path,span", SPAN_CASES)
def test_build_entry_span_once_under_build_in_order(build_spans, path, span):
    events = build_spans[path]
    want = [s for p, s in SPAN_CASES if p == path]
    assert [ev[0] for ev in events] == want  # each once, in the table's order
    k = want.index(span)
    _, start, end, parent = events[k]
    if k == 0:
        assert parent is None  # the caller's span, here none
        return
    _, b_start, b_end, _ = events[0]
    assert parent == "msbwt.build" and b_start <= start <= end <= b_end
    if k > 1:
        assert events[k - 1][2] <= start  # opens after the one before it has closed
