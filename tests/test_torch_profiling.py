"""The port's ``utils.profiling`` (on ``torch.profiler``) against the JAX
package's, on CPU: the roofline byte models give the JAX package's bytes
(exact integers), ``build_roofline`` counts the port's 3n + 6N bytes a
merge pass at radix 1 and 2, and the timers, the trace and the session probe
run on the CPU."""

import os

import pytest
import torch

from rust_msbwt_tpu.utils import profiling as jprof

from rust_msbwt_tpu_torch.utils import profiling as prof


@pytest.mark.parametrize("n,k,cache_k", [(1_000_000, 21, 0), (1_000_000, 21, 8),
                                         (12_345, 31, 9), (7, 5, 11)])
def test_query_rooflines_match_jax(n, k, cache_k):
    for bw in (8.2e11, prof.DEFAULT_HBM_BW):
        got = prof.query_roofline(n, k, 0.25, hbm_bw=bw, cache_k=cache_k)
        want = jprof.query_roofline(n, k, 0.25, hbm_bw=bw, cache_k=cache_k)
        assert got.bytes_touched == want.bytes_touched
        assert got.seconds_at_light == want.seconds_at_light
        assert got.fraction_of_light == want.fraction_of_light
        got = prof.pair_query_roofline(n, k, 0.25, cache_k=cache_k, hbm_bw=bw)
        want = jprof.pair_query_roofline(n, k, 0.25, cache_k=cache_k, hbm_bw=bw)
        assert got.bytes_touched == want.bytes_touched
        assert got.seconds_at_light == want.seconds_at_light


def test_default_bandwidth_is_the_h100s():
    assert prof.DEFAULT_HBM_BW == 3.35e12
    r = prof.query_roofline(1_000_000, 21, 1.0)
    assert r.seconds_at_light == r.bytes_touched / 3.35e12


@pytest.mark.parametrize("L", [1, 2, 100, 999, 1000])
def test_build_roofline_counts_passes(L):
    N = 500
    n = N * (L + 1)
    r1 = prof.build_roofline(n, L, 1.0, n_reads=N)
    assert r1.bytes_touched == (L + 1) * (3 * n + 6 * N)
    r2 = prof.build_roofline(n, L, 1.0, n_reads=N, radix=2)
    pairs, single = L // 2, L % 2
    assert r2.bytes_touched == (1 + single) * (3 * n + 6 * N) + pairs * (3 * n + 12 * N)
    # the same inserts in fewer passes: radix 2 saves 3n a pair
    assert r1.bytes_touched - r2.bytes_touched == pairs * 3 * n
    with pytest.raises(ValueError):
        prof.build_roofline(n, L, 1.0, n_reads=N, radix=3)


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
    out = prof.session_health(mxu_n=16, hbm_mwords=1, device="cpu")
    assert out["device"] == "cpu"
    assert set(out) == {"device", "dispatch_roundtrip_ms", "matmul_tflops_bf16", "mem_gbps"}
    assert all(out[k] >= 0 for k in out if k != "device")
