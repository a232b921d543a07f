"""The port's multi-device layer (``parallel/`` on ``torch.distributed``)
against the JAX package, on gloo ranks on the CPU at world sizes 1-4.

One spawn per world size (``tests/_torch_dist_worker.py``: a free port,
one thread a rank, rendezvous and collective timeouts, a join timeout) runs
every case on every rank; a module-scoped fixture holds the results and
each case is its own test. Every rank must get the same bytes, equal to the
JAX package's single-device ``kway_merge`` / ``multiway_bwt_merge`` /
``count_kmers`` on the same inputs; at D = 4 the JAX ``sharded_hm_merge``
(dense and ragged), ``sharded_doubling_merge``, ``count_kmers_sharded`` and
``count_kmers_partitioned`` also run on the conftest's CPU mesh
(``default_mesh(4)``). Bit-exact throughout (tolerance 0). The
distributed build command line runs as two gloo processes under
``torch.distributed.run``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from rust_msbwt_tpu.ops import merge as jmerge
from rust_msbwt_tpu.ops.rank import build_occ_index as jbuild_occ_index
from rust_msbwt_tpu.ops.rank import count_kmers as jcount_kmers
from rust_msbwt_tpu.parallel.mesh import default_mesh

from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
from rust_msbwt_tpu_torch.ops.bcr import encode_reads
from rust_msbwt_tpu_torch.utils.oracle import naive_bwt

from tests._data import GOLDEN_FA, GOLDEN_NPY
from tests._torch_dist_worker import run_ranks
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
WORLDS = [1, 2, 3, 4]
BUILDS = ["build_tree", "build_tree_pairwise", "build_tree_wide", "build_dense",
          "build_ragged", "build_dense_wide", "build_ragged_wide", "multihost"]
MERGES = ["hm_dense", "hm_ragged", "hm_ragged_wide", "doubling", "doubling_wide"]
COUNTS = ["sharded_index", "sharded_index_wide", "partitioned", "partitioned_wide"]
CASES = ["collectives", *BUILDS, *MERGES, *COUNTS]


def _bwt(strings):
    return np.asarray(convert_stoi(naive_bwt(strings)), np.uint8)


@pytest.fixture(scope="module")
def data():
    """Reads (symbols 1..5, ragged, two duplicated), five merge sources (one
    empty, two sharing reads: the tie order) and right-aligned k-mers."""
    r = np.random.default_rng(0x9A7)
    strings = ["".join(r.choice(list("ACGNT"), size=int(r.integers(3, 26))))
               for _ in range(40)]
    strings += strings[:2]
    reads, lengths = encode_reads([convert_stoi(s) for s in strings])
    groups = [strings[0:9], strings[9:17], [], strings[17:30], strings[30:] + strings[:3]]
    parts = [_bwt(g) if g else np.zeros(0, np.uint8) for g in groups]
    kmers = np.stack([convert_stoi(s[:6].ljust(6, "A")) for s in strings[:24]]
                     + [r.integers(1, 6, 6).astype(np.uint8) for _ in range(16)])
    klens = r.integers(1, 7, kmers.shape[0]).astype(np.int32)
    kmers[np.arange(6)[None, :] < (6 - klens)[:, None]] = 1  # masked, in 1..5
    decoded = _bwt(strings)
    return {"strings": strings, "groups": groups,
            "inputs": dict(reads=reads, lengths=lengths, kmers=kmers, klens=klens,
                           decoded=decoded, parts=np.concatenate(parts),
                           part_sizes=np.array([p.size for p in parts])),
            "parts": parts}


@pytest.fixture(scope="module")
def want(data):
    """The JAX package's single-device results on the same inputs."""
    inp = data["inputs"]
    idx = jbuild_occ_index(jnp.asarray(inp["decoded"]))
    merged, srcs = jmerge.multiway_bwt_merge(data["parts"], return_sources=True)
    # the reads' BWT: the merge of a partition of them
    thirds = [_bwt(data["strings"][i::3]) for i in range(3)]
    return {"bwt": np.asarray(jmerge.kway_merge(thirds)),
            "doubling": (np.asarray(merged), np.asarray(srcs)),
            "hm": {d: np.asarray(jmerge.kway_merge(data["parts"][:d])) for d in WORLDS},
            "counts": np.asarray(jcount_kmers(idx, inp["kmers"], inp["klens"]))}


@pytest.fixture(scope="module")
def spawns(data, tmp_path_factory):
    """``spawns(d)``: every rank's results at world size d, one spawn each."""
    done = {}

    def get(d):
        if d not in done:
            out = tmp_path_factory.mktemp(f"world{d}")
            done[d] = run_ranks(d, CASES, data["inputs"], str(out), timeout_s=120)
        return done[d]

    return get


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"world{d}")
def run(request, spawns):
    return request.param, spawns(request.param)


def test_oracle_and_kway_agree(data, want):
    assert np.array_equal(want["bwt"], data["inputs"]["decoded"])
    assert convert_itos(want["bwt"]) == naive_bwt(data["strings"])


def test_collectives(run):
    d, ranks = run
    for me, out in enumerate(ranks):
        assert out["collectives.gather"].tolist() == [[r, 10 * r] for r in range(d)]
        assert out["collectives.sum"].tolist() == [d * (d + 1) // 2]
        # rank r sent me + 1 copies of r here
        assert out["collectives.exchange"].tolist() == [r for r in range(d)
                                                        for _ in range(me + 1)]
        assert out["collectives.parts"].tolist() == [i for r in range(d) for i in range(r)]
        assert out["collectives.any"].tolist() == [True, False]


@pytest.mark.parametrize("case", BUILDS)
def test_builds_match_jax(run, want, case):
    _, ranks = run
    for out in ranks:
        assert np.array_equal(out[f"{case}.bwt"], want["bwt"]), case


@pytest.mark.parametrize("case", ["hm_dense", "hm_ragged", "hm_ragged_wide"])
def test_sharded_hm_merge_matches_jax(run, want, case):
    d, ranks = run
    for out in ranks:
        assert np.array_equal(out[f"{case}.bwt"], want["hm"][d])


@pytest.mark.parametrize("case", ["doubling", "doubling_wide"])
def test_sharded_doubling_merge_matches_jax(run, want, case):
    _, ranks = run
    merged, srcs = want["doubling"]
    for out in ranks:
        assert np.array_equal(out[f"{case}.bwt"], merged)
        assert out[f"{case}.src"].dtype == np.int32
        assert np.array_equal(out[f"{case}.src"], srcs)


@pytest.mark.parametrize("case", COUNTS)
def test_counts_match_jax(run, want, case):
    _, ranks = run
    for out in ranks:
        got = out[f"{case}.counts"]
        assert got.dtype == (np.int64 if case.endswith("wide") else np.int32)
        assert np.array_equal(got, want["counts"])


# ---------------------------------------------------------------------------
# the JAX package's sharded functions on the CPU mesh at D = 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(spawns):
    return spawns(4)


@pytest.mark.parametrize("transport", ["dense", "ragged"])
def test_jax_sharded_hm_merge_at_d4(data, world4, transport):
    from rust_msbwt_tpu.parallel.sharded_merge import sharded_hm_merge

    jax_out = sharded_hm_merge(data["parts"][:4], mesh=default_mesh(4), transport=transport)
    for out in world4:
        assert np.array_equal(out[f"hm_{transport}.bwt"], np.asarray(jax_out))


def test_jax_sharded_doubling_merge_at_d4(data, world4):
    from rust_msbwt_tpu.parallel.doubling_merge import sharded_doubling_merge

    merged, srcs = sharded_doubling_merge(data["parts"], mesh=default_mesh(4),
                                          return_sources=True)
    for out in world4:
        assert np.array_equal(out["doubling.bwt"], np.asarray(merged))
        assert np.array_equal(out["doubling.src"], np.asarray(srcs))


def test_jax_count_kmers_sharded_at_d4(data, world4):
    from rust_msbwt_tpu.parallel.sharded_index import build_sharded_index, count_kmers_sharded

    inp = data["inputs"]
    idx = build_sharded_index(inp["decoded"], mesh=default_mesh(4))
    jax_counts = np.asarray(count_kmers_sharded(idx, inp["kmers"], inp["klens"]))
    for out in world4:
        assert np.array_equal(out["sharded_index.counts"], jax_counts)


def test_jax_partitioned_at_d4(data, world4):
    """Counts, and the packed-table rows the two layouts share: a rank's
    bins (the JAX table pads every shard to the longest) and the occurrence
    lanes of its terminal row."""
    from rust_msbwt_tpu.parallel.partitioned import build_partitioned, count_kmers_partitioned

    inp = data["inputs"]
    pidx = build_partitioned(inp["reads"], inp["lengths"], mesh=default_mesh(4))
    jax_counts = np.asarray(count_kmers_partitioned(pidx, inp["kmers"], inp["klens"]))
    tables = np.asarray(pidx.table)
    sizes = np.asarray(pidx.sizes)
    for r, out in enumerate(world4):
        assert np.array_equal(out["partitioned.counts"], jax_counts)
        nb = -(-int(sizes[r]) // 128)
        assert int(out["partitioned.size"][0]) == int(sizes[r])
        table = out["partitioned.table"]
        assert table.shape == (nb + 1, 32)
        assert np.array_equal(table[:nb], tables[r, :nb])
        assert np.array_equal(table[nb, :6], tables[r, nb, :6])


# ---------------------------------------------------------------------------
# world size 1 without a process group, in this process
# ---------------------------------------------------------------------------

def test_no_group_is_world_size_one(data, want):
    from rust_msbwt_tpu_torch.parallel import mesh
    from rust_msbwt_tpu_torch.parallel.multihost import init_distributed, process_read_slice
    from rust_msbwt_tpu_torch.parallel.sharded_build import build_msbwt_sharded
    from rust_msbwt_tpu_torch.parallel.sharded_merge import sharded_hm_merge

    assert mesh.world() == (0, 1)
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "MSBWT_COORDINATOR")
           if k in os.environ}
    try:
        assert init_distributed("cpu") is False
    finally:
        os.environ.update(env)
    assert process_read_slice(10) == slice(0, 10)
    inp = data["inputs"]
    got = build_msbwt_sharded(inp["reads"], inp["lengths"], merge="sharded", device="cpu")
    assert np.array_equal(got, want["bwt"])
    with pytest.raises(ValueError, match="at most 1 parts"):
        sharded_hm_merge(data["parts"][:2], device="cpu")


def test_nccl_refuses_a_second_rank_on_a_card(monkeypatch):
    """Under NCCL a rank whose local rank has no card of its own raises
    before any rendezvous: NCCL never shares a card."""
    import torch

    from rust_msbwt_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL puts one rank on each card"):
        mesh.init_group(rank=1, world_size=2, init_method="tcp://127.0.0.1:1",
                        device="cuda", local_rank=1)


# ---------------------------------------------------------------------------
# msbwt2-build --distributed: two gloo processes under torch.distributed.run
# ---------------------------------------------------------------------------

def _torchrun_build(nproc, fasta, out, extra=()):
    from tests._torch_dist_worker import free_port

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "rust_msbwt_tpu_torch.cli.build", "--distributed", "--device", "cpu",
           *extra, "-o", str(out), str(fasta)]
    env = dict(os.environ, PYTHONPATH=_REPO, RUST_LOG="warning", OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=_REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_distributed_cli_golden(tmp_path):
    out = tmp_path / "out.npy"
    res = _torchrun_build(2, GOLDEN_FA, out)
    assert res.returncode == 0, res.stderr[-3000:]
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_distributed_cli_matches_jax_cli(tmp_path, data):
    from rust_msbwt_tpu.cli.build import main as jax_build_main

    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(data["strings"])))
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    res = _torchrun_build(2, fa, a)
    assert res.returncode == 0, res.stderr[-3000:]
    assert jax_build_main(["-o", str(b), str(fa)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_distributed_cli_refuses_unsorted(tmp_path):
    res = _torchrun_build(2, GOLDEN_FA, tmp_path / "x.npy", extra=("--unsorted",))
    assert res.returncode != 0  # torchrun reports the ranks' exit code 74
    assert "implies lexicographic" in res.stderr
