"""Card tests of the port's merge-insert kernel: the CUDA kernel against its
plain PyTorch twin on the same CUDA tensors, bit-exact (tolerance 0: every
output is an integer) — one pass, a build, an extend build onto a non-empty
base, and a streamed build.

Marked ``gpu``; without a card every test skips (the decision is made in a
fixture, never at import time). This file imports no jax, so it runs on a
machine with only torch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index, encode_reads
from rust_msbwt_tpu_torch.ops.merge_insert import (
    insert_maps,
    merge_insert,
    merge_insert_plain,
)
from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n_old, n_ins, n_cap, seed, frac_active=1.0, clustered=False):
    r = np.random.default_rng(seed)
    old = np.full(n_cap, 7, np.uint8)
    old[:n_old] = r.integers(0, 6, n_old)
    active = r.random(n_ins) < frac_active
    m = int(active.sum())
    if clustered:
        q = n_old // 3 + np.arange(n_ins)
    else:
        q = r.choice(n_old + m, size=n_ins, replace=False)
    v = r.integers(0, 6, n_ins)
    return old, q.astype(np.int32), v.astype(np.uint8), active


@pytest.mark.parametrize(
    "n_old,n_ins,n_cap,frac,clustered",
    [
        (0, 5, 64, 1.0, False),            # one partial bin
        (1000, 300, 1300, 1.0, False),      # n_cap % 128 != 0
        (4096, 1024, 5120, 1.0, False),     # n_cap % 128 == 0
        (100_000, 1000, 101_037, 1.0, False),  # sparse
        (100_000, 4000, 104_000, 0.5, False),  # masked
        (200_000, 20_000, 220_000, 1.0, True),  # clustered: dense bins
        (3_000_000, 70_000, 3_070_000, 1.0, False),  # many tiles
    ],
)
def test_kernel_matches_plain(cuda, n_old, n_ins, n_cap, frac, clustered):
    old, q, v, active = _case(n_old, n_ins, n_cap, n_old + n_ins, frac, clustered)
    if frac < 1.0:  # masked: slots only need to be valid for the active ones
        n_cap = n_old + int(active.sum())
        old = old[:n_cap]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    old_t = t(old)
    ins, tmap, m = insert_maps(n_cap, t(q), t(v), t(active))
    before = merge_insert.launches
    new_k, tab_k = merge_insert(old_t, ins[:n_cap], tmap)
    new_p, tab_p = merge_insert_plain(old_t, ins[:n_cap], tmap)
    torch.cuda.synchronize()
    assert merge_insert.launches == before + 1
    assert int(m) == int(active.sum())
    assert torch.equal(new_k, new_p)
    assert torch.equal(tab_k, tab_p)


def test_kernel_rejects_bad_input(cuda):
    old = torch.zeros(256, dtype=torch.uint8, device=cuda)
    ins = torch.zeros(256, dtype=torch.int8, device=cuda)
    tmap = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        merge_insert(old, ins.to(torch.int32), tmap)
    with pytest.raises(ValueError):
        merge_insert(old, ins[:128], tmap)
    with pytest.raises(ValueError):
        merge_insert(old, ins, tmap.cpu())


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_build_kernel_matches_plain(cuda, sorted_insert):
    r = np.random.default_rng(17)
    reads_l = [r.integers(1, 6, r.integers(1, 60)).astype(np.uint8)
               for _ in range(3000)]
    reads, lengths = encode_reads(reads_l)
    idx_k, pk = build_msbwt_with_index(reads, lengths, sorted_insert, device=cuda)
    idx_p, pp = build_msbwt_with_index(reads, lengths, sorted_insert, device=cuda,
                                       merge=merge_insert_plain)
    assert torch.equal(idx_k.bwt, idx_p.bwt)
    assert torch.equal(pk.table, pp.table)
    assert torch.equal(idx_k.occ, idx_p.occ)


def _ragged(n, seed):
    r = np.random.default_rng(seed)
    return encode_reads([r.integers(1, 6, r.integers(1, 60)).astype(np.uint8)
                         for _ in range(n)])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_extend_kernel_matches_plain(cuda, sorted_insert):
    base_reads, base_lens = _ragged(2000, 23)
    base, base_packed = build_msbwt_with_index(base_reads, base_lens, device=cuda)
    reads, lengths = _ragged(1500, 24)
    out = {}
    for name, merge in (("kernel", merge_insert), ("plain", merge_insert_plain)):
        before = merge_insert.launches
        out[name] = build_msbwt_with_index(
            reads, lengths, sorted_insert, base.bwt[: base.n], 2000,
            device=cuda, merge=merge)
        launched = merge_insert.launches - before
        assert launched > 0 if name == "kernel" else launched == 0
    (idx_k, pk), (idx_p, pp) = out["kernel"], out["plain"]
    assert torch.equal(idx_k.bwt, idx_p.bwt)
    assert torch.equal(pk.table, pp.table)
    assert idx_k.n == base.n + int(lengths.sum()) + 1500


def test_streamed_build_kernel_matches_plain(cuda):
    reads, lengths = _ragged(3000, 25)
    b = StreamingBuilder(device=cuda)
    before = merge_insert.launches
    for i in range(0, 3000, 700):
        b.add_batch(reads[i: i + 700], lengths[i: i + 700])
    assert merge_insert.launches > before
    idx_p, _ = build_msbwt_with_index(reads, lengths, device=cuda,
                                      merge=merge_insert_plain)
    assert torch.equal(b.finish(device_out=True), idx_p.bwt[: idx_p.n])
