"""Card tests of the port's merge-insert kernel: the CUDA kernel against its
plain PyTorch twin on the same CUDA tensors, bit-exact (tolerance 0: every
output is an integer).

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
