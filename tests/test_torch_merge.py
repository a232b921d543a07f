"""The port's merge-insert pass (the plain version of the CUDA kernel) on CPU.

``merge_insert(old, q, v, active)`` on CPU tensors runs
``merge_insert_slots`` (``insert_maps`` + ``merge_insert_plain``).

Three cases run against the JAX package's own Pallas kernel in interpret
mode (``merge_insert_phys(..., interpret=True)``, ~7 s each here): sparse,
masked, and one chunk with >= 128*K inserts (the kernel's wide path). Its
phys buffer and 64-lane fused table are put on the port's logical layout by
``utils.convert.state_from_jax_phys``. Many cheap cases run against a numpy
oracle. Every comparison is bit-exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rust_msbwt_tpu.ops.pallas_merge import CS, K_VIEWS, merge_insert_phys, to_phys

from rust_msbwt_tpu_torch.ops.merge_insert import (
    insert_maps,
    merge_insert,
    merge_insert_plain,
    merge_insert_slots,
    packed_table_plain,
)
from rust_msbwt_tpu_torch.utils.convert import state_from_jax_phys
from test_torch_gpu import EDGE_KINDS, _edge_case
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _case(n_old, n_ins, extra, seed, frac_active=1.0, clustered_at=None):
    r = np.random.default_rng(seed)
    old = r.integers(0, 6, n_old).astype(np.uint8)
    active = r.random(n_ins) < frac_active
    m = int(active.sum())
    if clustered_at is None:
        q = r.choice(n_old + m, size=n_ins, replace=False).astype(np.int32)
    else:
        q = (clustered_at + np.arange(n_ins)).astype(np.int32)
    v = r.integers(0, 6, n_ins).astype(np.uint8)
    n_cap = n_old + m + extra
    buf = np.full(n_cap, 7, np.uint8)
    buf[:n_old] = old
    return buf, q, v, active


def _oracle(buf, q, v, active):
    """Merged buffer + packed table, by plain numpy loops over the definition."""
    n_old = int(np.count_nonzero(buf != 7))
    qa, va = q[active], v[active]
    out = np.full(buf.size, 7, np.uint8)
    out[qa] = va
    rest = np.ones(buf.size, bool)
    rest[qa] = False
    out[np.flatnonzero(rest)[:n_old]] = buf[:n_old]
    nb = -(-buf.size // 128)
    padded = np.full(nb * 128, 7, np.uint8)
    padded[: buf.size] = out
    table = np.zeros((nb + 1, 32), np.int64)
    for b in range(nb + 1):
        before = padded[: b * 128]
        table[b, :6] = [np.count_nonzero(before == s) for s in range(6)]
        if b < nb:
            for p in range(3):
                for j in range(4):
                    bits = (padded[b * 128 + 32 * j: b * 128 + 32 * j + 32] >> p) & 1
                    table[b, 8 + 4 * p + j] = int(
                        sum(int(x) << k for k, x in enumerate(bits)))
    table = np.where(table >= 2**31, table - 2**32, table).astype(np.int32)
    return out, table


def _port(buf, q, v, active):
    new, table, m = merge_insert(torch.from_numpy(buf), torch.from_numpy(q),
                                 torch.from_numpy(v), torch.from_numpy(active))
    return new.numpy(), table.numpy(), int(m)


@pytest.mark.parametrize("case", [
    dict(n_old=3000, n_ins=500, extra=41, seed=1),                       # sparse
    dict(n_old=3000, n_ins=600, extra=0, seed=2, frac_active=0.5),       # masked
    dict(n_old=3000, n_ins=128 * K_VIEWS + 64, extra=5, seed=3,          # wide path
         clustered_at=1000),
], ids=["sparse", "masked", "wide"])
def test_merge_matches_jax_kernel(case):
    buf, q, v, active = _case(**case)
    n_cap = buf.size
    phys = to_phys(jnp.asarray(buf.astype(np.int32)), n_cap)
    new_phys, tab_phys, jm = merge_insert_phys(
        phys, jnp.asarray(q), jnp.asarray(v.astype(np.int32)), jnp.asarray(active),
        interpret=True,
    )
    new, table, m = _port(buf, q, v, active)
    counts = [int(np.count_nonzero(new == s)) for s in range(6)]
    jbuf, jtable = state_from_jax_phys(np.asarray(new_phys), np.asarray(tab_phys),
                                       counts, n_cap, cs=CS)
    assert m == int(jm) == int(active.sum())
    assert np.array_equal(new, jbuf.numpy())
    assert np.array_equal(table, jtable.numpy())


@pytest.mark.parametrize("n_old,n_ins,extra,frac", [
    (0, 1, 0, 1.0), (0, 5, 59, 1.0), (1, 1, 126, 1.0), (127, 1, 0, 1.0),
    (128, 0, 0, 1.0), (100, 28, 0, 1.0), (1000, 300, 37, 1.0), (4096, 1024, 0, 1.0),
    (500, 100, 0, 0.5), (2000, 400, 13, 0.1), (300, 300, 0, 1.0), (5000, 1, 7, 1.0),
])
def test_merge_matches_oracle(n_old, n_ins, extra, frac):
    buf, q, v, active = _case(n_old, n_ins, extra, seed=n_old + 3 * n_ins, frac_active=frac)
    want_new, want_table = _oracle(buf, q, v, active)
    new, table, m = _port(buf, q, v, active)
    assert m == int(active.sum())
    assert np.array_equal(new, want_new)
    assert np.array_equal(table, want_table)


@pytest.mark.parametrize("at", [0, 700, 1300])
def test_merge_clustered_matches_oracle(at):
    buf, q, v, active = _case(1300, 700, 3, seed=at, clustered_at=at)
    want_new, want_table = _oracle(buf, q, v, active)
    new, table, _ = _port(buf, q, v, active)
    assert np.array_equal(new, want_new) and np.array_equal(table, want_table)


def test_insert_maps():
    q = torch.tensor([4, 0, 9, 2], dtype=torch.int32)
    v = torch.tensor([5, 1, 3, 0], dtype=torch.uint8)
    active = torch.tensor([True, True, False, True])
    ins, tmap, m = insert_maps(6, q, v, active)
    assert ins[:6].tolist() == [2, 0, 1, 0, 6, 0]  # slot 9 (inactive) dropped
    assert tmap.tolist() == [1, 1, 2, 2, 3, 3]
    assert int(m) == 3


def test_packed_table_bit31_and_pad():
    """Plane words with bit 31 set are negative int32; PAD sets all planes."""
    sym = np.full(200, 5, np.uint8)  # T = 0b101: planes 0 and 2 all ones
    table = packed_table_plain(torch.from_numpy(sym)).numpy()
    assert table.shape == (3, 32)
    assert (table[0, 8:12] == -1).all() and (table[0, 12:16] == 0).all()
    assert (table[0, 16:20] == -1).all()
    assert table[1, :6].tolist() == [0, 0, 0, 0, 0, 128]
    # bin 1 holds 72 T then 56 PAD (=7): plane 1 is set only on the PAD tail
    assert table[1, 12:16].tolist() == [0, 0, -256, -1]
    assert table[2].tolist() == [0, 0, 0, 0, 0, 200] + [0] * 26


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    buf, q, v, active = _case(1000, 100, 3, seed=9)
    q, v, active = torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(active)
    ins, tmap, _ = insert_maps(buf.size, q, v, active)
    old = torch.from_numpy(buf)
    before = merge_insert.launches
    a = merge_insert(old, q, v, active)
    b = merge_insert_plain(old, ins[: buf.size], tmap)
    assert merge_insert.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[2]) == int(active.sum())


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a card is refused, never
    quietly computed by the plain version."""
    old = torch.empty(256, dtype=torch.uint8, device="meta")
    q = torch.empty(16, dtype=torch.int32, device="meta")
    v = torch.empty(16, dtype=torch.uint8, device="meta")
    active = torch.empty(16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        merge_insert(old, q, v, active)


def test_merge_writes_into_given_buffers():
    buf, q, v, active = _case(900, 100, 0, seed=4)
    out = torch.empty(buf.size, dtype=torch.uint8)
    table = torch.empty((-(-buf.size // 128) + 1, 32), dtype=torch.int32)
    new, tab, _ = merge_insert_slots(torch.from_numpy(buf), torch.from_numpy(q),
                                     torch.from_numpy(v), torch.from_numpy(active),
                                     out=out, table=table)
    assert new.data_ptr() == out.data_ptr() and tab.data_ptr() == table.data_ptr()
    want_new, want_table = _oracle(buf, q, v, active)
    assert np.array_equal(out.numpy(), want_new)
    assert np.array_equal(table.numpy(), want_table)


TILE = 16384  # positions per tile of the CUDA kernel (csrc/merge_insert.cu kTile)


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_merge_tile_edges_match_oracle(kind):
    buf, q, v, active = _edge_case(kind, len(kind), TILE)
    want_new, want_table = _oracle(buf, q, v, active)
    new, table, m = _port(buf, q, v, active)
    assert m == int(active.sum())
    assert np.array_equal(new, want_new)
    assert np.array_equal(table, want_table)
