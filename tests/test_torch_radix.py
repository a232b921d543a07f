"""The port's radix-2 stage (two BCR columns a merge pass) against the JAX
package, on CPU.

Forced ``MSBWT_TPU_RADIX=2`` builds of the port against the JAX package's
XLA builds and the port's own radix-1 builds (sorted, ``--unsorted``, ragged
reads with odd tails, duplicates, odd and even L, L = 1 and 2, an extend, a
bucketed build, a streamed build), a few against the JAX package's radix-2
Pallas build in interpret mode, double-column steps (``lf_pair_plain`` and
the stage loop's ``lf_pair``) against ``_pallas_stage_step2`` on uniform, ragged and
short reads (a pair with no read active in its second column), sorted and
unsorted; ``lf_pair_plain`` on the edge cases of ``tests/test_torch_gpu.py``
and the slot math above 2^30 against numpy argsort oracles;
``build_radix`` and the JAX package's each against its own rule, an
unforced extend onto a large base at radix 2, and the radix-2 bucket
schedule.
Every comparison is bit-exact (tolerance 0: every output is an integer).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_msbwt_tpu.ops import bcr as jbcr
from rust_msbwt_tpu.ops import pallas_merge as jpm
from rust_msbwt_tpu.utils.oracle import naive_bwt

from rust_msbwt_tpu_torch.ops import bcr, lf
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos
from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert_slots
from rust_msbwt_tpu_torch.ops.rank import PAD
from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder
from test_torch_gpu import LF_PAIR_KINDS, lf_pair_args, lf_pair_case, pair_tile_rule
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _reads(kind, seed):
    r = np.random.default_rng(seed)
    if kind == "even":
        return [r.integers(1, 6, 12).astype(np.uint8) for _ in range(30)]
    if kind == "odd":
        return [r.integers(1, 6, 13).astype(np.uint8) for _ in range(30)]
    if kind == "ragged":  # odd tails: reads end inside a column pair
        return [r.integers(1, 6, r.integers(1, 20)).astype(np.uint8) for _ in range(35)]
    if kind == "duplicates":
        base = [np.tile(r.integers(1, 6, r.integers(1, 4)), 5)[: r.integers(2, 12)]
                .astype(np.uint8) for _ in range(4)]
        return [base[i] for i in r.integers(0, 4, 30)]
    if kind in ("L1", "L2"):
        return [r.integers(1, 6, int(kind[1])).astype(np.uint8) for _ in range(20)]
    raise ValueError(kind)


def _port(reads_l, sorted_insert, radix, monkeypatch, **kw):
    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    reads, lengths = bcr.encode_reads(reads_l)
    idx, packed = bcr.build_msbwt_with_index(reads, lengths, sorted_insert,
                                             device="cpu", **kw)
    return idx.bwt[: idx.n].numpy(), packed.table.numpy()


KINDS = ["even", "odd", "ragged", "duplicates", "L1", "L2"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sorted_insert", [True, False])
def test_radix2_matches_jax_and_radix1(kind, sorted_insert, monkeypatch):
    reads_l = _reads(kind, seed=len(kind) + 5 * sorted_insert)
    bwt2, tab2 = _port(reads_l, sorted_insert, 2, monkeypatch)
    bwt1, tab1 = _port(reads_l, sorted_insert, 1, monkeypatch)
    want = jbcr.build_msbwt(*jbcr.encode_reads(reads_l), sorted_insert, engine="xla")
    assert np.array_equal(bwt2, np.asarray(want))
    assert np.array_equal(bwt2, bwt1) and np.array_equal(tab2, tab1)
    if sorted_insert:
        assert convert_itos(bwt2) == naive_bwt([convert_itos(s) for s in reads_l])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_radix2_extend_matches_jax(sorted_insert, monkeypatch):
    base_l, new_l = _reads("ragged", 41), _reads("odd", 42)[:9]
    base, _ = _port(base_l, True, 2, monkeypatch)
    got, tab = _port(new_l, sorted_insert, 2, monkeypatch, base=base,
                     base_string_count=len(base_l))
    ref, _ = _port(new_l, sorted_insert, 1, monkeypatch, base=base,
                   base_string_count=len(base_l))
    want = jbcr.build_msbwt(*jbcr.encode_reads(new_l), sorted_insert, base=base,
                            base_string_count=len(base_l), engine="xla")
    assert np.array_equal(got, np.asarray(want)) and np.array_equal(got, ref)
    if sorted_insert:
        assert convert_itos(got) == naive_bwt([convert_itos(s) for s in base_l + new_l])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_radix2_matches_jax_pallas_interpret(sorted_insert, monkeypatch):
    """The JAX package's own radix-2 build (Pallas, interpret mode) on ragged
    reads with duplicates: one shape, so both orders share one compile."""
    reads_l = _reads("ragged", seed=7)
    reads_l[1] = reads_l[0].copy()
    got, tab = _port(reads_l, sorted_insert, 2, monkeypatch)
    jidx, jpacked = jbcr.build_msbwt_with_index(*jbcr.encode_reads(reads_l), sorted_insert,
                                                engine="pallas")
    assert np.array_equal(got, np.asarray(jidx.bwt)[: jidx.n])
    assert np.array_equal(tab, np.asarray(jpacked.table))


def _step_reads(kind):
    """40 reads for the step test, as ``(reads, lengths)`` with a stage view
    of 8 rows: uniform (6 bp), ragged (1-6 bp) or short (2-3 bp: the pair
    (4, 5) has no read active in column 5, the pair (6, 7) none at all)."""
    r = np.random.default_rng(len(kind))
    lens = {"uniform": np.full(40, 6), "ragged": r.integers(1, 7, 40),
            "short": r.integers(2, 4, 40)}[kind]
    lens[0] = {"short": 3}.get(kind, 6)
    return bcr.encode_reads([r.integers(1, 6, k).astype(np.uint8) for k in lens])


@pytest.mark.parametrize("sorted_insert", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "ragged", "short"])
def test_stage_step2_matches_jax_step(kind, sorted_insert):
    """Three double-column steps (columns 2-3, 4-5, 6-7) from the same
    stage-1 carry: merged symbols, P, counts and prev_v after each equal the
    JAX package's ``_pallas_stage_step2`` (Pallas interpret mode), through
    ``lf_pair_plain`` and through ``lf_pair`` (the stage loop's call) alike."""
    p = bcr._prepare_build(*_step_reads(kind), sorted_insert)
    N, n_cap = p["N"], p["n_cap"]
    cols_np = np.zeros((8, N), np.uint8)
    cols_np[: p["cols"].shape[0]] = p["cols"]
    cols, lengths = torch.from_numpy(cols_np), torch.from_numpy(p["lengths"])

    # the JAX carry after stage 1, then its steps
    jcols, jlen = jnp.asarray(cols_np), jnp.asarray(p["lengths"])
    carry = jax.jit(functools.partial(jbcr._pallas_stage1, n0=0, n_cap=n_cap,
                                      interpret=True))(
        jnp.zeros(0, jnp.uint8), jnp.arange(N, dtype=jnp.int32), jcols, jlen,
        jnp.zeros(6, jnp.int32))
    step2 = jax.jit(lambda j, c: jbcr._pallas_stage_step2(j, c, jcols, jlen, N, True))

    # the port's: stage 1 through the plain pass, then each step + a pass
    cap = -(-n_cap // 128) * 128
    active = lengths >= 0
    q1 = torch.arange(N, dtype=torch.int32)
    buf, table, _ = merge_insert_slots(torch.full((cap,), PAD, dtype=torch.uint8), q1,
                                       cols[1], active)
    counts = bcr._bump_counts(torch.zeros(6, dtype=torch.int32), cols[1], active)
    state = {fn: (buf, table, q1, counts, cols[1])
             for fn in (lf.lf_pair_plain, lf.lf_pair)}
    for j in (2, 4, 6):
        carry = step2(jnp.int32(j), carry)
        want = np.asarray(jpm.from_phys(carry[0], n_cap))
        for fn, (buf, table, P, counts, prev_v) in state.items():
            q, v, act, P, counts, prev_v = fn(j, table, cap, N, cols, lengths, P, counts,
                                              prev_v)
            assert q.dtype == torch.int32 and v.dtype == torch.uint8 and q.shape == (2 * N,)
            buf, table, _ = merge_insert_slots(buf, q, v, act)
            assert np.array_equal(buf[:n_cap].numpy().astype(np.int32), want), (j, fn)
            assert np.array_equal(P.numpy(), np.asarray(carry[2]))
            assert np.array_equal(counts.numpy(), np.asarray(carry[3]))
            assert np.array_equal(prev_v.numpy(), np.asarray(carry[4]))
            state[fn] = (buf, table, P, counts, prev_v)
        if kind == "short" and j == 4:
            assert not act[N:].any() and act[:N].any()  # m2 = 0


def _pair_oracle(case):
    """``lf_pair``'s outputs for a case in numpy, its slot ranks by sorting:
    q1 from the all-A buffer's rank, inv1 and inb (the active q1 below, and
    those of the same symbol) by searchsorted over sorted slots, q2 at the
    clamped old position, f1 over sort(q2) - k."""
    j, cap, nst, cols = case["j"], case["cap"], case["nst"], case["cols"]
    n, lengths, counts = case["n"], case["lengths"].astype(np.int64), case["counts"]
    N = lengths.size

    def rank(s, pos):  # the buffer is A (1) at [0, n), PAD after
        return np.where(s == 1, np.minimum(pos, n), 0)

    def cvec(c):
        return np.array([0] + [nst + int(c[1:f].sum()) for f in range(1, 6)], np.int64)

    act1, act2 = j <= lengths + 1, j + 1 <= lengths + 1
    v1, v2 = cols[j].astype(np.int64), cols[j + 1].astype(np.int64)
    f = case["prev_v"].astype(np.int64)
    q1 = cvec(counts)[f] + rank(f, case["P"].astype(np.int64))
    counts1 = counts + np.bincount(v1[act1], minlength=6)
    inv1 = np.searchsorted(np.sort(q1[act1]), q1)
    inb = np.array([np.searchsorted(np.sort(q1[act1 & (v1 == s)]), q) for s, q in zip(v1, q1)],
                   dtype=np.int64).reshape(N)
    q2 = cvec(counts1)[v1] + rank(v1, np.clip(q1 - inv1, 0, cap)) + inb
    s = np.sort(q2[act2])
    f1 = q1 + np.searchsorted(s - np.arange(s.size), q1, side="right")
    return (np.concatenate([np.where(act1, f1, 0), np.where(act2, q2, 0)]),
            np.concatenate([v1, v2]), np.concatenate([act1, act2]),
            np.where(act2, q2, np.where(act1, f1, case["P"])),
            counts1 + np.bincount(v2[act2], minlength=6),
            np.where(act2, v2, np.where(act1, v1, f)))


@pytest.mark.parametrize("kind", LF_PAIR_KINDS + ["huge_c"])
def test_lf_pair_plain_matches_oracle(kind):
    """``lf_pair_plain`` on the card tests' column-pair cases (slots on tile
    edges, full tiles, empty tiles, tiles at their bucket's edges, clustered
    and many overfull tiles, N = 1, m2 = 0, ragged; "huge_c": slots past
    2^30) equals the numpy argsort oracle; the wrapper on CPU tensors runs
    it and launches nothing."""
    # the plain twin has no tiles: the cases at the kernel's tile rule and
    # its 128-place bucket
    case = lf_pair_case(kind, len(kind), tile=pair_tile_rule, bucket=128)
    args = lf_pair_args(case, "cpu")
    before = lf.lf_pair.launches
    got = lf.lf_pair(*args, scratch=lf.stage_scratch("cpu"))
    assert lf.lf_pair.launches == before
    plain = lf.lf_pair_plain(*args)
    want = _pair_oracle(case)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w, np.int64))
    if kind == "huge_c":
        assert int(got[0].max()) > 2**30
    if kind == "no_second":
        assert not got[2][case["P"].size:].any()


@pytest.mark.parametrize("seed", range(3))
def test_pair_slots_above_2_30_match_oracle(seed):
    """Slots near 2^31 (a BWT past 2^30 symbols): the JAX package's 2^30
    sentinel would sort these after the inactive reads; the port's int32
    maximum and its masked tail keep every slot exact."""
    r = np.random.default_rng(seed)
    N, cap = 64, 2**31 - 2
    active1 = r.random(N) < 0.8
    active2 = active1 & (r.random(N) < 0.7)
    lo = 2**31 - 2**20 - 256  # q1 + N stays below 2^31 - 1, as in a build
    q1 = np.where(active1, r.choice(2**20, N, replace=False) + lo,
                  r.integers(0, 2**31 - 1, N)).astype(np.int32)
    v1 = r.integers(0, 6, N).astype(np.uint8)
    # base2 = C[v1] + R(v1, old_pos): monotone in old_pos within a symbol,
    # disjoint ranges across symbols, every value above 2^30
    C = 2**31 - 2**24 + np.arange(6, dtype=np.int64) * 2**21

    t = torch.from_numpy
    order1, inv1, old_pos = lf.pair_order(t(q1), t(active1), cap)
    base2 = t(C.astype(np.int32))[t(v1).long()] + ((old_pos - lo) // 8)
    f1, q2 = lf.pair_slots(t(q1), t(v1), t(active1), t(active2), order1, inv1, base2)

    q1l = q1.astype(np.int64)
    act = np.flatnonzero(active1)
    inv_want = np.array([(q1l[act] < q1l[i]).sum() for i in range(N)])
    inb = np.array([((q1l[act] < q1l[i]) & (v1[act] == v1[i])).sum() for i in range(N)])
    assert np.array_equal(inv1.numpy()[act], inv_want[act])
    assert np.array_equal(old_pos.numpy()[act], np.clip(q1l - inv_want, 0, cap)[act])
    q2_want = base2.numpy().astype(np.int64) + inb
    assert np.array_equal(q2.numpy()[act], q2_want[act])
    assert (q2_want[active2] >= 2**30).all()
    s = np.sort(q2_want[active2])
    assert np.unique(s).size == s.size
    for i in act:  # the q1-th slot of B2 left free by the column j+1 inserts
        f = q1l[i]
        while (g := q1l[i] + (s <= f).sum()) != f:
            f = g
        assert int(f1[i]) == f, i


# (n_cap, n_reads, n_base) and the radix each rule picks, the port's and the
# JAX package's. The JAX doctest's five shapes (100 bp, 500 bp, 1,000 bp, an
# extend of 100 bp reads onto a 505M base, an unknown shape) and the JAX
# rule's edge (999 bp gives 2, 998 bp gives 1): the two rules differ on the
# extend alone, where the port counts the base. Then shapes of the port's
# rule onto a base: the benchmark's append (100k x 100 bp onto 4M reads),
# a streamed 100 bp batch below its edge, and its edge, 1,000 buffer symbols
# a new read (2) and one symbol fewer (1).
RADIX_SHAPES = [((505_000_000, 5_000_000, 0), 1, 1), ((500_500_000, 1_000_000, 0), 1, 1),
                ((500_500_000, 500_000, 0), 2, 2), ((505_101_000, 1_000, 505_000_000), 2, 1),
                ((None, None, 0), 1, 1), ((1000 * 1000, 1000, 0), 2, 2),
                ((999 * 1000, 1000, 0), 1, 1),
                ((414_100_000, 100_000, 404_000_000), 2, 1), ((909_000, 1_000, 808_000), 1, 1),
                ((1000 * 1000, 1000, 900_000), 2, 1), ((1000 * 1000 - 1, 1000, 900_000), 1, 1)]


@pytest.mark.parametrize("env", [None, "1", "2", "auto", "3"])
@pytest.mark.parametrize("shape,port_rule,jax_rule", RADIX_SHAPES,
                         ids=["100bp", "500bp", "1000bp", "extend", "unknown", "999bp",
                              "998bp", "append", "streamed", "edge", "below_edge"])
def test_build_radix(shape, port_rule, jax_rule, env, monkeypatch):
    """The port's radix choice and the JAX package's, each against its own
    rule: unforced (and under any value but 1 and 2) the port takes radix 2
    from 1,000 buffer symbols a new read with the base counted, the JAX
    package from a new batch of mean length + 1 of 1,000, the base left
    out; ``MSBWT_TPU_RADIX=1|2`` forces either in both, at every shape."""
    if env is None:
        monkeypatch.delenv("MSBWT_TPU_RADIX", raising=False)
    else:
        monkeypatch.setenv("MSBWT_TPU_RADIX", env)
    forced = {"1": 1, "2": 2}.get(env)
    n_cap, n_reads, n_base = shape
    assert bcr.build_radix(n_cap, n_reads) == (forced or port_rule)
    assert jbcr.build_radix(n_cap, n_reads, n_base) == (forced or jax_rule)


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_unforced_extend_onto_large_base_takes_radix2(sorted_insert, monkeypatch):
    """An extend whose buffer holds 1,000 symbols and more a new read (one
    12 bp read onto 40 reads of 30 bp: 1,253 symbols) takes radix 2 by
    itself, one ``lf_pair`` call a column pair, and gives the bytes of the
    forced radix-1 extend and of the JAX package's."""
    r = np.random.default_rng(18 + sorted_insert)
    base_l = [r.integers(1, 6, 30).astype(np.uint8) for _ in range(40)]
    new_l = [r.integers(1, 6, 12).astype(np.uint8)]
    base, _ = _port(base_l, True, 1, monkeypatch)
    n_cap = base.size + 13
    monkeypatch.delenv("MSBWT_TPU_RADIX", raising=False)
    assert bcr.build_radix(n_cap, 1) == 2
    assert jbcr.build_radix(n_cap, 1, base.size) == 1
    pairs = []

    def counting(*a, **k):
        pairs.append(1)
        return lf.lf_pair(*a, **k)

    monkeypatch.setattr(bcr, "lf_pair", counting)
    reads, lengths = bcr.encode_reads(new_l)
    idx, packed = bcr.build_msbwt_with_index(reads, lengths, sorted_insert, base=base,
                                             base_string_count=40, device="cpu")
    assert idx.n == n_cap and len(pairs) == 12 // 2
    got, tab = idx.bwt[: idx.n].numpy(), packed.table.numpy()
    ref, ref_tab = _port(new_l, sorted_insert, 1, monkeypatch, base=base,
                         base_string_count=40)
    want = jbcr.build_msbwt(reads, lengths, sorted_insert, base=base,
                            base_string_count=40, engine="xla")
    assert np.array_equal(got, ref) and np.array_equal(tab, ref_tab)
    assert np.array_equal(got, np.asarray(want))
    if sorted_insert:
        assert convert_itos(got) == naive_bwt([convert_itos(s) for s in base_l + new_l])


def test_bucket_growth_env(monkeypatch):
    for raw, want in ((None, 1.3), ("2", 2.0), ("1.0", 1.05), ("9", 4.0), ("x", 1.3)):
        if raw is None:
            monkeypatch.delenv("MSBWT_TPU_BUCKET_GROWTH", raising=False)
        else:
            monkeypatch.setenv("MSBWT_TPU_BUCKET_GROWTH", raw)
        assert bcr._bucket_growth() == want == jbcr._bucket_growth()
    monkeypatch.setenv("MSBWT_TPU_BUCKET_GROWTH", "1.2")
    assert bcr.bucket_schedule(0, 10, 20, 220, 16) == jbcr.bucket_schedule(0, 10, 20, 220, 16)


@pytest.mark.parametrize("growth", [1.05, 1.2, 1.3, 1.5, 2.0, 3.0, 4.0])
def test_bucket_schedules_at_every_growth(growth):
    """Both schedules (radix 1 and the paired one) cover stages [2, L + 2)
    with chunk-aligned, sufficient, non-decreasing capacities; the radix-1
    schedule equals the JAX package's; the paired one has even buckets but
    the last and holds every pair's end."""
    for n0, N, L, chunk in [(0, 10, 20, 16), (37, 7, 100, 64), (0, 1000, 100, 8192),
                            (5, 3, 8, 8), (0, 4, 1, 16), (0, 4, 2, 16)]:
        n_cap = n0 + N * (L + 1) + N
        sched = bcr.bucket_schedule(n0, N, L, n_cap, chunk, growth=growth)
        assert sched == jbcr.bucket_schedule(n0, N, L, n_cap, chunk, growth=growth)
        paired = bcr.pair_buckets(sched, L)
        for s in (sched, paired):
            assert s[0][0] == 2 and s[-1][1] == L + 2
            prev_jb, prev_cap = 2, 0
            for ja, jb, cap in s:
                assert ja == prev_jb and jb > ja and cap % chunk == 0
                assert cap >= n0 + (jb - 1) * N and cap >= prev_cap
                prev_jb, prev_cap = jb, cap
        assert all((jb - ja) % 2 == 0 for ja, jb, _ in paired[:-1])
        assert paired[0][2] >= n0 + N  # stage 1 runs in the first bucket


def _launches_of(reads_l, monkeypatch, radix, growth="1.3"):
    """Passes of a build, counted at the merge function."""
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return merge_insert_slots(*a, **k)

    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    monkeypatch.setenv("MSBWT_TPU_BUCKET_GROWTH", growth)
    reads, lengths = bcr.encode_reads(reads_l)
    idx, _ = bcr.build_msbwt_with_index(reads, lengths, device="cpu", merge=counting)
    return idx.bwt[: idx.n].numpy(), len(calls)


@pytest.mark.parametrize("L", [10, 11])
def test_bucketed_radix2_small_growth(L, monkeypatch):
    """Many buckets (growth 1.2): the radix-2 build equals the oracle and
    takes 1 + ceil(L / 2) passes against radix 1's 1 + L."""
    r = np.random.default_rng(L)
    reads_l = [r.integers(1, 6, L).astype(np.uint8) for _ in range(25)]
    got2, n2 = _launches_of(reads_l, monkeypatch, 2, "1.2")
    got1, n1 = _launches_of(reads_l, monkeypatch, 1, "1.2")
    assert len(bcr.bucket_schedule(0, 25, L, 25 * (L + 1), 128, 1.2)) > 1
    assert convert_itos(got2) == naive_bwt([convert_itos(s) for s in reads_l])
    assert np.array_equal(got1, got2)
    assert (n1, n2) == (1 + L, 1 + -(-L // 2))


def test_bucketed_ragged_radix2_matches_oracle(monkeypatch):
    r = np.random.default_rng(12)
    reads_l = [r.integers(1, 6, int(r.integers(4, 16))).astype(np.uint8) for _ in range(20)]
    got, _ = _launches_of(reads_l, monkeypatch, 2, "1.2")
    assert convert_itos(got) == naive_bwt([convert_itos(s) for s in reads_l])


def test_streamed_radix2_matches_one_shot(monkeypatch):
    reads_l = _reads("ragged", 51) + _reads("odd", 52)
    reads, lengths = bcr.encode_reads(reads_l)
    want, _ = _port(reads_l, True, 1, monkeypatch)
    monkeypatch.setenv("MSBWT_TPU_RADIX", "2")
    b = StreamingBuilder(device="cpu")
    for i in range(0, len(reads_l), 17):
        b.add_batch(reads[i: i + 17], lengths[i: i + 17])
    assert np.array_equal(b.finish(), want)
