"""The LF-step kernels' plain twins (``ops/lf.py``) against the JAX package,
on CPU.

On CPU tensors ``lf_stage`` and the four ``lf_walk`` wrappers run their
plain PyTorch twins and launch nothing. The stage column is held against
the JAX package's ``_pallas_stage_step`` (Pallas interpret mode) column by
column from the same stage-1 carry, and at edge shapes (N = 1, every read
inactive, P == n with n % 128 == 0, every P in the last bin) against a
numpy oracle and the JAX package's C array and ``rank_packed``. The walks
are held against ``terminator_positions``, ``read_lengths_from_bwt``,
``_extract_impl`` and ``_locate_walk_impl`` on the read kinds of
tests/test_torch_extend.py and on a base of n % 128 == 0 symbols. The same
cases run on the card, kernel against twin, in tests/test_torch_gpu.py.
Every output is an integer: bit-exact throughout (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rust_msbwt_tpu.ops import bcr as jbcr
from rust_msbwt_tpu.ops import extract as jextract
from rust_msbwt_tpu.ops import pallas_merge as jpm
from rust_msbwt_tpu.ops.packed_rank import pack_index as j_pack_index
from rust_msbwt_tpu.ops.packed_rank import rank_packed as j_rank_packed
from rust_msbwt_tpu.ops.rank import build_occ_index as j_build_occ_index

from rust_msbwt_tpu_torch.ops import bcr, lf
from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert_slots
from rust_msbwt_tpu_torch.ops.packed_rank import lf_step
from rust_msbwt_tpu_torch.ops.rank import PAD
from test_torch_extend import KINDS, N_BASE, _case, _pad
from test_torch_gpu import (
    LF_STAGE_KINDS,
    LF_WALK_KINDS,
    lf_stage_args,
    lf_stage_case,
    lf_walk_calls,
    lf_walk_case,
)
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _launches():
    return lf.lf_stage.launches, lf.lf_walk_launches()


def test_lf_stage_matches_jax_stage_steps():
    """Every column of a ragged build (lengths 1-4, 40 reads), stepped from
    the same stage-1 carry: the merged symbols, P, counts and prev_v equal
    the JAX package's ``_pallas_stage_step`` (Pallas interpret mode) after
    each column."""
    r = np.random.default_rng(11)
    reads_l = [r.integers(1, 6, r.integers(1, 5)).astype(np.uint8) for _ in range(40)]
    reads_l[1] = reads_l[0].copy()
    p = bcr._prepare_build(*bcr.encode_reads(reads_l), True)
    N, n_cap, L = p["N"], p["n_cap"], p["L"]
    cols, lengths = torch.from_numpy(p["cols"]), torch.from_numpy(p["lengths"])

    jcols, jlen = jnp.asarray(p["cols"]), jnp.asarray(p["lengths"])
    carry = jax.jit(functools.partial(jbcr._pallas_stage1, n0=0, n_cap=n_cap,
                                      interpret=True))(
        jnp.zeros(0, jnp.uint8), jnp.arange(N, dtype=jnp.int32), jcols, jlen,
        jnp.zeros(6, jnp.int32))
    step = jax.jit(lambda j, c: jbcr._pallas_stage_step(j, c, jcols, jlen, N, True))

    cap = -(-n_cap // 128) * 128
    active = lengths >= 0
    q1 = torch.arange(N, dtype=torch.int32)
    buf, table, _ = merge_insert_slots(torch.full((cap,), PAD, dtype=torch.uint8), q1,
                                       cols[1], active)
    P, counts, prev_v = q1, lf._bump_counts(torch.zeros(6, dtype=torch.int32), cols[1],
                                            active), cols[1]
    before = _launches()
    for j in range(2, L + 2):
        carry = step(jnp.int32(j), carry)
        q, v, act, P, counts, prev_v = lf.lf_stage(j, table, N, cols, lengths, P, counts,
                                                   prev_v)
        assert q.dtype == torch.int32 and act.dtype == torch.bool and v.dtype == torch.uint8
        buf, table, _ = merge_insert_slots(buf, q, v, act)
        want = np.asarray(jpm.from_phys(carry[0], n_cap))
        assert np.array_equal(buf[:n_cap].numpy().astype(np.int32), want), j
        assert np.array_equal(P.numpy(), np.asarray(carry[2]))
        assert np.array_equal(counts.numpy(), np.asarray(carry[3]))
        assert np.array_equal(prev_v.numpy(), np.asarray(carry[4]))
    assert _launches() == before


def _stage_oracle(c):
    """One column in numpy: C array, rank by counting, the carry."""
    f = c["prev_v"].astype(np.int64)
    C = np.concatenate([[0], c["nst"] + np.cumsum(c["counts"])[:-1] - c["counts"][0]])
    rank = np.array([(c["buf"][:p] == s).sum() for p, s in zip(c["P"], f)], np.int64)
    q = C[f] + rank
    active = c["j"] <= c["lengths"] + 1
    v = c["cols"][c["j"]]
    return (q, v, active, np.where(active, q, c["P"]),
            c["counts"] + np.bincount(v[active], minlength=6), np.where(active, v, f))


@pytest.mark.parametrize("kind", LF_STAGE_KINDS)
def test_lf_stage_edges_match_oracle_and_jax(kind):
    """The column at its edge shapes equals a numpy oracle, and its slots
    equal the JAX package's C array + ``rank_packed`` on the same table."""
    case = lf_stage_case(kind, len(kind))
    args = lf_stage_args(case, "cpu")
    before = _launches()
    got = lf.lf_stage(*args)
    assert _launches() == before
    want = _stage_oracle(case)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w, np.int64))
    if kind == "inactive":
        assert not got[2].any()
    if kind == "terminal":
        assert int((args[5] == case["buf"].size).sum()) > 0
    table, f = jnp.asarray(args[1].numpy()), jnp.asarray(case["prev_v"].astype(np.int32))
    jq = (jbcr._cvec(jnp.asarray(case["counts"]), case["nst"])[f]
          + j_rank_packed(table, f, jnp.asarray(case["P"])))
    assert np.array_equal(got[0].numpy(), np.asarray(jq))


@pytest.mark.parametrize("radix", [1, 2])
def test_build_passes_one_scratch_to_every_column(radix, monkeypatch):
    """The stage loop's wiring of lf_stage's scratch: one build passes one
    zeroed int32 [8] scratch to every column (L ``lf_stage`` calls at radix
    1; at ``MSBWT_TPU_RADIX=2`` one ``lf_pair`` call a column pair and an
    ``lf_stage`` call for a bucket's last column alone, the schedule's; its
    column groups take no scratch), a second build its own; both BWTs equal
    the JAX package's build of the same reads."""
    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    seen = []

    def recording(real):
        def call(*args, **kw):
            seen.append(kw["scratch"])
            return real(*args, **kw)
        return call

    for name in ("lf_stage", "lf_pair"):
        monkeypatch.setattr(bcr, name, recording(getattr(bcr, name)))
    r = np.random.default_rng(21 + radix)
    scratches = []
    for _ in range(2):
        reads_l = [r.integers(1, 6, r.integers(1, 12)).astype(np.uint8) for _ in range(30)]
        reads, lengths = bcr.encode_reads(reads_l)
        seen.clear()
        idx, _ = bcr.build_msbwt_with_index(reads, lengths, device="cpu")
        N, L = lengths.size, reads.shape[1]
        steps = bcr.group_schedule(
            bcr.pair_buckets(bcr.bucket_schedule(0, N, L, int(lengths.sum()) + N, 128), L),
            bcr.active_counts(lengths, L), N)
        assert len(seen) == (L if radix == 1 else sum(k <= 2 for _, k, _ in steps))
        assert all(t is seen[0] for t in seen)
        assert seen[0].dtype == torch.int32 and tuple(seen[0].shape) == (8,)
        assert not seen[0].any()
        scratches.append(seen[0])
        want = jbcr.build_msbwt(*jbcr.encode_reads(reads_l), True, engine="xla")
        assert np.array_equal(idx.bwt[: idx.n].numpy(), np.asarray(want))
    assert scratches[0] is not scratches[1]
    assert scratches[0].data_ptr() != scratches[1].data_ptr()


@pytest.mark.parametrize("radix", [1, 2])
def test_two_threads_build_like_jax(radix, monkeypatch):
    """Two builds at once from two host threads on CPU tensors (each its
    own reads): each BWT equals the JAX package's build of its reads."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    r = np.random.default_rng(31 + radix)
    sets = [[r.integers(1, 6, r.integers(1, 25)).astype(np.uint8) for _ in range(60)]
            for _ in range(2)]

    def build(reads_l):
        idx, _ = bcr.build_msbwt_with_index(*bcr.encode_reads(reads_l), device="cpu")
        return idx.bwt[: idx.n].numpy()

    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(build, sets))
    for reads_l, g in zip(sets, got):
        want = jbcr.build_msbwt(*jbcr.encode_reads(reads_l), True, engine="xla")
        assert np.array_equal(g, np.asarray(want))


def test_lf_stage_takes_a_scratch_on_cpu():
    """On CPU tensors lf_stage runs its twin with or without a scratch,
    launches nothing and leaves the scratch as it was."""
    args = lf_stage_args(lf_stage_case("ragged", 41), "cpu")
    scratch = lf.stage_scratch("cpu")
    before = _launches()
    got, want = lf.lf_stage(*args, scratch=scratch), lf.lf_stage_plain(*args)
    assert _launches() == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not scratch.any()


@functools.lru_cache(maxsize=None)
def _walk_case(kind):
    """``lf_walk_case``'s tuple for the kinds of tests/test_torch_extend.py
    (new reads padded to one shape and sorted) and for its own kinds."""
    if kind in LF_WALK_KINDS:
        return lf_walk_case(kind, len(kind))
    base_l, new_l, base = _case(kind, seed=len(kind))
    reads, lens = bcr.sort_reads(*_pad(new_l))
    return base, N_BASE, max(len(s) for s in base_l) + 1, reads, lens


def _jax_walk(walk, case, args):
    base, n_strings, rot_max, reads, lengths = case
    jidx = j_build_occ_index(base)
    jpk = j_pack_index(jidx)
    if walk == "cyclic":
        return jbcr.terminator_positions(jidx, reads, lengths, rot_max)
    if walk == "lengths":
        return jbcr.read_lengths_from_bwt(jidx, n_strings)
    if walk.startswith("extract"):
        return jextract._extract_impl(jidx.bwt, jpk.table, jpk.starts,
                                      jnp.asarray(args[3].numpy()), args[4])
    return jextract._locate_walk_impl(jidx.bwt, jpk.table, jpk.starts,
                                      jnp.asarray(args[3].numpy()), jnp.int32(n_strings),
                                      args[5])


WALKS = ["cyclic", "lengths", "extract", "extract_short", "locate"]


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("kind", KINDS + LF_WALK_KINDS)
def test_lf_walks_match_jax(kind, walk):
    """Each walk's plain twin (through its wrapper, on CPU tensors) equals
    the JAX package's walk; ``extract_short`` bounds the walk 2 below the
    longest read, so some walks do not close and the clamped column 0 is
    written as in the JAX package."""
    case = _walk_case(kind)
    wrapper, _, args = lf_walk_calls(case, "cpu")[walk]
    before = _launches()
    got = wrapper(*args)
    assert _launches() == before
    want = _jax_walk(walk, case, args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), walk
    if walk == "extract_short" and case[2] - 1 > 2:  # the longest read > 2
        assert not bool(got[1].all())


@pytest.mark.parametrize("walk", ["cyclic", "extract", "locate"])
def test_lf_walks_one_walker_match_jax(walk):
    """One walker (N = 1): the last new read's search, the last read's
    extract, the last row's locate (in the last bin of n % 128 == 0)."""
    base, n_strings, rot_max, reads, lengths = case = _walk_case("aligned")
    if walk == "cyclic":
        case = (base, n_strings, rot_max, reads[-1:], lengths[-1:])
    wrapper, _, args = lf_walk_calls(case, "cpu")[walk]
    if walk != "cyclic":
        args = (*args[:3], args[3][-1:].clone(), *args[4:])
    got = wrapper(*args)
    want = _jax_walk(walk, case, args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].shape[0] == 1
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), walk


@pytest.mark.parametrize("kind", KINDS + LF_WALK_KINDS)
def test_symbols_from_table_match_bwt_on_walk_positions(kind):
    """The walk kernels' symbol decode (``symbols_from_table``, plain) on
    every position a read-length walk visits: the walks from the '$'
    rotations visit each of [0, n) exactly once (what the LF-array form of
    the read-length walk rests on) and never n or past it, and each
    position decodes to the BWT's symbol, off the port's table and off the
    JAX package's packed table of the same BWT; the padded positions of the
    last bin decode to 7 (PAD). ``aligned`` has n % 128 == 0."""
    base, n_strings = _walk_case(kind)[:2]
    idx, packed = bcr.index_from_symbols(torch.from_numpy(base))
    n = packed.n
    pos = torch.arange(n_strings, dtype=torch.int32)
    live = torch.ones(n_strings, dtype=torch.bool)
    seen = []
    while bool(live.any()):
        seen.append(pos[live].clone())
        sym = idx.bwt[pos.long()]
        live &= sym != 0
        pos = torch.where(live, lf_step(packed.table, packed.starts, torch.where(live, sym, 0),
                                         pos), pos)
    seen = torch.cat(seen)
    assert torch.equal(torch.sort(seen).values, torch.arange(n, dtype=torch.int32))
    jtable = torch.from_numpy(np.array(j_pack_index(j_build_occ_index(base)).table))
    want = torch.from_numpy(base)[seen.long()]
    assert torch.equal(lf.symbols_from_table(packed.table, seen), want)
    assert torch.equal(lf.symbols_from_table(jtable, seen), want)
    pad = torch.arange(n, -(-n // 128) * 128)
    assert bool((lf.symbols_from_table(packed.table, pad) == PAD).all())
    if kind == "aligned":
        assert n % 128 == 0 and pad.numel() == 0


def test_lf_walk_lengths_raises_on_open_walk():
    """A BWT whose walk from row 0 never meets '$' raises ValueError."""
    idx, packed = bcr.index_from_symbols(torch.tensor([1, 1, 2, 2], dtype=torch.uint8))
    with pytest.raises(ValueError, match="did not close"):
        lf.lf_walk_lengths(idx.bwt, packed.table, packed.starts, packed.n, 1)
    with pytest.raises(ValueError, match="did not close"):
        bcr.read_lengths_from_bwt(idx, 1, packed)


def test_lf_wrappers_refuse_other_devices():
    """A table on neither the CPU nor a CUDA card raises; nothing runs."""
    meta = torch.empty((3, 32), dtype=torch.int32, device="meta")
    z = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lf.lf_stage(2, meta, 4, z, z, z, z, z)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lf.lf_walk_locate(z, meta, z, z, 1, 3)
