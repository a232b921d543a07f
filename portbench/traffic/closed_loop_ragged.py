"""Closed-loop one-shot builds of a ragged read set: the ``build`` op of
``closed_loop`` (one client, back to back, each call waiting for the last,
``READ_SETS`` read sets drawn from the seed in set-up and taken in turn),
with read lengths from a distribution in place of one fixed length.

The configuration's ``read_lengths`` fixes the lengths: a gamma of the
given ``mean`` and ``sd`` (the shape of Badread's ``--length mean,sd``),
the i-th length its quantile at (i + 0.5) / ``reads``, rounded. So every
seed and every read set has the same lengths; the seed only shuffles
their order and draws the reads: a uniform start in [0, G - length], a
uniform strand, then substitutions and N calls at the configuration's
rates. Reads are drawn on the device in chunks of at most ``data._CHUNK``
bases and copied to the host once, as the ``[N, L_max]`` uint8 array
(zero past each read) and the ``[N]`` int32 lengths the entry takes.

The warm-up op builds a small subset (``warm_rows``), which loads every
kernel and host library the window's builds run without repeating their
work, and the staging buffers are sized from the sets' symbol count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data
from portbench.traffic import closed_loop

READ_SETS = closed_loop.READ_SETS
WARM_READS = 64   # reads of the warm-up build
BIN = 128         # symbols a row of the entry's packed table


def gamma_lengths(n: int, mean: float, sd: float) -> np.ndarray:
    """The quantiles of a gamma of ``mean`` and ``sd`` at (i + 0.5) / n,
    i = 0..n-1, rounded to the nearest integer (int64, ascending): the
    regularized lower incomplete gamma solved by bisection in float64.

    >>> gamma_lengths(4, 150, 130).tolist()
    [30, 83, 154, 294]
    """
    k = torch.tensor((mean / sd) ** 2, dtype=torch.float64)
    theta = sd * sd / mean
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    lo = torch.zeros(n, dtype=torch.float64)
    hi = torch.full((n,), 1.0, dtype=torch.float64)
    while n and bool((torch.special.gammainc(k, hi) < p).any()):
        hi *= 2
    for _ in range(100):  # far below one base: the interval halves each step
        mid = 0.5 * (lo + hi)
        below = torch.special.gammainc(k, mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return torch.round(0.5 * (lo + hi) * theta).long().clamp_(min=1).numpy()


def config_lengths(cfg: dict) -> np.ndarray:
    """The configuration's ``reads`` lengths, ascending (int64)."""
    model = cfg["read_lengths"]
    if model["model"] != "gamma":
        raise ValueError(f"unknown read-length model {model['model']!r}")
    return gamma_lengths(cfg["reads"], model["mean"], model["sd"])


def ragged_reads(codes: torch.Tensor, cfg: dict, lengths: np.ndarray, count: int,
                 seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``count`` read sets of ``lengths`` each, drawn with generator seed
    ``seed`` on the genome's device: uint8 ``[count * N, L_max]``, zero
    past each read; set k is rows [k N, (k + 1) N) and row i of it has
    length ``lengths[perm_k[i]]`` for its own seeded permutation
    ``perm_k``. Returns ``(reads, lengths int32 [count * N])``."""
    dev = codes.device
    G, N = codes.numel(), len(lengths)
    L = int(lengths.max())
    if not (0 < int(lengths.min()) and L <= G):
        raise ValueError(f"read lengths {int(lengths.min())}..{L} outside the genome of {G}")
    g = data.generator(seed, dev)
    lens = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    lens = torch.cat([lens[torch.randperm(N, generator=g, device=dev)] for _ in range(count)])
    lut = torch.tensor(data._SYMBOL_OF_CODE, dtype=torch.uint8, device=dev)
    out = torch.zeros((count * N, L), dtype=torch.uint8, device=dev)
    ends = torch.cumsum(lens, 0).cpu().numpy()
    a = 0
    while a < len(ends):  # rows [a, b): at most data._CHUNK bases, at least one row
        first = ends[a - 1] if a else 0
        b = max(a + 1, int(np.searchsorted(ends, first + data._CHUNK, side="right")))
        ln = lens[a:b]
        m, total = b - a, int(ends[b - 1] - first)
        start = (torch.rand(m, generator=g, dtype=torch.float64, device=dev)
                 * (G - ln + 1).double()).long()
        reverse = torch.randint(0, 2, (m,), generator=g, device=dev).bool()
        row = torch.repeat_interleave(torch.arange(m, device=dev), ln)
        t = torch.arange(total, device=dev) - (torch.cumsum(ln, 0) - ln)[row]
        rev = reverse[row]
        # on the reverse strand base t of the read is the complement of the
        # window's base (length - 1 - t): A<->T, C<->G
        c = codes[start[row] + torch.where(rev, ln[row] - 1 - t, t)]
        c = torch.where(rev, 3 - c, c)
        sub = torch.rand(total, generator=g, device=dev) < cfg["substitution_rate"]
        shift = torch.randint(1, 4, (total,), generator=g, dtype=torch.uint8, device=dev)
        s = lut[torch.where(sub, (c + shift) % 4, c).long()]
        if cfg.get("n_rate", 0.0) > 0:
            call_n = torch.rand(total, generator=g, device=dev) < cfg["n_rate"]
            s = torch.where(call_n, data._N, s)
        out[a + row, t] = s
        a = b
    return out, lens.int()


def warm_rows(lengths: np.ndarray, count: int = WARM_READS) -> np.ndarray:
    """Rows of a set for the warm-up build: ``count`` reads spread evenly
    over the shortest quarter of the lengths, so the build is ragged, its
    mean length (and so its radix) that of short reads of the set, and its
    passes a quarter-length's, few beside the window's."""
    order = np.argsort(lengths, kind="stable")
    quarter = order[: max(1, len(order) // 4)]
    return np.sort(quarter[np.linspace(0, len(quarter) - 1, min(count, len(quarter))).astype(int)])


def staging(outs: dict, n: int, pin: bool) -> dict:
    """Host buffers for the outputs of a build of ``n`` symbols, as the
    entry shapes them: the buffer ``[ceil(n / 128) * 128]``, the table and
    ``occ`` ``[ceil(n / 128) + 1, ...]``; the other tensors as in ``outs``
    (another build's outputs), whose dtypes all take."""
    rows = -(-n // BIN)
    first = {"bwt": rows * BIN, "table": rows + 1, "occ": rows + 1}
    return {k: torch.empty((first.get(k, v.shape[0]), *v.shape[1:]), dtype=v.dtype,
                           pin_memory=pin)
            for k, v in outs.items() if isinstance(v, torch.Tensor)}


class Session(closed_loop.Session):
    """``closed_loop.Session`` for the ``build`` op over ragged read sets:
    its own set-up draws the sets and warms up on a subset; the op, the
    check and the free are the parent's, and so is the step between ops
    once the staging buffers fit the outputs."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, *, control=False):
        from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index

        if cfg["insertion"] != "sorted":
            raise ValueError("the reference holds sorted insertion only")
        if mix["op"] != "build":
            raise ValueError(f"ragged reads take the build op, not {mix['op']!r}")
        self.build = build_msbwt_with_index
        self.device = torch.device(device)
        self.sorted = not control  # the control: the program's chronological insertion
        self.phases, t0 = {}, time.perf_counter()
        codes = data.genome(cfg, self.device)
        closed_loop._sync(self.device)
        self.phases["genome_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        self.base_kw, self.base_n, self.base_parts = {}, 0, []
        n, count = cfg["reads"], READ_SETS
        reads, lengths = ragged_reads(codes, cfg, config_lengths(cfg), count,
                                      data.stream(seed, "inputs"))
        reads, lengths = reads.cpu().numpy(), lengths.cpu().numpy()
        self.sets = [(reads[k * n: (k + 1) * n], lengths[k * n: (k + 1) * n])
                     for k in range(count)]
        del codes
        self.phases["inputs_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        rng = np.random.default_rng(data.stream(seed, "checked"))
        self.drawn = int(rng.integers(count))
        self.kept = self.last = self.out = self.inp = None
        # warm-up: a small ragged build through the same entry
        reads, lengths = self.sets[-1]
        rows = warm_rows(lengths)
        res = closed_loop._outputs(self.build(reads[rows, : int(lengths[rows].max())],
                                              lengths[rows], self.sorted, device=self.device))
        self.pin = self.device.type == "cuda"
        self.stage = staging(res, int(lengths.sum()) + n, self.pin)
        del res
        closed_loop._sync(self.device)
        self.phases["warm_s"] = time.perf_counter() - t0

    def after(self, i: int, last: bool) -> None:
        if i == self.drawn:  # outputs shaped otherwise than ``staging`` says get their own
            for k, v in closed_loop._outputs(self.out).items():
                if k in self.stage and self.stage[k].shape != v.shape:
                    self.stage[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=self.pin)
        super().after(i, last)
