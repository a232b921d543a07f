"""Plain reference: the multi-string BWT of a read set under sorted
insertion, and its packed rank table, in PyTorch on any device.

Semantics (those of msbwt2's sorted insertion, which the port's build and
its sorted appends keep). Each read s_r ends in its own terminator $_r;
the terminators sort below every base and among themselves in the order
of the reads sorted as strings ``s + '$'``. The BWT lists, for every
suffix of every ``s_r $_r`` in sorted order, the symbol before it, and $
(0) before a whole read. Reads that are equal give the same symbols
whichever order their terminators take, so the order among them is free.
An append of sorted reads onto a base built this way gives the BWT of the
union built this way, which is what this reference computes for it.

Method: suffix sorting by prefix doubling over the concatenation of the
reads, each followed by its $. The first key of a position is its next 10
symbols (zeros from its $ on) and, where its $ lies among them, its read's
rank: so two suffixes never compare past a $, and equal suffixes order by
their reads. Each round then sorts by (rank of the h-prefix, rank of the
h-prefix h on), until every rank is distinct. A round is one
``torch.sort`` of n int64 keys.
"""

from __future__ import annotations

import torch

PAD = 7     # the symbol past n in the port's padded buffer
BIN = 128   # symbols a table row
ROW = 32    # int32 lanes a table row
SIGMA = 6   # $ A C G N T
OCC_LANES = list(range(SIGMA))           # occurrences before the row's bin
PLANE_LANES = list(range(8, 8 + 3 * 4))  # three bit planes of four words
_K0 = 10     # symbols in the first key (3 bits each)
_WORD = 21   # symbols in one int64 word of a read's sort key
_CHUNK = 1 << 25


def read_ranks(rows: torch.Tensor) -> torch.Tensor:
    """The rank (int64) of each read among the reads sorted as ``s + '$'``:
    rows are zero past their length, and $ == 0, so a row compares like its
    string. A stable LSD sort over 21-symbol words; equal reads keep their
    order."""
    N, L = rows.shape
    dev = rows.device
    shifts = 3 * torch.arange(_WORD - 1, -1, -1, device=dev)
    order = torch.arange(N, device=dev)
    for w in reversed(range(-(-L // _WORD))):
        part = rows[:, w * _WORD:(w + 1) * _WORD].long()
        if part.shape[1] < _WORD:
            part = torch.nn.functional.pad(part, (0, _WORD - part.shape[1]))
        key = (part << shifts).sum(1)
        order = order[torch.sort(key[order], stable=True).indices]
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(N, device=dev)
    return rank


def _dense_rank(key: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Ranks of ``key``'s values (0 for the smallest, equal values equal)
    and their number; frees ``key``'s sorted copy as it goes."""
    vals, order = torch.sort(key)
    n = vals.numel()
    new = torch.ones(n, dtype=torch.bool, device=vals.device)
    torch.ne(vals[1:], vals[:-1], out=new[1:])
    del vals
    dense = torch.cumsum(new, 0)
    del new
    dense -= 1
    rank = torch.empty(n, dtype=torch.int64, device=dense.device)
    rank[order] = dense
    return rank, int(dense[-1]) + 1 if n else 0


def msbwt(parts, device) -> torch.Tensor:
    """The BWT (uint8 ``[n]`` on ``device``) of the reads of ``parts``, a
    list of ``(reads u8 [N_i, L_i], lengths i32 [N_i])`` host arrays taken
    together in this order; n = sum(lengths) + N."""
    dev = torch.device(device)
    L = max(int(r.shape[1]) for r, _ in parts)
    rows = torch.zeros((sum(int(r.shape[0]) for r, _ in parts), L + 1),
                       dtype=torch.uint8, device=dev)
    lengths, a = [], 0
    for r, ln in parts:
        rows[a: a + r.shape[0], : r.shape[1]] = torch.as_tensor(r).to(dev)
        lengths.append(torch.as_tensor(ln).to(dev).long())
        a += r.shape[0]
    lengths = torch.cat(lengths)
    N = rows.shape[0]
    col = torch.arange(L + 1, device=dev)
    rows[col[None, :] >= lengths[:, None]] = 0  # zero past each read: its $ and after
    rr = read_ranks(rows[:, :L])
    text = rows[col[None, :] <= lengths[:, None]]  # each read, then its $
    del rows
    n = text.numel()
    if n >= 2**30 or N >= 2**30:
        raise ValueError("the reference keys hold fewer than 2^30 symbols")
    owner = torch.repeat_interleave(torch.arange(N, device=dev, dtype=torch.int32),
                                    lengths + 1)
    dollar = torch.cumsum(lengths + 1, 0) - 1  # each read's $ position
    rbits = max(1, N.bit_length())
    padded = torch.cat([text, torch.zeros(_K0, dtype=torch.uint8, device=dev)])
    key = torch.empty(n, dtype=torch.int64, device=dev)
    for a in range(0, n, _CHUNK):
        b = min(n, a + _CHUNK)
        own = owner[a:b].long()
        dist = dollar[own] - torch.arange(a, b, device=dev)  # symbols before the $
        k = torch.zeros(b - a, dtype=torch.int64, device=dev)
        for t in range(_K0):
            s = padded[a + t: b + t].long()
            k |= torch.where(dist >= t, s, 0) << (3 * (_K0 - 1 - t))
        key[a:b] = (k << rbits) | torch.where(dist < _K0, rr[own] + 1, 0)
    del owner, dollar, rr
    rank, groups = _dense_rank(key)
    del key
    h = _K0
    while groups < n:
        nxt = torch.zeros(n, dtype=torch.int64, device=dev)
        nxt[: max(n - h, 0)] = rank[h:]
        key = (rank << 30) | nxt
        del nxt, rank
        rank, groups = _dense_rank(key)
        del key
        h *= 2
    bwt = torch.empty(n, dtype=torch.uint8, device=dev)
    bwt[rank] = torch.roll(text, 1)  # the symbol before each suffix; $ before a read
    return bwt


def packed_table(bwt: torch.Tensor, block_bins: int = 1 << 18) -> torch.Tensor:
    """The packed rank table of a BWT (int32 ``[ceil(n/128) + 1, 32]``):
    row b holds in lanes 0..5 the occurrences of each symbol before bin b,
    and in lanes 8 + 4p + j bit p of the symbols at bin positions 32j ..
    32j + 31 (bit k of the word for position 32j + k), PAD past n; the last
    row holds the totals. Lanes 6, 7 and 20..31 are left 0."""
    n = bwt.numel()
    dev = bwt.device
    nb = -(-n // BIN)
    padded = torch.full((nb * BIN,), PAD, dtype=torch.uint8, device=dev)
    padded[:n] = bwt
    table = torch.zeros((nb + 1, ROW), dtype=torch.int32, device=dev)
    running = torch.zeros(SIGMA, dtype=torch.int64, device=dev)
    bit = torch.arange(32, device=dev)
    for a in range(0, nb, block_bins):
        b = min(nb, a + block_bins)
        sub = padded[a * BIN: b * BIN].view(b - a, BIN)
        for s in range(SIGMA):
            cnt = (sub == s).sum(1)
            incl = torch.cumsum(cnt, 0)
            table[a:b, s] = (running[s] + incl - cnt).int()
            running[s] += incl[-1]
        w = sub.view(b - a, 4, 32).long()
        for p in range(3):
            words = (((w >> p) & 1) << bit).sum(2)
            table[a:b, 8 + 4 * p: 12 + 4 * p] = torch.where(
                words >= 2**31, words - 2**32, words).int()
    table[nb, :SIGMA] = running.int()
    return table


def starts_of(table: torch.Tensor) -> torch.Tensor:
    """The C array (int32 ``[7]``): symbols below each symbol, and n."""
    totals = table[-1, :SIGMA].long()
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=table.device),
                      torch.cumsum(totals, 0)]).int()
