"""Read sets drawn from a configuration and a seed, made on the device.

A configuration names a genome (its length and a fixed seed: the same
genome for every run) and a read model (length, substitution rate, N
rate). Reads are drawn from ``--seed``: uniform start, uniform strand,
then substitutions (to one of the three other bases) and N calls. Symbols
are the port's alphabet ``$ A C G N T`` = 0..5.

Everything is drawn with a seeded ``torch.Generator`` on the given device
in a few large calls, then copied to the host once as the ``[N, L]``
uint8 array the build entry takes.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

# base codes 0..3 = A C G T -> the port's symbols; N is 4
_SYMBOL_OF_CODE = (1, 2, 3, 5)
_N = 4
_CHUNK = 1 << 24  # symbols drawn per call: bounds the temporaries


def stream(seed: int, *key) -> int:
    """A 64-bit generator seed for one stream of a run: ``seed`` and a key
    (strings and ints), mixed by numpy's ``SeedSequence``.

    >>> stream(7, "batch", 3) == stream(7, "batch", 3) != stream(7, "batch", 4)
    True
    """
    words = [int(seed) % 2**64]
    for k in key:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k) % 2**64)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def genome(cfg: dict, device) -> torch.Tensor:
    """The configuration's genome as base codes 0..3 (uint8), from its own
    fixed ``genome_seed``."""
    g = generator(stream(cfg["genome_seed"], "genome"), device)
    return torch.randint(0, 4, (cfg["genome_length"],), generator=g,
                         dtype=torch.uint8, device=device)


def reads(codes: torch.Tensor, cfg: dict, n: int, seed: int) -> torch.Tensor:
    """``n`` reads of ``cfg["read_length"]`` symbols (uint8 ``[n, L]`` on
    the genome's device) drawn with generator seed ``seed``."""
    dev = codes.device
    L, G = cfg["read_length"], codes.numel()
    if not 0 < L <= G:
        raise ValueError(f"read length {L} outside the genome of {G} bases")
    g = generator(seed, dev)
    lut = torch.tensor(_SYMBOL_OF_CODE, dtype=torch.uint8, device=dev)
    ar = torch.arange(L, device=dev)
    out = torch.empty((n, L), dtype=torch.uint8, device=dev)
    rows = max(1, _CHUNK // L)
    for a in range(0, n, rows):
        m = min(n, a + rows) - a
        start = torch.randint(0, G - L + 1, (m,), generator=g, device=dev)
        reverse = torch.randint(0, 2, (m, 1), generator=g, device=dev).bool()
        c = codes[start[:, None] + ar[None, :]]
        c = torch.where(reverse, 3 - c.flip(1), c)  # reverse complement: A<->T, C<->G
        sub = torch.rand((m, L), generator=g, device=dev) < cfg["substitution_rate"]
        shift = torch.randint(1, 4, (m, L), generator=g, dtype=torch.uint8, device=dev)
        c = torch.where(sub, (c + shift) % 4, c)
        s = lut[c.long()]
        call_n = torch.rand((m, L), generator=g, device=dev) < cfg.get("n_rate", 0.0)
        out[a: a + m] = torch.where(call_n, _N, s)
    return out


def reads_host(codes: torch.Tensor, cfg: dict, n: int, seed: int):
    """``reads`` copied to the host: ``(reads u8 [n, L], lengths i32 [n])``."""
    r = reads(codes, cfg, n, seed).cpu().numpy()
    return r, np.full(n, cfg["read_length"], dtype=np.int32)
