"""Carry state across from the JAX package: numpy arrays in, port tensors out.

The parity tests run the JAX package and the port on the same input and
compare what each computes; these converters put both on the port's
logical layout (``uint8`` buffer, ``PackedOccIndex`` table). They take
numpy arrays only, so this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.packed_rank import ROW, PackedOccIndex
from rust_msbwt_tpu_torch.ops.rank import BIN, OccIndex


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # own copy


def occ_index_from_numpy(bwt, occ, starts, n: int, device) -> OccIndex:
    """An ``OccIndex`` from its numpy parts (``bwt`` u8 [nb*128], ``occ``
    i32 [nb+1, 6], ``starts`` i32 [7])."""
    return OccIndex(bwt=_t(bwt, np.uint8, device), occ=_t(occ, np.int32, device),
                    starts=_t(starts, np.int32, device), n=int(n))


def packed_index_from_numpy(table, starts, n: int, device) -> PackedOccIndex:
    """A ``PackedOccIndex`` from its numpy parts (``table`` i32 [nb+1, 32])."""
    return PackedOccIndex(table=_t(table, np.int32, device),
                          starts=_t(starts, np.int32, device), n=int(n))


def state_from_jax_phys(phys, table_phys, counts, n_cap: int, *, cs: int = 128,
                        device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A JAX merge-kernel carry -> the port's ``(buffer u8 [n_cap],
    table i32 [NB+1, 32])``, NB = ceil(n_cap / 128).

    ``phys`` is the int32 ``[rows, 128]`` phys buffer (one front-guard chunk
    of ``cs * 128`` elements, then the logical buffer), ``table_phys`` the
    fused table (logical bin b at row b + cs; lanes 0..5 occ, plane-p byte
    qword q at lane ``base + 16p + q`` with base 8 for the 64-lane table and
    32 for the 128-lane one), ``counts`` the [6] symbol totals (terminal
    row). Applies the JAX package's ``from_phys`` and
    ``_derive_indexes_from_phys`` rules in numpy.
    """
    phys = np.asarray(phys)
    table_phys = np.asarray(table_phys).astype(np.int64)
    chunk = cs * 128
    nb = -(-n_cap // BIN)
    buf = phys.reshape(-1)[chunk: chunk + n_cap].astype(np.uint8)
    body = table_phys[cs: cs + nb]
    base = 8 if table_phys.shape[1] == 64 else 32
    table = np.zeros((nb + 1, ROW), np.int64)
    table[:nb, :6] = body[:, :6]
    table[nb, :6] = np.asarray(counts)
    for p in range(3):
        q = body[:, base + 16 * p: base + 16 * p + 16] & 0xFF  # byte qwords
        table[:nb, 8 + 4 * p: 12 + 4 * p] = (
            q[:, 0::4] | (q[:, 1::4] << 8) | (q[:, 2::4] << 16) | (q[:, 3::4] << 24)
        )
    table = np.where(table >= 2**31, table - 2**32, table).astype(np.int32)
    return _t(buf, np.uint8, device), _t(table, np.int32, device)

