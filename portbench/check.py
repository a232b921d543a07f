"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.msbwt``), exactly.

Each number compared counts differences, so its limit is 0:

* ``bwt_mismatch``: symbols of the returned buffer (``OccIndex.bwt``, n
  symbols then PAD up to the next 128) that differ from the reference's,
  and the difference of the two lengths;
* ``table_mismatch``: entries of the packed table
  (``PackedOccIndex.table``: occurrence lanes 0..5 and the bit-plane lanes
  8..19 of every row) and of ``OccIndex.occ`` that differ, and the
  entries of rows one side lacks;
* ``starts_mismatch``: entries of both indexes' C arrays that differ;
* ``n_mismatch``: the difference of each index's n from the reference's.
"""

from __future__ import annotations

import torch

from portbench.reference import msbwt as ref

LIMITS = {"bwt_mismatch": 0, "table_mismatch": 0, "starts_mismatch": 0, "n_mismatch": 0}


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries that differ over the common leading rows, plus the entries
    of the rows only one side has."""
    m = min(a.shape[0], b.shape[0])
    extra = (max(a.shape[0], b.shape[0]) - m) * (a[0].numel() if a.dim() > 1 else 1)
    return int((a[:m] != b[:m]).sum()) + extra


def compare(out: dict, parts, device) -> dict:
    """The numbers of one checked op. ``out`` holds the program's outputs
    as host tensors (``bwt``, ``table``, ``occ``, ``starts``,
    ``packed_starts``, ``n``, ``packed_n``); ``parts`` the op's reads, as
    ``reference.msbwt`` takes them."""
    dev = torch.device(device)
    bwt = ref.msbwt(parts, dev)
    n = bwt.numel()
    table = ref.packed_table(bwt)
    padded = torch.full(((table.shape[0] - 1) * ref.BIN,), ref.PAD, dtype=torch.uint8,
                        device=dev)
    padded[:n] = bwt
    del bwt
    starts = ref.starts_of(table)
    lanes = torch.tensor(ref.OCC_LANES + ref.PLANE_LANES, device=dev)
    got_table = out["table"].to(dev)
    numbers = {
        "bwt_mismatch": _diff(out["bwt"].to(dev), padded),
        "table_mismatch": _diff(got_table[:, lanes], table[:, lanes])
        + _diff(out["occ"].to(dev), table[:, : ref.SIGMA]),
        "starts_mismatch": _diff(out["starts"].to(dev).int(), starts)
        + _diff(out["packed_starts"].to(dev).int(), starts),
        "n_mismatch": abs(int(out["n"]) - n) + abs(int(out["packed_n"]) - n),
    }
    return numbers
