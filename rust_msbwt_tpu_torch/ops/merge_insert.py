"""The BCR merge-insert pass: hand-written CUDA kernel + plain PyTorch twin.

Port of the JAX package's ``ops.pallas_merge`` (TPU kernel ``_merge_kernel``,
reached through ``merge_insert_phys``). Every BCR stage rebuilds the BWT
buffer by merging N new symbols into it: ``new[p] = v[i]`` if ``p == q[i]``
for an active insert i, else ``old[p - #{active q <= p}]``, and the same pass
emits the packed rank table of the merged buffer, which the next stage
ranks against.

Layout. The buffer is a logical ``uint8`` tensor of ``n`` symbols with PAD
(7) past the valid ones; the table is exactly ``PackedOccIndex.table``
(``[ceil(n/128) + 1, 32]`` int32, see ``ops.packed_rank``). The TPU
kernel's physical layout (guard chunks, rows of 128 int32 lanes, the
64-lane fused table, the shifted-view fast path) exists for Mosaic's
limits and is not carried over.

Two halves:

* **Prep (torch ops)** — ``insert_maps``: a masked scatter of ``v + 1`` into
  an int8 insert map (inactive inserts go to a dump slot at index ``n``:
  torch has no ``mode="drop"``), then ``tmap = cumsum(ins > 0)`` in int32.
* **The pass** — ``merge_insert``: on a CUDA tensor it launches the kernel in
  ``csrc/merge_insert.cu`` (or raises); on a CPU tensor it runs
  ``merge_insert_plain``, the same function written with gather and
  ``where``. ``merge_insert.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from rust_msbwt_tpu_torch.ops.rank import BIN, PAD

ROW = 32  # int32 lanes per table row
_I32 = torch.int32


def insert_maps(n: int, q: torch.Tensor, v: torch.Tensor, active: torch.Tensor,
                *, ins: torch.Tensor | None = None, tmap: torch.Tensor | None = None):
    """Insert map and shift map for one pass over ``n`` positions.

    ``q`` [N] distinct slots in new coordinates (< n where active), ``v`` [N]
    symbols 0..5, ``active`` [N] bool. Returns ``(ins, tmap, m)``:
    ``ins`` int8 [n + 1] (v+1 at active slots, 0 elsewhere; slot n is the
    dump slot of inactive inserts), ``tmap`` int32 [n] (inclusive count of
    insert slots at or before p) and ``m`` the number of active inserts, a
    device scalar (no host sync). ``ins``/``tmap`` may be given as
    preallocated buffers of at least n + 1 / n elements.
    """
    dev = q.device
    ins = torch.empty(n + 1, dtype=torch.int8, device=dev) if ins is None else ins[: n + 1]
    tmap = torch.empty(n, dtype=_I32, device=dev) if tmap is None else tmap[:n]
    ins.zero_()
    slot = torch.where(active, q.long(), n)
    ins[slot] = (v.to(torch.int8) + 1)
    torch.cumsum(ins[:n].ne(0), 0, dtype=_I32, out=tmap)
    return ins, tmap, active.sum(dtype=_I32)


def packed_table_plain(sym: torch.Tensor) -> torch.Tensor:
    """The packed rank table of a uint8 symbol array (plain PyTorch):
    ``[NB + 1, 32]`` int32 with NB = ceil(n / 128), positions past n as PAD.
    Reshape to ``[NB, 4, 32]``, shift and sum in int64, wrap to int32."""
    n = sym.shape[0]
    nb = -(-n // BIN)
    padded = torch.full((nb * BIN,), PAD, dtype=torch.uint8, device=sym.device)
    padded[:n] = sym
    bins = padded.view(nb, BIN)
    table = torch.zeros((nb + 1, ROW), dtype=_I32, device=sym.device)
    per_bin = torch.stack([(bins == s).sum(1, dtype=_I32) for s in range(6)], 1)
    incl = torch.cumsum(per_bin, 0, dtype=_I32)
    table[:nb, :6] = incl - per_bin
    table[nb, :6] = incl[-1] if nb else 0
    w = padded.view(nb, 4, 32).long()
    k = torch.arange(32, device=sym.device)
    for p in range(3):
        words = (((w >> p) & 1) << k).sum(2)  # int64 in [0, 2^32)
        table[:nb, 8 + 4 * p: 12 + 4 * p] = torch.where(
            words >= 2**31, words - 2**32, words
        ).to(_I32)
    return table


def merge_insert_plain(old: torch.Tensor, ins: torch.Tensor, tmap: torch.Tensor,
                       *, out: torch.Tensor | None = None,
                       table: torch.Tensor | None = None):
    """Plain PyTorch merge pass: ``(new, table)`` for ``old`` u8 [n], ``ins``
    i8 [n], ``tmap`` i32 [n]; writes into ``out``/``table`` when given."""
    n = old.shape[0]
    src = torch.arange(n, device=old.device) - tmap.long()
    is_ins = ins != 0
    new = torch.where(is_ins, (ins - 1).to(torch.uint8), old[src.clamp_(min=0)])
    tab = packed_table_plain(new)
    if out is not None:
        new = out.copy_(new)
    if table is not None:
        tab = table.copy_(tab)
    return new, tab


def _check(name, t, dtype, n):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected shape [{n}], got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def merge_insert(old: torch.Tensor, ins: torch.Tensor, tmap: torch.Tensor,
                 *, out: torch.Tensor | None = None,
                 table: torch.Tensor | None = None):
    """One merge-insert pass: ``(new, table)``.

    ``old`` uint8 [n] (PAD past the valid symbols), ``ins`` int8 [n] (v+1 at
    insert slots), ``tmap`` int32 [n] (inclusive insert count). ``new`` is
    uint8 [n]; ``table`` is int32 [ceil(n/128) + 1, 32] in the
    ``PackedOccIndex`` layout. ``out``/``table`` may be given (same shapes).

    On CUDA tensors this launches the Hopper kernel on the current stream
    (and raises if it cannot); on CPU tensors it runs ``merge_insert_plain``.
    """
    if old.device.type == "cpu":
        return merge_insert_plain(old, ins, tmap, out=out, table=table)
    n = old.shape[0]
    nb = -(-n // BIN)
    _check("old", old, torch.uint8, n)
    _check("ins", ins, torch.int8, n)
    _check("tmap", tmap, _I32, n)
    if ins.device != old.device or tmap.device != old.device:
        raise ValueError("old, ins and tmap must be on one device")
    if n >= 2**31:
        raise ValueError("merge_insert: n must be < 2^31")
    if out is None:
        out = torch.empty(n, dtype=torch.uint8, device=old.device)
    if table is None:
        table = torch.empty((nb + 1, ROW), dtype=_I32, device=old.device)
    _check("out", out, torch.uint8, n)
    if table.dtype != _I32 or tuple(table.shape) != (nb + 1, ROW) \
            or not table.is_contiguous() or table.device != old.device:
        raise ValueError(f"table: expected contiguous int32 [{nb + 1}, {ROW}] "
                         f"on {old.device}")
    from rust_msbwt_tpu_torch import _kernels

    lib = _kernels.load()
    scratch = torch.empty(lib.msbwt_merge_insert_scratch_len(n), dtype=_I32,
                          device=old.device)
    err = lib.msbwt_merge_insert(
        old.data_ptr(), ins.data_ptr(), tmap.data_ptr(), out.data_ptr(),
        table.data_ptr(), scratch.data_ptr(), n,
        torch.cuda.current_stream(old.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"merge_insert kernel launch failed: CUDA error {err}")
    merge_insert.launches += 1
    return out, table


merge_insert.launches = 0


def merge_insert_slots(old: torch.Tensor, q: torch.Tensor, v: torch.Tensor,
                       active: torch.Tensor, *, merge=merge_insert, ins=None,
                       tmap=None, out=None, table=None):
    """Prep + pass, the contract of the JAX package's ``merge_insert_phys``:
    ``(old, q, v, active) -> (new, table, m)`` on the logical layout.
    ``ins``, ``tmap``, ``out`` and ``table`` may be preallocated buffers;
    ``merge`` is the pass (the kernel wrapper, or ``merge_insert_plain``).
    """
    n = old.shape[0]
    ins, tmap, m = insert_maps(n, q, v, active, ins=ins, tmap=tmap)
    new, table = merge(old, ins[:n], tmap, out=out, table=table)
    return new, table, m
