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

* **The pass** — ``merge_insert(old, q, v, active)``: on a CUDA tensor it
  launches the kernel in ``csrc/merge_insert.cu`` (or raises), which takes
  the slots as they are and builds each tile's insert map and shift in
  shared memory; on a CPU tensor it runs ``merge_insert_slots``.
  ``merge_insert.launches`` counts kernel launches, one a pass.
* **The plain version** — ``merge_insert_slots``, the same contract in two
  torch steps: ``insert_maps`` (a masked scatter of ``v + 1`` into an int8
  insert map, inactive inserts to a dump slot at index ``n`` since torch has
  no ``mode="drop"``, then ``tmap = cumsum(ins > 0)`` in int32) and
  ``merge_insert_plain`` (gather and ``where``, then the table).

The build functions' ``merge=`` argument takes either of the two.
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
    for s in range(6):  # one 1-D scan a symbol: a dim-0 scan of [nb, 6] is slow
        per_bin = (bins == s).sum(1, dtype=_I32)
        incl = torch.cumsum(per_bin, 0, dtype=_I32)
        table[:nb, s] = incl - per_bin
        table[nb, s] = incl[-1] if nb else 0
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


def merge_insert_slots(old: torch.Tensor, q: torch.Tensor, v: torch.Tensor,
                       active: torch.Tensor, *, out: torch.Tensor | None = None,
                       table: torch.Tensor | None = None):
    """The plain PyTorch version of the pass, in the kernel's contract:
    ``insert_maps`` + ``merge_insert_plain`` -> ``(new, table, m)``, the
    contract of the JAX package's ``merge_insert_phys`` on the logical
    layout. Runs on any device; ``out`` / ``table`` as in ``merge_insert``.
    """
    ins, tmap, m = insert_maps(old.shape[0], q, v, active)
    new, table = merge_insert_plain(old, ins[: old.shape[0]], tmap, out=out, table=table)
    return new, table, m


def _check(name, t, dtype, shape, dev, aligned=False):
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary")


def merge_insert(old: torch.Tensor, q: torch.Tensor, v: torch.Tensor,
                 active: torch.Tensor, *, out: torch.Tensor | None = None,
                 table: torch.Tensor | None = None):
    """One merge-insert pass: ``(new, table, m)``.

    ``old`` uint8 [n] (PAD past the valid symbols); ``q`` int32 [N] slots in
    new coordinates, distinct and < n where ``active``; ``v`` uint8 [N]
    symbols 0..5; ``active`` bool [N]. ``new`` is uint8 [n]: ``v[i]`` at
    ``q[i]`` for every active i, old's symbols in order elsewhere; ``table``
    is int32 [ceil(n/128) + 1, 32] in the ``PackedOccIndex`` layout; ``m``
    the number of active inserts, a device scalar (no host sync).
    ``out`` / ``table`` may be given (same shapes).

    On CUDA tensors this launches the Hopper kernel on their card's current
    stream, with that card the current device (and raises if it cannot); its scratch is O(N + n / 16384) int32. On CPU
    tensors it runs ``merge_insert_slots``, the plain version.
    """
    if old.device.type == "cpu":
        return merge_insert_slots(old, q, v, active, out=out, table=table)
    dev = old.device
    if dev.type != "cuda":
        raise ValueError(f"old: expected a CPU or CUDA tensor, got {dev}")
    n, N = old.shape[0], q.shape[0]
    nb = -(-n // BIN)
    if n >= 2**31:
        raise ValueError("merge_insert: n must be < 2^31")
    if out is None:
        out = torch.empty(n, dtype=torch.uint8, device=dev)
    if table is None:
        table = torch.empty((nb + 1, ROW), dtype=_I32, device=dev)
    _check("old", old, torch.uint8, (n,), dev, aligned=True)
    _check("q", q, _I32, (N,), dev)
    _check("v", v, torch.uint8, (N,), dev)
    _check("active", active, torch.bool, (N,), dev)
    _check("out", out, torch.uint8, (n,), dev, aligned=True)
    _check("table", table, _I32, (nb + 1, ROW), dev, aligned=True)
    from rust_msbwt_tpu_torch import _kernels

    lib = _kernels.load()
    scratch = torch.empty(lib.msbwt_merge_insert_scratch_len(n, N), dtype=_I32, device=dev)
    with torch.cuda.device(dev.index):  # the kernel runs on the runtime's current device
        err = lib.msbwt_merge_insert(
            old.data_ptr(), q.data_ptr(), v.data_ptr(), active.data_ptr(), out.data_ptr(),
            table.data_ptr(), scratch.data_ptr(), n, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"merge_insert kernel launch failed: CUDA error {err}")
    merge_insert.launches += 1
    return out, table, scratch[0]


merge_insert.launches = 0
