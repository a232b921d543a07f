"""Streaming MSBWT construction (port of the JAX package's
``utils.streaming``): read batches arrive incrementally and the BWT stays on
the device between batches.

This is the batch-granular form of the reference's load-and-extend flow
(load an existing BWT into ``DynamicBWT`` and ``insert_string`` more — ref:
src/lib.rs:30-43, test src/dynamic_bwt.rs:734-773). Each batch extends the
BWT the earlier batches built, through ``ops.bcr.build_msbwt_with_index``
with the packed index the previous build wrote, so device memory holds one
batch's build plus the accumulated BWT. PyTorch launches asynchronously:
``add_batch`` returns once the build's stage loop is enqueued and its one
symbol-count check has passed.

Sorted streaming is exact: sorted insertion is input-order independent, so
feeding batches in any order gives the same BWT as one sorted build; each
batch finds its terminator slots by the batched cyclic backward search
(``ops.bcr.terminator_positions``). Chronological streaming appends each
batch's terminators in arrival order, as repeated
``insert_string(s, false)`` does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index


class StreamingBuilder:
    """Incremental builder on ``device``: ``add_batch`` reads, then
    ``finish`` -> BWT.

    Two batches equal one sorted one-shot build (order independence):

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.bcr import encode_reads
    >>> b = StreamingBuilder(device="cpu")
    >>> b.add_batch(*encode_reads([convert_stoi("ACGT")]))
    >>> b.add_batch(*encode_reads([convert_stoi("TGCA")]))
    >>> b.string_count, convert_itos(b.finish())
    (2, 'TAC$GATCG$')
    """

    def __init__(self, sorted_insert: bool = True, *, device="cuda"):
        self.sorted_insert = sorted_insert
        self.device = torch.device(device)
        self._bwt: torch.Tensor | None = None  # decoded symbols on the device
        self._packed = None       # the packed index of _bwt, when known
        self._string_count = 0
        self._rot_max = 0         # longest rotation (read length + 1) so far

    @property
    def string_count(self) -> int:
        return self._string_count

    def add_batch(self, reads: np.ndarray, lengths: np.ndarray) -> None:
        """Fold one ``[N, L] u8 / [N] i32`` batch into the BWT."""
        reads = np.asarray(reads, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        if reads.shape[0] == 0:
            return
        idx, self._packed = build_msbwt_with_index(
            reads, lengths, self.sorted_insert, base=self._bwt,
            base_string_count=self._string_count,
            base_rot_max=self._rot_max or None, device=self.device,
            base_index=self._packed,
        )
        self._bwt = idx.bwt[: idx.n]
        self._string_count += int(reads.shape[0])
        self._rot_max = max(self._rot_max, int(lengths.max()) + 1)

    def finish(self, device_out: bool = False):
        """The accumulated decoded BWT: host uint8 [n], or the device tensor
        with ``device_out=True``."""
        bwt = self._bwt
        if bwt is None:
            bwt = torch.zeros(0, dtype=torch.uint8, device=self.device)
        return bwt if device_out else bwt.cpu().numpy()

    # --- checkpoint / resume (the reference's "the npy IS the checkpoint"
    # flow, ref: src/lib.rs:30-43, at batch granularity) ---

    def checkpoint(self, path: str) -> None:
        """Persist the accumulated BWT (npy with the reference's exact
        header, the same bytes the JAX package writes) and the builder state
        to ``path + '.meta.json'``."""
        from rust_msbwt_tpu_torch.ops.rle import encode_symbols
        from rust_msbwt_tpu_torch.utils.npy import save_bwt_bytes

        save_bwt_bytes(encode_symbols(self.finish()), path)
        with open(path + ".meta.json", "w") as fp:
            json.dump(
                {
                    "string_count": self._string_count,
                    "rot_max": self._rot_max,
                    "sorted_insert": self.sorted_insert,
                },
                fp,
            )

    @classmethod
    def restore(cls, path: str, *, device="cuda") -> "StreamingBuilder":
        """Resume a checkpointed ingestion (the port's or the JAX package's):
        the BWT is decoded on ``device`` and later ``add_batch`` calls
        extend it."""
        from rust_msbwt_tpu_torch.ops.rle import decode_symbols_device
        from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes

        with open(path + ".meta.json") as fp:
            meta = json.load(fp)
        b = cls(sorted_insert=bool(meta["sorted_insert"]), device=device)
        rle = load_bwt_bytes(path)
        if rle.size:
            b._bwt = decode_symbols_device(rle, device=b.device)
        b._string_count = int(meta["string_count"])
        b._rot_max = int(meta["rot_max"])
        return b


def build_msbwt_streaming(reads: np.ndarray, lengths: np.ndarray, batch_size: int,
                          sorted_insert: bool = True, *, device="cuda") -> np.ndarray:
    """Stream a read matrix through ``StreamingBuilder`` in ``batch_size``
    chunks. The result equals one-shot ``build_msbwt``."""
    b = StreamingBuilder(sorted_insert=sorted_insert, device=device)
    n = int(np.asarray(reads).shape[0])
    for i in range(0, n, batch_size):
        b.add_batch(reads[i: i + batch_size], lengths[i: i + batch_size])
    return b.finish()
