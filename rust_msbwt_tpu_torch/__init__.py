"""rust_msbwt_tpu_torch — the multi-string BWT engine in PyTorch and CUDA.

The port of ``rust_msbwt_tpu`` (JAX) to PyTorch for NVIDIA Hopper cards.
The JAX package stays the reference: every module here is held bit-exact
against its counterpart by the ``tests/test_torch_*.py`` suite. This
package imports ``torch`` and numpy, never ``jax``.

Layer map (mirrors the JAX package):
  * ``ops.alphabet``      — alphabet/encoding tables (numpy)
  * ``ops.rle``           — RLE byte-stream codec (numpy; device decode)
  * ``ops.rank``          — occurrence index, rank, k-mer prefix cache
  * ``ops.packed_rank``   — packed single-gather rank + batched k-mer counts
  * ``ops.merge_insert``  — the BCR merge-insert pass: hand-written CUDA
                            kernel (``csrc/merge_insert.cu``) + plain twin
  * ``ops.bcr``           — batched column-wise BWT construction and
                            extension (terminator search, LF walks)
  * ``ops.extract``       — read recovery: ``extract_reads``, ``locate_kmers``
  * ``models.dynamic``    — ``DynamicBWT`` construction engine (insert,
                            load, extend)
  * ``models.rle_bwt``    — ``RleBWT`` static query engine
  * ``utils``             — npy container, FASTX, native host library,
                            streamed builds (``streaming``), JAX-state
                            converters for the parity tests
  * ``cli``               — ``build``, ``query`` and ``extract`` command
                            lines

Nothing is imported here eagerly: ``import rust_msbwt_tpu_torch`` costs
nothing and builds nothing. CUDA kernels are compiled at first use
(``_kernels``).
"""

__version__ = "0.1.0"
