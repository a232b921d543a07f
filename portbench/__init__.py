"""The benchmark of the PyTorch / CUDA port (``rust_msbwt_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` (see ``portbench.run``).
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: a deployment (genome, read length, error rates);
* ``traffic/<traffic>.json``: a mix's parameters, naming its generator
  module ``traffic/<generator>.py``;
* ``endtoend/<metric>.py``: an end-to-end metric (``--trace 0``);
* ``metrics/<metric>.py``: a per-layer metric (``--trace 1``);
* ``reference/``: the plain reference that decides ``correct``.

Nothing here imports JAX or the JAX package ``rust_msbwt_tpu``; the plain
reference imports nothing of the port either.
"""
