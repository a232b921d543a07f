"""Applications on top of the port's engines: fmlrc-style read correction."""

from rust_msbwt_tpu_torch.apps.correct import (  # noqa: F401
    correct_reads,
    flag_read_errors,
)
