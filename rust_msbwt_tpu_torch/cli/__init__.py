"""Command lines of the port: ``python -m rust_msbwt_tpu_torch.cli.build``
and ``python -m rust_msbwt_tpu_torch.cli.query``."""
