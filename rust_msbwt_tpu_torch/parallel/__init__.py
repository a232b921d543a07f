"""The multi-device layer on ``torch.distributed``: one process per device,
every function called by every rank of the default process group (port of
the JAX package's ``parallel``)."""
