"""Device and host operators of the port (torch + numpy)."""
