"""Host utilities of the port: npy, FASTX, checks, native library, converters."""
