"""BWT engines of the port: ``DynamicBWT`` (construction), ``RleBWT`` (query)."""
