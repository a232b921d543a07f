"""CPU tests of the benchmark harness (and its card tests, marked gpu)."""
