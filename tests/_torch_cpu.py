"""One torch intra-op thread in each test process that runs the port on the
CPU; every ``tests/test_torch_*.py`` that does imports this module first.

The suite runs under pytest-xdist, several workers on the machine's cores.
By default torch starts one intra-op thread a core in every worker, so the
workers' thread pools contend for the same cores, and the plain CPU twins,
which run thousands of small ops, pay for that contention on every op: the
slowest port files ran an order of magnitude longer than with one thread a
worker. Every output the tests compare is an integer, so the thread count
changes no result. The port's own modules keep torch's default.
"""

import torch

torch.set_num_threads(1)
