"""The port never imports jax: in a fresh interpreter where ``import jax``
fails, every module of ``rust_msbwt_tpu_torch`` imports and the CPU build of
``test_data/two_string.fa`` gives the golden bytes."""

import os
import subprocess
import sys

from tests._data import GOLDEN_FA, GOLDEN_NPY

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import rust_msbwt_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "rust_msbwt_tpu."))
               for m in sys.modules if sys.modules[m] is not None), "jax leaked"
for name in ("ops.extract", "utils.streaming", "cli.extract", "ops.pair_rank",
             "ops.run_rank", "utils.checkpoint", "apps.correct", "cli.correct",
             "cli.convert", "ops.merge", "utils.oracle", "parallel.mesh",
             "parallel.sharded_merge", "parallel.doubling_merge", "parallel.sharded_build",
             "parallel.sharded_index", "parallel.partitioned", "parallel.multihost",
             "utils.profiling", "ops.lf", "ops.query"):
    assert pkg.__name__ + "." + name in names, name

from rust_msbwt_tpu_torch.cli.build import main
out = os.path.join(tempfile.mkdtemp(), "out.npy")
assert main(["--device", "cpu", "-o", out, sys.argv[1]]) == 0
assert open(out, "rb").read() == open(sys.argv[2], "rb").read()
print("OK", len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, RUST_LOG="warning")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, GOLDEN_FA, GOLDEN_NPY],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 39  # every module was walked
