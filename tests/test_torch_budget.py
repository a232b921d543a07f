"""The query-tier budget of the port's ``RleBWT`` (on CPU).

On a CUDA device the decoded + pair tiers (priced at 9 B a position) may
claim what the card can still give: ``mem_get_info``'s free bytes plus the
caching allocator's reserved-but-unused bytes, less
``QUERY_HEADROOM_BYTES``. These tests patch ``torch.cuda``'s counters and
the engine's device, so they need no card; ``MSBWT_TPU_DEVICE_BUDGET_GB``
takes precedence, and a CPU engine keeps the JAX package's 12 GB.
"""

import numpy as np
import pytest
import torch

from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops.rle import encode_symbols

from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

N_SYMBOLS, N_RUNS = 1_515_000_000, 95_000_000  # a 15M x 100 bp BWT
H = RleBWT.QUERY_HEADROOM_BYTES


def _engine(monkeypatch, free, reserved=0, allocated=0, device="cuda"):
    """An engine that believes it holds a 1.515G-symbol BWT on ``device``,
    with the card's counters patched."""
    monkeypatch.delenv("MSBWT_TPU_DEVICE_BUDGET_GB", raising=False)
    monkeypatch.delenv("MSBWT_TPU_RUN_TIER", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: allocated)
    bwt = RleBWT(device="cpu")
    bwt.load_vector(encode_symbols(np.array([5, 1, 2, 0], np.uint8)))
    bwt.device = torch.device(device)
    bwt.total_size, bwt.n_runs = N_SYMBOLS, N_RUNS
    return bwt


@pytest.mark.parametrize("spare", [0, 3 * 2**30])
def test_pair_below_budget_run_above(monkeypatch, spare):
    """9 B a position against free + spare - headroom, to the byte; the
    reserved-but-unused bytes count as free."""
    fits = 9 * N_SYMBOLS + H - spare
    bwt = _engine(monkeypatch, fits, reserved=spare + 5, allocated=5)
    assert bwt.device_budget_bytes() == 9 * N_SYMBOLS
    assert not bwt._auto_run_tier()
    bwt = _engine(monkeypatch, fits - 1, reserved=spare + 5, allocated=5)
    assert bwt._auto_run_tier()


def test_card_budget_is_not_the_jax_number(monkeypatch):
    """An 80 GB card with a 1.515G-symbol index: the JAX package's 12 GB
    would pick the run tier (13.6 GB of decoded + pair bytes); the card's
    free memory keeps the pair tier."""
    bwt = _engine(monkeypatch, 79 * 2**30)
    assert not bwt._auto_run_tier()
    monkeypatch.setenv("MSBWT_TPU_DEVICE_BUDGET_GB", "12")
    assert bwt._auto_run_tier()


@pytest.mark.parametrize("env,want", [("12", True), ("20", False), ("1e-6", True)])
def test_env_budget_takes_precedence(monkeypatch, env, want):
    bwt = _engine(monkeypatch, 79 * 2**30)
    monkeypatch.setenv("MSBWT_TPU_DEVICE_BUDGET_GB", env)
    assert bwt.device_budget_bytes() == float(env) * 1e9
    assert bwt._auto_run_tier() is want


def test_cpu_keeps_twelve_gb(monkeypatch):
    bwt = _engine(monkeypatch, 79 * 2**30, device="cpu")
    assert bwt.device_budget_bytes() == RleBWT.DEVICE_BUDGET_GB * 1e9 == 12e9
    assert bwt._auto_run_tier()  # 13.6 GB > 12 GB
    bwt.total_size = 1_000_000_000  # 9 GB fits
    assert not bwt._auto_run_tier()


def test_run_tier_switches_still_win(monkeypatch):
    bwt = _engine(monkeypatch, 0)  # no room at all
    monkeypatch.setenv("MSBWT_TPU_RUN_TIER", "0")
    assert not bwt._auto_run_tier()
    bwt = _engine(monkeypatch, 79 * 2**30)
    monkeypatch.setenv("MSBWT_TPU_RUN_TIER", "1")
    assert bwt._auto_run_tier()
