"""The control at each cell's own size, on the card: the program's
chronological insertion in place of its sorted one, run through the whole
harness (set-up, a short window at the cell's load, the check) on three
seeds, has to come out as not correct; a sound run beside it as correct.

Marked ``gpu``; without a card every test skips (decided in the fixture).
Run on a card with

    python -m pytest -o addopts="" -m gpu portbench/tests/test_portbench_card.py -s
"""

import json
import time

import pytest

from portbench import run

pytestmark = pytest.mark.gpu

CELLS = ["ecoli-sr100.append"]
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _run(card, name, seed, control):
    cell = run.find_cell(name)
    res, _ = run.run_cell(cell, seed, 3.0, False, card, control=control,
                          t_start=time.perf_counter())
    print(json.dumps({"cell": name, "seed": seed, "control": control,
                      "correct": res["correct"], "attempted": res["attempted"],
                      "compared": res["compared"]}), flush=True)
    return res


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_at_cell_size_is_not_correct(card, name, seed):
    res = _run(card, name, seed, control=True)
    assert not res["correct"] and res["compared"]["bwt_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_at_cell_size_is_correct(card, name):
    assert _run(card, name, SEEDS[0], control=False)["correct"]
