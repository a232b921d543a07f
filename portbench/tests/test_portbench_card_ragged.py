"""The control of ``ecoli-ont50x.build`` at its own size, on the card: the
program's chronological insertion in place of its sorted one, run through
the whole harness (set-up, a short window, the check), has to come out as
not correct; a sound run on another seed as correct.

Marked ``gpu``; without a card every test skips (decided in the fixture).
Run on a card with

    python -m pytest -o addopts="" -m gpu portbench/tests/test_portbench_card_ragged.py -s
"""

import json
import time

import pytest

from portbench import run

pytestmark = pytest.mark.gpu

CELL = "ecoli-ont50x.build"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _run(card, seed, control):
    res, _ = run.run_cell(run.find_cell(CELL), seed, 3.0, False, card, control=control,
                          t_start=time.perf_counter())
    print(json.dumps({"cell": CELL, "seed": seed, "control": control,
                      "correct": res["correct"], "attempted": res["attempted"],
                      "compared": res["compared"]}), flush=True)
    return res


def test_control_at_cell_size_is_not_correct(card):
    res = _run(card, 2**31 + 404, control=True)
    assert not res["correct"] and res["compared"]["bwt_mismatch"]["value"] > 0


def test_sound_run_at_cell_size_is_correct(card):
    assert _run(card, 2**31 + 505, control=False)["correct"]
