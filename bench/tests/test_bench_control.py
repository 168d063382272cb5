"""On the card: each cell's control (the plain reference computed in float8
in the program's place) fails one of the cell's numbers where the
program's own run passes them all.  Each cell runs at its own size with
a short window, on one seed; ``bench/tools/readings.py`` reads the same
on many seeds.

    PYTHONPATH=src python -m pytest -q -m gpu bench/tests
"""
import time

import pytest

from conftest import ROOT
from harness import spec
from harness.cell import run_cell

CELLS = {"internlm2-1.8b.train-b4s2048": 1.0,
         "deepseek-v2-lite-16b.serve-longprompt": 10.0,
         "internlm2-1.8b.serve-decode": 15.0}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_where_the_program_passes(cuda_device, cell):
    result, rec = run_cell(ROOT, cell, 2 ** 31 + 4242, CELLS[cell], False,
                           cuda_device, time.perf_counter(), control=True)
    assert result["correct"] is True, result["compared"]
    limits = spec.load_cell(ROOT, cell).limits
    assert any(rec["control"][k] > lim["limit"]
               for k, lim in limits.items()), rec["control"]
