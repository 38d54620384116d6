"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (harness/faults.py), planted in the program of a
tiny copy of the cell on the CPU, the rest of the run as on the card."""
import pytest
import torch

import run
from conftest import cells_of
from harness.faults import PLANTS

TRAIN, SAMPLE = cells_of('train')[-1], cells_of('sample')[0]
CASES = [(TRAIN, fault) for fault in ('unchanged', 'half_batch', 'answer')]
CASES += [(SAMPLE, fault) for fault in ('unchanged', 'answer')]


@pytest.mark.parametrize('cell,fault', CASES)
def test_fault_is_not_correct(tiny_root, cell, fault):
    out, _notes = run.run_cell(tiny_root, f'tiny.{cell}', 2 ** 32 + 5, 0.2, False,
                               torch.device('cpu'), plant=PLANTS[fault],
                               bench_dir=tiny_root / 'benchmark')
    assert out['correct'] is False
    assert out['failed'] > 0


@pytest.mark.parametrize('cell', [TRAIN, SAMPLE])
def test_sound_run_is_correct(tiny_root, cell):
    out, _notes = run.run_cell(tiny_root, f'tiny.{cell}', 2 ** 32 + 5, 0.2, False,
                               torch.device('cpu'), bench_dir=tiny_root / 'benchmark')
    assert out['correct'] is True
