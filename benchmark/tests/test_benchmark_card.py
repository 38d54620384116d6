"""On the card, at the cells' own sizes: the control in lower precision
comes out not correct (harness/faults.py: the program's float32 products
in TF32; the env's reward in bfloat16). On a machine with a CUDA card:

    python -m pytest benchmark/tests/test_benchmark_card.py -q

(about a minute); without a card every case skips."""
from pathlib import Path

import pytest
import torch

import run
from conftest import cells_of
from harness.faults import PLANTS

ROOT = Path(run.BENCH_DIR).parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('cell,seconds', [(cells_of('train')[-1], 0),
                                          (cells_of('sample')[0], 3)])
@pytest.mark.parametrize('control', ['tf32', 'reward_bf16'])
def test_control_is_not_correct(card, cell, seconds, control):
    out, _notes = run.run_cell(ROOT, cell, 2 ** 31 + 17, seconds, False, card,
                               plant=PLANTS[control])
    assert out['correct'] is False
