"""The control: the plain reference in bfloat16, put in the program's
place by the configuration's comparison, must come out as not correct; on
the card at the cell's own size too (``card`` marker;
``python -m pytest benchmark/tests -m card`` on the card machine)."""
import pytest
import torch

import run

CELLS = ['grey_rce.sweep512k', 'rce_conv.reference32k', 'grey_rce.dp4x512k']


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    c = run.load_cell(cell)
    c['traffic']['members'] = 8
    nums = run.comparison(c).control(c, 2 ** 31 + 5, 'bfloat16',
                                     torch.device('cpu'))
    ok, lines = run.judge(c, nums)
    assert not ok, lines


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    c = run.load_cell(cell)
    nums = run.comparison(c).control(c, 2 ** 31 + 11, 'bfloat16', card)
    ok, lines = run.judge(c, nums)
    assert not ok, lines
