"""The control of each cell -- the reference in the precision below the
configuration's (fp8 products for bf16, TF32 for float32), put in the
program's place -- comes out as not correct, at a size a test run holds.
TF32 exists only on the card, so the float32 cells' control runs there
(``python -m pytest bench_torch/tests -m cuda`` on the card)."""

import pytest
import torch

from conftest import TINY_CELLS
from harness import check, drive
from harness.cell import load_cell

SEEDS = (11, 2 ** 31 + 3, 987654321)


def _device_for(cfg):
    if check.control_mode(cfg) == "tf32":
        if not torch.cuda.is_available():
            pytest.skip("TF32 products exist only on a CUDA card")
        return torch.device("cuda", 0)
    return torch.device("cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [c[0] for c in TINY_CELLS
                                  if c[1] == "tiny_transunet"])
def test_bf16_control_fails(tiny_root, name, seed):
    cell = load_cell(tiny_root, name)
    numbers = drive.control_numbers(cell, seed, _device_for(cell.config))
    ok, checks = check.judge(numbers, cell.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [c[0] for c in TINY_CELLS
                                  if c[1] == "tiny_swin"])
def test_tf32_control_fails(tiny_root, name, seed):
    cell = load_cell(tiny_root, name)
    numbers = drive.control_numbers(cell, seed, _device_for(cell.config))
    ok, checks = check.judge(numbers, cell.limits)
    assert not ok, checks
