"""On the card, at each cell's own size: the program within the cell's
limits and the control (the plain reference one precision step below the
configuration's, in the program's place) outside them. Skips without a
card; run on one with ``python -m pytest -m cuda portbench/tests``."""

import pytest

from portbench import harness, readings

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SECONDS = {"fl_rounds": 1.0, "tdm_slots": 1.5, "serve": 15.0}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    c = harness.cell(cell)
    line = readings.read_seed(c, 2**31 + 101, SECONDS[c.kind], card, control=True)
    assert all(v <= c.limits[k] for k, v in line["program"].items()), line
    assert any(v > c.limits[k] for k, v in line["control"].items()), line
