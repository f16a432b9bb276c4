"""Card-only tests (marked ``gpu``; each skips without a CUDA card, or
with fewer cards than its cell asks for): every cell at its tiny size,
traced and not, and at its own size with the control in the program's
place, which the harness's own check has to find not correct."""

import pytest

from portbench import harness, registry
from portbench.check_line import check
from portbench.control import HOOK
from portbench.tests.tiny import cells, tree

CELLS = cells()


@pytest.fixture
def card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = registry.Cell(name).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"cell {name} needs {chips} CUDA cards")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_tiny_on_the_card(card, tmp_path, name, trace):
    here = tree(tmp_path)
    [(line, notes)] = harness.run_cell(name, [2**31 + 3], 0.5, trace, "cuda", here=here)
    assert line["correct"] is True, notes
    names = [m["name"] for m in registry.Cell(name, here=here).metrics(trace)]
    assert check(line, names, trace, count=registry.Cell(name).chips) == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_own_size_is_not_correct(card, name):
    [(line, notes)] = harness.run_cell(name, [2**32 + 17], 1.0, False, "cuda", hook=HOOK)
    assert line["correct"] is False, notes
    cell = registry.Cell(name)
    assert check(line, [m["name"] for m in cell.metrics(False)], False,
                 count=cell.chips) == []
