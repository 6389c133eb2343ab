"""On the card, at each cell's own size: the control (the reference in the
nearest lower precision than its configuration states) fails the cell's
comparison on three seeds. Run with ``python -m pytest port_bench/tests
-m gpu`` on a machine with the card."""

from __future__ import annotations

import pytest

from port_bench.harness.registry import Registry
from port_bench.tests.control import control_reading

CELLS = [w["name"] for w in Registry().spec["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    reg = Registry()
    limits = reg.config(reg.cell(cell)["config"])["limits"]
    for seed in (11, 2 ** 31 + 12, 3 ** 30 + 13):
        reading = control_reading(reg, cell, seed, card)
        assert any(reading[k] > limits[k] for k in limits if k in reading), \
            reading
