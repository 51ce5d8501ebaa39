"""On the card: a short run of each cell comes out correct with every
metric read, and its control does not (``pytest -m cuda
portbench/tests`` on a machine with an NVIDIA card; skipped without one)."""

import pytest

from portbench import controls, registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    r = run.run_cell(cell, 2**31 + 99, 1.0, True, card)
    assert r["correct"] and not r["errors"], r["compared"]
    assert r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in registry.cell_metrics(
        registry.benchmark(), cell, "per_layer")}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card(card, cell):
    assert not controls.run_control(cell, 2**31 + 98, "bfloat16",
                                    card)["correct"]
