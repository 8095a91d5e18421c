"""The harness's comparison on the CPU at a tiny size (``tiny_cell``): the
port against the plain reference under the contract's rule comes out
correct, in a timed and in a traced run; with the timed path broken
underneath (``system.FAULTS``) and with the control in the detector's
place, it comes out incorrect."""

import pytest
import tiny_cell

from benchmark import check, control, system

CELLS = ["loop-s96.yolov8s-416-bf16", "loop-s96.yolov8s-416-int8", "mixed-s90.yolov8s-416-bf16"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    out = tiny_cell.run_tiny(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["steps_per_s"]["value"] > 0 and out["attempted"] > 0


def test_traced_run_reads_the_same():
    out = tiny_cell.run_tiny(CELLS[0], trace=True)
    assert out["correct"], out["checks"]
    assert set(out["device"]) >= {"busy_s", "window_s"} and "breakdown" in out


@pytest.mark.parametrize("fault", system.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    out = tiny_cell.run_tiny(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(cell):
    """The configuration one precision lower in the detector's place (the
    bf16 cells: the port's int8 path; the int8 cell: the reference at int4),
    on two seeds."""
    files = tiny_cell.files(cell)
    limits = tiny_cell.TINY_LIMITS[files[1]["precision"]]
    rows = control.readings(cell, [], [11, 12], [], device="cpu", faults=(), files=files)
    assert len(rows) == 2
    for row in rows:
        assert not check.verdict(row["numbers"], limits)[0], row["numbers"]
