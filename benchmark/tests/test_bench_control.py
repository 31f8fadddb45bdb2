"""The control comes out not correct: the reference in the precision below
the configuration's (float8 operands under bf16, TF32 under float32), put
in the program's place, fails one of the cell's numbers; here at tiny
sizes on the CPU (the limits are the cells' own, set at the cells' sizes
on the card by ``tools/readings.py``)."""

import pytest
import tiny

from pcbench import drivers, harness


@pytest.mark.parametrize("workload", ["drq_walker_pn.updates", "sac_maniskill_pn.updates", "drq_walker_pn.loop"])
def test_the_control_fails_a_limit(workload):
    cell = harness.Cell(workload)
    args = harness.parse_args(["--workload", workload, "--seed", "2147483659", "--seconds", "0.3", "--trace", "0"])
    tw = tiny.tweak(workload.split(".")[0])
    tw["readings"] = True
    out = drivers.run(cell, args, "cpu", 0.0, tw)
    control = out["readings"]["control"]
    over = {k: v for k, v in control.items() if k in cell.limits and v > cell.limits[k]}
    assert over, (control, cell.limits)
    for fault in ("half_batch", "unchanged"):
        assert any(v > cell.limits[k] for k, v in out["readings"][fault].items() if k in cell.limits), fault
