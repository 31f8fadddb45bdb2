"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip (a CPU run at tiny sizes,
the program in float32 so that a sound run agrees with the reference to
rounding) and drives the rest of a run with one fault planted in the
program: a step that leaves its state unchanged; every update over half of
its batch; and, in a loop cell, a pushed action or a fused point altered
where it is produced.  The cells' own limits decide."""

import pytest
import tiny
from test_bench_reference import _f32

from pcbench import harness

CELLS = ["drq_walker_pn.updates", "sac_maniskill_pn.updates", "drq_walker_pn.loop"]
FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "half_batch")]
FAULTS += [(c, f) for c in CELLS if c.endswith(".loop") for f in ("action_altered", "fuse_altered")]


def _run(workload, fault, capsys):
    import json

    tw = _f32(workload.split(".")[0])
    if fault:
        tw["fault"] = fault
    rc = harness.main(["--workload", workload, "--seed", "2147483653", "--seconds", "0.5", "--trace", "0"],
                      device="cpu", tweak=tw)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, capsys):
    res = _run(workload, None, capsys)
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == set(harness.Cell(workload).limits)  # every number with a limit, and no other


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault, capsys):
    res = _run(workload, fault, capsys)
    assert res["correct"] is False, (fault, res["compared"])
