"""Tiny sizes of the benchmark's configurations, for its CPU tests.

``tweak(config_name)`` is what ``pcbench.harness.main(..., tweak=)`` patches
into a configuration: every width, the batch, the points and the replay cut
so that a cell runs on the CPU in seconds.  Each configuration's sizes are
the file ``tiny/<config>.json``: ``config``, the patch, and ``float32``,
what further makes its program compute in float32 (``tweak(name,
float32=True)``), where a sound run agrees with the reference to rounding.
The timed sizes are the configuration files'."""

from __future__ import annotations

import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TRAFFIC = {"fill_rows": 600, "warm_rounds": 2, "warm_cycles": 3, "trace_rounds": 0}


def sizes(name: str) -> dict:
    with open(os.path.join(BENCH, "tests", "tiny", f"{name}.json")) as f:
        return json.load(f)


def tweak(name: str, fault=None, float32: bool = False) -> dict:
    from pcbench.drivers import merge

    tiny = sizes(name)
    config = merge(tiny["config"], tiny["float32"]) if float32 else tiny["config"]
    out = {"config": config, "traffic": dict(TRAFFIC)}
    if fault:
        out["fault"] = fault
    return out


def run_cell(workload: str, seed: int = 7, seconds: float = 1.0, fault=None, capsys=None):
    """Run a cell on the CPU at the tiny sizes; returns the result line (a dict)."""
    import json

    from pcbench import harness

    config = workload.split(".")[0]
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                      device="cpu", tweak=tweak(config, fault))
    assert rc == 0, rc
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
