"""The readings a cell's limits are set from, at the cell's own size.

    python benchmark/tools/readings.py --workload <cell> --seeds 12 --control-seeds 3 [--base-seed N]
        [--fault <name>]

Runs the cell once per seed in this process (a short window), with the
check's numbers of the program on every seed and, on the first
``--control-seeds``, those of the control (the reference computed in the
precision below the configuration's, in the program's place) and of the
planted faults (the reference over half of each batch; a step that leaves
the state unchanged; every step of a round on the round's first batch), all
against the float32 reference on the same batches.  Prints a JSON line per seed and a summary: the largest program
reading (the lower reading) and the smallest control and fault readings
of each number.  With ``--fault`` the fault is planted in the program
(``drivers.plant_fault``, e.g. ``exchange_left_out``), and the summary
gives the smallest of its readings as that fault's.  A cell of several
cards runs its seeds on as many ranks (``pcbench/ranks.py``), each seed's
program numbers taken at the worst rank.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def seed_rows(workload: str, seeds, control_seeds: int, seconds: float, fault) -> list:
    """The readings of each seed on this process's card (one rank's, on several)."""
    import torch

    from pcbench import drivers, harness

    cell = harness.Cell(workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows = []
    for i, seed in enumerate(seeds):
        args = harness.parse_args(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                                   "--trace", "0"])
        t0 = time.time()
        tweak = {"readings": i < control_seeds}
        if fault:
            tweak["fault"] = fault
        out = drivers.run(cell, args, device, t0, tweak)
        rec = out["readings"] or {"program": {k: v["value"] for k, v in out["compared"].items()}}
        rec.update(seed=seed, s=time.time() - t0, updates_per_s=out["end_to_end"]["updates_per_s"])
        rows.append(rec)
        print(json.dumps(dict(rec, rank=drivers.rank())), flush=True)
        drivers.free(torch.device(device))
    return rows


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args()

    from pcbench import harness, ranks

    cell = harness.Cell(a.workload)
    seeds = [a.base_seed + 7919 * i for i in range(a.seeds)]
    job = (a.workload, seeds, a.control_seeds, a.seconds, a.fault)
    if cell.chips > 1:
        import torch

        per_rank = ranks.launch(cell.chips, seed_rows, job, "cuda" if torch.cuda.is_available() else "cpu")
        rows = per_rank[0]
        for i, row in enumerate(rows):  # the program's numbers at the worst rank
            row["program"] = {k: max(r[i]["program"][k] for r in per_rank) for k in row["program"]}
    else:
        rows = seed_rows(*job)
    summary = {"workload": a.workload, "fault": a.fault, "seeds": [r["seed"] for r in rows], "lower": {},
               "upper": {}}
    for name in rows[0]["program"]:
        least, most = (f(r["program"][name] for r in rows) for f in (min, max))
        if a.fault:
            summary["upper"].setdefault(name, {})[a.fault] = least
        else:
            summary["lower"][name] = most
        for kind in ("control", "half_batch", "unchanged", "one_draw"):
            vals = [r[kind][name] for r in rows if kind in r and name in r[kind]]
            if vals:
                summary["upper"].setdefault(name, {})[kind] = min(vals)
    print(json.dumps(summary), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
