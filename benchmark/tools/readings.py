"""The readings a cell's limits are set from, at the cell's own size.

    python benchmark/tools/readings.py --workload <cell> --seeds 12 --control-seeds 3 [--base-seed N]

Runs the cell once per seed in this process (a short window), with the
check's numbers of the program on every seed and, on the first
``--control-seeds``, those of the control (the reference computed in the
precision below the configuration's, in the program's place) and of the
planted faults (the reference over half of each batch; a step that leaves
the state unchanged; every step of a round on the round's first batch), all
against the float32 reference on the same batches.  Prints a JSON line per seed and a summary: the largest program
reading (the lower reading) and the smallest control and fault readings
of each number.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out", default=None)
    a = p.parse_args()

    import torch

    from pcbench import drivers, harness

    cell = harness.Cell(a.workload)
    rows = []
    for i in range(a.seeds):
        seed = a.base_seed + 7919 * i
        args = harness.parse_args(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                                   "--trace", "0"])
        t0 = time.time()
        out = drivers.run(cell, args, "cuda" if torch.cuda.is_available() else "cpu", time.time(),
                          {"readings": i < a.control_seeds})
        rec = out["readings"] or {"program": {k: v["value"] for k, v in out["compared"].items()}}
        rec.update(seed=seed, s=time.time() - t0, updates_per_s=out["end_to_end"]["updates_per_s"])
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        drivers.free(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    summary = {"workload": a.workload, "seeds": [r["seed"] for r in rows], "lower": {}, "upper": {}}
    for name in rows[0]["program"]:
        summary["lower"][name] = max(r["program"][name] for r in rows)
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
