"""One run of one cell: the command line, the cell's files, the result line.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
finds the cell in ``BENCHMARK.json``, reads its files (``workloads/<cell>.json``,
the configuration's ``configs/<config>.json``, the traffic's
``traffic/<traffic>.json``), runs the traffic's driver (``drivers.py``),
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read
by the file ``metrics/<metric>.py`` that bears its name.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import os.path as osp
import sys
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
ROOT = osp.dirname(BENCH_DIR)
# top-level modules that must not be loaded in the process that prints the result
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pointcloud_rl_tpu")


def process_start_time() -> float:
    """The wall-clock time this process started, from /proc (10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # field 22: start time in clock ticks after boot
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def blocked_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BLOCKED)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        bench = _read_json(osp.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.file = _read_json(osp.join(BENCH_DIR, "workloads", f"{name}.json"))
        cfg_entry = next(c for c in bench["configs"] if c["name"] == self.entry["config"])
        self.config = _read_json(osp.join(root, cfg_entry["file"]))
        self.traffic = _read_json(osp.join(BENCH_DIR, "traffic", f"{self.entry['traffic']}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        self.limits: Dict[str, float] = dict(self.file["limits"])


def load_metric_reader(name: str):
    path = osp.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pcbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _num(x: float) -> float:
    return float(x) if math.isfinite(x) else (1e300 if x > 0 else -1e300)


# One thread per process for the numeric libraries, in the run and in the
# env workers it starts: the host-bound loop cells share the machine's
# cores between the run and its workers, and pools of idle threads that
# spin on those cores make the runs spread.
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def main(argv=None, device: Optional[str] = None, tweak: Optional[dict] = None) -> int:
    """Run a cell once; returns the exit code.  ``device`` and ``tweak`` are
    for the benchmark's own tests: a CPU run (which skips the look for a
    chip) at the sizes ``tweak`` patches in, with a fault planted."""
    t_proc = process_start_time()
    for var in THREAD_VARS:
        os.environ[var] = "1"
    args = parse_args(argv)
    cell = Cell(args.workload)
    if device is None:
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()} and {have} are visible", file=sys.stderr)
            return 2
        device = "cuda"
    from . import drivers

    out = drivers.run(cell, args, device, t_proc, tweak or {})
    found = blocked_modules()
    if found:
        print(f"benchmark: the run loaded {found}; the benchmark measures pointcloud_rl_torch alone", file=sys.stderr)
        return 3

    # the numbers the cell's file gives a limit decide ``correct``; the others are printed beside them
    compared = {k: {"value": _num(v["value"]), "limit": cell.limits[k]} for k, v in out["compared"].items()
                if k in cell.limits}
    for k, v in out["compared"].items():
        if k not in cell.limits:
            out.setdefault("notes", []).append(f"{k} {v['value']!r} (not compared: no limit)")
    correct = all(v["value"] <= v["limit"] for v in compared.values()) and out["failed"] == 0
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_metric_reader(m["name"])(out["read"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": int(out["attempted"]),
                              "failed": int(out["failed"]), "metrics": metrics, "device": out["device"]}
    if args.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    for line in out.get("notes", []):
        print(f"[benchmark] {line}", file=sys.stderr)
    for k, v in compared.items():
        where = out["compared"][k].get("at")
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}" + (f" (worst at {where})" if where else ""),
              file=sys.stderr)
    result["compared"] = compared
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
