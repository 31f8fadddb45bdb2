"""One run of one cell: the command line, the cell's files, the result line.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
finds the cell in ``BENCHMARK.json``, reads its files (``workloads/<cell>.json``,
the configuration's ``configs/<config>.json``, the traffic's
``traffic/<traffic>.json``), runs the traffic's driver (``drivers.py``),
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read
by the file ``metrics/<metric>.py`` that bears its name (or the leading
dotted part of it).  A cell of several chips runs one data-parallel rank
of the port per chip, each in a process of its own (``ranks.py``); this
process waits for them, puts their parts together and prints the line.
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


def metric_file(name: str) -> str:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of the
    longest leading dotted part of the name that has one, so that
    ``device.idle_pct.<config>`` is read as ``device.idle_pct`` is."""
    parts = name.split(".")
    for end in range(len(parts), 0, -1):
        path = osp.join(BENCH_DIR, "metrics", ".".join(parts[:end]) + ".py")
        if osp.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} under {osp.join(BENCH_DIR, 'metrics')}")


def load_metric(name: str):
    """The reader module of metric ``name``: ``read(ctx)``, and optionally
    ``combine(values)``, which makes one reading of the ranks' (rank 0's
    where the module has none)."""
    path = metric_file(name)
    mod_name = "pcbench_metric_" + osp.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric_reader(name: str):
    return load_metric(name).read


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


def run_part(workload: str, args, device: str, t_proc: float, tweak: dict) -> dict:
    """One rank's run of the cell: the driver, then the per-layer readers on
    this rank's trace (``--trace 1``).  What it returns is plain data: the
    harness puts the ranks' parts together (``combine``)."""
    from . import drivers

    cell = Cell(workload)
    out = drivers.run(cell, args, device, t_proc, tweak)
    part = {k: out[k] for k in ("compared", "end_to_end", "attempted", "failed", "device", "notes")}
    part["breakdown"] = out.get("breakdown")
    part["per_layer"] = {m["name"]: load_metric_reader(m["name"])(out["read"]) for m in cell.per_layer} \
        if args.trace else {}
    part["blocked"] = blocked_modules()
    return part


def _worst(parts: List[dict], key: str) -> tuple:
    """(the largest value of the compared number ``key`` over the ranks, where it lies)."""
    r = max(range(len(parts)), key=lambda i: _num(parts[i]["compared"][key]["value"]))
    at = parts[r]["compared"][key].get("at")
    if len(parts) > 1:
        at = f"{at}, rank {r}" if at else f"rank {r}"
    return _num(parts[r]["compared"][key]["value"]), at


def combine(cell: "Cell", args, parts: List[dict]) -> Dict[str, Any]:
    """The result line of a run from its ranks' parts (one part on one card):
    each compared number at its worst rank, the end-to-end metrics and the
    breakdown of rank 0, each per-layer metric as its reader combines the
    ranks', the memory peak of the fullest card and the busy seconds
    averaged over the cards."""
    lead = parts[0]
    limits = cell.limits
    compared, notes = {}, list(lead["notes"])
    for k in lead["compared"]:
        value, at = _worst(parts, k)
        if k in limits:
            compared[k] = {"value": value, "limit": limits[k], "at": at}
        else:
            notes.append(f"{k} {value!r} (not compared: no limit)")
    failed = sum(int(p["failed"]) for p in parts)
    correct = all(v["value"] <= v["limit"] for v in compared.values()) and failed == 0
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            values = [p["per_layer"][m["name"]] for p in parts]
            value = getattr(load_metric(m["name"]), "combine", lambda vs: vs[0])(values)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(lead["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(lead["device"], count=len(parts), memory_peak_bytes=max(p["device"]["memory_peak_bytes"]
                                                                          for p in parts))
    busy = [p["device"]["busy_s"] for p in parts if "busy_s" in p["device"]]
    if busy:
        device["busy_s"] = sum(busy) / len(busy)
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": int(lead["attempted"]), "failed": failed,
                              "metrics": metrics, "device": device}
    if args.trace and lead.get("breakdown"):
        result["breakdown"] = lead["breakdown"]
    return {"result": result, "compared": compared, "notes": notes}


def main(argv=None, device: Optional[str] = None, tweak: Optional[dict] = None) -> int:
    """Run a cell once; returns the exit code.  ``device`` and ``tweak`` are
    for the benchmark's own tests: a CPU run (which skips the look for a
    chip) at the sizes ``tweak`` patches in, with a fault planted, on
    ``tweak["ranks"]`` ranks where given.  A cell of several chips runs one
    rank per chip, each in a process of its own (``ranks.py``)."""
    t_proc = process_start_time()
    for var in THREAD_VARS:
        os.environ[var] = "1"
    args = parse_args(argv)
    cell = Cell(args.workload)
    tweak = tweak or {}
    world = int(tweak.get("ranks", cell.chips))
    if device is None:
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()} and {have} are visible", file=sys.stderr)
            return 2
        device = "cuda"
    if world > 1:
        from . import ranks

        try:
            parts = ranks.launch(world, run_part, (cell.name, args, device, t_proc, tweak), device)
        except ranks.RankFailed as err:
            print(f"benchmark: {err}", file=sys.stderr)
            return 3
    else:
        parts = [run_part(cell.name, args, device, t_proc, tweak)]
    found = sorted(set(blocked_modules()).union(*(p["blocked"] for p in parts)))
    if found:
        print(f"benchmark: the run loaded {found}; the benchmark measures pointcloud_rl_torch alone", file=sys.stderr)
        return 3

    run = combine(cell, args, parts)
    result, compared = run["result"], run["compared"]
    for line in run["notes"]:
        print(f"[benchmark] {line}", file=sys.stderr)
    for k, v in compared.items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}" + (f" (worst at {v['at']})" if v["at"] else ""),
              file=sys.stderr)
    result["compared"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in compared.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
