"""The encoder plug is enough: a configuration whose encoder the benchmark
has never named comes in as new files and appended entries of
``BENCHMARK.json``, and runs.

In a copy of ``BENCHMARK.json`` and ``benchmark/`` the test adds what
``plug/`` holds: an encoder module (``pcbench/encoders/tapnet.py``), a
configuration, a cell, its tiny CPU sizes, and entries appended to
``BENCHMARK.json`` (a per-layer metric among them that no reader file
bears the name of: the leading dotted part's reader reads it).  The port's
side of the encoder (``plug/tapnet_port.py``, whose kernel is ``[taps, in,
width]``) is registered in the port's ``NETWORK`` registry by the run.  No
file of the copy that was there before changes, but for the appended
entries.  The cell runs correct; half a batch and a step that leaves its
state unchanged run not correct."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import tiny

PLUG = os.path.join(tiny.BENCH, "tests", "plug")


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add_plug(copy):
    """The new files, and the entries appended to BENCHMARK.json."""
    bench = os.path.join(copy, "benchmark")
    for d, _, files in os.walk(PLUG):
        rel = os.path.relpath(d, PLUG)
        for f in files:
            if rel == "." and f in ("tapnet_port.py", "benchmark_entries.json"):
                continue
            dst = os.path.join(bench, rel, f)
            assert not os.path.exists(dst), dst  # new files only
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(d, f), dst)
    with open(os.path.join(PLUG, "benchmark_entries.json")) as f:
        entries = json.load(f)
    path = os.path.join(copy, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    for key, items in entries.items():
        spec[key] = spec[key] + items
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)


RUN = r"""
import json, math, sys
sys.path[:0] = ["benchmark", "benchmark/tests", {plug!r}, {root!r}]
import tapnet_port
tapnet_port.register()
import tiny
from pcbench import harness, flops, weights

cell = "drq_walker_tap.updates"
for fault in (None, "half_batch", "unchanged"):
    rc = harness.main(["--workload", cell, "--seed", "2147483677", "--seconds", "0.5", "--trace", "0"], device="cpu",
                      tweak=tiny.tweak("drq_walker_tap", fault))
    assert rc == 0, rc
    print("FAULT " + json.dumps(fault), flush=True)
cfg = harness.Cell(cell).config
shapes = {{"visual.tap_kernel": (3, 9, 256), "visual.tap_bias": (256,),
          "critic.VmapMLP_0.Dense_0.weight": (2, 56, 1024)}}
w = weights.make(shapes, 11, "cpu", "tapnet")
print("CHECKS " + json.dumps({{
    "reader": harness.metric_file("device.idle_pct.drq_walker_tap"),
    "flops": flops.update_flops(cfg["shapes"], cfg["reference"]["encoder"])["total"],
    "kernel_max": float(w["visual.tap_kernel"].abs().max()), "kernel_bound": 1 / math.sqrt(3 * 9),
    "bias_max": float(w["visual.tap_bias"].abs().max()),
    "heads_max": float(w["critic.VmapMLP_0.Dense_0.weight"].abs().max()), "heads_bound": 1 / math.sqrt(56)}}))
"""


def test_a_new_encoder_comes_in_as_new_files(tmp_path):
    copy = str(tmp_path)
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(tiny.BENCH, os.path.join(copy, "benchmark"), ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        spec_before = json.load(f)
    before = _digests(copy)
    _add_plug(copy)
    after = _digests(copy)
    changed = [p for p in before if after.get(p) != before[p]]
    assert changed == ["BENCHMARK.json"], changed
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for key, items in spec_before.items():  # the old entries stand as they were, the new ones after them
        assert spec[key] == items if not isinstance(items, list) else spec[key][:len(items)] == items, key

    proc = subprocess.run([sys.executable, "-c", RUN.format(plug=PLUG, root=tiny.ROOT)], capture_output=True,
                          text=True, timeout=600, cwd=copy, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    results = {}
    for i, line in enumerate(lines):
        if line.startswith("FAULT "):
            results[json.loads(line[len("FAULT "):])] = json.loads(lines[i - 1])
    assert results[None]["correct"] is True, results[None]["compared"]
    assert set(results[None]["compared"]) == set(json.load(open(os.path.join(
        copy, "benchmark", "workloads", "drq_walker_tap.updates.json")))["limits"])
    for fault in ("half_batch", "unchanged"):
        assert results[fault]["correct"] is False, (fault, results[fault]["compared"])
    checks = json.loads([ln for ln in lines if ln.startswith("CHECKS ")][-1][len("CHECKS "):])
    assert checks["reader"].endswith(os.path.join("metrics", "device.idle_pct.py"))
    assert checks["flops"] > 0
    # the taps count in the kernel's fan in: its values fill +-1/sqrt(taps x in), not +-1/sqrt(in)
    assert 0.9 * checks["kernel_bound"] < checks["kernel_max"] <= checks["kernel_bound"]
    assert checks["bias_max"] <= checks["kernel_bound"]
    assert 0.9 * checks["heads_bound"] < checks["heads_max"] <= checks["heads_bound"]
