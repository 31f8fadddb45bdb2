"""The traced sub-window: a ``torch.profiler`` session and its readers.

The readers follow ``chip_smoke.py``'s (``trace_busy_ms``: the device's
busy time as the union of its kernel, memcpy and memset intervals;
``profiled``: the profiler over a window that ends in a synchronize), read
from the Chrome trace the profiler exports.  Time stamps are in
microseconds on the host's clock, kernels included.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "benchmark.traced_window"


class Trace:
    """The events of one traced sub-window."""

    def __init__(self, events: List[dict]):
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "ts" in e),
                             key=lambda e: e["ts"])
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
        self.host_spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
        window = [e for e in self.host_spans if e.get("name") == WINDOW_SPAN]
        if window:
            w = window[0]
            self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        elif self.device:
            self.t0 = float(self.device[0]["ts"])
            self.t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in self.device)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self, events=None, clip: Optional[Tuple[float, float]] = None) -> List[Tuple[float, float]]:
        """The union of the events' [start, end) intervals, merged, in us."""
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                       for e in (self.device if events is None else events))
        if clip is not None:
            lo, hi = clip
            spans = [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]
        merged: List[Tuple[float, float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def busy_us(self, events=None, clip=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(events, clip))

    def graph_replays(self) -> List[List[dict]]:
        """The kernels of each CUDA graph launch, grouped by the launch's
        correlation id."""
        launches = {e["args"]["correlation"] for e in self.runtime
                    if e.get("name", "").startswith("cudaGraphLaunch") and "correlation" in e.get("args", {})}
        groups: Dict[int, List[dict]] = {}
        for k in self.kernels:
            c = k.get("args", {}).get("correlation")
            if c in launches:
                groups.setdefault(c, []).append(k)
        return [sorted(g, key=lambda e: e["ts"]) for g in groups.values()]

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took the most time."""
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + float(e.get("dur", 0))
        return [[n, t / 1e6] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[what the host was doing, seconds] of the longest stretches of the
        window with nothing on the device; the host's doing is the
        benchmark's innermost span over the gap's middle."""
        busy = self.busy_intervals(clip=(self.t0, self.t1))
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [s for s in self.host_spans if s.get("name") != WINDOW_SPAN]
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            inner = [h for h in spans if h["ts"] <= mid <= h["ts"] + h["dur"]]
            name = min(inner, key=lambda h: h["dur"])["name"] if inner else "host work outside the benchmark's spans"
            out.append([name, (e - s) / 1e6])
        return out


def start(device_type: str):
    """A profiler session of the host and the card, started."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def read(prof) -> Trace:
    """The trace of a stopped ``prof`` (written to, and removed from, TMPDIR)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)
