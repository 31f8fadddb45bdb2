"""The program's own spans in the traced sub-window.

``pointcloud_rl_torch/utils/trace.py`` opens a ``record_function`` at each
of the port's layer boundaries while a profiler session runs; the spans
land in the trace as ``user_annotation`` events beside the benchmark's
own, on the same clock.  A span is the window's when it starts inside
``[t0, t1]``.  A program without such spans gives no reading (``None``),
and nothing raises.
"""

from __future__ import annotations

from typing import List, Optional

CYCLE = "rollout.forward_with_policy"  # the benchmark's span around each collection: one a cycle
UPDATE = "sac.update"  # the program's span around the host side of one update


def in_window(trace, name: str) -> List[dict]:
    """The spans ``name`` that start inside the window."""
    if trace is None:
        return []
    return [e for e in trace.host_spans if e.get("name") == name and trace.t0 <= float(e["ts"]) <= trace.t1]


def self_ms(spans: List[dict], inner: List[dict]) -> float:
    """The spans' summed ms less the ``inner`` spans that lie inside them,
    on the same thread."""
    total = 0.0
    for s in spans:
        a, b = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        nested = sum(float(i["dur"]) for i in inner
                     if (i.get("pid"), i.get("tid")) == (s.get("pid"), s.get("tid"))
                     and a <= float(i["ts"]) and float(i["ts"]) + float(i["dur"]) <= b)
        total += float(s["dur"]) - nested
    return total / 1e3


def per(trace, name: str, over: str, inner: Optional[str] = None) -> Optional[float]:
    """The window's ``name`` spans' ms (their self time less the ``inner``
    spans inside them, where given) over its count of ``over`` spans; no
    ``name`` span or no ``over`` span in the window: ``None``."""
    spans, count = in_window(trace, name), len(in_window(trace, over))
    if not spans or not count:
        return None
    return self_ms(spans, in_window(trace, inner) if inner else []) / count
