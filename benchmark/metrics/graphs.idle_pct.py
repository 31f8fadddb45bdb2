"""``graphs.idle_pct``: the share of the update programs' replays with nothing on the card.

Each CUDA graph launch in the traced sub-window (its kernels share the
launch's correlation id) spans from its first kernel's start to its last
kernel's end; the idle part is that span less the union of its kernels.
Summed over the launches, over their summed spans.  No graph launch in the
window: no reading.
"""


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    span = idle = 0.0
    for kernels in trace.graph_replays():
        s = float(kernels[0]["ts"])
        e = max(float(k["ts"]) + float(k.get("dur", 0)) for k in kernels)
        if s < trace.t0 or e > trace.t1:
            continue
        span += e - s
        idle += (e - s) - trace.busy_us(kernels)
    return 100.0 * idle / span if span > 0 else None
