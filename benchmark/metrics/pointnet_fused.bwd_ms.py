"""``pointnet_fused.bwd_ms``: device ms of one call of the fused PointNet body's winner backward.

One call launches its kernels (every name holds ``winner_bwd``) one after
another on the stream, as a chain that starts with ``winner_bwd_prep``.
The chains whose first kernel starts in the traced sub-window are counted;
a chain whose first kernel ran before it is cut by the window's edge and
left out, with the rest of its kernels.  Their kernels' device time,
summed, over their number.  A program without these kernels (a backward
of plain PyTorch ops) gives no reading.
"""

MARK = "winner_bwd"
FIRST = "winner_bwd_prep"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    total_us, chains, counted = 0.0, 0, False
    for k in trace.kernels:
        name = k["name"]
        if MARK not in name:
            continue
        if FIRST in name:
            counted = trace.t0 <= float(k["ts"]) <= trace.t1
            chains += counted
        if counted:
            total_us += float(k.get("dur", 0))
    return total_us / chains / 1e3 if chains else None
