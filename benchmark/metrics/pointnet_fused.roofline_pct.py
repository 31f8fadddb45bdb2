"""``pointnet_fused.roofline_pct``: the fused PointNet body's share of its roofline.

Every launch of ``pointnet_fused_fwd_idx`` / ``pointnet_fused_fwd_max`` in
the traced sub-window is its three kernels (``prep_weights_kernel``, the
body kernel ``pointnet_body_idx_kernel`` / ``pointnet_body_max_kernel``,
``merge_chunks_kernel``), one after another on the stream.  The least time
of each launch (``flops.bound_ms`` at its rows, the configuration's points,
channels and widths, its dtype from the body kernel's name) is summed, and
divided by the device time of those kernels.  A launch's rows come from the
merge kernel's grid (one block per 256 outputs of rows x the last width),
matched against the rows the cell runs at; a launch matching none of them
is an error.  The launches found are held to the program's own counters
(``pointnet_fused.launch_counts`` over the sub-window): a trace that lost
some gives no reading, nor does a window without a launch.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.flops import bound_ms  # noqa: E402

BODY = ("pointnet_body_idx_kernel", "pointnet_body_max_kernel")


def read(ctx):
    trace, shapes = ctx["trace"], ctx["config"]["shapes"]
    if trace is None:
        return None
    widths = [int(w) for w in shapes["widths"]]
    N, C = int(shapes["points"]), int(shapes["channels"])
    blocks = {-(-r * widths[-1] // 256): r for r in ctx["kernel_rows"]}
    ks = [k for k in trace.kernels if trace.t0 <= k["ts"] <= trace.t1]
    work = time_us = 0.0
    found = 0
    used = set()
    for i, k in enumerate(ks):
        name = k["name"]
        if not any(b in name for b in BODY):
            continue
        prep = next((j for j in range(i - 1, -1, -1) if j not in used and "prep_weights_kernel" in ks[j]["name"]), None)
        merge = next((j for j in range(i + 1, len(ks)) if j not in used and "merge_chunks_kernel" in ks[j]["name"]),
                     None)
        if prep is None or merge is None:
            continue  # cut by the window's edge
        used.update((prep, merge))
        grid = ks[merge].get("args", {}).get("grid", [0])[0]
        if grid not in blocks:
            raise ValueError(f"a fused PointNet launch with a merge grid of {grid} blocks matches none of the "
                             f"cell's rows {ctx['kernel_rows']}")
        dtype = "bfloat16" if "bfloat16" in name else "float32"
        work += 1e3 * bound_ms(blocks[grid], N, C, widths, dtype, "idx" in name)[0]
        time_us += sum(float(ks[j].get("dur", 0)) for j in (prep, i, merge))
        found += 1
    if found != sum(ctx["launches"].values()):
        return None
    return 100.0 * work / time_us if time_us > 0 else None
