"""``voxel_conv.roofline_pct``: the 3D convolutions' share of their roofline.

The least time of every convolution call in the traced sub-window (the
encoder module's ``least_ms``: each call's products at the f32 peak that
``flops.bound_ms`` takes, or its bytes at HBM's rate, whichever is larger,
at the rows of an update's encode), summed, over the device time of the
kernels that ran them (main kernels and cuDNN's helpers).  The calls
are those the trace shows, held to the port's counts (``pcbench/convs.py``);
each encode runs every layer once, so a kind's calls fall evenly on the
layers.  A mismatch, a window without a convolution, a program without the
counters, or an encoder without ``least_ms``: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench import encoders  # noqa: E402
from pcbench.convs import KINDS, window_calls  # noqa: E402


def read(ctx):
    found = window_calls(ctx)
    config = ctx["config"]
    least_ms = getattr(encoders.load(config["reference"]["encoder"]), "least_ms", None)
    if found is None or least_ms is None:
        return None
    shapes = config["shapes"]
    rows = int(shapes["batch_size"]) // int(ctx["chips"]) * int(shapes.get("num_aug", 1))
    least = least_ms(shapes, rows, config["precision"])
    layers = len(shapes["widths"])
    work_ms = 0.0
    for kind in KINDS:
        per_layer, rest = divmod(found["calls"][kind], layers)
        if rest:
            return None
        work_ms += per_layer * sum(least[(i, kind)] for i in range(layers))
    return 100.0 * work_ms * 1e3 / found["us"]
