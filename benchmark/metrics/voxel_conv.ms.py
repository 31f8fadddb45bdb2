"""``voxel_conv.ms``: device ms per update of the 3D convolutions' kernels.

cuDNN's forward, input-gradient and weight-gradient kernels and its
helpers (layout conversions, output fills) that start in the traced
sub-window, summed, over the sub-window's updates.  The calls they make
are held to the port's counts (``pcbench/convs.py``): a mismatch, a
window without a convolution, or a program without the counters gives no
reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.convs import window_calls  # noqa: E402


def read(ctx):
    found = window_calls(ctx)
    if found is None or not ctx.get("traced_updates"):
        return None
    return found["us"] / 1e3 / ctx["traced_updates"]
