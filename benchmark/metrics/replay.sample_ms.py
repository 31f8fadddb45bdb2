"""``replay.sample_ms``: host ms per update in the host replay's gather.

The program's ``replay.sample`` spans (``ReplayMemory.sample``: the index
draw and the numpy gather of the batch's rows) that start in the traced
sub-window, summed, over the window's count of ``sac.update`` spans (the
host side of one update).  A program without these spans, or a window
without an update: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import UPDATE, per  # noqa: E402


def read(ctx):
    return per(ctx["trace"], "replay.sample", UPDATE)
