"""``obs_fuse.ms``: host ms per cycle in the fusion of the raw renders.

The program's ``obs_fuse`` spans (``env/server_env.py`` ``_fuse``: the raw
renders' upload, the fusion's launches, and the copy of the clouds to the
host, which waits for everything queued on the stream before them) that
start in the traced sub-window, summed, over the window's cycles (the
benchmark's ``rollout.forward_with_policy`` spans that start in it).  A
program without these spans, or a window without a cycle: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import CYCLE, per  # noqa: E402


def read(ctx):
    return per(ctx["trace"], "obs_fuse", CYCLE)
