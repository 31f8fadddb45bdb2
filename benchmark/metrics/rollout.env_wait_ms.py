"""``rollout.env_wait_ms``: host ms per cycle waiting for the env workers.

The self time of the program's ``rollout.env_wait`` spans
(``UnifiedVectorEnvAPI.step_dict_wait`` around the workers' step) that
start in the traced sub-window: each span less the ``obs_fuse`` spans
inside it (``obs_fuse.ms`` reads those), summed, over the window's cycles
(the benchmark's ``rollout.forward_with_policy`` spans that start in it).
A program without these spans, or a window without a cycle: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import CYCLE, per  # noqa: E402


def read(ctx):
    return per(ctx["trace"], "rollout.env_wait", CYCLE, inner="obs_fuse")
