"""``forward_async.dispatch_ms``: host ms per cycle in the act's dispatch.

The program's ``forward_async.dispatch`` spans (``BaseAgent.forward_async``:
the obs packed on the host, their upload, the act's launches, the pinned
copy of the actions enqueued) that start in the traced sub-window, summed,
over the window's cycles (the benchmark's ``rollout.forward_with_policy``
spans that start in it).  A program without these spans, or a window
without a cycle: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import CYCLE, per  # noqa: E402


def read(ctx):
    return per(ctx["trace"], "forward_async.dispatch", CYCLE)
