"""``graphs.upload_ms``: host ms per update in the copy of the batch into the update program.

The program's ``graphs.upload`` spans (``algorithms/graphs.py``: the host
batch copied into the captured program's static inputs; from pageable
memory the copy first waits for the stream, so the span holds that wait)
that start in the traced sub-window, summed, over the window's count of
``sac.update`` spans.  A program without these spans, or a window without
an update: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import UPDATE, per  # noqa: E402


def read(ctx):
    return per(ctx["trace"], "graphs.upload", UPDATE)
