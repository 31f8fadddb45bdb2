"""``graphs.rebuilds``: update programs run eagerly or captured inside the traced sub-window.

The program's ``graphs.eager`` (a program's eager first run) and
``graphs.capture`` spans that start in the window, counted.  Once set-up
has run each program twice it is only replayed, so a sound window reads
0; a key that changes from call to call rebuilds its program on every
call.  A window with none of the program's ``graphs.*`` spans (a program
without them): no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.spans import in_window  # noqa: E402


def read(ctx):
    trace = ctx["trace"]
    rebuilt = len(in_window(trace, "graphs.eager")) + len(in_window(trace, "graphs.capture"))
    if not rebuilt and not in_window(trace, "graphs.replay"):
        return None
    return float(rebuilt)
