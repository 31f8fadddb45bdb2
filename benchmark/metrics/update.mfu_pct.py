"""``update.mfu_pct``: the update step's share of the card's peak.

The FLOPs one update needs (``flops.update_flops``: the matrix products of
every encode and head forward, and of the differentiated ones' backward,
the max-pool's over its winner points), times the updates the run's window
completed, over the window's time, over the peak of the configuration's
precision (bf16 at 989 TFLOP/s, f32 at 495/3) times the cards the updates
ran on (a data-parallel cell's ranks share each update).  A run with no
update in its window: no reading.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pcbench.flops import peak_flops  # noqa: E402


def read(ctx):
    w = ctx["window"]
    if not w["updates"] or w["seconds"] <= 0:
        return None
    rate = ctx["flops"]["total"] * w["updates"] / w["seconds"]
    return 100.0 * rate / (peak_flops(ctx["config"]["precision"]) * ctx["chips"])
