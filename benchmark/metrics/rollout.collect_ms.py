"""``rollout.collect_ms``: host ms per cycle in the collection.

The benchmark's own span around each ``rollout.forward_with_policy`` call
of the window (the act dispatches, the env steps, the replay push), less
the update chunks its ``update_hook`` ran inside it, averaged over the
window's cycles.  A cell without a collection: no reading.
"""

import math


def read(ctx):
    v = ctx["spans"].get("collect_ms")
    return None if v is None or not math.isfinite(v) else float(v)
