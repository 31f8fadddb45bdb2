"""``parallel.allreduce_ms``: device ms of the gradient exchange per update, the least over the ranks.

On each rank, the NCCL all-reduce kernels (their names, as the trace gives
them, hold ``nccl`` and ``AllReduce``) that start in the traced sub-window,
their device time summed, over the updates of the sub-window.  A rank's
kernel waits on the card until every rank has reached it, so the rank that
reaches it last waits least: the least over the ranks (``combine``) is the
exchange itself with no launch skew in it.  A run on one card, or a
program whose exchange launches no such kernel, gives no reading.
"""


def _is_allreduce(name: str) -> bool:
    low = name.lower()
    return "nccl" in low and "allreduce" in low


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx.get("chips", 1) < 2 or not ctx.get("traced_updates"):
        return None
    us = [float(k.get("dur", 0)) for k in trace.kernels
          if _is_allreduce(k["name"]) and trace.t0 <= float(k["ts"]) <= trace.t1]
    if not us:
        return None
    return sum(us) / ctx["traced_updates"] / 1e3


def combine(values):
    """The least of the ranks' readings."""
    found = [v for v in values if v is not None]
    return min(found) if found else None
