"""``device.idle_pct``: the share of the traced sub-window with nothing on the card.

One minus the union of the kernel, memcpy and memset intervals over the
sub-window's length (the benchmark's ``benchmark.traced_window`` span,
which ends after a synchronize).
"""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_us <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us(clip=(trace.t0, trace.t1)) / trace.window_us)
