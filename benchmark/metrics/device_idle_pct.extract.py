"""device_idle_pct.extract: the share of the traced window in which no
operation ran on the card (the union of the trace's device intervals)."""


def read(out, cell, peaks):
    if out.trace is None or out.trace.window_s <= 0 or out.trace.device_events == 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)
