"""device_idle_pct.verify: the share of the traced window in which no
operation ran on the card.  The tracer's own cost a launch inflates it on
short calls (a captured 32 x 400 bucket call read 46.0% idle traced
against 29.0% on the host clock, NVIDIA H100 80GB HBM3), so it reads high
against an untraced window."""


def read(out, cell, peaks):
    if out.trace is None or out.trace.window_s <= 0 or out.trace.device_events == 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)
