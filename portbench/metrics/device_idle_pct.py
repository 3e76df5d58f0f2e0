"""device_idle_pct: the share of the traced window in which no operation ran
on the device (one minus the union of busy intervals over the window)."""


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
