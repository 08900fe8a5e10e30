"""Share of the traced window in which no kernel, copy or set ran on the
card, in a sketch cell: one minus the union of the device's intervals over
the window."""


def read(r):
    if r.trace is None or not r.work.get("bases") or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.mean_busy_s(r.n_devices) / r.trace.window_s)
