"""Share of the traced window in which no kernel, copy or set ran, in a
search cell, as the mean over the cell's cards."""


def read(r):
    if r.trace is None or not r.work.get("queries") or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.mean_busy_s(r.n_devices) / r.trace.window_s)
