"""Milliseconds of host-to-device copies a search call, from the trace,
summed over the cell's cards."""


def read(r):
    if r.trace is None or not r.work.get("queries") or not r.calls:
        return None
    return 1e3 * r.trace.htod_s / r.calls
