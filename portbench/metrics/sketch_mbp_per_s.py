"""Megabases sketched a second: the bases of every genome whose sketch
completed in the window, over the window's whole time."""


def read(r):
    if not r.work.get("bases"):
        return None
    return r.work["bases"] / 1e6 / r.window_s
