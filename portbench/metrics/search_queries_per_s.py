"""Queries searched a second: the queries of every call completed in the
window, over the window's whole time."""


def read(r):
    if not r.work.get("queries"):
        return None
    return r.work["queries"] / r.window_s
