"""Share of a search call spent loading the two .hgdb directories: the
benchmark's span around each load_db over its span around each call."""


def read(r):
    if not r.span_s.get("search_call"):
        return None
    return 100.0 * r.span_s.get("load_db", 0.0) / r.span_s["search_call"]
