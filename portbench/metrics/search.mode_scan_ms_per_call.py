"""Host milliseconds a search call spends choosing the dot's mode: the
span search_mode_scan (resolve_mode's abs_bound over the whole database and
the queries, parallel/search) over the window's calls."""

from portbench.harness.program_spans import refs

COUNTERS = refs(["search_mode_scan"])


def read(r):
    if not r.counters.get("search_mode_scan.n") or not r.calls:
        return None
    return 1e-6 * r.counters["search_mode_scan.ns"] / r.calls
