"""Host milliseconds a search call spends on the winners' host float chain
and the TSV: the span search_host_chain (parallel/search.run_search_cli)
over the window's calls."""

from portbench.harness.program_spans import refs

COUNTERS = refs(["search_host_chain"])


def read(r):
    if not r.counters.get("search_host_chain.n") or not r.calls:
        return None
    return 1e-6 * r.counters["search_host_chain.ns"] / r.calls
