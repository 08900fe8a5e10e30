"""Host milliseconds a `dist` call spends on the candidates' host float32
chain and keep mask: the span dist_host_chain (each tile of
models/comparator's pair loop) over the window's calls."""

from portbench.harness.program_spans import refs

COUNTERS = refs(["dist_host_chain"])


def read(r):
    if not r.counters.get("dist_host_chain.n") or not r.calls:
        return None
    return 1e-6 * r.counters["dist_host_chain.ns"] / r.calls
