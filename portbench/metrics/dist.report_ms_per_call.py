"""Host milliseconds a `dist` call spends after the tiles: the spans
dist_finish (the survivors joined, the symmetric filter and the (i, j)
order) and dist_report (the stable sort by ANI and the TSV), from
models/comparator, over the window's calls."""

from portbench.harness.program_spans import refs

PARTS = ("dist_finish", "dist_report")
COUNTERS = refs(PARTS)


def read(r):
    if not r.counters.get("dist_report.n") or not r.calls:
        return None
    return 1e-6 * sum(r.counters[f"{p}.ns"] for p in PARTS) / r.calls
