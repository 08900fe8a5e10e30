"""Host milliseconds a build call spends decompressing its sketches into
the dense database before the .hgdb write: the span db_decompress
(io/sketch_db.sketches_to_db) over the window's calls."""

from portbench.harness.program_spans import refs

COUNTERS = refs(["db_decompress"])


def read(r):
    if not r.counters.get("db_decompress.n") or not r.calls:
        return None
    return 1e-6 * r.counters["db_decompress.ns"] / r.calls
