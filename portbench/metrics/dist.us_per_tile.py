"""Microseconds of `dist`'s pair path a tile product: the span dist_compare
(a whole ani_pairs_thresholded call: the row tiles' upload and split, every
tile's product, margin test, compaction, fetch and host chain, and the
finish) over the tile products, one dist_fetch each (models/comparator)."""

from portbench.harness.program_spans import refs

COUNTERS = {**refs(["dist_compare"], ("ns",)), **refs(["dist_fetch"], ("n",))}


def read(r):
    if not r.counters.get("dist_fetch.n"):
        return None
    return 1e-3 * r.counters["dist_compare.ns"] / r.counters["dist_fetch.n"]
