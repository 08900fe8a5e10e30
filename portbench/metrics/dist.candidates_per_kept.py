"""Pairs the card's margin test passes and sends to the host, a pair the
host chain keeps: the counters dist_candidates over dist_kept
(models/comparator). The slack of the device's filter, with, in a
symmetric call, the pairs i >= j of the diagonal tiles, which the finish
drops."""

from portbench.harness.program_counters import refs

COUNTERS = refs(["dist_candidates", "dist_kept"])


def read(r):
    if not r.counters.get("dist_kept"):
        return None
    return r.counters["dist_candidates"] / r.counters["dist_kept"]
