"""Share of the program's .hgdb load spent reading the shards' files: the
span db_load_read over db_load_manifest + db_load_read + db_load_assemble
(io/sketch_db.load_sharded_db), summed over the window's loads."""

from portbench.harness.program_spans import refs

PARTS = ("db_load_manifest", "db_load_read", "db_load_assemble")
COUNTERS = refs(PARTS, ("ns",))


def read(r):
    ns = {p: r.counters.get(f"{p}.ns") for p in PARTS}
    if None in ns.values() or sum(ns.values()) <= 0:
        return None
    return 100.0 * ns["db_load_read"] / sum(ns.values())
