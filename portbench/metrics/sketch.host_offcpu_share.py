"""Share of the sketcher's submit (the spans pack and dispatch,
models/sketcher) in which its thread ran no instruction, waiting for the
interpreter lock or a core: their wall less their thread CPU time, over
their wall, summed over the window's batches."""

from portbench.harness.program_spans import refs

PARTS = ("pack", "dispatch")
COUNTERS = refs(PARTS, ("ns", "cpu_ns"))


def read(r):
    wall = [r.counters.get(f"{p}.ns") for p in PARTS]
    cpu = [r.counters.get(f"{p}.cpu_ns") for p in PARTS]
    if None in wall or None in cpu or sum(wall) <= 0:
        return None
    return 100.0 * (sum(wall) - sum(cpu)) / sum(wall)
