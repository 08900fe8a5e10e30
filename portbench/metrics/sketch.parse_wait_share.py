"""Share of sketch_files' wall spent on the parse: the program's host spans
fasta_read (waiting on a parse) and io_pool (the parser pool's own time)
over the sum of its spans, which is the wall (Sketcher.last_stage_times),
summed over the window's calls."""


def read(r):
    st = r.stages
    if not st or sum(st.values()) <= 0:
        return None
    return 100.0 * (st.get("fasta_read", 0.0) + st.get("io_pool", 0.0)) / sum(
        st.values())
