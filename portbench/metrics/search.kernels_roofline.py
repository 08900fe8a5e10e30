"""The search kernels' share of their roofline: the bound of the work the
window's calls needed (counts.search_bound: M N D multiply-adds at the
int8 tensor-core peak, or the database and queries moved once) over all
kernel time in the trace, summed over the cell's cards."""


def read(r):
    if r.trace is None or not r.needed.get("search_s"):
        return None
    sec = r.trace.all_kernels_s()
    return 100.0 * r.needed["search_s"] / sec if sec > 0 else None
