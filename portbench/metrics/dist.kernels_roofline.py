"""`dist`'s kernels' share of their roofline: the bound of the pairs the
window's calls needed (dist_counts.dist_bound: M (M - 1) / 2 D
multiply-adds at the int8 tensor-core peak, or the rows moved once) over
all kernel time in the trace, summed over the cell's cards."""


def read(r):
    if r.trace is None or not r.needed.get("dist_s"):
        return None
    sec = r.trace.all_kernels_s()
    return 100.0 * r.needed["dist_s"] / sec if sec > 0 else None
