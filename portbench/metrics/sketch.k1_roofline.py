"""K1's share of its roofline in a sketch cell: the bound of the hashing
the window's batches needed (positions below each row's n_pos,
counts.k1_bound) over K1's kernel time in the trace. Not reported where the
trace's K1 events differ from the port's launch counter."""

KERNEL = "rolling_packed_kernel"
COUNTER = "k1_launches"
COUNTERS = {"k1_launches":
            "hypergen_tpu_torch.ops.kernels.hash_kernel:hash_packed_rows.launches"}


def read(r):
    if r.trace is None or KERNEL in r.unmatched or not r.needed.get("k1_s"):
        return None
    sec, n = r.trace.kernel_time(KERNEL)
    return 100.0 * r.needed["k1_s"] / sec if n and sec > 0 else None
