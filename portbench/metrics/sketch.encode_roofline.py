"""The encode kernel's share of its roofline in a sketch cell: the
bound of bundling each sketched row's distinct hashes (counts.encode_bound,
hash counts from the plain reference) over the encode's kernel time in the
trace. Not reported where the trace's encode events differ from the port's
launch counter."""

KERNEL = "encode_hv_kernel"
COUNTER = "encode_launches"
COUNTERS = {"encode_launches":
            "hypergen_tpu_torch.ops.kernels.encode_kernel:encode_hv_i16.launches"}


def read(r):
    if r.trace is None or KERNEL in r.unmatched or not r.needed.get("encode_s"):
        return None
    sec, n = r.trace.kernel_time(KERNEL)
    return 100.0 * r.needed["encode_s"] / sec if n and sec > 0 else None
