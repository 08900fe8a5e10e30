"""Host milliseconds to submit one batch of the sketch step (pack and
dispatch): the benchmark's clock around each submit_batch_packed where it
calls it itself; inside sketch_files, the program's pack and dispatch spans
(Sketcher.last_stage_times) over K1's launches in the window."""

COUNTERS = {"k1_launches":
            "hypergen_tpu_torch.ops.kernels.hash_kernel:hash_packed_rows.launches"}


def read(r):
    if r.span_n.get("submit"):
        return 1e3 * r.span_s["submit"] / r.span_n["submit"]
    if r.stages and r.counters.get("k1_launches"):
        return 1e3 * (r.stages.get("pack", 0.0) + r.stages.get("dispatch", 0.0)) \
            / r.counters["k1_launches"]
    return None
