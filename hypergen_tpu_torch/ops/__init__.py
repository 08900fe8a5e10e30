"""Device ops in PyTorch: plain tensor code, plus ``kernels`` for CUDA.

A u64 is carried as the int64 with the same 64 bits (``ops.u64``), because
torch has no uint64 add, shift or compare. Everything here runs on any
device; only ``kernels`` needs a CUDA card for its fast path.
"""
