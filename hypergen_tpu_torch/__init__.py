"""HyperGen in PyTorch: the sketch -> dist path of ``hypergen_tpu`` for CUDA.

A second package beside the JAX one, which stays the reference. It imports
torch and never jax. The JAX-free host modules of ``hypergen_tpu`` are
reused as they are: ``params``, ``io.fastx`` (FASTA parse and 2-bit pack),
``io.sketch_db`` (the bincode ``.sketch`` format) and ``utils.logging``.

  - ``ops``      u64 arithmetic on int64 tensors, t1ha2 / mm_hash64 /
                 wyrng, k-mer hashing, compaction, HV encoding, the exact
                 int16 dot; ``ops.kernels`` holds the hand-written CUDA
                 kernel and its build.
  - ``models``   the batched sketcher and the ANI comparator.
  - ``cli``      the ``sketch`` and ``dist`` subcommands.

Outputs are byte-identical to ``python -m hypergen_tpu.cli ... -D cpu``.
"""

from hypergen_tpu.params import DistParams, SketchParams  # noqa: F401
