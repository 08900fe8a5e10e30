"""HyperGen in PyTorch for CUDA: sketch, dist, search and hist.

A second package beside the JAX one, which stays the reference. It imports
torch, never jax, and nothing of ``hypergen_tpu``: the host modules it needs
are its own copies.

  - ``params``   configuration structs and frozen constants.
  - ``io``       FASTA parse and 2-bit pack (native parser in
                 ``csrc/fastx.cpp``, numpy fallback), HV bit-packing, the
                 bincode ``.sketch`` format and the ``.hgdb`` layout.
  - ``ops``      u64 arithmetic on int64 tensors, t1ha2 / mm_hash64 /
                 wyrng, k-mer hashing, compaction, HV encoding, the exact
                 int16 dot (int8 tensor-core splits and the float64 direct
                 dot); ``ops.kernels`` holds the hand-written CUDA kernels
                 and their build.
  - ``models``   the batched sketcher (with the tiled route for huge
                 genomes) and the ANI comparator.
  - ``parallel`` sequence parallelism (one huge genome's chunks over a list
                 of devices) and top-k database search over a list of
                 devices.
  - ``utils``    logging and progress.
  - ``cli``      the ``sketch`` (``.sketch`` or ``.hgdb``, ``--resume``),
                 ``dist``, ``search`` and ``hist`` subcommands.

Outputs are byte-identical to ``python -m hypergen_tpu.cli ... -D cpu``.
"""

from hypergen_tpu_torch.params import DistParams, SketchParams  # noqa: F401
