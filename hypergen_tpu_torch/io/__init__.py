"""Host-side I/O: FASTA parsing/normalization, HV bit-packing, sketch DB."""

from hypergen_tpu_torch.io.fastx import (  # noqa: F401
    codes_from_records,
    read_fasta_records,
    seq_to_codes,
)
from hypergen_tpu_torch.io.sketch_db import (  # noqa: F401
    FileSketch,
    dump_sketch,
    load_sketch,
)
