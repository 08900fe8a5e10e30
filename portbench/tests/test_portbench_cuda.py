"""Small runs of the one-card cells on the card: the kernels' path agrees
with the plain reference there. Run on a machine with a card:

    python -m pytest -q portbench/tests/test_portbench_cuda.py
"""

import pytest
import torch

from portbench.tests.small import run_small


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gtdb_r220_build.files_mix",
                                  "gtdb_r220_build.packed_stream",
                                  "gtdb_r220_db.search_4096"])
def test_small_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run_small(cell, device="cuda", trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
