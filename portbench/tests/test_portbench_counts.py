"""The frozen bounds reproduce the numbers the repository has quoted."""

import pytest

from portbench.harness import counts


def test_k1_bound_at_the_production_shape():
    # PERF.md §6: 0.0440 ms at 8 x 32 x 131072, bounded by operations; the
    # rows of chip_smoke.py's phase 4 end 1,000 (b + 1) positions short
    nc, C, cells, cap = 32, 131072, 2048, 4
    n_pos = sum(nc * C - 1000 * (b + 1) for b in range(8))
    sec, by = counts.k1_bound(8, nc * C // 16 + 4, n_pos, nc, 21, cap, cells)
    assert by == "operations"
    assert round(sec * 1e3, 4) == 0.0440


@pytest.mark.parametrize("rows, valid, ms", [
    (8, 22_532, 0.000344), (1, 89_920, 0.001374), (1, 1_453_769, 0.022219)])
def test_encode_bound_at_phase_16_shapes(rows, valid, ms):
    sec, by = counts.encode_bound(rows, valid, 4096)
    assert by == "operations"
    assert round(sec * 1e3, 6) == ms


def test_search_bound_at_gtdb_scale():
    sec, by = counts.search_bound(113_104, 4096, 4096, 10)
    assert by == "operations"
    assert round(sec * 1e3, 3) == 1.918
    bytes_s = ((113_104 + 4096) * (4096 * 2 + 4) + 4096 * 10 * 12) \
        / counts.HBM_BYTES_PER_S
    assert round(bytes_s * 1e3, 3) == 0.287


def test_t1ha2_multiply_adds():
    assert counts.t1ha2_mads(21) == 22
    assert counts.t1ha2_mads(32) == 26
