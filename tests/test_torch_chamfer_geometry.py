"""The Chamfer kernel's launch geometry (``ops/chamfer_kernel.py::
launch_geometry``), checked on the CPU against the layout of
``csrc/chamfer.cu``: every gt and pred point is walked, the block stays
within the card's limits, and the main path's shapes fill the H100's SMs.
"""

import pytest

from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck

# (frames, N gt points, M pred points, C): the card tests' and phase 7a's
# shapes, the orced_inference chunk, a serving request, and one whose
# minima do not fit in shared memory
SHAPES = {
    "n1": (6, 1, 1, 4),
    "n1_m9": (6, 1, 9, 4),
    "ragged_n37_m53": (15, 37, 53, 4),
    "c5": (15, 37, 53, 5),
    "n704": (24, 704, 704, 4),
    "two_tiles": (2, 1500, 2100, 4),
    "chunk_1920": (1920, 150, 150, 4),
    "request_480": (480, 150, 150, 4),
    "one_frame": (1, 150, 150, 4),
    "scratch": (2, 3000, 4000, 4),
}
KERNEL_MAX_THREADS = 256  # __launch_bounds__ of csrc/chamfer.cu


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_every_point_is_covered(shape):
    frames, n, m, c = shape
    geo = ck.launch_geometry(frames, n, m, c)
    pass_rows = ck.ROW_LANES * geo.rows_per_thread
    rows = {base + tr + ck.ROW_LANES * k
            for base in range(0, n, pass_rows)
            for tr in range(ck.ROW_LANES) for k in range(geo.rows_per_thread)}
    assert set(range(n)) <= rows
    lanes = ck.COL_LANES * geo.warps
    step = ck.COL_GROUP * lanes
    cols = set()
    for t0 in range(0, m, geo.tile_cap):
        cnt = min(m - t0, geo.tile_cap)
        padded = -(-cnt // step) * step
        assert padded <= geo.tile_cap  # the padded tile fits the staged buffer
        walked = [t0 + j0 + tc * ck.COL_GROUP + s for j0 in range(0, padded, step)
                  for tc in range(lanes) for s in range(ck.COL_GROUP)]
        assert len(set(walked)) == len(walked) == padded  # each staged column walked once
        cols.update(j for j in walked if j < t0 + cnt)
    assert cols == set(range(m))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_block_within_card_limits(shape):
    frames, n, m, c = shape
    geo = ck.launch_geometry(frames, n, m, c)
    assert geo.rows_per_thread in ck.ROWS_PER_THREAD
    assert geo.warps in ck.WARPS_PER_FRAME
    assert 32 * geo.warps <= KERNEL_MAX_THREADS <= 1024
    assert geo.tile_cap % (ck.COL_GROUP * ck.COL_LANES * geo.warps) == 0
    assert geo.tile_cap <= ck.COL_TILE
    floats = geo.tile_cap * (c + 2) + geo.warps * ck.ROW_LANES * geo.rows_per_thread
    if geo.scratch_floats:
        assert geo.scratch_floats == frames * (n + m)
        assert 4 * (floats + n + m) > ck.SMEM_LIMIT  # scratch only where it must
    else:
        floats += n + m
    assert geo.smem_bytes == 4 * floats <= ck.SMEM_LIMIT


@pytest.mark.parametrize("frames", [1920, 480], ids=["chunk_1920", "request_480"])
def test_main_path_shapes_fill_the_card(frames):
    """Every SM gets frames, and at least 8 warps each (two for each of its
    four schedulers), at both the chunk and the serving request."""
    geo = ck.launch_geometry(frames, 150, 150, 4)
    assert frames >= ck.SMS
    assert frames * geo.warps >= 8 * ck.SMS
    assert geo.rows_per_thread * ck.ROW_LANES >= 150  # one pass over the rows
    assert geo.scratch_floats == 0


def test_geometry_depends_on_the_shape_only():
    assert ck.launch_geometry(1920, 150, 150, 4) == ck.launch_geometry(1920, 150, 150, 4)
    assert ck.launch_geometry(1, 150, 150, 4).rows_per_thread == \
        ck.launch_geometry(1920, 150, 150, 4).rows_per_thread
