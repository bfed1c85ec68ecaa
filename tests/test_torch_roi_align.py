"""tfssd::roi_align, Mask R-CNN's multi-level RoIAlign
(ops/kernels/roi_align.py): its plain version against the benchmark's
reference (portbench/reference/maskrcnn.py:roi_align) bit for bit on every
case of ops/kernels/roi_align_cases.py, in float32 and float64; its
arithmetic against values worked out by hand (a map that is a ramp,
samples past the border, the last row, a box under a cell); the
operator's CPU implementation, its fake implementation, its launch
counter and its input checks; on a card, the kernel against the plain
version on the same cases.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from portbench.reference import maskrcnn as ref
from tfssd_torch.ops.kernels import roi_align as ra
from tfssd_torch.ops.kernels.roi_align_cases import NAMES, crafted_boxes

# A frame of 120 x 150 padded to 128 x 160: P2-P5 of 32x40 ... 4x5.
FRAME = (120, 150)
SHAPES = ((32, 40), (16, 20), (8, 10), (4, 5))
SCALES = [0.25, 0.125, 0.0625, 0.03125]
CFG = {"roi_levels": [2, 3, 4, 5], "roi_canonical_level": 4,
       "roi_canonical_scale": 224}


def _maps(b=2, c=5, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, c, h, w, generator=gen, dtype=dtype).to(device)
            for h, w in SHAPES]


def _levels(boxes):
    return ref.roi_levels(CFG, boxes)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("case", NAMES)
def test_the_plain_version_is_the_references_roi_align(case, dtype):
    boxes = dict(crafted_boxes(2, 60, *FRAME, seed=4))[case].to(dtype)
    maps = _maps(dtype=dtype)
    levels = _levels(boxes)
    for size in (7, 14):
        got = ra.roi_align_reference(maps, boxes, levels, SCALES, size, 2)
        want = ref.roi_align(maps, boxes, levels, SCALES, size, 2)
        assert got.shape == (2, 60, 5, size, size) and got.dtype == dtype
        assert torch.equal(got, want), (case, size)
    if case == "level_edges":
        # the edges' boxes fall on both sides of each edge
        assert len(torch.unique(levels)) == 4
    if case in ("tiny", "outside"):
        # boxes wholly outside the maps read 0; tiny and zero-size ones,
        # their extent raised to a cell, read the map
        assert bool((got == 0).all(dim=(2, 3, 4)).any()) == (
            case == "outside")


def test_the_arithmetic_on_a_ramp():
    """On the map f(y, x) = x + 100 y bilinear interpolation is exact:
    each bin is the mean of its samples' positions, clamped and cut as
    torchvision's bilinear_interpolate does."""
    h, w = 8, 10
    ramp = (torch.arange(w, dtype=torch.float64)[None, :]
            + 100.0 * torch.arange(h, dtype=torch.float64)[:, None])
    maps = [ramp.expand(1, 1, h, w).contiguous()]
    # a box of 4 x 2 cells at scale 1: 2 x 2 bins of 2 x 2 samples
    boxes = torch.tensor([[[2.0, 3.0, 6.0, 5.0],
                           # under a cell: the extent is raised to 1
                           [1.0, 1.0, 1.25, 1.5],
                           # reaches past the last row: clamped, then cut
                           [0.0, 6.5, 2.0, 8.5]]], dtype=torch.float64)
    levels = torch.zeros(1, 3, dtype=torch.int64)
    out = ra.roi_align_reference(maps, boxes, levels, [1.0], 2, 2)[0, :, 0]
    # box 0: x samples 2.5, 3.5 | 4.5, 5.5; y 3.25, 3.75 | 4.25, 4.75
    torch.testing.assert_close(out[0], torch.tensor(
        [[3.0 + 350.0, 5.0 + 350.0], [3.0 + 450.0, 5.0 + 450.0]],
        dtype=torch.float64), rtol=0, atol=1e-12)
    # box 1: extent 1 a side from (1, 1): x 1.125 .. 1.875, y likewise
    torch.testing.assert_close(out[1], torch.tensor(
        [[1.25 + 125.0, 1.75 + 125.0], [1.25 + 175.0, 1.75 + 175.0]],
        dtype=torch.float64), rtol=0, atol=1e-12)
    # box 2: x samples 0.25, 0.75 | 1.25, 1.75; y 6.75 (rows 6 and 7),
    # 7.25 (past row 7 = H - 1: row 7 alone) | 7.75 (row 7), 8.25 (past
    # H = 8: reads 0)
    torch.testing.assert_close(out[2], torch.tensor(
        [[(675.25 + 675.75 + 700.25 + 700.75) / 4,
          (676.25 + 676.75 + 701.25 + 701.75) / 4],
         [(700.25 + 700.75) / 4, (701.25 + 701.75) / 4]],
        dtype=torch.float64), rtol=0, atol=1e-12)


def test_the_chunks_do_not_change_the_result(monkeypatch):
    boxes = dict(crafted_boxes(2, 60, *FRAME, seed=5))["random"]
    maps, levels = _maps(), _levels(boxes)
    whole = ra.roi_align_reference(maps, boxes, levels, SCALES, 7, 2)
    monkeypatch.setattr(ra, "CHUNK_OUTPUTS", 5 * 49 * 4 * 3)
    assert torch.equal(
        ra.roi_align_reference(maps, boxes, levels, SCALES, 7, 2), whole)


def test_the_cpu_op_is_the_plain_version_and_launches_nothing():
    boxes = dict(crafted_boxes(2, 40, *FRAME, seed=6))["random"]
    maps, levels = _maps(), _levels(boxes)
    before = ra.LAUNCHES
    got = ra.roi_align(maps, boxes, levels, SCALES, 7, 2)
    assert ra.LAUNCHES == before
    assert torch.equal(got, ra.roi_align_reference(maps, boxes, levels,
                                                   SCALES, 7, 2))
    # a level out of range is clamped into the levels
    assert torch.equal(
        ra.roi_align(maps, boxes, torch.full_like(levels, 9), SCALES, 7, 2),
        ra.roi_align(maps, boxes, torch.full_like(levels, 3), SCALES, 7, 2))


def test_the_fake_implementation_gives_the_shape_and_dtype():
    boxes = dict(crafted_boxes(2, 30, *FRAME, seed=6))["random"]
    maps, levels = _maps(), _levels(boxes)
    with FakeTensorMode() as mode:
        out = torch.ops.tfssd.roi_align(
            [mode.from_tensor(m) for m in maps], mode.from_tensor(boxes),
            mode.from_tensor(levels), SCALES, 14, 2)
    assert out.shape == (2, 30, 5, 14, 14) and out.dtype == torch.float32


def test_the_inputs_are_checked():
    boxes = dict(crafted_boxes(2, 10, *FRAME, seed=6))["random"]
    maps, levels = _maps(), _levels(boxes)
    with pytest.raises(ValueError, match="scales"):
        ra.roi_align(maps, boxes, levels, SCALES[:3], 7, 2)
    with pytest.raises(TypeError):
        ra.roi_align(maps, boxes, levels.int(), SCALES, 7, 2)
    with pytest.raises(ValueError):
        ra.roi_align(maps, boxes[:1], levels, SCALES, 7, 2)
    with pytest.raises(TypeError):
        ra.roi_align(maps, boxes.double(), levels, SCALES, 7, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ra.roi_align_cuda(maps, boxes, levels, SCALES, 7, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NAMES)
def test_the_kernel_matches_the_plain_version_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    boxes = dict(crafted_boxes(2, 60, *FRAME, seed=4))[case].cuda()
    maps = _maps(device="cuda")
    levels = _levels(boxes)
    for size in (7, 14):
        got = ra.roi_align_cuda(maps, boxes, levels, SCALES, size, 2)
        torch.cuda.synchronize()
        want = ra.roi_align_reference(maps, boxes, levels, SCALES, size, 2)
        assert torch.equal(got, want), (case, size)
