"""tfssd::classwise_keep, RetinaNet's class-wise greedy NMS keep
(ops/kernels/classwise_keep.py): the operator's CPU implementation (the
plain version), its fake implementation, its launch counter and its input
checks; on a card, the kernel against the plain version on every split of
ops/kernels/classwise_keep_cases.py. classwise_nms against a greedy loop
per class on the same splits is in tests/test_torch_retinanet.py.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tfssd_torch.ops.kernels import classwise_keep as ckeep
from tfssd_torch.ops.kernels import nms_keep as tkeep
from tfssd_torch.ops.kernels.classwise_keep_cases import (random_candidates,
                                                          split_cases)
from tfssd_torch.ops.nms import class_order


def _inputs(b=2, t=600, c=9, seed=3, device="cpu"):
    """The op's inputs for random candidates: class-ordered boxes and
    scores, and (B, C) column slices of the ordering's counts and starts,
    as classwise_nms passes them."""
    boxes, scores, classes = (x.to(device) for x in random_candidates(
        b, t, c, seed))
    sb, ss, _, counts, starts = class_order(boxes, scores, classes, c, 0.05)
    return sb, ss, counts[:, :c], starts[:, :c]


def test_the_cpu_op_is_the_plain_version_and_launches_nothing():
    sb, ss, counts, starts = _inputs(c=2)
    before = (ckeep.LAUNCHES, tkeep.LAUNCHES)
    got = ckeep.classwise_keep(sb, ss, counts, starts, 0.5, 0.05)
    want = ckeep.classwise_keep_reference(sb, ss, counts, starts, 0.5, 0.05)
    assert (ckeep.LAUNCHES, tkeep.LAUNCHES) == before
    assert got.dtype == torch.bool and got.shape == ss.shape
    assert torch.equal(got, want)
    # two classes of ~300 candidates: each walks two rows of 256
    assert bool((counts > 256).all())
    assert int(got.sum()) > 0 and not bool(got.all())


def test_the_fake_implementation_gives_the_shape_and_dtype():
    sb, ss, counts, starts = _inputs(b=3, t=300, c=5)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in (sb, ss, counts, starts)]
        out = torch.ops.tfssd.classwise_keep(*fake, 0.5, 0.05)
    assert out.shape == (3, 300) and out.dtype == torch.bool


def test_positions_outside_the_given_classes_are_not_kept():
    sb, ss, counts, starts = _inputs(t=400)
    keep = ckeep.classwise_keep(sb, ss, counts, starts, 0.5, 0.05)
    # without its last class, image 0 keeps nothing from where it started
    last = int(starts[0, -1])
    part = ckeep.classwise_keep(sb, ss, counts[:, :-1], starts[:, :-1], 0.5,
                                0.05)
    assert keep[0, last:].any() and not part[0, last:].any()
    assert torch.equal(part[0, :last], keep[0, :last])
    none = ckeep.classwise_keep(sb, ss, counts[:, :0], starts[:, :0], 0.5,
                                0.05)
    assert not none.any()


def test_the_inputs_are_checked():
    sb, ss, counts, starts = _inputs(t=100)
    with pytest.raises(TypeError):
        ckeep.classwise_keep(sb.double(), ss, counts, starts, 0.5, 0.05)
    with pytest.raises(TypeError):
        ckeep.classwise_keep(sb, ss, counts.int(), starts, 0.5, 0.05)
    with pytest.raises(ValueError):
        ckeep.classwise_keep(sb, ss[:, :50], counts, starts, 0.5, 0.05)
    with pytest.raises(ValueError):
        ckeep.classwise_keep(sb, ss, counts, starts[:1], 0.5, 0.05)
    # the kernel's wrapper takes CUDA tensors only, and no tensor
    # thresholds
    with pytest.raises(ValueError, match="CUDA"):
        ckeep.classwise_keep_cuda(sb, ss, counts, starts, 0.5, 0.05)
    with pytest.raises(TypeError):
        ckeep.classwise_keep_cuda(sb, ss, counts, starts,
                                  torch.tensor(0.5), 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("t", (1, 255, 1500))
def test_the_kernel_matches_the_plain_version_on_every_split_on_card(t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    base = (x.cuda() for x in random_candidates(3, t, 42, 5))
    for name, boxes, scores, classes in split_cases(*base, 42, 0.05):
        sb, ss, _, counts, starts = class_order(boxes, scores, classes, 42,
                                                0.05)
        # all classes, and without the last (its positions stay unkept)
        for c in (42, 41):
            args = (sb, ss, counts[:, :c], starts[:, :c], 0.5, 0.05)
            got = ckeep.classwise_keep_cuda(*args)
            torch.cuda.synchronize()
            want = ckeep.classwise_keep_reference(*args)
            assert torch.equal(got, want), (name, c)
