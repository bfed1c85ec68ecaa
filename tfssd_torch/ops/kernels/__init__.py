"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package, each beside its plain PyTorch version and a launch counter,
and each registered as a custom operator (torch.library) whose CPU
implementation is the plain version and whose CUDA implementation is the
kernel. Importing this package registers every operator, which is all a
process that loads an exported program needs of the port besides
utils/export.py.

  nms_keep.py      — tfssd::nms_keep, exact greedy NMS keep mask
                     (csrc/nms_keep.cu)
  match_encode.py  — tfssd::match_encode, gt matching + target encoding
                     (csrc/match_encode.cu)
  classwise_keep.py — tfssd::classwise_keep, RetinaNet's class-wise exact
                     greedy NMS keep (csrc/classwise_keep.cu; no TPU kernel)
  grouped_conv3x3.py — tfssd::grouped_conv3x3, RetinaNet's grouped 3x3
                     convs with bias and ReLU (csrc/grouped_conv3x3.cu; no
                     TPU kernel)
  roi_align.py     — tfssd::roi_align, Mask R-CNN's multi-level RoIAlign
                     (csrc/roi_align.cu; no TPU kernel)
  dense_conv.py    — tfssd::dense_conv, the ResNet trunks' groups-1 1x1
                     and 3x3 convs with bias, shortcut add and ReLU
                     (csrc/dense_conv.cu; no TPU kernel)
  build.py         — nvcc into build/tfssd_torch/, loaded with ctypes
"""

from tfssd_torch.ops.kernels import (  # noqa: F401
    classwise_keep, dense_conv, grouped_conv3x3, match_encode, nms_keep,
    roi_align)
