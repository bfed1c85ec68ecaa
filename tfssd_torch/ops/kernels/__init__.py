"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package, each beside its plain PyTorch version and a launch counter,
and each registered as a custom operator (torch.library) whose CPU
implementation is the plain version and whose CUDA implementation is the
kernel. Importing this package registers both operators, which is all a
process that loads an exported program needs of the port besides
utils/export.py.

  nms_keep.py      — tfssd::nms_keep, exact greedy NMS keep mask
                     (csrc/nms_keep.cu)
  match_encode.py  — tfssd::match_encode, gt matching + target encoding
                     (csrc/match_encode.cu)
  build.py         — nvcc into build/tfssd_torch/, loaded with ctypes
"""

from tfssd_torch.ops.kernels import match_encode, nms_keep  # noqa: F401
