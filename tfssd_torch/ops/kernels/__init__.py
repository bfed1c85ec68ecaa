"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package, each beside its plain PyTorch version and a launch counter.

  nms_keep.py      — exact greedy NMS keep mask (csrc/nms_keep.cu)
  match_encode.py  — gt matching + target encoding (csrc/match_encode.cu)
  build.py         — nvcc into build/tfssd_torch/, loaded with ctypes
"""
