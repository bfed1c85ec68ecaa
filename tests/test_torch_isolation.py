"""Import and layout guard of the PyTorch/CUDA port.

The machine with the card has PyTorch, numpy, Pillow and the CUDA toolkit,
but no jax, flax, optax, orbax, tensorstore, zarr, zstandard, chex,
tensorflow, h5py, keras, tensorboard, google_crc32c or protobuf, and
Triton is imported only inside a launching function. So
every module of tfssd_torch and chip_smoke.py must import with all of those
blocked and PIL too (it is imported only where an image is decoded or
drawn), and their sources must not name the JAX package, jax, PyTorch's
ninja-based extension loader or fast math (which would break the kernels'
bit-exactness).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "orbax", "chex", "PIL", "tensorflow",
           "triton", "tensorstore", "zarr", "zstandard", "h5py", "keras",
           "tensorboard", "google_crc32c", "google.protobuf")

_IMPORT_ALL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import importlib, pkgutil
import tfssd_torch, tfssd_torch.predict, tfssd_torch.trainer, chip_smoke
for mod in pkgutil.walk_packages(tfssd_torch.__path__, "tfssd_torch."):
    importlib.import_module(mod.name)
# the training slice's modules and the VGG16 backbone, named so that a
# rename cannot drop them
for name in ("ops.matching", "ops.kernels.match_encode", "ops.losses",
             "data.augment", "data.loader", "train", "trainer",
             "profile_train", "utils.checkpoint", "utils.metrics",
             "utils.io", "utils.convert", "models.vgg16",
             # the serving CLI's slice: the orbax reader, VOC and drawing
             "utils.zstd", "utils.ocdbt", "data.voc", "utils.drawing",
             # the training CLI's slice: tracing, the VOC drill writer
             "utils.profiling", "make_voc_drill",
             # export and data parallelism
             "utils.export", "parallel",
             # --port-h5 and TensorBoard scalars
             "utils.hdf5", "utils.port_weights", "utils.tfevents",
             "make_keras_drill"):
    assert "tfssd_torch." + name in sys.modules, name
leaked = sorted(n for n in sys.modules if sys.modules[n] is not None
                and any(n == b or n.startswith(b + ".") for b in {BLOCKED!r}))
assert not leaked, leaked
"""


def _port_sources():
    files = sorted((ROOT / "tfssd_torch").rglob("*.py"))
    files += sorted((ROOT / "tfssd_torch" / "csrc").glob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_and_chip_smoke_import_without_jax_pil_or_triton():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # chip_smoke.py does its work only under __main__: importing prints
    # nothing.
    assert proc.stdout == ""


@pytest.mark.parametrize("pattern", [r"\btfssd_tpu\b", r"\bjax\b",
                                     r"cpp_extension\.load",
                                     r"use_fast_math"])
def test_port_sources_do_not_name(pattern):
    hits = []
    for path in _port_sources():
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(pattern, line):
                hits.append(f"{path.relative_to(ROOT)}:{no}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_chip_smoke_fails_without_a_card_or_without_the_port(tmp_path):
    # Without CUDA (this test's machine or a CPU-only PyTorch) the script
    # must exit non-zero and print no result line; alone in a directory it
    # must fail on the missing package.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.cuda
def test_predict_serves_ssd512_on_the_card():
    # Here, not beside the VGG16 parity tests: those import JAX, which the
    # card's machine lacks.
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the keep kernel has no CPU mode")
    from tfssd_torch import predict
    from tfssd_torch.ops.kernels import nms_keep

    nms_keep.LAUNCHES = 0
    run = predict.main(["--backbone", "vgg16_512", "--random-weights",
                        "--limit", "4", "--batch-size", "2"])
    torch.cuda.synchronize()
    assert run.config.img_size == 512
    assert nms_keep.LAUNCHES == len(run.results) == 2
    assert run.outputs[0][0].shape == (2, 24564, 4)
    assert run.outputs[0][0].is_cuda
    assert all(torch.isfinite(t).all() for out in run.outputs for t in out)
