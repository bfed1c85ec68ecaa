"""Parity of the port's augmentation (tfssd_torch.data.augment) with the
JAX package's data/augment.py.

The random streams differ (torch.Generator vs jax.random), so the two
parts of the port are held separately:

  * the deterministic part, apply_draws, is fed JAX's own random numbers:
    the test replays augment_image's key splits with jax.random and hands
    the very uniforms JAX used to the port; image, boxes and labels must
    then agree (images within 1e-5: the resample is a float32 matrix
    product summed in another order; boxes within 1e-6; labels equal),
    at s = 20 and at the configs' s = 300 and 512;
  * the sampler, sample_draws + crop_region, is held to a sequential
    numpy oracle of the reference's crop retry loop (a copy of the one in
    tests/test_augment_distribution.py) by the same statistics and
    tolerances as the JAX sampler is.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch.data import augment as ta  # noqa: E402
from tfssd_tpu.data import augment as ja  # noqa: E402

IMG_ATOL = 1e-5


def _image(rng, b, s):
    return rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation",
                                "hue"])
def test_photometric_op_matches_jax(op):
    rng = np.random.default_rng(1)
    img = _image(rng, 3, 12)
    values = {"brightness": [-0.2, 0.05, 0.19],
              "contrast": [0.5, 1.0, 1.49], "saturation": [0.5, 0.8, 1.4],
              "hue": [-0.08, 0.01, 0.07]}[op]
    jfn, tfn = getattr(ja, f"adjust_{op}"), getattr(ta, f"adjust_{op}")
    want = np.stack([np.asarray(jfn(jnp.asarray(img[i]), jnp.float32(v)))
                     for i, v in enumerate(values)])
    got = tfn(torch.from_numpy(img),
              torch.tensor(values, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("region", [
    (-0.9, -1.3, 3.7, 3.7),      # expand, ratio 3.7: the image shrinks
    (-0.2, -0.05, 1.3, 1.3),     # small expand
    (0.1, 0.25, 0.4, 0.6),       # crop: the image grows
    (0.0, 0.0, 1.0, 1.0),        # identity
    (-1.5, -0.7, 3.2, 3.2),      # composed expand + crop
])
def test_apply_region_matches_scale_and_translate(region):
    rng = np.random.default_rng(2)
    img = _image(rng, 1, 24)
    want = np.asarray(ja._apply_region(jnp.asarray(img[0]),
                                       jnp.asarray(region, jnp.float32)))
    got = ta.apply_region(torch.from_numpy(img),
                          torch.tensor([region], dtype=torch.float32))
    np.testing.assert_allclose(got[0].numpy(), want, atol=IMG_ATOL)


def _jax_draws(keys, trials):
    """augment_image's random numbers, replayed from its key splits."""
    def one(rng):
        k_photo, k_exp_p, k_exp, k_crop, k_flip = jax.random.split(rng, 5)
        pk = jax.random.split(k_photo, 8)
        k1, k2, k3 = jax.random.split(k_exp, 3)
        k_iou, k_wh, k_pos, k_none = jax.random.split(k_crop, 4)
        u = jax.random.uniform
        return dict(
            photo_apply=u(pk[0], (4,)),
            brightness=u(pk[1], (), minval=-0.2, maxval=0.2),
            contrast=u(pk[2], (), minval=0.5, maxval=1.5),
            saturation=u(pk[3], (), minval=0.5, maxval=1.5),
            hue=u(pk[4], (), minval=-0.08, maxval=0.08),
            expand_apply=u(k_exp_p, ()),
            expand_ratio=u(k1, (), minval=1.0, maxval=4.0),
            expand_pos=jnp.stack([u(k2, (), minval=0.0, maxval=1.0),
                                  u(k3, (), minval=0.0, maxval=1.0)]),
            crop_choice=jax.random.randint(k_iou, (), 0,
                                           len(ta.MIN_IOU_CHOICES)),
            crop_skip=u(k_none, ()),
            crop_wh=u(k_wh, (trials, 2), minval=0.3, maxval=1.0),
            crop_pos=u(k_pos, (trials, 2)),
            flip=u(k_flip, ()),
        )

    d = jax.jit(jax.vmap(one))(keys)
    out = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    out["crop_choice"] = out["crop_choice"].long()
    return ta.AugmentDraws(**out)


def _config_batch(s):
    """Two seeded (s, s) images with 1-4 gts each and their JAX keys."""
    rng = np.random.default_rng(s)
    b, g = 2, 4
    img = _image(rng, b, s)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        for j in range(int(rng.integers(1, g + 1))):
            y0, x0 = rng.uniform(0, 0.6, 2)
            h, w = rng.uniform(0.15, 0.4, 2)
            boxes[i, j] = [y0, x0, y0 + h, x0 + w]
            labels[i, j] = rng.integers(1, 21)
    return img, boxes, labels, jax.random.split(jax.random.key(s), b)


# JAX's side of the config-size case, run where XLA may not emit FMA
# instructions (--xla_cpu_max_isa=AVX), as tests/test_torch_nms.py runs
# the keep kernel. XLA:CPU otherwise contracts the resample's sample
# positions ((o + 0.5) / scale - t / scale - 0.5) into multiply-adds that
# round once: the positions then move by ~s ulp, the weights with them,
# and at s = 512 the images part by 5.3e-5 (at s = 20 by < 1e-6). Without
# FMAs the port is within 3e-7 at s = 300 and 512.
_CONFIG_SCRIPT = """
import sys
import dataclasses
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import test_torch_augment as t
from tfssd_tpu.data import augment as ja
s, out = int(sys.argv[1]), sys.argv[2]
img, boxes, labels, keys = t._config_batch(s)
want = jax.jit(jax.vmap(ja.augment_image))(
    keys, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(labels))
draws = dataclasses.asdict(t._jax_draws(keys, ja.NUM_TRIALS))
np.savez(out, image=np.asarray(want[0]), boxes=np.asarray(want[1]),
         labels=np.asarray(want[2]),
         **{"draw_" + k: v.numpy() for k, v in draws.items()})
"""


@pytest.mark.parametrize("s", [300, 512])
def test_augment_with_jax_draws_matches_at_the_configs_sizes(s, tmp_path):
    # SSD300's and SSD512's own image sizes: the resample is one matmul
    # pair per image, summed over s rows and s columns.
    out = tmp_path / "augment.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.dirname(here), here]),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", _CONFIG_SCRIPT, str(s), str(out)],
                   env=env, check=True, timeout=600)
    with np.load(out) as f:
        want = {k: f[k] for k in f.files}
    draws = ta.AugmentDraws(**{
        k[len("draw_"):]: torch.from_numpy(v) for k, v in want.items()
        if k.startswith("draw_")})
    img, boxes, labels, _ = _config_batch(s)
    got = ta.apply_draws(torch.from_numpy(img), torch.from_numpy(boxes),
                         torch.from_numpy(labels), draws)
    assert got[0].shape == (2, s, s, 3)
    np.testing.assert_array_equal(got[2].numpy(), want["labels"])
    np.testing.assert_allclose(got[1].numpy(), want["boxes"], atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want["image"],
                               atol=IMG_ATOL)


def test_augment_with_jax_draws_matches_augment_image():
    assert ta.NUM_TRIALS == ja.NUM_TRIALS
    rng = np.random.default_rng(3)
    b, s, g = 16, 20, 4
    img = _image(rng, b, s)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        for j in range(int(rng.integers(1, g + 1))):
            y0, x0 = rng.uniform(0, 0.6, 2)
            h, w = rng.uniform(0.15, 0.4, 2)
            boxes[i, j] = [y0, x0, y0 + h, x0 + w]
            labels[i, j] = rng.integers(1, 21)
    keys = jax.random.split(jax.random.key(11), b)
    want = jax.jit(jax.vmap(ja.augment_image))(
        keys, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(labels))
    draws = _jax_draws(keys, ja.NUM_TRIALS)
    got = ta.apply_draws(torch.from_numpy(img), torch.from_numpy(boxes),
                         torch.from_numpy(labels), draws)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=IMG_ATOL)
    # the draws exercised every branch somewhere in the batch
    assert (draws.expand_apply < 0.5).any() and (draws.flip < 0.5).any()
    assert (draws.expand_apply >= 0.5).any() and (draws.flip >= 0.5).any()
    _, accepted = ta.crop_region(
        draws, ta.transform_boxes(torch.from_numpy(boxes),
                                  ta.expand_region(draws)),
        torch.from_numpy(labels) > 0)
    assert accepted.any() and not accepted.all()
    assert (got[2].numpy() != labels).any()  # some box was dropped


# ---------------------------------------------------------------------------
# The sampler against the sequential oracle (a copy of the oracle in
# tests/test_augment_distribution.py).
# ---------------------------------------------------------------------------

_ORACLE_CHOICES = [None, -1.0, 0.1, 0.3, 0.5, 0.7, 0.9]  # None = skip crop


def oracle_sample_crop(rng, boxes, valid, trials):
    """Sequential-retry crop sampler: the reference's loop in numpy."""
    choice = rng.integers(0, len(_ORACLE_CHOICES))
    min_iou = _ORACLE_CHOICES[choice]
    info = {"choice": choice, "accepted": False}
    identity = np.array([0.0, 0.0, 1.0, 1.0])
    if min_iou is None:
        return identity, info
    vb = boxes[valid]
    cy = (vb[:, 0] + vb[:, 2]) / 2.0
    cx = (vb[:, 1] + vb[:, 3]) / 2.0
    area_b = np.maximum(vb[:, 2] - vb[:, 0], 0) * np.maximum(
        vb[:, 3] - vb[:, 1], 0)
    for _ in range(trials):
        h = rng.uniform(0.3, 1.0)
        w = rng.uniform(0.3, 1.0)
        if not (0.5 < w / h < 2.0):
            continue
        y0 = rng.uniform(0.0, 1.0) * (1.0 - h)
        x0 = rng.uniform(0.0, 1.0) * (1.0 - w)
        iy0 = np.maximum(y0, vb[:, 0])
        ix0 = np.maximum(x0, vb[:, 1])
        iy1 = np.minimum(y0 + h, vb[:, 2])
        ix1 = np.minimum(x0 + w, vb[:, 3])
        inter = np.maximum(iy1 - iy0, 0) * np.maximum(ix1 - ix0, 0)
        iou = inter / np.maximum(h * w + area_b - inter, 1e-8)
        if vb.shape[0] and np.max(iou) < min_iou:
            continue
        center_in = ((cy > y0) & (cy < y0 + h)
                     & (cx > x0) & (cx < x0 + w))
        if not np.any(center_in):
            continue
        info["accepted"] = True
        return np.array([y0, x0, h, w]), info
    return identity, info


def _run_oracle(boxes, valid, n, seed):
    rng = np.random.default_rng(seed)
    regions, choices, accepted = [], [], []
    for _ in range(n):
        r, info = oracle_sample_crop(rng, boxes, valid, ta.NUM_TRIALS)
        regions.append(r)
        choices.append(info["choice"])
        accepted.append(info["accepted"])
    return (np.stack(regions), np.asarray(choices),
            np.asarray(accepted, bool))


def _run_port(boxes, valid, n, seed):
    gen = torch.Generator().manual_seed(seed)
    draws = ta.sample_draws(gen, n)
    bx = torch.from_numpy(boxes)[None].expand(n, -1, -1)
    vl = torch.from_numpy(valid)[None].expand(n, -1)
    region, accepted = ta.crop_region(draws, bx, vl)
    return (region.numpy(), draws.crop_choice.numpy(),
            accepted.numpy().astype(bool))


_SCENES = {
    "easy": np.array([[0.3, 0.3, 0.8, 0.8]], np.float32),
    "hard_small": np.array([[0.05, 0.05, 0.18, 0.2]], np.float32),
    "multi": np.array([[0.1, 0.1, 0.4, 0.35], [0.5, 0.55, 0.9, 0.95],
                       [0.4, 0.2, 0.6, 0.5]], np.float32),
}
_N = 12000


@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_crop_sampler_matches_sequential_oracle(scene):
    boxes = _SCENES[scene]
    valid = np.ones(len(boxes), bool)
    pr, pc, pa = _run_port(boxes, valid, _N, seed=0)
    orr, oc, oa = _run_oracle(boxes, valid, _N, seed=1)
    # P(accepted) and P(identity): two-sample sigma <= 0.0065 at N=12000
    np.testing.assert_allclose(pa.mean(), oa.mean(), atol=0.04)
    ident = np.array([0.0, 0.0, 1.0, 1.0])
    pi = np.all(np.abs(pr - ident) < 1e-7, axis=-1)
    oi = np.all(np.abs(orr - ident) < 1e-7, axis=-1)
    np.testing.assert_allclose(pi.mean(), oi.mean(), atol=0.04)
    # the joint frequency P(accepted, constraint k) (the port, as JAX,
    # draws the constraint over 6 and skips with P = 1/7 apart)
    for k in range(6):
        np.testing.assert_allclose((pa & (pc == k)).mean(),
                                   (oa & (oc == k + 1)).mean(), atol=0.025,
                                   err_msg=f"P(accepted, choice {k})")
    pacc, oacc = pr[pa], orr[oa]
    for name, f in (("area", lambda r: r[:, 2] * r[:, 3]),
                    ("aspect", lambda r: r[:, 3] / r[:, 2]),
                    ("y0", lambda r: r[:, 0]), ("x0", lambda r: r[:, 1])):
        a, b = f(pacc), f(oacc)
        np.testing.assert_allclose(a.mean(), b.mean(), atol=0.035,
                                   err_msg=f"{name} mean")
        np.testing.assert_allclose(a.std(), b.std(), atol=0.035,
                                   err_msg=f"{name} std")
        for q, qv in zip((0.25, 0.5, 0.75), np.quantile(b, [0.25, 0.5,
                                                            0.75])):
            np.testing.assert_allclose((a <= qv).mean(), q, atol=0.05,
                                       err_msg=f"{name} CDF at q{q}")


def test_sample_draws_ranges_and_zero_gt_never_crops():
    gen = torch.Generator().manual_seed(5)
    d = ta.sample_draws(gen, 2000)
    assert float(d.brightness.min()) >= -0.2 and float(
        d.brightness.max()) < 0.2
    assert float(d.expand_ratio.min()) >= 1.0 and float(
        d.expand_ratio.max()) < 4.0
    assert float(d.crop_wh.min()) >= 0.3 and float(d.crop_wh.max()) < 1.0
    assert set(d.crop_choice.tolist()) == set(range(6))
    _, accepted = ta.crop_region(d, torch.zeros(2000, 2, 4),
                                 torch.zeros(2000, 2, dtype=torch.bool))
    assert not accepted.any()
