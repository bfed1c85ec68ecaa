"""Parity of the port's SSD loss (tfssd_torch.ops.losses) with the JAX
package's ops/losses.py: the total, the metrics dict and the gradients
with respect to the predicted deltas and logits, on numpy-seeded targets
and predictions, with exact ties among the negatives' losses (the
hard-negative ranking must break them by index on both sides: a stable
sort).

Tolerances: 1e-5 relative on the losses (float32 sums in another order),
num_pos equal, hard-negative selections equal, gradients within 1e-6
absolute (they are of order 1 / (B * #pos)).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch.ops import losses as tl  # noqa: E402
from tfssd_tpu.ops import losses as jl  # noqa: E402

B, N, L = 3, 64, 6


def _inputs(seed, ties):
    rng = np.random.default_rng(seed)
    labels = np.zeros((B, N), np.int64)
    for b in range(B):
        pos = rng.choice(N, size=int(rng.integers(0, 8)), replace=False)
        labels[b, pos] = rng.integers(1, L, size=len(pos))
    onehot = np.eye(L, dtype=np.float32)[labels]
    actual = (rng.normal(0, 1, (B, N, 4)) * (labels > 0)[..., None]).astype(
        np.float32)
    pred = rng.normal(0, 1.5, (B, N, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (B, N, L)).astype(np.float32)
    if ties:
        # blocks of identical logit rows -> identical negative losses
        logits[:, 10:40] = logits[:, 10:11]
        logits[:, 50:] = logits[:, 50:51]
    return actual, onehot, pred, logits


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_losses_and_gradients_match_jax(seed, ties):
    actual, onehot, pred, logits = _inputs(seed, ties)

    def jloss(p, lg):
        return jl.ssd_losses(jnp.asarray(actual), jnp.asarray(onehot), p, lg,
                             3, 1.0)

    (jtotal, jmet), (jgd, jgl) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(pred),
                                             jnp.asarray(logits))

    tp = torch.from_numpy(pred).requires_grad_(True)
    tlg = torch.from_numpy(logits).requires_grad_(True)
    total, met = tl.ssd_losses(torch.from_numpy(actual),
                               torch.from_numpy(onehot), tp, tlg, 3, 1.0)
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in ("loss", "loc_loss", "conf_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(met["num_pos"]) == float(jmet["num_pos"])
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgd), atol=1e-6)
    np.testing.assert_allclose(tlg.grad.numpy(), np.asarray(jgl), atol=1e-6)


def test_rank_descending_breaks_ties_by_index():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 4, size=(5, 40)).astype(np.float32)  # many ties
    v[:, :3] = -np.inf
    got = tl.rank_descending(torch.from_numpy(v)).numpy()
    want = np.asarray(jl.rank_descending(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    # and the hard-negative selection it implies
    onehot = np.zeros((5, 40, 3), np.float32)
    onehot[:, :, 0] = 1.0
    onehot[:, :3, 0], onehot[:, :3, 1] = 0.0, 1.0
    logits = np.zeros((5, 40, 3), np.float32)
    logits[..., 1] = np.where(np.isfinite(v), v, 0.0)  # tied negative losses
    got = tl.confidence_loss(torch.from_numpy(onehot),
                             torch.from_numpy(logits), 3)
    want = jl.confidence_loss(jnp.asarray(onehot), jnp.asarray(logits), 3)
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_huber_matches_jax():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_allclose(tl.huber(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.huber(jnp.asarray(x))),
                               atol=1e-7)
