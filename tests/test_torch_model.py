"""Parity of the port's model blocks (tfssd_torch.models.layers) with the
JAX package's Flax blocks: the same seeded weights, converted by
tfssd_torch.utils.convert, and the same inputs give the same outputs
within 1e-5, with BatchNorm folded and unfolded. Odd and even input sizes
hit both TF "SAME" paddings of a stride-2 conv ((1, 1) and (0, 1))."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch.models import layers as tlayers  # noqa: E402
from tfssd_torch.models.layers import same_padding  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_torch.utils.fold_bn import fold_batch_norm as tfold  # noqa: E402
from tfssd_tpu.models import layers as jlayers  # noqa: E402
from tfssd_tpu.utils.fold_bn import fold_batch_norm as jfold  # noqa: E402

ATOL = 1e-5


def _randomize(variables, seed):
    """Replace every leaf with seeded numpy values; BN variances positive."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(0, 1, shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


# name -> (Flax module factory, torch module factory, in channels)
BLOCKS = {
    "convbn_s2": (lambda fold: jlayers.ConvBN(16, (3, 3), strides=(2, 2),
                                              fold_bn=fold),
                  lambda fold: tlayers.ConvBN(8, 16, 3, 2, fold_bn=fold), 8),
    "convbn_s1": (lambda fold: jlayers.ConvBN(24, (3, 3), fold_bn=fold),
                  lambda fold: tlayers.ConvBN(12, 24, 3, 1, fold_bn=fold),
                  12),
    "inverted_residual_s1": (
        lambda fold: jlayers.InvertedResidual(16, stride=1, expand_ratio=2,
                                              fold_bn=fold),
        lambda fold: tlayers.InvertedResidual(16, 16, 1, 2, fold_bn=fold),
        16),
    "inverted_residual_s2": (
        lambda fold: jlayers.InvertedResidual(24, stride=2, expand_ratio=2,
                                              fold_bn=fold),
        lambda fold: tlayers.InvertedResidual(16, 24, 2, 2, fold_bn=fold),
        16),
    "extra_block": (
        lambda fold: jlayers.ExtraFeatureBlock(16, 32, use_bn=True,
                                               fold_bn=fold),
        lambda fold: tlayers.ExtraFeatureBlock(24, 16, 32, fold_bn=fold),
        24),
}


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_parity(block, fold, size):
    make_j, make_t, cin = BLOCKS[block]
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    jmod = make_j(False)
    variables = _randomize(jmod.init(jax.random.key(0), jnp.asarray(x)),
                           seed=len(block))
    if fold:
        # fold_batch_norm folds ConvBN subtrees, so nest the block one level
        wrapped = jfold({c: {"m": v} for c, v in variables.items()})
        jvars = {c: v["m"] for c, v in wrapped.items()}
        want = make_j(True).apply(jvars, jnp.asarray(x))
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    want = np.asarray(want)

    tmod = make_t(False)
    convert.load_variables(tmod, variables)
    if fold:
        folded = make_t(True)
        folded.load_state_dict(tfold(tmod.state_dict()))
        tmod = folded
        # the JAX-folded tree converts into the same folded module
        check = convert.load_variables(make_t(True), jvars).state_dict()
        for k, v in tmod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), check[k].numpy(),
                                       atol=1e-6, err_msg=k)
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("size,stride,want", [
    (300, 2, (0, 1)), (150, 2, (0, 1)), (75, 2, (1, 1)), (38, 2, (0, 1)),
    (19, 2, (1, 1)), (10, 2, (0, 1)), (5, 2, (1, 1)), (3, 2, (1, 1)),
    (2, 2, (0, 1)), (19, 1, (1, 1)), (1, 1, (1, 1))])
def test_same_padding_of_the_serving_shapes(size, stride, want):
    assert same_padding(size, 3, stride) == want


def test_convert_layouts_and_unknown_keys():
    tree = {"params": {"blk": {"conv": {
        "kernel": np.arange(3 * 3 * 1 * 5, dtype=np.float32).reshape(
            3, 3, 1, 5)}}}}
    sd = convert.variables_to_state_dict(tree)
    w = sd["blk.conv.weight"]
    assert w.shape == (5, 1, 3, 3)  # depthwise HWIO -> OIHW
    assert w[4, 0, 2, 1] == tree["params"]["blk"]["conv"]["kernel"][2, 1, 0, 4]
    flat = convert.flatten_tree(tree)
    assert list(flat) == ["params/blk/conv/kernel"]
    assert convert.variables_to_state_dict(flat).keys() == sd.keys()
    with pytest.raises(KeyError):
        convert.variables_to_state_dict({"params": {"blk": {"beta": 1.0}}})
    with pytest.raises(RuntimeError):  # a key the model does not have
        convert.load_variables(
            tlayers.ConvBN(1, 5, 3, groups=1, fold_bn=True),
            {"params": {"conv": {"kernel": np.zeros((3, 3, 1, 5)),
                                 "bias": np.zeros(5)},
                        "extra": {"bias": np.zeros(5)}}})
