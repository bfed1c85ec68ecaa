"""Data parallelism of the port (tfssd_torch/parallel.py, the sharded train
steps, trainer and predict under a process group) against one process at
the global batch and against the JAX package's step, on the CPU with gloo.

One two-rank world (parallel.spawn, PARALLEL_TIMEOUT_S) runs, on each rank,
what tests/test_torch_parallel_ranks.py:rank_work lists; the tests read its
results. Tolerances, each with its reason (measured on an AVX512 CPU):

  * Two train steps at global batch 4 (the dry run's tiny config,
    augmentation on, the model and Adam in float64, its images augmented
    in float32) in the single-step, K-step (--steps-per-call 2), cached
    and rematerialised (--remat: the recompute sums BatchNorm's statistics
    over the ranks again and updates nothing) forms, against the same
    form in one process: the ranks apply the
    global batch's draws to their rows and BatchNorm sums its statistics
    over the ranks in two passes where the one process takes
    F.batch_norm's, so the runs differ by float64 rounding only. The
    losses (which the loss computes in float32) equal; grad_norm within
    GRAD_NORM_REL = 1e-8 relative at step 0 (measured 2.5e-11) and 1e-5
    at step 1, after Adam has turned rounding-level gradients into
    lr-sized steps (measured 1.9e-7); the parameters
    within PARAMS_REL = 1e-6 in relative norm (measured 7.2e-9) and
    UPDATE_LR = 0.01 lr on the largest element (measured 5.3e-4 lr); the
    running statistics within STATS_REL = 1e-8 in relative norm (measured
    3.8e-11); both ranks' weights bit-equal. BatchNorm over each rank's
    own rows instead moves step 0's loss by 5%.
  * One step (augmentation off) of the two ranks from a JAX TrainState
    carried over by utils/convert.py, against JAX's step at the global
    batch of 4: the gates of tests/test_torch_train.py's float64 step
    against JAX (the same rounding of JAX's float32 step).
  * A process group of one rank: bit-equal to the run without a group
    (train steps and serving).
  * predict.serve over the two ranks, device-cached and streamed: the
    gathered NMSResults of every batch equal the one process's (classes
    and valid equal, boxes and scores within ATOL_NMS = 1e-6,
    tests/test_torch_serving.py's NMS tolerance), the same ids and mAP.
  * trainer.main under the two ranks: step 0's losses within 1e-5 of the
    one-process run at the global batch (the streamed feed at full width,
    float32); a batch that does not divide into the ranks stops with the
    JAX trainer's message; only rank 0 writes a checkpoint.
  * dryrun_multichip(2) prints `dryrun_multichip(2): ok`.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import test_torch_parallel_ranks as ranks  # noqa: E402
from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import parallel  # noqa: E402
from tfssd_torch.data.augment import augment_batch, sample_draws, take_rows  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from test_torch_train_parity import (LR, distance, jax_reference,  # noqa: E402
                                     jax_step, np_tree, seeded_moments)

PARALLEL_TIMEOUT_S = 300
GRAD_NORM_REL = (1e-8, 1e-5)  # step 0, step 1
PARAMS_REL = 1e-6
UPDATE_LR = 0.01
STATS_REL = 1e-8
ATOL_NMS = 1e-6
FORMS = ("single", "multi", "cached", "remat")
# tests/test_torch_train.py's TINY and its float64-step-against-JAX gates
JAX_TINY = dict(img_size=96, feature_map_shapes=(6, 3, 2, 1, 1, 1),
                total_labels=6, max_gt_boxes=8, bn_momentum=0.8)
JAX_COUNT = 3  # Adam's step count of the JAX state
JAX_GATES = {"loss": 1e-4, "loc_loss": 1e-4, "conf_loss": 1e-4,
             "grad_norm": 1e-3, "grads_head": 1e-3, "grads": 5e-2,
             "update_head_lr": 1e-3, "update_lr": 0.25, "update": 1e-2,
             "mu": 1e-2, "nu": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch at one thread in this module, as on the ranks (a float32
    forward's bits move with the thread count), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The two-rank world started on rank_work, then, while it runs, JAX's
    step from a state with Adam moments at global batch 4 (its compile
    overlaps the ranks' work); (the ranks' Group, the trainer's
    directories, the JAX step's results)."""
    import jax

    jcfg = j_hyper("mobilenet_v2", **JAX_TINY)
    tcfg = t_hyper("mobilenet_v2", **JAX_TINY)
    model = j_get_model(jcfg)
    state = jtrain.create_train_state(model, jax.random.key(0),
                                      jtrain.make_optimizer(LR))
    mu, nu = seeded_moments(np_tree(state.params))
    ds = SyntheticDataset(num_examples=4, image_size=96, max_objects=2,
                          seed=7, num_classes=5)
    batch = next(batch_examples(ds, 4, jcfg.max_gt_boxes))
    batch = {k: batch[k] for k in ("image", "boxes", "labels")}
    payload = dict(tcfg=tcfg, anchors=generate_anchors(jcfg), batch=batch,
                   params=np_tree(state.params),
                   batch_stats=np_tree(state.batch_stats), mu=mu, nu=nu,
                   count=JAX_COUNT, lr=LR)
    root = tmp_path_factory.mktemp("dp")
    dirs = (str(root / "models"), str(root / "logs"))
    group = parallel.Group(ranks.rank_work, 2, payload, *dirs)
    try:
        reference = jax_reference(jcfg, tcfg, state, batch, mu, nu,
                                  count=JAX_COUNT, with_eval=False)
    except BaseException:
        group.wait(PARALLEL_TIMEOUT_S)
        raise
    return group, dirs, reference


@pytest.fixture(scope="module")
def tiny(started):
    """JAX's step (test_torch_train_parity.jax_reference's results)."""
    return started[2]


@pytest.fixture(scope="module")
def world(started):
    """Each rank's rank_work results, and the directories the trainer
    wrote to."""
    group, dirs, _ = started
    return group.wait(PARALLEL_TIMEOUT_S), dirs


def _rel_norm(got, want, keys):
    a = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    b = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("form", FORMS)
def test_two_ranks_train_as_one_process_at_the_global_batch(world, form):
    want = ranks.train_form(form, parallel.SINGLE)
    results, _ = world
    got = results[0]["forms"][form]
    assert got["step"] == want["step"] == ranks.STEPS
    for g, w, gate in zip(got["metrics"], want["metrics"], GRAD_NORM_REL):
        for k in ("loss", "loc_loss", "conf_loss", "num_pos"):
            assert g[k] == w[k], (k, g[k], w[k])
        assert abs(g["grad_norm"] / w["grad_norm"] - 1) < gate
    keys = sorted(want["state"])
    params = [k for k in keys if "running_" not in k]
    stats = [k for k in keys if "running_" in k]
    assert _rel_norm(got["state"], want["state"], params) < PARAMS_REL
    assert max(float(np.abs(got["state"][k] - want["state"][k]).max())
               for k in params) < UPDATE_LR * 1e-3
    assert _rel_norm(got["state"], want["state"], stats) < STATS_REL
    other = results[1]["forms"][form]
    assert other["metrics"] == got["metrics"]
    for k in keys:
        np.testing.assert_array_equal(other["state"][k], got["state"][k])


def test_two_ranks_step_matches_jax_at_the_global_batch(world, tiny):
    results, _ = world
    got = results[0]["jax_state"]
    got = {key: ({k: torch.from_numpy(v) for k, v in val.items()}
                 if key != "metrics" else val) for key, val in got.items()}
    want = jax_step(tiny)
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"] > 0
    d = distance(got, want)
    assert all(d[k] < v for k, v in JAX_GATES.items()), (d, JAX_GATES)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_a_world_of_one_rank_is_bit_equal_to_no_process_group():
    want = ranks.train_form("single", parallel.SINGLE)
    want_serve = ranks.serve_run(True, parallel.SINGLE)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{parallel.free_port()}",
        rank=0, world_size=1)
    try:
        shard = parallel.current()
        assert shard == parallel.Shard(0, 1, True)
        got = ranks.train_form("single", shard)
        got_serve = ranks.serve_run(True, shard)
    finally:
        dist.destroy_process_group()
    assert got["metrics"] == want["metrics"]
    for k in want["state"]:
        np.testing.assert_array_equal(got["state"][k], want["state"][k])
    for g, w in zip(got_serve["results"], want_serve["results"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device_cache", [True, False])
def test_two_ranks_serve_the_one_process_results(world, device_cache):
    want = ranks.serve_run(device_cache, parallel.SINGLE)
    results, _ = world
    got = results[0]["serve"][device_cache]
    assert got["num_valid"] == want["num_valid"] == [4, 4, 2]
    assert got["ids"] == want["ids"]
    assert got["mean_ap"] == pytest.approx(want["mean_ap"], abs=1e-9)
    assert results[1]["serve"][device_cache]["mean_ap"] is None
    for g, w in zip(got["results"], want["results"]):
        boxes, scores, classes, valid = g
        np.testing.assert_array_equal(valid, w[3])
        np.testing.assert_array_equal(classes, w[2])
        np.testing.assert_allclose(boxes, w[0], atol=ATOL_NMS)
        np.testing.assert_allclose(scores, w[1], atol=ATOL_NMS)


def test_two_ranks_run_the_trainer_cli(world, tmp_path):
    results, (model_dir, log_dir) = world
    want = ranks.trainer_run(str(tmp_path / "m"), str(tmp_path / "l"), 2)
    got = [r["trainer"] for r in results]
    assert [g["rank"] for g in got] == [0, 1]
    assert got[0]["step_metrics"] == got[1]["step_metrics"]
    for k in ("loss", "loc_loss", "conf_loss"):
        g, w = got[0]["step_metrics"][0][k], want["step_metrics"][0][k]
        assert abs(g / w - 1) < 1e-5, (k, g, w)
    assert got[0]["step_metrics"][0]["num_pos"] == \
        want["step_metrics"][0]["num_pos"]
    assert sorted(os.listdir(os.path.join(model_dir,
                                          "ssd_mobilenet_v2_torch"))) == [
        "ckpt_1.json", "ckpt_1.pt"]
    assert len(os.listdir(os.path.join(log_dir, "ssd_mobilenet_v2_torch"))) \
        == 1
    for r in results:
        assert r["trainer_odd"]["exit"] == (
            "--batch-size 3 must be a multiple of the 2 data-parallel ranks "
            "(the batch axis is split over the ranks)")


def test_the_ranks_draw_the_global_batch_augmentation():
    gen = torch.Generator().manual_seed(3)
    images = torch.rand(4, 32, 32, 3, generator=gen)
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]]] * 4)
    labels = torch.ones(4, 1, dtype=torch.int32)
    gen.manual_seed(9)
    whole = augment_batch(gen, images, boxes, labels)
    for rank in range(2):
        gen.manual_seed(9)
        part = augment_batch(gen, images[2 * rank:2 * rank + 2],
                             boxes[:2], labels[:2], rank, 2)
        for a, b in zip(part, whole):
            np.testing.assert_array_equal(
                a.numpy(), b[2 * rank:2 * rank + 2].numpy())
    gen.manual_seed(9)
    draws = take_rows(sample_draws(gen, 4), slice(2, 4))
    assert draws.flip.shape == (2,)


def test_dryrun_multichip_prints_ok(capsys):
    parallel.dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
