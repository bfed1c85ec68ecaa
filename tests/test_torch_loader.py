"""The port's host data staging (tfssd_torch.data.loader.stage_arrays,
prefetch) against the JAX package's data/loader.py: the same arrays for
the same synthetic dataset, byte for byte, and a prefetcher that keeps
order, raises the producer's exception and stops early."""

import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from tfssd_torch.data import loader as tloader  # noqa: E402
from tfssd_torch.data.synthetic import SyntheticDataset as TSynth  # noqa: E402
from tfssd_tpu.data import loader as jloader  # noqa: E402
from tfssd_tpu.data.synthetic import SyntheticDataset as JSynth  # noqa: E402


@pytest.mark.parametrize("pad", [None, 4])
def test_stage_arrays_equals_jax(pad):
    kw = dict(num_examples=6, image_size=32, max_objects=3, seed=2)
    got, n = tloader.stage_arrays(TSynth(**kw), 8, pad_to_multiple=pad)
    want, wn = jloader.stage_arrays(JSynth(**kw), 8, workers=1,
                                    pad_to_multiple=pad)
    assert n == wn == 6
    for k in ("image", "boxes", "labels", "difficult"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ids"] == want["ids"]
    assert len(got["image"]) == (8 if pad else 6)


def test_prefetch_keeps_order_raises_and_stops_early():
    assert list(tloader.prefetch(iter(range(20)), depth=3)) == list(range(20))

    def failing():
        yield 1
        raise ValueError("corrupt input")

    with pytest.raises(ValueError, match="corrupt"):
        list(tloader.prefetch(failing()))

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = tloader.prefetch(endless(), depth=2)
    assert next(it) == 0
    it.close()  # the consumer stops: the producer thread must end
    assert not any(t.name.startswith("Thread") and t.is_alive()
                   and "producer" in repr(t) for t in threading.enumerate())
    assert len(produced) < 10
