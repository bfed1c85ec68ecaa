"""Host-side batching: examples -> padded numpy batches (port of the JAX
package's data/loader.py: ConcatDataset, TakeDataset, pad_gt,
batch_examples, _collate, stage_arrays, stack_batches, prefetch).

Ground truth is padded to the static `max_gt_boxes` rows with label 0;
a short final batch is padded with zero images when not dropped. Images
stay uint8 until the device (models/decoder.py:preprocess_images).
`batch_examples` shuffles a random-access dataset by
np.random.default_rng(shuffle_seed).permutation(len(dataset)), the order
the trainer's device cache gathers too, so both feeds see the same
batches. `stage_arrays` decodes a whole dataset into contiguous arrays
once, for the trainer's and the predictor's device-resident caches.
Decoding runs in `workers` threads where asked (PIL releases the
interpreter lock while it decodes a JPEG), in the dataset's order.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

# The JAX trainer's and predictor's rule for --device-cache auto: stage the
# data on the device when its uint8 images take at most this many bytes.
DEVICE_CACHE_BYTES = 6e9


def _parallel_examples(dataset, order: Sequence[int],
                       workers: int) -> Iterator[Dict]:
    """dataset.example(i) for i in `order`, decoded by `workers` threads at
    most 2 * workers ahead, yielded in `order`."""
    pool = ThreadPoolExecutor(max_workers=workers)
    futures = deque()
    it = iter(order)
    try:
        for i in itertools.islice(it, workers * 2):
            futures.append(pool.submit(dataset.example, int(i)))
        while futures:
            out = futures.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futures.append(pool.submit(dataset.example, int(nxt)))
            yield out
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class ConcatDataset:
    """Random-access datasets (`__len__` and `example(i)`) one after
    another: VOC07 and VOC12 roots read as one."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        for d in datasets:
            if not hasattr(d, "example") or not hasattr(d, "__len__"):
                raise TypeError(
                    f"ConcatDataset children need random access "
                    f"(__len__ + example); got {type(d).__name__}")
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def example(self, index: int) -> Dict:
        if not 0 <= index < len(self):
            raise IndexError(index)
        child = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[child].example(index - int(self._offsets[child]))

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self.example(i)


class TakeDataset:
    """The first `n` examples of a random-access dataset, so that a
    --limit decodes and stages only the rows it serves."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self.n = max(0, min(int(n), len(dataset)))

    def __len__(self) -> int:
        return self.n

    def example(self, index: int) -> Dict:
        if not 0 <= index < self.n:
            raise IndexError(index)
        return self.dataset.example(index)

    def __iter__(self) -> Iterator[Dict]:
        for i in range(self.n):
            yield self.example(i)


def pad_gt(boxes: np.ndarray, labels: np.ndarray, max_gt: int):
    """Pad/truncate (G,4)/(G,) gt arrays to the static max_gt rows."""
    g = min(len(labels), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_boxes[:g] = boxes[:g]
    out_labels[:g] = labels[:g]
    return out_boxes, out_labels


def batch_examples(dataset: Iterable[Dict], batch_size: int, max_gt: int,
                   *, repeat: bool = False,
                   shuffle_seed: Optional[int] = None,
                   drop_remainder: bool = True, workers: int = 1,
                   shard: Tuple[int, int] = (0, 1)
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches {'image' (B,S,S,3) uint8, 'boxes' (B,G,4) float32,
    'labels' (B,G) int32, 'difficult' (B,G) bool, 'ids', 'num_valid'}.
    The order is the dataset's, or with `shuffle_seed` the permutation
    np.random.default_rng(shuffle_seed).permutation(len(dataset)) (each
    pass of `repeat` draws the generator's next one). `workers` > 1
    decodes in that many threads. A seed, workers or a shard need a
    random-access dataset (`__len__` and `example(i)`); a plain iterable
    is batched in its own order, and raises ValueError with any of them
    rather than batch in file order unnoticed.

    `shard` = (rank, world) yields, of each global batch of
    `batch_size`, only rank's rows (batch_size // world of them, the
    rows rank * b .. (rank + 1) * b - 1, parallel.Shard.rows) and decodes
    no other: every rank yields as many batches, a short last batch
    padded (and num_valid counting the rank's real rows, possibly 0)."""
    rank, world = shard
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide into "
                         f"{world} ranks")
    passes = itertools.count() if repeat else range(1)
    if not hasattr(dataset, "example"):
        if shuffle_seed is not None or workers > 1 or world > 1:
            raise ValueError(
                "shuffle_seed/workers/shard require a random-access dataset "
                "(with .example); got a plain iterable")
        for _ in passes:
            buf = []
            for ex in dataset:
                buf.append(ex)
                if len(buf) == batch_size:
                    yield _collate(buf, max_gt)
                    buf = []
            if buf and not drop_remainder:
                yield _collate(buf, max_gt, pad_to=batch_size)
        return
    rng = (np.random.default_rng(shuffle_seed)
           if shuffle_seed is not None else None)
    local = batch_size // world
    for _ in passes:
        n = len(dataset)
        order = rng.permutation(n) if rng is not None else np.arange(n)
        n_batches = (n // batch_size if drop_remainder
                     else -(-n // batch_size))
        mine = [order[g * batch_size + rank * local:
                      g * batch_size + (rank + 1) * local]
                for g in range(n_batches)]
        wanted = np.concatenate(mine) if mine else order[:0]
        examples = (_parallel_examples(dataset, wanted, workers)
                    if workers > 1 else
                    (dataset.example(int(i)) for i in wanted))
        for rows in mine:
            buf = list(itertools.islice(examples, len(rows)))
            if buf:
                yield _collate(buf, max_gt, pad_to=local)
            else:
                # this rank's part of the padded last batch is all padding
                out = _allocate(local, dataset.example(0)["image"], max_gt)
                out["num_valid"] = 0
                yield out


def _allocate(total: int, image: np.ndarray, max_gt: int) -> Dict:
    """Zeroed arrays for `total` examples shaped like `image`: zero rows
    are the padding (zero images, all-background gts)."""
    return {"image": np.zeros((total,) + image.shape, image.dtype),
            "boxes": np.zeros((total, max_gt, 4), np.float32),
            "labels": np.zeros((total, max_gt), np.int32),
            "difficult": np.zeros((total, max_gt), bool), "ids": []}


def _put_example(out: Dict, i: int, ex: Dict, max_gt: int) -> None:
    """Example `ex` into row i of _allocate's arrays, its gts padded or
    cut to max_gt rows."""
    out["image"][i] = ex["image"]
    out["boxes"][i], out["labels"][i] = pad_gt(ex["boxes"], ex["labels"],
                                               max_gt)
    d = np.asarray(ex.get("difficult", np.zeros(len(ex["labels"]), bool)))
    g = min(len(d), max_gt)
    out["difficult"][i, :g] = d[:g]
    out["ids"].append(ex.get("id", str(i)))


def _collate(examples, max_gt: int, pad_to: Optional[int] = None):
    out = _allocate(pad_to or len(examples), examples[0]["image"], max_gt)
    for i, ex in enumerate(examples):
        _put_example(out, i, ex, max_gt)
    out["num_valid"] = len(examples)
    return out


def stage_arrays(dataset, max_gt: int, *, workers: int = 8,
                 pad_to_multiple: Optional[int] = None):
    """Decode the whole dataset into contiguous host arrays once, in
    `workers` threads: ({'image' (N,S,S,3) uint8, 'boxes' (N,G,4),
    'labels' (N,G), 'difficult', 'ids'}, n_real). `pad_to_multiple`
    appends all-zero rows (label 0, so zero loss) up to a multiple; n_real
    counts the rows before padding. Each example is written into arrays
    allocated once from the first one's shape, so the host holds the
    dataset once, not a list of examples beside a collated copy."""
    n = len(dataset)
    total = n
    if pad_to_multiple:
        total = -(-n // pad_to_multiple) * pad_to_multiple
    first = dataset.example(0)
    out = _allocate(total, first["image"], max_gt)
    # the shape probe is row 0, not decoded twice
    rest = (_parallel_examples(dataset, range(1, n), workers)
            if workers > 1 else (dataset.example(i) for i in range(1, n)))
    for i, ex in enumerate(itertools.chain([first], rest)):
        _put_example(out, i, ex, max_gt)
    return out, n


def stack_batches(batches: Iterable[Dict], k: int) -> Iterator[Dict]:
    """Super-batches of k consecutive batches, for
    train.make_multi_train_step: the arrays gain a leading (k,) axis,
    `num_valid` is the sum and `ids` the concatenation. A trailing group
    of fewer than k batches is dropped (the trainer floors its steps per
    epoch to a multiple of k)."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            out = {key: np.stack([c[key] for c in buf])
                   for key in ("image", "boxes", "labels", "difficult")}
            out["ids"] = [i for c in buf for i in c["ids"]]
            out["num_valid"] = sum(c["num_valid"] for c in buf)
            yield out
            buf = []


@dataclasses.dataclass
class PrefetchStats:
    """What a prefetch consumer saw: the items it took, how many of them
    it had to wait for (the queue was empty when it asked) and the
    seconds it spent waiting."""

    items: int = 0
    waited: int = 0
    wait_s: float = 0.0

    @property
    def wait_share(self) -> Optional[float]:
        return self.waited / self.items if self.items else None


def prefetch(iterator: Iterator, depth: int = 2,
             stats: Optional[PrefetchStats] = None) -> Iterator:
    """Run `iterator` in a background thread, `depth` items ahead of the
    consumer. An exception in the producer is raised in the consumer; a
    consumer that stops early stops the producer. `stats`, where given,
    counts the items taken and the waits for them."""
    q: Queue = Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(sentinel)
        except BaseException as e:  # noqa: BLE001 - raised consumer-side
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            wait = None
            try:
                item = q.get_nowait()
            except Empty:
                t0 = time.perf_counter()
                item = q.get()
                wait = time.perf_counter() - t0
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            if stats is not None:
                stats.items += 1
                if wait is not None:
                    stats.waited += 1
                    stats.wait_s += wait
            yield item
    finally:
        stop.set()
        try:  # drain so a blocked producer sees the stop event
            while True:
                q.get_nowait()
        except Empty:
            pass
        t.join(timeout=5.0)
