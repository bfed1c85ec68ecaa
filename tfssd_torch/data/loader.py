"""Host-side batching: examples -> padded numpy batches (port of the JAX
package's data/loader.py: ConcatDataset, TakeDataset, pad_gt,
batch_examples, _collate, stage_arrays, prefetch).

Ground truth is padded to the static `max_gt_boxes` rows with label 0;
a short final batch is padded with zero images when not dropped. Images
stay uint8 until the device (models/decoder.py:preprocess_images).
`stage_arrays` decodes a whole dataset into contiguous arrays once, for
the trainer's and the predictor's device-resident caches. Decoding runs
in `workers` threads where asked (PIL releases the interpreter lock while
it decodes a JPEG), in the dataset's order.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np


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
                   *, drop_remainder: bool = True, workers: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches {'image' (B,S,S,3) uint8, 'boxes' (B,G,4) float32,
    'labels' (B,G) int32, 'difficult' (B,G) bool, 'ids', 'num_valid'} in
    dataset order, one pass; `workers` > 1 decodes in that many threads
    and needs a random-access dataset."""
    if workers > 1:
        if not hasattr(dataset, "example"):
            raise ValueError("workers > 1 needs a random-access dataset "
                             "(with .example); got a plain iterable")
        dataset = _parallel_examples(dataset, range(len(dataset)), workers)
    buf = []
    for ex in dataset:
        buf.append(ex)
        if len(buf) == batch_size:
            yield _collate(buf, max_gt)
            buf = []
    if buf and not drop_remainder:
        yield _collate(buf, max_gt, pad_to=batch_size)


def _collate(examples, max_gt: int, pad_to: Optional[int] = None):
    n = len(examples)
    total = pad_to or n
    s = examples[0]["image"].shape[0]
    images = np.zeros((total, s, s, 3), examples[0]["image"].dtype)
    boxes = np.zeros((total, max_gt, 4), np.float32)
    labels = np.zeros((total, max_gt), np.int32)
    difficult = np.zeros((total, max_gt), bool)
    ids = []
    for i, ex in enumerate(examples):
        images[i] = ex["image"]
        boxes[i], labels[i] = pad_gt(ex["boxes"], ex["labels"], max_gt)
        d = np.asarray(ex.get("difficult",
                              np.zeros(len(ex["labels"]), bool)))
        g = min(len(d), max_gt)
        difficult[i, :g] = d[:g]
        ids.append(ex.get("id", str(i)))
    return {"image": images, "boxes": boxes, "labels": labels,
            "difficult": difficult, "ids": ids, "num_valid": n}


def stage_arrays(dataset, max_gt: int, *, workers: int = 8,
                 pad_to_multiple: Optional[int] = None):
    """Decode the whole dataset into contiguous host arrays once, in
    `workers` threads: ({'image' (N,S,S,3) uint8, 'boxes' (N,G,4),
    'labels' (N,G), 'difficult', 'ids'}, n_real). `pad_to_multiple`
    appends all-zero rows (label 0, so zero loss) up to a multiple; n_real
    counts the rows before padding."""
    n = len(dataset)
    total = n
    if pad_to_multiple:
        total = -(-n // pad_to_multiple) * pad_to_multiple
    examples = list(_parallel_examples(dataset, range(n), workers)
                    if workers > 1 else
                    (dataset.example(i) for i in range(n)))
    batch = _collate(examples, max_gt, pad_to=total)
    del batch["num_valid"]
    return batch, n


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a background thread, `depth` items ahead of the
    consumer. An exception in the producer is raised in the consumer; a
    consumer that stops early stops the producer."""
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
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # drain so a blocked producer sees the stop event
            while True:
                q.get_nowait()
        except Empty:
            pass
        t.join(timeout=5.0)
