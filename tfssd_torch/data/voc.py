"""Pascal VOC from raw VOCdevkit directories, and folders of images (port
of the JAX package's data/voc.py; numpy and the standard library, PIL for
the images).

A VOC root (VOCdevkit/VOC2007-style) holds JPEGImages/, Annotations/*.xml
and ImageSets/Main/<split>.txt. An example is {'image' (S, S, 3) uint8
(resized with PIL's BILINEAR when an image size is given), 'boxes' (G, 4)
normalized [ymin, xmin, ymax, xmax] float32, 'labels' (G,) int32 in
[1, 20] (0 is background), 'difficult' (G,) bool, 'id'}.

PIL is imported only where an image is decoded or resized, and an
ImportError that names Pillow is raised where it is not installed.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
LABELS = ("bg",) + VOC_CLASSES
_NAME_TO_ID = {n: i + 1 for i, n in enumerate(VOC_CLASSES)}
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def pil_image():
    """PIL.Image, or an ImportError that names Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding images (VOC directories, --image-dir, --draw) needs "
            "Pillow (the PIL package), which is not installed") from e
    return Image


def get_labels() -> List[str]:
    """The 21 label names, background first."""
    return list(LABELS)


def parse_annotation(xml_path: str, keep_difficult: bool = False) -> Dict:
    """One VOC XML -> {'filename', 'width', 'height', 'boxes' (G, 4)
    normalized [ymin, xmin, ymax, xmax] float32, 'labels' (G,) int32,
    'difficult' (G,) bool}. Objects of unknown class are left out, and
    difficult ones too unless `keep_difficult`."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip().lower()
        if name not in _NAME_TO_ID:
            continue
        diff_node = obj.find("difficult")
        is_diff = diff_node is not None and diff_node.text.strip() == "1"
        if is_diff and not keep_difficult:
            continue
        bb = obj.find("bndbox")
        # VOC pixel coordinates are 1-based: (v - 1) / size on all four, as
        # tensorflow_datasets' VOC builder and the JAX package do.
        xmin = (float(bb.find("xmin").text) - 1.0) / width
        ymin = (float(bb.find("ymin").text) - 1.0) / height
        xmax = (float(bb.find("xmax").text) - 1.0) / width
        ymax = (float(bb.find("ymax").text) - 1.0) / height
        boxes.append([ymin, xmin, ymax, xmax])
        labels.append(_NAME_TO_ID[name])
        difficult.append(is_diff)
    return {
        "filename": root.find("filename").text.strip(),
        "width": int(width),
        "height": int(height),
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
        "difficult": np.asarray(difficult, bool),
    }


def load_image(path: str, image_size: Optional[int]) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, resized to a square of
    `image_size` with PIL's BILINEAR where given."""
    image = pil_image()
    img = image.open(path).convert("RGB")
    if image_size is not None:
        img = img.resize((image_size, image_size), image.BILINEAR)
    return np.asarray(img, np.uint8)


class VOCDataset:
    """A split of a VOC root, with random access (`example(i)`) for the
    loader's parallel decode. `skip_difficult` leaves difficult objects
    out; evaluation keeps them (the metric ignores their matches)."""

    def __init__(self, root: str, split: str = "trainval",
                 image_size: Optional[int] = None,
                 skip_difficult: bool = True):
        self.root = root
        self.split = split
        self.image_size = image_size
        self.skip_difficult = skip_difficult
        split_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            self.ids = [line.strip().split()[0] for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def example(self, index: int) -> Dict:
        image_id = self.ids[index]
        ann = parse_annotation(
            os.path.join(self.root, "Annotations", f"{image_id}.xml"),
            keep_difficult=True)
        keep = (~ann["difficult"] if self.skip_difficult
                else np.ones(len(ann["labels"]), bool))
        return {
            "image": load_image(os.path.join(self.root, "JPEGImages",
                                             f"{image_id}.jpg"),
                                self.image_size),
            "boxes": ann["boxes"][keep],
            "labels": ann["labels"][keep],
            "difficult": ann["difficult"][keep],
            "id": image_id,
        }

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self.ids)):
            yield self.example(i)


def get_custom_imgs(path: str) -> List[str]:
    """The image files of a folder, sorted, for prediction on arbitrary
    images."""
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS)


def custom_image_generator(paths: Sequence[str],
                           image_size: int) -> Iterator[Dict]:
    """Examples of image files: the image resized to `image_size`, no gt
    boxes, the file name as the id and the original (height, width)."""
    image = pil_image()
    for p in paths:
        img = image.open(p).convert("RGB")
        orig_w, orig_h = img.size
        arr = np.asarray(
            img.resize((image_size, image_size), image.BILINEAR), np.uint8)
        yield {
            "image": arr,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int32),
            "difficult": np.zeros((0,), bool),
            "id": os.path.basename(p),
            "orig_hw": (orig_h, orig_w),
        }
