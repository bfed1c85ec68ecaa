"""Detections drawn on images (port of the JAX package's utils/drawing.py):
a rectangle and the class name and score of each detection, in a colour
per class, saved as an image file. PIL is imported when an image is drawn
(data/voc.py:pil_image names Pillow where it is missing)."""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

from tfssd_torch.data.voc import pil_image


def class_colors(n: int) -> list:
    """`n` distinct RGB colours, the same on every call."""
    return [
        tuple(int(c * 255)
              for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.9, 0.9))
        for i in range(n)
    ]


def draw_predictions(
    image: np.ndarray,            # (H, W, 3) uint8 or float in [0, 1]
    boxes: np.ndarray,            # (D, 4) normalized corners
    scores: np.ndarray,           # (D,)
    classes: np.ndarray,          # (D,) label ids (1-based, 0 = padding)
    labels: Optional[Sequence[str]] = None,
    score_threshold: float = 0.5,
    path: Optional[str] = None,
):
    """Draw the detections scoring at least `score_threshold`; return the
    PIL image, saved to `path` where given."""
    pil_image()
    from PIL import Image, ImageDraw

    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    img = Image.fromarray(image)
    draw = ImageDraw.Draw(img)
    h, w = image.shape[:2]
    n_classes = (len(labels) if labels else int(classes.max(initial=1)) + 1)
    colors = class_colors(n_classes)
    for box, score, cls in zip(boxes, scores, classes):
        if score < score_threshold or cls <= 0:
            continue
        y0, x0, y1, x1 = box
        rect = [x0 * w, y0 * h, x1 * w, y1 * h]
        color = colors[int(cls) % n_classes]
        draw.rectangle(rect, outline=color, width=2)
        name = labels[int(cls)] if labels else str(int(cls))
        draw.text((rect[0] + 2, rect[1] + 2), f"{name} {score:.2f}",
                  fill=color)
    if path:
        img.save(path)
    return img
