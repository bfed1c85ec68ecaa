"""Write a VOC-format tree of synthetic scenes to disk (port of the
repository's tools/make_voc_drill.py, which imports the JAX package).

    python -m tfssd_torch.make_voc_drill --out DIR [--train 192] \\
        [--test 64] [--image-size 300] [--difficult-every 17]

DIR/VOC2007 gets JPEGImages/*.jpg (PIL, quality 92), Annotations/*.xml
(1-based pixel bndboxes, class names, every Nth object difficult) and
ImageSets/Main/{trainval,test}.txt, from SyntheticDataset scenes
(seeds 424200 and 535300): the same files, byte for byte, as the tool
writes with the same arguments. Then:

    python -m tfssd_torch.trainer --dataset voc --data-root DIR/VOC2007 \\
        --val-split test ...
    python -m tfssd_torch.predict --dataset voc --data-root DIR/VOC2007 \\
        --split test ...
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.data.voc import get_labels, pil_image

TRAIN_SEED = 424200
TEST_SEED = 535300


def write_split(root: str, split: str, num: int, image_size: int,
                seed: int, difficult_every: int) -> None:
    """`num` scenes of SyntheticDataset(seed) as split `split` of the VOC
    root `root`."""
    image = pil_image()
    labels = get_labels()
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ds = SyntheticDataset(num, image_size=image_size, seed=seed)
    ids = []
    obj_count = 0
    for i in range(num):
        ex = ds.example(i)
        image_id = f"{split}_{i:06d}"
        ids.append(image_id)
        image.fromarray(ex["image"]).save(
            os.path.join(root, "JPEGImages", f"{image_id}.jpg"), quality=92)
        objs = []
        for box, lab in zip(ex["boxes"], ex["labels"]):
            y0, x0, y1, x1 = (float(v) for v in box)
            # 1-based inclusive pixel coordinates; round(), not int(), so
            # the float's binary error does not cut a pixel off
            obj_count += 1
            diff = 1 if (difficult_every
                         and obj_count % difficult_every == 0) else 0
            objs.append(f"""  <object><name>{labels[int(lab)]}</name>
    <pose>Unspecified</pose><truncated>0</truncated>
    <difficult>{diff}</difficult>
    <bndbox><xmin>{round(x0 * image_size) + 1}</xmin>
      <ymin>{round(y0 * image_size) + 1}</ymin>
      <xmax>{round(x1 * image_size)}</xmax>
      <ymax>{round(y1 * image_size)}</ymax></bndbox>
  </object>""")
        xml = (f"<annotation>\n  <filename>{image_id}.jpg</filename>\n"
               f"  <size><width>{image_size}</width>"
               f"<height>{image_size}</height><depth>3</depth></size>\n"
               + "\n".join(objs) + "\n</annotation>\n")
        with open(os.path.join(root, "Annotations", f"{image_id}.xml"),
                  "w") as f:
            f.write(xml)
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    print(f"{split}: {num} images, {obj_count} objects -> {root}")


def make_drill(out: str, train: int = 192, test: int = 64,
               image_size: int = 300, difficult_every: int = 17) -> str:
    """Write the trainval and test splits under out/VOC2007; return that
    root."""
    root = os.path.join(out, "VOC2007")
    write_split(root, "trainval", train, image_size, TRAIN_SEED,
                difficult_every)
    write_split(root, "test", test, image_size, TEST_SEED, difficult_every)
    return root


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=192)
    p.add_argument("--test", type=int, default=64)
    p.add_argument("--image-size", type=int, default=300)
    p.add_argument("--difficult-every", type=int, default=17,
                   help="mark every Nth object difficult (0 = none) so "
                        "the difficult-ignore eval path is exercised")
    args = p.parse_args(argv)
    return make_drill(args.out, args.train, args.test, args.image_size,
                      args.difficult_every)


if __name__ == "__main__":
    main()
