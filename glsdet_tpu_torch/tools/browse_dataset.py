"""Dataset browser: dump annotated/augmented samples to disk, the
counterpart of ``tools/browse_dataset.py`` (behavioral reference:
``yolox-ufp/tools/misc/browse_dataset.py``): render the training
pipeline's output (post-augmentation) with GT boxes drawn, for visual
sanity checks of the data layer.

    python -m glsdet_tpu_torch.tools.browse_dataset train.json images/ vis/ --num 10

The samples come from the port's ``data/loader.py: TrainPipeline`` with
one ``RandomState(--seed)`` drawn in the JAX CLI's order, so sample
``i`` is the JAX CLI's sample ``i``; each is written as
``sample_{i:04d}.jpg`` (``image_io.write_jpeg``, ``cv2.imwrite``'s
quality 95) with its boxes as outlines without label text
(``utils/visualize.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    """Write the samples; returns the number written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ann_file")
    ap.add_argument("img_root")
    ap.add_argument("out_dir")
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--img-hw", type=int, nargs=2, default=[640, 640])
    ap.add_argument("--no-aug", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.coco import (IMAGENET_MEAN, IMAGENET_STD,
                                            CocoDataset)
    from glsdet_tpu_torch.data.image_io import write_jpeg
    from glsdet_tpu_torch.data.loader import TrainPipeline
    from glsdet_tpu_torch.utils.visualize import draw_detections

    ds = CocoDataset(args.ann_file, args.img_root)
    pipe = TrainPipeline(ds, tuple(args.img_hw),
                         mosaic=not args.no_aug,
                         enable_mixup=not args.no_aug,
                         hsv=not args.no_aug)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    n = min(args.num, len(ds))
    for i in range(n):
        sample = pipe(i, rng)
        img = (sample["images"] * IMAGENET_STD + IMAGENET_MEAN)
        img = np.clip(img, 0, 255).astype(np.uint8)
        valid = sample["gt_valid"]
        drawn = draw_detections(
            img, sample["gt_boxes"][valid],
            np.ones(int(valid.sum())), sample["gt_labels"][valid],
            ds.class_names, score_thr=0.0)
        write_jpeg(os.path.join(args.out_dir, f"sample_{i:04d}.jpg"), drawn)
    print(f"wrote {n} samples to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
