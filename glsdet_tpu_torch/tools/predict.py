"""Unified prediction CLI, the counterpart of ``tools/predict.py``
(behavioral reference: ``yolox-drone/tools/predict.py``): one image, a
directory sweep or an FPS probe over ``apis.Detector`` (one model) or,
with ``--mp-config``, ``apis.TwoStageDetector`` (the UFPMP pipeline:
kernels B1 and B2 on the card), on ``--device``.  Frames are read with
``data/image_io.py: read_image`` and the drawn results written as PNG
(``write_png``); the boxes are drawn as ``utils/visualize.py`` draws
them, outlines in their class's colour without label text.

    python -m glsdet_tpu_torch.tools.predict predict frame.jpg \\
        --checkpoint coarse.pt --mp-config mp_det_res50 --mp-checkpoint mp.pt

The ``video`` mode needs a video decoder, which the GPU machine does not
have: it raises ``NotImplementedError`` (ROADMAP.md item 19).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from glsdet_tpu_torch.data.image_io import read_image, write_png
from glsdet_tpu_torch.tools.common import add_device_arg

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def build_detector(args):
    from glsdet_tpu_torch.apis import Detector, TwoStageDetector
    from glsdet_tpu_torch.config import parse_cfg_options

    opts = parse_cfg_options(args.cfg_options)
    if args.mp_config:
        return TwoStageDetector(
            args.config, args.checkpoint,
            mp_config=args.mp_config, mp_checkpoint=args.mp_checkpoint,
            score_thr=args.score_thr,
            coarse_options=opts,
            mp_options=parse_cfg_options(args.mp_cfg_options),
            device=args.device)
    return Detector(args.config, args.checkpoint,
                    score_thr=args.score_thr, options=opts,
                    device=args.device)


def annotate(det, image, score_thr):
    from glsdet_tpu_torch.utils.visualize import draw_detections

    d = det.detect(image)
    return draw_detections(image, d["boxes"], d["scores"], d["labels"],
                           det.class_names, score_thr), d


def mode_predict(det, args) -> dict:
    out, d = annotate(det, read_image(args.input), args.draw_thr)
    dst = args.output or (os.path.splitext(args.input)[0] + "_det.png")
    write_png(dst, np.asarray(out, np.uint8))
    n = int((np.asarray(d["scores"]) >= args.draw_thr).sum())
    print(f"{n} detections >= {args.draw_thr} -> {dst}")
    return {"images": 1, "detections": n, "output": dst}


def mode_dir_predict(det, args) -> dict:
    out_dir = args.output or "img_out"
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(args.input)
                   if f.lower().endswith(IMG_EXTS))
    if not names:
        raise SystemExit(f"no images under {args.input}")
    t0 = time.time()
    for i, name in enumerate(names):
        out, _ = annotate(det, read_image(os.path.join(args.input, name)),
                          args.draw_thr)
        write_png(os.path.join(out_dir, os.path.splitext(name)[0] + ".png"),
                  np.asarray(out, np.uint8))
        print(f"[{i + 1}/{len(names)}] {name}")
    dt = time.time() - t0
    print(f"{len(names)} images in {dt:.1f}s -> {out_dir}/")
    return {"images": len(names), "seconds": dt, "output": out_dir}


def mode_fps(det, args) -> dict:
    image = read_image(args.input)
    det.detect(image)  # warm-up outside the timed loop
    t0 = time.time()
    for _ in range(args.test_interval):
        det.detect(image)
    fps = args.test_interval / (time.time() - t0)
    print(f"{args.test_interval} forwards: {fps:.2f} FPS "
          f"({1000.0 / fps:.1f} ms/img)")
    return {"images": args.test_interval, "fps": fps}


def mode_video(det, args):
    raise NotImplementedError(
        "predict video: reading and writing video needs a video decoder "
        "(the JAX CLI uses cv2.VideoCapture), which is not ported yet "
        "(ROADMAP.md, queue A item 19)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode",
                    choices=["predict", "dir_predict", "fps", "video"])
    ap.add_argument("input", nargs="?",
                    help="image path (predict/fps), image dir "
                         "(dir_predict), or video path / '0' for camera")
    ap.add_argument("--config", default="coarse_det")
    ap.add_argument("--checkpoint")
    ap.add_argument("--mp-config",
                    help="stage-2 config: run the full two-stage "
                         "UFPMP pipeline")
    ap.add_argument("--mp-checkpoint")
    ap.add_argument("--output", help="output image/dir/video path")
    ap.add_argument("--score-thr", type=float, default=None,
                    help="detector score threshold (default: config)")
    ap.add_argument("--draw-thr", type=float, default=0.3,
                    help="min score to draw")
    ap.add_argument("--test-interval", type=int, default=20,
                    help="fps mode: timed forwards")
    ap.add_argument("--video-fps", type=float, default=None)
    ap.add_argument("--max-frames", type=int, default=0,
                    help="video mode: stop after N frames (0 = all)")
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    ap.add_argument("--mp-cfg-options", nargs="*", metavar="KEY=VAL",
                    help="stage-2 overrides (with --mp-config)")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    """Run the mode; returns what it did (images, detections, times)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.mode != "video" and not args.input:
        ap.error(f"mode {args.mode} requires an input path")
    if args.mode == "video":
        mode_video(None, args)
    det = build_detector(args)
    try:
        return {"predict": mode_predict, "dir_predict": mode_dir_predict,
                "fps": mode_fps}[args.mode](det, args)
    finally:
        close = getattr(det, "close", None)
        if close is not None:
            close()


if __name__ == "__main__":
    main()
