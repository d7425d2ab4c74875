"""Inference speed benchmark CLI, the counterpart of
``tools/benchmark.py``.

Behavioral reference: ``tools/analysis_tools/benchmark.py:58``
(measure_inference_speed: warmup then fps over the val loop) and
``yolox-drone/yolo.py:199`` (get_FPS).  Measures a single model's
forward+NMS images/sec on ``--device`` (the card by default), or with
``--train`` its training step, and optionally a profiler trace.

    python -m glsdet_tpu_torch.tools.benchmark coarse_det --batch-size 8
    python -m glsdet_tpu_torch.tools.benchmark coarse_det --train --batch-size 32

Inference is ``tools/common.py: ModelForward`` of the seeded model in
``model_dtype`` on the JAX CLI's zero NHWC input, decoded at
``cfg.eval.max_dets`` (kernel B2 on the card); the timed loop ends with
one host read of a score, as the JAX CLI synchronises.
``--train`` times the family's ``train/steps.py`` step on the JAX CLI's
synthetic batch (zero images, 50 GT rows of which 8 are valid at [32,
32, 96, 96], label 0; MP-Det with its BoIW dictionary), reading the loss
back once after the timed loop.  On zero images the losses are NaN
from the second step on, in the JAX CLI's step as in the port's: the
command times steps.  ``--trace-dir`` writes a ``torch.profiler``
Chrome trace of the timed loop to ``<trace-dir>/<config>.trace.json``.
"""

from __future__ import annotations

import argparse
import os
import time

from glsdet_tpu_torch.tools.common import (ModelForward, add_device_arg,
                                           model_dtype)


def device_name(dev) -> str:
    """What the lines name the device by: the card's name, or ``cpu``."""
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _profiler(trace_dir, dev):
    import contextlib

    import torch

    if not trace_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _save_trace(prof, trace_dir, name) -> None:
    if prof is None:
        return
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))


def _train(cfg, args, dev):
    """The ``--train`` benchmark: returns the line's numbers."""
    import torch

    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.train.loop import (build_optimizer, family_strides,
                                             make_state_template)
    from glsdet_tpu_torch.train.steps import (make_gfl_train_step,
                                              make_mpdet_train_step,
                                              make_yolox_train_step)

    m, hw, b = cfg.model, tuple(cfg.data.img_hw), args.batch_size
    dtype = model_dtype(cfg, dev)
    model = build_model(cfg, dev)
    state = make_state_template(cfg, model, build_optimizer(cfg, 1000, model),
                                torch.Generator(device=dev).manual_seed(0))
    G = 50
    valid = torch.zeros((b, G), dtype=torch.bool, device=dev)
    valid[:, :8] = True
    batch = {
        "images": torch.zeros((b, *hw, 3), dtype=torch.float32, device=dev),
        "gt_boxes": torch.tensor([32.0, 32, 96, 96], device=dev).repeat(
            b, G, 1),
        "gt_labels": torch.zeros((b, G), dtype=torch.int32, device=dev),
        "gt_valid": valid,
    }
    if m.family == "mpdet":
        step = make_mpdet_train_step(model, hw, m.num_classes,
                                     m.proxies_list, dtype=dtype)
    elif m.family == "gfl":
        step = make_gfl_train_step(model, hw, m.num_classes, dtype=dtype)
    else:
        step = make_yolox_train_step(model, hw,
                                     strides=family_strides(m.family),
                                     dtype=dtype)
    for _ in range(args.warmup):
        state, met = step(state, batch)
    float(met["loss"])
    with _profiler(args.trace_dir, dev) as prof:
        t0 = time.time()
        for _ in range(args.iters):
            state, met = step(state, batch)
        float(met["loss"])
        dt = time.time() - t0
    _save_trace(prof, args.trace_dir, cfg.name)
    n = args.iters * b
    print(f"{cfg.name} TRAIN: {n / dt:.2f} images/sec "
          f"({1000 * dt / args.iters:.1f} ms/step, batch "
          f"{b}) on {device_name(dev)}")
    return {"images_per_sec": n / dt, "ms_per_step": 1000 * dt / args.iters}


def main(argv=None):
    """Run the benchmark; returns its numbers (``images_per_sec`` and
    ``ms_per_img``, or ``ms_per_step`` with ``--train``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="coarse_det")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--trace-dir", help="write a torch.profiler trace")
    ap.add_argument("--train", action="store_true",
                    help="benchmark the training step instead of inference")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model, resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    if dev.type == "cuda":
        # float32 math stays float32, as in the eval runner
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.train:
        return _train(cfg, args, dev)

    dtype = model_dtype(cfg, dev)
    forward = ModelForward(build_model(cfg, dev).to(dtype), cfg, True, dtype)
    x = torch.zeros((args.batch_size, *cfg.data.img_hw, 3),
                    dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for _ in range(args.warmup):
            out = forward(x)
        float(out["scores"][0, 0])  # a real host fetch synchronises
        with _profiler(args.trace_dir, dev) as prof:
            t0 = time.time()
            for _ in range(args.iters):
                out = forward(x)
            float(out["scores"][0, 0])
            elapsed = time.time() - t0
    _save_trace(prof, args.trace_dir, cfg.name)

    n = args.iters * args.batch_size
    print(f"{cfg.name}: {n / elapsed:.2f} images/sec "
          f"({1000 * elapsed / n:.2f} ms/img) on {device_name(dev)}")
    return {"images_per_sec": n / elapsed, "ms_per_img": 1000 * elapsed / n}


if __name__ == "__main__":
    main()
