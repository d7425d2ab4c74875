"""One-command VisDrone pipeline, the counterpart of
``scripts/visdrone_e2e.sh``: the five stages of GLSDet's recipe, each
through its command's ``main`` in this process, on ``--device``:

  1. VisDrone -> COCO conversion of both splits (``convert_datasets``);
  2. coarse detector training (``train coarse_det``);
  3. the UFP mosaic dataset built with its last checkpoint
     (``build_ufp_dataset``); 0 mosaics fails the run;
  4. MP-Det training on the mosaics (``train mp_det_res50``);
  5. the two-stage UFPMP eval on val (``ufpmp_det_eval``, COCO maxDets
     [10, 100, 500]); its output is also written to ``<workdir>/eval.log``.

    python -m glsdet_tpu_torch.tools.visdrone_e2e <train_root> <val_root> <workdir>
    python -m glsdet_tpu_torch.tools.visdrone_e2e --synthetic <workdir>

The roots hold the stock VisDrone layout (``images/`` and
``annotations/*.txt``).  ``--synthetic`` writes that layout with small
coloured-box frames (48 train and 8 val, as the script; JPEGs with the
bytes ``cv2.imwrite`` writes) and switches to the script's smoke-scale models and schedules.
``GLSDET_E2E_COARSE_OPTS`` / ``GLSDET_E2E_MP_OPTS`` append
``--cfg-options`` entries to the coarse stages (training and the build)
and to MP-Det's training; ``GLSDET_E2E_EVAL_OPTS`` appends to the eval's
``--first-options``.  Stages 3 and 5 read each training's last
checkpoint, ``epoch_{train.epochs}.pt`` of the config with those
overrides applied.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import time

import numpy as np

from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                     parse_cfg_options)
from glsdet_tpu_torch.tools import (build_ufp_dataset, convert_datasets,
                                    train, ufpmp_det_eval)
from glsdet_tpu_torch.tools.common import add_device_arg

SYNTH_COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40)]

# scripts/visdrone_e2e.sh's smoke-scale models and schedules
SYNTH_COARSE_MODEL = ("model.phi=nano model.dtype=float32 "
                      "data.img_hw=(256,256) eval.coarse_score_thr=0.05")
SYNTH_COARSE_SCHED = (
    "data.batch_size=4 data.max_gt=20 data.mosaic=False data.mixup=False "
    "data.hsv=False data.flip_prob=0.0 data.num_workers=2 train.epochs=60 "
    "train.base_lr=0.002 train.warmup_epochs=2 train.num_last_epochs=5 "
    "train.ckpt_interval=60 train.log_interval=24")
SYNTH_MP_MODEL = "model.depth=18 model.dtype=float32 data.img_hw=(256,256)"
SYNTH_MP_SCHED = (
    "data.batch_size=2 data.max_gt=30 data.num_workers=2 train.epochs=4 "
    "train.base_lr=0.002 train.ckpt_interval=4 train.log_interval=24 "
    "train.ot_interval=40")
SYNTH_EVAL_OPTS = ("model.phi=nano model.dtype=float32 "
                   "data.img_hw=(256,256) eval.coarse_score_thr=0.05")
SYNTH_EVAL_SECOND = "model.depth=18 model.dtype=float32"


def write_synthetic(root: str, n: int, seed: int) -> None:
    """The script's synthetic VisDrone layout: ``n`` 384x640 noise frames
    with 4-8 flat boxes of 4 colours, one annotation row per box."""
    from glsdet_tpu_torch.data.image_io import write_jpeg

    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/annotations", exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        img = rs.randint(20, 60, (384, 640, 3)).astype(np.uint8)
        lines = []
        for _ in range(rs.randint(4, 9)):
            w, h = rs.randint(14, 36), rs.randint(14, 36)
            x, y = rs.randint(0, 640 - w), rs.randint(0, 384 - h)
            c = rs.randint(0, 4)
            img[y:y + h, x:x + w] = SYNTH_COLORS[c]
            lines.append(f"{x},{y},{w},{h},1,{c + 1},0,0")
        # cv2.imwrite reads the array as BGR: the same file from RGB
        write_jpeg(f"{root}/images/{i:04d}.jpg", img[..., ::-1])
        with open(f"{root}/annotations/{i:04d}.txt", "w") as f:
            f.write("\n".join(lines))
    print(f"synthetic VisDrone layout at {root}: {n} images")


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _last_epoch(name: str, opts) -> int:
    cfg = apply_overrides(get_config(name), parse_cfg_options(opts))
    return cfg.train.epochs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="write a synthetic VisDrone layout under the "
                         "work dir and run at smoke scale")
    ap.add_argument("paths", nargs="+", metavar="PATH",
                    help="<train_root> <val_root> <workdir>, or "
                         "<workdir> with --synthetic")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    """Run the five stages; returns each stage's seconds and result."""
    ap = parser()
    args = ap.parse_args(argv)
    from glsdet_tpu_torch.models.build import resolve_device

    resolve_device(args.device)
    if args.synthetic:
        if len(args.paths) != 1:
            ap.error("usage: visdrone_e2e --synthetic <workdir>")
        wd = args.paths[0]
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
        train_root = f"{wd}/VisDrone2019-DET-train"
        val_root = f"{wd}/VisDrone2019-DET-val"
        write_synthetic(train_root, 48, 0)
        write_synthetic(val_root, 8, 1)
        coarse_model, coarse_sched = SYNTH_COARSE_MODEL, SYNTH_COARSE_SCHED
        mp_model, mp_sched = SYNTH_MP_MODEL, SYNTH_MP_SCHED
        eval_opts, eval_second = SYNTH_EVAL_OPTS, SYNTH_EVAL_SECOND
    else:
        if len(args.paths) != 3:
            ap.error("usage: visdrone_e2e <train_root> <val_root> <workdir>")
        train_root, val_root, wd = args.paths
        os.makedirs(wd, exist_ok=True)
        # the real recipe: the named configs carry the hyperparameters
        coarse_model = coarse_sched = mp_model = mp_sched = ""
        eval_opts = eval_second = ""
    env = os.environ
    coarse_opts = (coarse_model.split() + coarse_sched.split()
                   + env.get("GLSDET_E2E_COARSE_OPTS", "").split())
    build_opts = (coarse_model.split()
                  + env.get("GLSDET_E2E_COARSE_OPTS", "").split())
    mp_opts = (mp_model.split() + mp_sched.split()
               + env.get("GLSDET_E2E_MP_OPTS", "").split())
    first_opts = (eval_opts.split()
                  + env.get("GLSDET_E2E_EVAL_OPTS", "").split())
    dev = ["--device", args.device]
    coarse_ckpt = f"{wd}/coarse/epoch_{_last_epoch('coarse_det', coarse_opts)}.pt"
    mp_ckpt = f"{wd}/mpdet/epoch_{_last_epoch('mp_det_res50', mp_opts)}.pt"

    out, t_all = {}, time.perf_counter()

    def stage(key, title, fn):
        print(f"=== {title} ===", flush=True)
        t0 = time.perf_counter()
        out[key] = {"result": fn(), "seconds": time.perf_counter() - t0}
        return out[key]["result"]

    def convert():
        return [len(convert_datasets.main(["visdrone", root, dst])["images"])
                for root, dst in ((train_root, f"{wd}/train.json"),
                                  (val_root, f"{wd}/val.json"))]

    stage("convert", "stage 1: VisDrone -> COCO", convert)
    stage("train_coarse", "stage 2: train coarse detector",
          lambda: train.main([
              "coarse_det", "--ann", f"{wd}/train.json",
              "--img-root", f"{train_root}/images",
              "--work-dir", f"{wd}/coarse", "--cfg-options", *coarse_opts,
              *dev]))
    ufp = stage("build_ufp", "stage 3: build UFP dataset",
                lambda: build_ufp_dataset.main([
                    "coarse_det", coarse_ckpt, f"{wd}/train.json",
                    f"{train_root}/images", f"{wd}/ufp",
                    "--cfg-options", *build_opts, *dev]))
    # fail fast instead of training MP-Det on an empty mosaic set
    if ufp["mosaics"] <= 0:
        raise AssertionError(
            "UFP build produced 0 mosaics: the coarse model found nothing")
    print(f"UFP dataset: {ufp['mosaics']} mosaics")
    stage("train_mp", "stage 4: train MP-Det on UFP mosaics",
          lambda: train.main([
              "mp_det_res50", "--ann", f"{wd}/ufp/ufp_train.json",
              "--img-root", f"{wd}/ufp/images", "--work-dir", f"{wd}/mpdet",
              "--cfg-options", *mp_opts, *dev]))

    def evaluate():
        argv = ["coarse_det", coarse_ckpt, "mp_det_res50", mp_ckpt,
                f"{wd}/val.json", f"{val_root}/images",
                "--out-json", f"{wd}/val_dets.json",
                "--first-options", *first_opts, *dev]
        if eval_second:
            argv += ["--second-options", *eval_second.split()]
        with open(f"{wd}/eval.log", "w") as log, \
                contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            return ufpmp_det_eval.main(argv)

    res, stats = stage("eval", "stage 5: two-stage eval on val", evaluate)
    print(f"VisDrone e2e AP@[.5:.95] = {res.ap}")
    if args.synthetic:
        print("synthetic dry-run complete (smoke AP is high-variance; "
              "not a quality signal)")
    else:
        print("north star (BASELINE.md): reference parity +-0.3 "
              "(UFPMP-Det paper: ~36.6 on VisDrone-val)")
    print("VISDRONE E2E COMPLETE")
    out["seconds"] = time.perf_counter() - t_all
    out["ap"] = res.ap
    out["coarse_ckpt"], out["mp_ckpt"] = coarse_ckpt, mp_ckpt
    return out


if __name__ == "__main__":
    main()
