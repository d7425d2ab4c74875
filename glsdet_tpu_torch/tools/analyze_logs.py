"""Training-log analysis CLI, the counterpart of ``tools/analyze_logs.py``
(behavioral reference: ``yolox-ufp/tools/analysis_tools/analyze_logs.py``):
plot loss/metric curves from the json log and compute average iteration
time.  Reads the ``train.log.json`` files the training loop writes.

    python -m glsdet_tpu_torch.tools.analyze_logs plot_curve work_dirs/x/train.log.json --keys loss
    python -m glsdet_tpu_torch.tools.analyze_logs cal_train_time work_dirs/x/train.log.json

``plot_curve`` draws one curve per key against the step in numpy
(``utils/plot.py``: matplotlib's colour cycle, a grid, no text: the
GPU machine has neither matplotlib nor a font) and writes ``--out`` as a
PNG.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_log(path):
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def cal_train_time(entries):
    """Print the mean, fastest and slowest ``time`` of the entries;
    returns the times (None without any)."""
    times = [e["time"] for e in entries if "time" in e]
    if not times:
        print("no timing entries")
        return None
    times = np.asarray(times)
    print(f"average iter time: {times.mean():.4f} s/iter")
    print(f"fastest: {times.min():.4f}  slowest: {times.max():.4f}")
    return times


def plot_curve(entries, keys, out):
    """Each key's values against ``step``, in the colour cycle's order,
    written to ``out`` (PNG); returns the image."""
    from glsdet_tpu_torch.data.image_io import write_png
    from glsdet_tpu_torch.utils.plot import CYCLE, line_plot

    curves = []
    for i, key in enumerate(keys):
        xs = [e["step"] for e in entries if key in e]
        ys = [e[key] for e in entries if key in e]
        curves.append((xs, ys, CYCLE[i % len(CYCLE)]))
    img = line_plot([c for c in curves if c[1]])
    write_png(out, img)
    print(f"wrote {out}")
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("task", choices=["plot_curve", "cal_train_time"])
    ap.add_argument("json_log")
    ap.add_argument("--keys", nargs="+", default=["loss"])
    ap.add_argument("--out", default="curve.png")
    args = ap.parse_args(argv)

    entries = load_log(args.json_log)
    if args.task == "cal_train_time":
        return cal_train_time(entries)
    return plot_curve(entries, args.keys, args.out)


if __name__ == "__main__":
    main()
