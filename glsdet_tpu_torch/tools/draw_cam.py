"""Class-activation-map visualization (basetools/draw_cam.py analog), the
counterpart of ``tools/draw_cam.py``.

Reference behavior: ``yolox-drone/tools/basetools/draw_cam.py`` hooks an
intermediate feature map, weights its channels by their global average
(``returnCAM``: ``adaptive_avg_pool2d`` -> channel-weighted sum), min-max
normalizes, upsamples to the input size, colormaps (JET) and overlays on
the image.

The JAX CLI records every flax module's output (``capture_intermediates``)
and ``--layer`` selects one by path substring (default: the last backbone
stage).  The port hooks every module instead (:func:`capture`) and names
each output as flax does, ``<module path>/__call__/[call]`` plus
``/[i]`` per element of a returned tuple or list, in flax's order (keys
sorted at each level), so ``--layer`` and ``--index`` pick the same map.

Usage:
    python -m glsdet_tpu_torch.tools.draw_cam --config yolox_s_visdrone \\
        --checkpoint work_dir/epoch_12.pt --image img.jpg --out cam.jpg \\
        [--layer backbone] [--index -1]

The frame is read with ``data/image_io.py: read_image`` and resized as
``cv2.resize`` does (``ops/image.py: resize_linear_u8``); the map is
upsampled with ``resize_linear_f32`` (within a few float32 ulps of
``cv2.resize``), coloured with OpenCV's JET table (``utils/plot.py:
JET``) and written in the format of ``--out``'s extension (``.jpg`` or
``.png``).
"""

from __future__ import annotations

import argparse

import numpy as np

from glsdet_tpu_torch.tools.common import (add_device_arg, checkpoint_arg,
                                           model_dtype)


def compute_cam(feat: np.ndarray) -> np.ndarray:
    """(H, W, C) feature map -> (H, W) normalized activation map.
    Channel weights are the feature's own global average (the
    ``returnCAM`` recipe, draw_cam.py:18-27)."""
    weights = feat.mean(axis=(0, 1))                   # (C,)
    cam = (feat * weights).sum(axis=-1)                # (H, W)
    cam = cam - cam.min()
    rng = cam.max()
    return cam / rng if rng > 0 else cam


def capture(model, x):
    """One forward of ``model`` on ``x`` with every module's output
    recorded; returns ``[(name, tensor)]`` of the 4-D outputs in flax's
    ``tree_flatten_with_path`` order, NHWC (the port's modules return
    NCHW maps, except the model and its ``head``, whose maps are NHWC
    already)."""
    import torch

    nhwc = {"", "head"}
    tree: dict = {}
    hooks = []
    for name, mod in model.named_modules():
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        calls = node.setdefault("__call__", [])

        def hook(m, i, out, calls=calls, name=name):
            calls.append((out, name in nhwc))

        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()

    leaves = []

    def walk(node, path, is_nhwc):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + [key], is_nhwc)
        elif isinstance(node, list) and path[-1] == "__call__":
            for c, (out, flag) in enumerate(node):
                walk(out, path + [f"[{c}]"], flag)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"[{i}]"], is_nhwc)
        elif torch.is_tensor(node) and node.dim() == 4:
            leaves.append(("/".join(path),
                           node if is_nhwc else node.permute(0, 2, 3, 1)))

    walk(tree, [], False)
    return leaves


def pick_intermediate(leaves, key_filter: str, index=None):
    """Pick a 4D feature whose name contains ``key_filter``: by list
    ``index`` when given, else the most-downsampled match (the coarsest
    semantic feature — what CAM wants; the first of equal areas).
    Returns its name and its first image as (H, W, C) float32 numpy."""
    matches = [(n, a) for n, a in leaves if key_filter in n]
    if not matches:
        raise SystemExit(
            f"no 4D intermediate matching {key_filter!r}; available: "
            + ", ".join(sorted(set(n for n, _ in leaves))[:20]))
    if index is None:
        name, arr = min(matches,
                        key=lambda kv: kv[1].shape[1] * kv[1].shape[2])
    else:
        name, arr = matches[index]
    print(f"layer: {name}  shape: {tuple(arr.shape)}")
    return name, arr[0].float().cpu().numpy()


def main(argv=None):
    """Write the overlay; returns ``(layer name, (H, W) CAM before the
    upsampling, overlay)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--layer", default="backbone",
                    help="module-path substring to hook")
    ap.add_argument("--index", type=int, default=None,
                    help="which matching feature map (default: the "
                         "most-downsampled match)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from glsdet_tpu_torch.apis import init_detector
    from glsdet_tpu_torch.config import parse_cfg_options
    from glsdet_tpu_torch.data.coco import normalize
    from glsdet_tpu_torch.data.image_io import read_image, write_image
    from glsdet_tpu_torch.models.build import resolve_device
    from glsdet_tpu_torch.ops.image import resize_linear_f32, resize_linear_u8
    from glsdet_tpu_torch.utils.plot import JET

    dev = resolve_device(args.device)
    cfg, model, _ = init_detector(
        args.config, checkpoint_arg(args.checkpoint),
        options=parse_cfg_options(args.cfg_options), device="cpu")
    net = model.to(dev, model_dtype(cfg, dev))
    img = read_image(args.image)
    h, w = cfg.data.img_hw
    small = resize_linear_u8(torch.from_numpy(img), (h, w)).numpy()
    batch = torch.from_numpy(normalize(small)[None]).permute(0, 3, 1, 2)
    leaves = capture(net, batch.to(dev, next(net.parameters()).dtype))
    name, feat = pick_intermediate(leaves, args.layer, args.index)
    cam = compute_cam(np.asarray(feat, np.float32))
    up = resize_linear_f32(torch.from_numpy(cam), img.shape[:2]).numpy()
    heat = JET[np.uint8(255 * up)]
    overlay = (args.alpha * heat
               + (1 - args.alpha) * img).astype(np.uint8)
    write_image(args.out, overlay)
    print(f"wrote {args.out}")
    return name, cam, overlay


if __name__ == "__main__":
    main()
