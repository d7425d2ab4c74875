"""Checkpoint utility: inspect / re-stamp / strip / EMA-swap / publish.

The counterpart of the JAX package's ``tools/ckpt_tool.py`` (behavioral
reference: ``yolox-drone/tools/basetools/ckpt_converter.py`` and mmcv's
EMA parameter swap, ``core/hook/ema.py:84-102``), with its commands and
messages, on the port's checkpoints (``train/state.py: state_dict``,
``work_dir/epoch_{n}.pt``: ``step``, ``model``, ``optimizer``,
``ema_params``, ``generator``, ``boiw``):

- ``inspect <ckpt> [-v]``: step and a summary of each section (tensors,
  elements, bytes); ``-v`` lists every tensor's shape and dtype.
- ``restamp <src> <dst> [--step N]``: copy with ``step`` reset (restart
  the schedules from N on resume).
- ``strip <src> <dst> [--keep-ema/--no-keep-ema]``: a weights-only
  serving artifact (``model``, ``boiw`` and, kept by default,
  ``ema_params``), which ``apis.init_detector`` and
  ``train.load_from`` read.
- ``swap-ema <src> <dst>``: exchange the model's parameters and
  ``ema_params`` (serve the raw weights, or train on from the EMA).
- ``publish <src> <dst>``: strip, then name the file
  ``<dst>-<sha256[:8]>`` (before a ``.pt``/``.pth`` suffix), the hash
  taken over every tensor's key, dtype, shape and bytes
  (``tools/model_converters/publish_model.py`` analog).

Run as ``python -m glsdet_tpu_torch.tools.ckpt_tool <command> ...``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

WEIGHTS = ("model", "boiw")


def _leaves(node, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, tensor) of every tensor in nested dicts and lists."""
    if torch.is_tensor(node):
        yield prefix, node
    elif isinstance(node, dict):
        for k in node:
            yield from _leaves(node[k], prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, prefix + (str(i),))


def _section_stats(tree) -> Tuple[int, int, int]:
    leaves = [t for _, t in _leaves(tree)]
    return (len(leaves), sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def _weights(raw: Dict, keep_ema: bool) -> Dict:
    keep = set(WEIGHTS) | ({"ema_params"} if keep_ema else set())
    return {k: v for k, v in raw.items() if k in keep and v is not None}


def cmd_inspect(args, raw):
    step = raw.get("step")
    if step is not None:
        print(f"step: {int(step)}")
    for name in sorted(raw):
        if name == "step":
            continue
        n, size, nbytes = _section_stats(raw[name])
        print(f"{name:12s} {n:5d} arrays  {size / 1e6:10.2f}M params  "
              f"{nbytes / 1e6:8.1f} MB")
    if args.verbose:
        for key, val in sorted(_leaves(
                {k: v for k, v in raw.items() if isinstance(v, dict)}),
                key=lambda kv: kv[0]):
            print("  " + "/".join(key), tuple(val.shape),
                  str(val.dtype).replace("torch.", ""))


def cmd_restamp(args, raw):
    raw = dict(raw)
    raw["step"] = int(args.step)
    torch.save(raw, args.dst)
    print(f"{args.src} -> {args.dst} (step={args.step})")


def cmd_strip(args, raw):
    out = _weights(raw, args.keep_ema)
    torch.save(out, args.dst)
    n, size, nbytes = _section_stats(out)
    print(f"{args.src} -> {args.dst}: {sorted(out)} "
          f"({size / 1e6:.2f}M params, {nbytes / 1e6:.1f} MB)")


def content_hash(tree) -> str:
    """sha256 over every tensor's key path, dtype, shape and bytes, in
    key order (not over the file, whose pickle framing may vary)."""
    h = hashlib.sha256()
    for key, val in sorted(_leaves(tree), key=lambda kv: kv[0]):
        h.update("/".join(key).encode())
        h.update(str(val.dtype).encode())
        h.update(str(tuple(val.shape)).encode())
        h.update(val.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cmd_publish(args, raw):
    """Weights-only artifact with a content-hash-stamped name."""
    out = _weights(raw, args.keep_ema)
    stem, ext = os.path.splitext(args.dst.rstrip("/"))
    if ext not in (".pt", ".pth"):
        stem, ext = args.dst.rstrip("/"), ""
    final = f"{stem}-{content_hash(out)[:8]}{ext}"
    torch.save(out, final)
    n, size, nbytes = _section_stats(out)
    print(f"{args.src} -> {final}: {sorted(out)} "
          f"({size / 1e6:.2f}M params, {nbytes / 1e6:.1f} MB)")
    return final


def cmd_swap_ema(args, raw):
    if raw.get("ema_params") is None:
        raise SystemExit(f"{args.src} has no ema_params section")
    raw = dict(raw)
    model, ema = dict(raw["model"]), dict(raw["ema_params"])
    for k in ema:
        model[k], ema[k] = ema[k], model[k]
    raw["model"], raw["ema_params"] = model, ema
    torch.save(raw, args.dst)
    print(f"{args.src} -> {args.dst} (params <-> ema_params)")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect")
    p.add_argument("src")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-array shapes")

    p = sub.add_parser("restamp")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--step", type=int, default=0)

    for name in ("strip", "publish"):
        p = sub.add_parser(name)
        p.add_argument("src")
        p.add_argument("dst")
        p.add_argument("--keep-ema", action=argparse.BooleanOptionalAction,
                       default=True)

    p = sub.add_parser("swap-ema")
    p.add_argument("src")
    p.add_argument("dst")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Run one command; ``publish`` returns the path it wrote."""
    from glsdet_tpu_torch.train.loop import restore_raw

    args = parse_args(argv)
    raw = restore_raw(args.src)
    if "model" not in raw:                  # a bare state-dict file
        raw = {"model": raw}
    return {"inspect": cmd_inspect, "restamp": cmd_restamp,
            "strip": cmd_strip, "publish": cmd_publish,
            "swap-ema": cmd_swap_ema}[args.cmd](args, raw)


if __name__ == "__main__":
    main()
