"""Network structure summary CLI, the counterpart of ``tools/summary.py``
(behavioral reference: ``yolox-drone/tools/summary.py``, torchsummary):
print the model's layer table to ``--depth``, then its totals.

    python -m glsdet_tpu_torch.tools.summary coarse_det --depth 2

The table has one row per module down to ``--depth`` levels below the
model (the model itself first): its path (flax's, ``/``-separated), its
type, the shape of what it returns from a batch-1 zero input on
``--device`` (a list for several tensors, ``xN`` for a module called N
times) and the parameters below it.  The JAX CLI prints flax's
``tabulate`` there; the totals line is the same.
"""

from __future__ import annotations

import argparse

from glsdet_tpu_torch.tools.common import add_device_arg


def _shapes(out):
    import torch

    if torch.is_tensor(out):
        return [tuple(out.shape)]
    if isinstance(out, (list, tuple)):
        return [s for o in out for s in _shapes(o)]
    if isinstance(out, dict):
        return [s for k in sorted(out) for s in _shapes(out[k])]
    return []


def table(model, x, depth: int):
    """Rows ``(path, type, output shapes, parameters)`` of ``model``'s
    modules at most ``depth`` levels down, in registration order."""
    import torch

    rows, calls, hooks = [], {}, []
    for name, mod in model.named_modules():
        if name and name.count(".") + 1 > depth:
            continue
        rows.append((name, mod))
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, name=name: calls.setdefault(name, []).append(
                _shapes(o))))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    out = []
    for name, mod in rows:
        seen = calls.get(name, [])
        shape = ", ".join(str(s) for s in seen[0]) if seen else "-"
        if len(seen) > 1:
            shape += f" x{len(seen)}"
        out.append((name.replace(".", "/") or "(model)", type(mod).__name__,
                    shape, sum(p.numel() for p in mod.parameters())))
    return out


def main(argv=None):
    """Print the table and the totals; returns ``(rows, n_params,
    n_bytes)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="coarse_det")
    ap.add_argument("--shape", type=int, nargs=2, default=None,
                    help="input H W (default: config img_hw)")
    ap.add_argument("--depth", type=int, default=2,
                    help="module nesting depth to show")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model

    cfg = get_config(args.config)
    model = build_model(cfg, args.device)
    hw = tuple(args.shape) if args.shape else tuple(cfg.data.img_hw)
    x = torch.zeros((1, 3, *hw), dtype=torch.float32,
                    device=next(model.parameters()).device)
    rows = table(model, x, args.depth)
    widths = [max(len(str(r[i])) for r in rows + [("path", "type",
                                                   "output", "params")])
              for i in range(4)]
    for r in [("path", "type", "output", "params")] + rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(r, widths)))

    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    n_bytes = sum(p.numel() * p.element_size() for p in params)
    print(f"config: {args.config}  input: {hw[0]}x{hw[1]}")
    print(f"total params: {n_params / 1e6:.2f}M "
          f"({n_bytes / 1e6:.1f} MB at param dtype)")
    return rows, n_params, n_bytes


if __name__ == "__main__":
    main()
