"""Print a resolved config tree, the counterpart of ``tools/print_config.py``
(mmdet ``tools/misc/print_config.py`` analog): the same text for the same
arguments, over the port's ``config/``.

    python -m glsdet_tpu_torch.tools.print_config coarse_det \\
        --cfg-options data.batch_size=16
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                     parse_cfg_options)


def main(argv=None) -> str:
    """Print the config; returns the printed text."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    args = ap.parse_args(argv)
    cfg = apply_overrides(get_config(args.config),
                          parse_cfg_options(args.cfg_options))
    text = json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
    print(text)
    return text


if __name__ == "__main__":
    main()
