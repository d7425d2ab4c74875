"""Serve detection models over HTTP, the counterpart of ``tools/serve.py``
(torchserve-deployment analog; reference:
``yolox-ufp/tools/deployment/mmdet2torchserve.py``): ``archive`` packages
a config and its checkpoints (``serve.archive_model``), ``serve`` serves
every ``.gtar`` of a directory (``serve.DetectionService``,
``make_server``) on ``--device``, and ``client`` posts an image to a
running server.

    python -m glsdet_tpu_torch.tools.serve archive --config coarse_det \\
        --checkpoint coarse.pt --mp-config mp_det_res50 \\
        --mp-checkpoint mp.pt --output store/ufpmp
    python -m glsdet_tpu_torch.tools.serve serve --model-store store --port 8080
    python -m glsdet_tpu_torch.tools.serve client frame.jpg --url http://127.0.0.1:8080

The archives are the JAX CLI's (an archive it wrote serves here too);
a checkpoint is a file of the port or an orbax directory of the JAX
package.  ``--devices all`` (every card) or ``--devices N`` (the first
N) serves two-stage request batches on those cards in turn; with
``--async-batching`` the pipeline depth rises to ``N + 1`` so that every
card stays busy, as in the JAX command.
"""

from __future__ import annotations

import argparse
import glob
import os

from glsdet_tpu_torch.serve import DetectionService, archive_model, make_server
from glsdet_tpu_torch.tools.common import add_device_arg


def _client(args) -> list:
    """POST an image to a running server and print the detections
    (``tools/deployment/test_torchserver.py`` analog without the local
    comparison); ``--repeat`` makes it a latency probe.  Returns the
    detections."""
    import json
    import time
    import urllib.request

    base = args.url.rstrip("/")
    with urllib.request.urlopen(base + "/ping", timeout=10) as r:
        print("ping:", r.read().decode().strip())
    model = args.model
    if model is None:
        with urllib.request.urlopen(base + "/models", timeout=10) as r:
            models = json.loads(r.read().decode())["models"]
        if not models:
            raise SystemExit("server has no registered models")
        model = models[0]
    with open(args.image, "rb") as f:
        payload = f.read()

    url = f"{base}/predictions/{model}"
    times, result = [], None
    for _ in range(max(1, args.repeat)):
        req = urllib.request.Request(
            url, data=payload,
            headers={"Content-Type": "application/octet-stream"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            result = json.loads(r.read().decode())
        times.append(time.perf_counter() - t0)
    dets = result if isinstance(result, list) else [result]
    print(f"{model}: {len(dets)} detections "
          f"(latency {min(times) * 1e3:.1f} ms best of {len(times)})")
    print(json.dumps(dets[:10], indent=2))
    return dets


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("archive", help="package config+ckpt into .gtar")
    a.add_argument("--config", required=True, help="named config")
    a.add_argument("--checkpoint", default=None,
                   help="checkpoint file or JAX orbax ckpt dir")
    a.add_argument("--output", required=True, help="output path (.gtar)")
    a.add_argument("--model-name", default=None)
    a.add_argument("--score-thr", type=float, default=0.3)
    a.add_argument("--force", action="store_true")
    a.add_argument("--mp-config", default=None,
                   help="stage-2 MP-Det config: makes a TWO-STAGE "
                        "archive serving the full UFPMP pipeline "
                        "(--config becomes the coarse detector)")
    a.add_argument("--mp-checkpoint", default=None,
                   help="stage-2 checkpoint file or JAX orbax ckpt dir")
    a.add_argument("--no-fuse-global", action="store_true",
                   help="disable the integrated global-local fusion in "
                        "two-stage archives")
    a.add_argument("--int8", choices=["static", "dynamic"], default=None,
                   help="serving precision baked into the manifest "
                        "(static = calibrated W8A8, ops/quant_static.py)")
    a.add_argument("--int8-scales", default=None,
                   help="saved-scales json (ops/quant_static.save_scales "
                        "/ the CLIs' --int8-scales) to embed so serving "
                        "never re-calibrates")
    a.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL",
                   help="config overrides the model was trained with; "
                        "embedded in the manifest and replayed at serve "
                        "time")
    a.add_argument("--mp-cfg-options", nargs="*", metavar="KEY=VAL",
                   help="stage-2 config overrides (two-stage archives)")

    s = sub.add_parser("serve", help="serve archives over HTTP")
    s.add_argument("--model-store", required=True,
                   help="directory of .gtar archives")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080,
                   help="0 takes any free port")
    s.add_argument("--async-batching", action="store_true",
                   help="serve each model through AsyncDetector: "
                        "concurrent requests get dynamic batching + "
                        "pipelining")
    s.add_argument("--max-batch", type=int, default=8,
                   help="dynamic-batching drain size (--async-batching)")
    s.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="straggler wait window (--async-batching)")
    s.add_argument("--pipeline-depth", type=int, default=2,
                   help="batches kept in flight (--async-batching)")
    s.add_argument("--devices", default=None,
                   help="'all' or a count: round-robin two-stage "
                        "request batches over several cards")
    add_device_arg(s)

    c = sub.add_parser("client", help="exercise a running server "
                       "(tools/deployment/test_torchserver.py analog)")
    c.add_argument("image", help="image file to POST")
    c.add_argument("--model", default=None,
                   help="model name (default: first of GET /models)")
    c.add_argument("--url", default="http://127.0.0.1:8080")
    c.add_argument("--repeat", type=int, default=1,
                   help="POST the image N times and report latency")
    return ap


def serving_devices(spec: str, device="cuda") -> list:
    """``--devices``: ``all`` is every card, ``N`` the first N (all of
    them where there are fewer, as the JAX command slices its device
    list), as ``torch.device`` s of ``device``'s type; on the CPU (for
    tests) ``N`` turns of it."""
    import torch

    from glsdet_tpu_torch.models.build import resolve_device

    dev = resolve_device(device)
    if spec != "all" and int(spec) < 1:
        raise ValueError(f"--devices {spec}: expected 'all' or a count >= 1")
    if dev.type == "cpu":
        return [dev] * (1 if spec == "all" else int(spec))
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return cards if spec == "all" else cards[:int(spec)]


def main(argv=None):
    """``archive``: returns the archive's path; ``client``: the
    detections; ``serve`` serves until the server is shut down."""
    args = parser().parse_args(argv)
    if args.cmd == "client":
        return _client(args)

    if args.cmd == "archive":
        from glsdet_tpu_torch.config import parse_cfg_options

        quant8 = {"static": "static", "dynamic": True}.get(args.int8, False)
        path = archive_model(args.config, args.checkpoint, args.output,
                             model_name=args.model_name,
                             score_thr=args.score_thr, force=args.force,
                             mp_config=args.mp_config,
                             mp_checkpoint=args.mp_checkpoint,
                             fuse_global=not args.no_fuse_global,
                             quant8=quant8, int8_scales=args.int8_scales,
                             options=parse_cfg_options(args.cfg_options),
                             mp_options=parse_cfg_options(
                                 args.mp_cfg_options))
        print(f"wrote {path}")
        return path

    devices = None
    if args.devices:
        devices = serving_devices(args.devices, args.device)
        if args.async_batching and args.pipeline_depth <= len(devices):
            args.pipeline_depth = len(devices) + 1      # keep cards busy
    service = DetectionService()
    for path in sorted(glob.glob(os.path.join(args.model_store, "*.gtar"))):
        name = service.register_archive(
            path, async_batching=args.async_batching,
            max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            pipeline_depth=args.pipeline_depth, devices=devices,
            device=args.device)
        print(f"registered {name} from {path}")
    if not service.models:
        raise SystemExit(f"no .gtar archives in {args.model_store}")
    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serving {sorted(service.models)} on http://{host}:{port}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        for det, _ in service.models.values():
            close = getattr(det, "close", None)
            if close is not None:
                close()


if __name__ == "__main__":
    main()
