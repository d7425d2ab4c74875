"""Model serving, the counterpart of ``glsdet_tpu.serve``: archive format,
HTTP inference server and async facade.

Analog of the reference's TorchServe deployment path
(``yolox-ufp/tools/deployment/mmdet2torchserve.py`` packages
config+checkpoint into a ``.mar``; ``mmdet_handler.py`` decodes request
images, runs ``inference_detector`` and returns per-class detections)
and of mmdet's async inference API (``mmdet/apis/inference.py``
``async_inference_detector``, exercised by ``tests/test_async.py``).

Design notes:
- the server owns one detector per model and one card; requests are
  funneled through a single dispatch queue: batching at the facade is
  the throughput lever, as ``TwoStagePipeline.run_batch``.
- ``AsyncDetector`` keeps up to ``pipeline_depth`` batches in flight
  through the detector's streaming protocol: PyTorch returns from a
  launch before the card finishes, so the next batch's coarse stage is
  queued while the host packs and reads back the previous one.
- An archive holds the port's checkpoint files (``torch.save``) where
  the JAX package's holds orbax directories, under the same
  ``MANIFEST.json``.  ``archive_model`` takes either as its checkpoints
  (an orbax directory is converted, ``train/loop.py: restore_raw``), and
  ``load_archive`` opens the JAX package's archives too.
"""

from __future__ import annotations

import collections
import io
import json
import os
import queue
import threading
import time
import zipfile
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from glsdet_tpu_torch.apis import Detector, TwoStageDetector
from glsdet_tpu_torch.data.image_io import decode_image

ARCHIVE_MANIFEST = "MANIFEST.json"
ARCHIVE_SUFFIX = ".gtar"
CKPT, CKPT_MP = "ckpt.pt", "ckpt_mp.pt"


# ---------------------------------------------------------------------------
# model archive (mmdet2torchserve .mar analog)
# ---------------------------------------------------------------------------

def archive_model(config_name: str, checkpoint: Optional[str],
                  output_path: str, model_name: Optional[str] = None,
                  class_names: Optional[Sequence[str]] = None,
                  score_thr: float = 0.3,
                  force: bool = False,
                  mp_config: Optional[str] = None,
                  mp_checkpoint: Optional[str] = None,
                  fuse_global: bool = True,
                  quant8=False,
                  int8_scales: Optional[str] = None,
                  options: Optional[dict] = None,
                  mp_options: Optional[dict] = None) -> str:
    """Package a named config + checkpoint into a single self-describing
    zip archive (the ``.mar`` analog).

    The checkpoint is embedded as ``ckpt.pt`` so the archive is one
    portable artifact: a checkpoint file as it is, a JAX package orbax
    directory converted to the port's form (``train/loop.py:
    restore_raw``).  Passing ``mp_config`` makes a TWO-STAGE archive
    (``pipeline: "two_stage"``): ``config_name`` is the coarse detector,
    ``mp_config``/``mp_checkpoint`` (embedded as ``ckpt_mp.pt``) the
    stage-2 MP-Det; serving builds a ``TwoStageDetector`` running the full
    UFPMP pipeline.

    ``quant8`` ("static" | True | False) selects the serving precision
    baked into the manifest; with ``quant8="static"``, ``int8_scales``
    may name a saved-scales json (``ops/quant_static.save_scales``)
    embedded as ``int8_scales.json`` so serving never re-calibrates.
    Without it the detector calibrates lazily on its first requests.
    """
    if not output_path.endswith(ARCHIVE_SUFFIX):
        output_path += ARCHIVE_SUFFIX
    if os.path.exists(output_path) and not force:
        raise FileExistsError(f"{output_path} exists (use force=True)")
    manifest = {
        "model_name": model_name or config_name,
        "config_name": config_name,
        "class_names": list(class_names) if class_names else None,
        "score_thr": score_thr,
        "has_checkpoint": checkpoint is not None,
        "format_version": 1,
    }
    if options:
        # --cfg-options the model was trained with (dotted-key dict);
        # serving replays them so non-stock shapes load correctly
        manifest["options"] = dict(options)
    if mp_options:
        manifest["mp_options"] = dict(mp_options)
    if quant8:
        manifest["quant8"] = quant8
        manifest["has_int8_scales"] = int8_scales is not None
    if mp_config:
        manifest.update({
            "pipeline": "two_stage",
            "mp_config_name": mp_config,
            "has_mp_checkpoint": mp_checkpoint is not None,
            "fuse_global": fuse_global,
        })

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with zipfile.ZipFile(output_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(ARCHIVE_MANIFEST, json.dumps(manifest, indent=2))
        for src, name in ((checkpoint, CKPT), (mp_checkpoint, CKPT_MP)):
            if src and os.path.isdir(src):
                from glsdet_tpu_torch.train.loop import restore_raw

                buf = io.BytesIO()
                torch.save(restore_raw(src), buf)
                zf.writestr(name, buf.getvalue())
            elif src:
                zf.write(src, name)
        if int8_scales:
            zf.write(int8_scales, "int8_scales.json")
    return output_path


def load_archive(path: str, workdir: Optional[str] = None):
    """Unpack an archive; returns (manifest dict, checkpoint|None).

    A checkpoint is the file the port's archives hold or, in an archive
    of the JAX package's ``serve.archive_model``, the orbax directory it
    embeds under ``ckpt/`` (``ckpt_mp/``), which ``apis.init_detector``
    reads.  For a two-stage archive (``manifest["pipeline"] ==
    "two_stage"``) the second element is a dict ``{"coarse": ckpt|None,
    "mp": ckpt|None}``.
    """
    import tempfile

    workdir = workdir or tempfile.mkdtemp(prefix="glsdet_serve_")
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read(ARCHIVE_MANIFEST))
        names = zf.namelist()

        def _extract(name):
            if name in names:
                return zf.extract(name, workdir)
            prefix = name[:-len(".pt")] + "/"        # the JAX archive's
            members = [n for n in names if n.startswith(prefix)]
            if not members:
                return None
            for n in members:
                zf.extract(n, workdir)
            return os.path.join(workdir, prefix[:-1])

        ckpt = (_extract(CKPT) if manifest.get("has_checkpoint") else None)
        if manifest.get("has_int8_scales") \
                and "int8_scales.json" in zf.namelist():
            zf.extract("int8_scales.json", workdir)
            manifest["_int8_scales_path"] = os.path.join(
                workdir, "int8_scales.json")
        if manifest.get("pipeline") == "two_stage":
            mp_ckpt = (_extract(CKPT_MP)
                       if manifest.get("has_mp_checkpoint") else None)
            return manifest, {"coarse": ckpt, "mp": mp_ckpt}
    return manifest, ckpt


# ---------------------------------------------------------------------------
# async inference facade
# ---------------------------------------------------------------------------

class AsyncDetector:
    """Asynchronous single-model predictor.

    ``submit(image)`` returns a ``concurrent.futures.Future`` resolving to
    the same dict ``Detector.detect`` returns.  One worker thread batches
    the queued requests and drives the detector (launches return before
    the card finishes, so with ``pipeline_depth > 1`` the worker launches
    the next batch before it reads the last one back).  Also usable from
    asyncio via ``detect_async`` (mmdet ``async_inference_detector``
    analog).
    """

    def __init__(self, detector, max_queue: int = 64,
                 max_batch: int = 8, batch_window_ms: float = 2.0,
                 pipeline_depth: int = 2):
        """``max_batch``/``batch_window_ms``: dynamic batching — the
        worker drains up to ``max_batch`` queued requests (waiting at
        most the window for stragglers) and serves them with ONE stacked
        dispatch via ``detector.detect_batch`` when available (the
        torchserve batch-inference analog).

        ``pipeline_depth``: multi-stream serving — when >1 and the
        detector implements the streaming protocol (``submit_batch`` /
        optional ``advance_batch`` / ``collect_batch``), up to this many
        batches stay in flight: batch N+1's programs are dispatched
        before batch N's results are read back, so per-batch read-backs
        and host-side UFP packing hide behind the card's work (the
        serving twin of ``TwoStagePipeline.run_device_batches``)."""
        self._det = detector
        self._q: "queue.Queue" = queue.Queue(max_queue)
        self._stop = object()
        self._max_batch = max(1, int(max_batch))
        self._window_s = max(0.0, batch_window_ms) / 1e3
        self._depth = max(1, int(pipeline_depth))
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _drain(self, first):
        """Gather a batch: ``first`` plus whatever arrives within the
        window, up to max_batch.  Returns (items, saw_stop)."""
        import time as _time

        items = [first]
        deadline = _time.monotonic() + self._window_s
        while len(items) < self._max_batch:
            timeout = deadline - _time.monotonic()
            try:
                item = self._q.get(timeout=max(0.0, timeout)) \
                    if timeout > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._stop:
                return items, True
            items.append(item)
        return items, False

    def _run(self):
        if (self._depth > 1 and hasattr(self._det, "submit_batch")
                and hasattr(self._det, "collect_batch")):
            return self._run_streaming()
        batched = hasattr(self._det, "detect_batch")
        while True:
            item = self._q.get()
            if item is self._stop:
                return
            items, saw_stop = (self._drain(item) if batched
                               and self._max_batch > 1 else ([item], False))
            live = [(f, im) for f, im in items
                    if f.set_running_or_notify_cancel()]
            try:
                if batched and len(live) > 1:
                    results = self._det.detect_batch(
                        [im for _, im in live])
                else:
                    results = [self._det.detect(im) for _, im in live]
                for (f, _), r in zip(live, results):
                    f.set_result(r)
            except BaseException as e:  # surface in the futures
                for f, _ in live:
                    if not f.done():
                        f.set_exception(e)
            if saw_stop:
                return

    def _run_streaming(self):
        """Multi-stream worker: keep up to ``pipeline_depth`` batches in
        flight through the detector's submit/advance/collect protocol.

        Per loop turn: (1) drain the queue into a new batch and submit it
        (dispatch-only, non-blocking) whenever there is room in the
        pipeline, (2) advance the oldest un-advanced in-flight batch
        (two-stage: coarse readback + packing + mosaic launch; the newer
        batch's coarse stage is already queued on the card behind it, so
        the card need not idle during the host work), (3) collect the
        oldest batch when the pipeline is full or traffic paused.
        """
        advance = getattr(self._det, "advance_batch", None)
        pending: list = []   # [handle, live (future, image) list, state]
        stopping = False
        while True:
            # 1. take new work only while the pipeline has room (FIFO:
            # a full pipeline leaves requests queued, not reordered)
            got_work = False
            if not stopping and len(pending) < self._depth:
                try:
                    item = (self._q.get() if not pending
                            else self._q.get_nowait())
                except queue.Empty:
                    item = None
                if item is self._stop:
                    stopping = True
                elif item is not None:
                    got_work = True
                    items, saw_stop = (self._drain(item)
                                       if self._max_batch > 1
                                       else ([item], False))
                    stopping = stopping or saw_stop
                    live = [(f, im) for f, im in items
                            if f.set_running_or_notify_cancel()]
                    if live:
                        try:
                            h = self._det.submit_batch(
                                [im for _, im in live])
                            pending.append([h, live, "submitted"])
                        except BaseException as e:
                            for f, _ in live:
                                f.set_exception(e)

            # 2. advance the oldest un-advanced batch (the newer batch's
            # coarse stage is already queued on the card behind it)
            if advance is not None:
                for entry in pending:
                    if entry[2] == "submitted":
                        try:
                            advance(entry[0])
                            entry[2] = "advanced"
                        except BaseException as e:
                            entry[2] = e
                        break

            # 3. collect the oldest batch once the pipeline is full or
            # traffic paused (drains the pipeline when the queue is idle)
            if pending and (len(pending) >= self._depth or not got_work):
                h, live, state = pending.pop(0)
                try:
                    if isinstance(state, BaseException):
                        raise state
                    results = self._det.collect_batch(h)
                    for (f, _), r in zip(live, results):
                        f.set_result(r)
                except BaseException as e:
                    for f, _ in live:
                        if not f.done():
                            f.set_exception(e)
            if stopping and not pending:
                return

    @property
    def class_names(self):
        return getattr(self._det, "class_names", None)

    def submit(self, image: np.ndarray) -> Future:
        fut: Future = Future()
        self._q.put((fut, image))
        return fut

    async def detect_async(self, image: np.ndarray) -> dict:
        """Awaitable detection (asyncio bridge over ``submit``)."""
        import asyncio

        return await asyncio.wrap_future(self.submit(image))

    def map(self, images: Sequence[np.ndarray]):
        """Submit all, then gather — overlaps host decode with device
        compute across the sequence."""
        futs = [self.submit(im) for im in images]
        return [f.result() for f in futs]

    def close(self):
        self._q.put(self._stop)
        self._worker.join(timeout=5)


async def async_inference_detector(detector, image: np.ndarray) -> dict:
    """One-shot awaitable inference (mmdet apis analog).

    Runs ``detector.detect`` in a thread so the event loop is never
    blocked on the card's read-back.
    """
    import asyncio

    return await asyncio.get_event_loop().run_in_executor(
        None, detector.detect, image)


# ---------------------------------------------------------------------------
# HTTP server (torchserve inference-API analog)
# ---------------------------------------------------------------------------

def _decode_image(body: bytes) -> np.ndarray:
    """Decode request bytes: raw JPEG/PNG, or JSON {"image": base64,
    "shape" [h, w, 3] + "dtype" for raw arrays}.  JPEG and PNG decode
    with the port's own decoders (``data/image_io.py``), equal to
    ``cv2.imdecode(..., IMREAD_COLOR)`` after BGR -> RGB; a body that is
    neither, or that ``cv2.imdecode`` could not read, raises
    ``ValueError``."""
    import base64

    if body[:1] in (b"{", b"["):
        payload = json.loads(body)
        data = base64.b64decode(payload["image"])
        if "shape" in payload:
            arr = np.frombuffer(data, dtype=payload.get("dtype", "uint8"))
            return arr.reshape(payload["shape"]).copy()
        body = data
    try:
        return decode_image(body)
    except ValueError as e:
        raise ValueError("request body is not a decodable image") from e


class DetectionService:
    """Request handler state: one detector per registered model name."""

    def __init__(self):
        self.models = {}  # name -> (detector or AsyncDetector, manifest)
        # serving metrics (torchserve metrics-API analog): per-model
        # request/error counters + a latency ring for quantiles
        self._stats = {}
        self._stats_lock = threading.Lock()

    def register(self, name: str, detector, manifest: Optional[dict] = None):
        self.models[name] = (detector, manifest or {})
        self._stats[name] = {"requests": 0, "errors": 0,
                             "lat_ms": collections.deque(maxlen=1024)}

    def register_archive(self, path: str, detector_cls=None,
                         async_batching: bool = False,
                         max_batch: int = 8,
                         batch_window_ms: float = 2.0,
                         pipeline_depth: int = 2,
                         devices=None, device="cuda"):
        """Load a ``.gtar`` archive and register its detector, built on
        ``device``.

        ``async_batching=True`` wraps the detector in
        :class:`AsyncDetector` so concurrent ``/predictions`` requests
        are served with dynamic batching and (two-stage archives) the
        multi-stream pipelined worker.  ``devices`` (two-stage archives
        only) serves request batches on several cards in turn, in place of
        ``device``; pair it with ``pipeline_depth > len(devices)`` so
        every card stays busy.
        """
        manifest, ckpt = load_archive(path)
        qkw = {}
        if manifest.get("quant8"):
            qkw = {"quant8": manifest["quant8"],
                   "int8_scales": manifest.get("_int8_scales_path")}
        if manifest.get("pipeline") == "two_stage":
            detector_cls = detector_cls or TwoStageDetector
            det = detector_cls(
                manifest["config_name"], ckpt["coarse"],
                manifest["mp_config_name"], ckpt["mp"],
                class_names=manifest.get("class_names"),
                score_thr=manifest.get("score_thr"),
                fuse_global=manifest.get("fuse_global", True),
                coarse_options=manifest.get("options"),
                mp_options=manifest.get("mp_options"),
                devices=devices, device=device, **qkw)
        else:
            detector_cls = detector_cls or Detector
            det = detector_cls(manifest["config_name"], ckpt,
                               class_names=manifest.get("class_names"),
                               score_thr=manifest.get("score_thr"),
                               options=manifest.get("options"),
                               device=device, **qkw)
        if async_batching:
            det = AsyncDetector(det, max_batch=max_batch,
                                batch_window_ms=batch_window_ms,
                                pipeline_depth=pipeline_depth)
        self.register(manifest["model_name"], det, manifest)
        return manifest["model_name"]

    def predict(self, name: str, body: bytes) -> list:
        det, manifest = self.models[name]
        t0 = time.time()
        try:
            image = _decode_image(body)
            if isinstance(det, AsyncDetector):
                # concurrent HTTP handler threads funnel into the
                # batching worker: dynamic batching + pipelining
                out = det.submit(image).result()
            else:
                out = det.detect(image)
        except Exception:
            with self._stats_lock:
                self._stats[name]["errors"] += 1
            raise
        with self._stats_lock:
            st = self._stats[name]
            st["requests"] += 1
            st["lat_ms"].append((time.time() - t0) * 1e3)
        names = getattr(det, "class_names", None)
        results = []
        for box, score, label in zip(out["boxes"], out["scores"],
                                     out["labels"]):
            cls = (names[int(label)] if names and int(label) < len(names)
                   else int(label))
            results.append({
                "class_name": cls,
                "class_label": int(label),
                "score": round(float(score), 6),
                "bbox": [round(float(v), 2) for v in box],
            })
        return results

    def metrics_text(self) -> str:
        """Prometheus text exposition (the torchserve ``/metrics`` API
        analog): per-model request/error counters, latency quantiles
        over the last 1024 requests, async queue depth."""
        lines = [
            "# TYPE glsdet_requests_total counter",
            "# TYPE glsdet_errors_total counter",
            "# TYPE glsdet_request_latency_ms summary",
            "# TYPE glsdet_queue_depth gauge",
        ]
        with self._stats_lock:
            snap = {n: (s["requests"], s["errors"], list(s["lat_ms"]))
                    for n, s in self._stats.items()}
        for name in sorted(snap):
            req, err, lat = snap[name]
            lines.append(f'glsdet_requests_total{{model="{name}"}} {req}')
            lines.append(f'glsdet_errors_total{{model="{name}"}} {err}')
            if lat:
                arr = np.sort(np.asarray(lat))
                for q in (0.5, 0.9, 0.99):
                    v = float(arr[min(int(q * len(arr)), len(arr) - 1)])
                    lines.append(
                        f'glsdet_request_latency_ms{{model="{name}",'
                        f'quantile="{q}"}} {v:.3f}')
            det = self.models[name][0]
            if isinstance(det, AsyncDetector):
                lines.append(f'glsdet_queue_depth{{model="{name}"}} '
                             f'{det._q.qsize()}')
        return "\n".join(lines) + "\n"


def make_server(service: DetectionService, host: str = "127.0.0.1",
                port: int = 8080):
    """Build (not start) a ThreadingHTTPServer speaking the torchserve
    inference-API surface:

    - ``GET /ping`` -> {"status": "Healthy"}
    - ``GET /models`` -> registered model list
    - ``GET /metrics`` -> Prometheus text (requests/errors/latency/queue)
    - ``POST /predictions/<model>`` with image bytes -> detection JSON
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/ping":
                self._send(200, {"status": "Healthy"})
            elif self.path == "/models":
                self._send(200, {"models": sorted(service.models)})
            elif self.path == "/metrics":
                data = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if not self.path.startswith("/predictions/"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            name = self.path[len("/predictions/"):]
            if name not in service.models:
                self._send(404, {"error": f"model {name!r} not registered"})
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                self._send(200, service.predict(name, body))
            except Exception as e:
                self._send(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
