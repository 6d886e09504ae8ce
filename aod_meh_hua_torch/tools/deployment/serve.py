"""HTTP detection server with a dynamic batcher.

Port of tools/deployment/serve.py of the JAX package (`build_detector`
:41-62, `ArchiveDetector` :65-148, `decode_image` :151-160, `Batcher`
:163-212, `make_handler` :215-257, `main` :260-318), after the
reference's TorchServe deployment (tools/deployment/mmdet2torchserve.py
and mmdet_handler.py): image bytes (raw or base64) POSTed to
/predictions come back as JSON rows {class_name, bbox [x1, y1, x2, y2],
score} at or above the threshold (mmdet_handler.py:44-67); GET /ping is
the health check. A ThreadingHTTPServer takes requests concurrently and
one batcher thread coalesces up to --max-batch images, waiting at most
--batch-delay-ms for stragglers after the first, into one padded
predict_batch (TorchServe's batch_size and max_batch_delay).

The model is an api.Detector (family, checkpoint) or, with --archive, a
package_model.py archive (ArchiveDetector: the exported programs and the
MANIFEST's geometry, no config or checkpoint). Payloads are decoded by
the port's JPEG decoder (data/jpeg.py); a payload that is not a baseline
JPEG gets the JAX server's reply to an undecodable payload, 400. The
PNG and BMP payloads that the JAX server's cv2.imdecode also reads are
not taken (ROADMAP Queue 3).

    python -m aod_meh_hua_torch.tools.deployment.serve [--family retinanet|cascade_rcnn|...] \\
        [--checkpoint c.ckpt | --archive model_store/m.tar] [--port 8080] \\
        [--score-thr 0.5] [--max-batch 8] [--batch-delay-ms 5] [--warmup] [--cpu]
    curl -X POST --data-binary @image.jpg localhost:8080/predictions

It runs on the card unless given --cpu, and pins the numerics
(utils/device.py pin_numerics).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from ...data.jpeg import decode
from ...data.pipeline import resize_linear_u8
from ...utils.device import pin_numerics


def build_detector(args):
    """api.Detector of --family (retinanet, ssd or a family of
    utils/config.py ZOO_FAMILIES; the tiny model with --mini) with
    --checkpoint's weights, on the card unless --cpu."""
    from ...api import Detector, init_detector
    from ...data.pipeline import PipelineConfig
    from ...utils.config import ZOO_FAMILIES, RetinaNetConfig, SSDConfig, tiny_test_config

    if args.family == "retinanet":
        cfg = tiny_test_config() if args.mini else RetinaNetConfig()
    elif args.family == "ssd":
        cfg = SSDConfig(width_mult=0.125) if args.mini else SSDConfig()
    else:
        full_cls, tiny_fn = ZOO_FAMILIES[args.family]
        cfg = tiny_fn() if args.mini else full_cls()
    model = init_detector(cfg, checkpoint=args.checkpoint,
                          device="cpu" if args.cpu else "cuda")
    pipeline = None
    if args.mini:
        # tiny canvases need a resize rule that always fits them
        h, w = cfg.canvas
        pipeline = PipelineConfig(img_scale=(max(h, w), min(h, w)), canvas=cfg.canvas,
                                  device_normalize=True)
    return Detector(cfg, model, pipeline=pipeline)


class ArchiveDetector:
    """Serve straight from a package_model.py archive: the programs are
    the archive's exported eval steps (weights inside, on the device they
    were exported on), the preprocessing geometry is the MANIFEST's. It
    has the predict_batch(images) of api.Detector that the Batcher
    drives. Every family's program returns the same fields (an
    NMSResult, or the RPN families' one-class ProposalResult), so a
    two-stage archive serves as a dense one: the manifest's family and
    geometry are all it reads."""

    def __init__(self, archive_path: str):
        from .package_model import load_archive

        self.manifest, programs = load_archive(archive_path)
        geo = self.manifest.get("geometry")
        if not geo:
            raise ValueError("archive manifest has no geometry block; "
                             "re-package with the current package_model.py")
        self.geo = geo
        self.batch = int(geo["batch"])
        self.num_fg = int(geo["num_fg_classes"])
        self.programs = {o: p.module() for o, p in programs.items()}
        self.device = next(self.programs["landscape"].parameters()).device

    def _prepare(self, img: np.ndarray, canvas_hw):
        """Fit-resize (bit-equal to cv2.resize INTER_LINEAR) + normalise +
        pad into the given canvas. Unlike prepare_sample this also bounds
        the resize by the canvas itself, so a portrait image can be
        letterboxed into the LANDSCAPE program when the archive has no
        portrait one."""
        geo = self.geo
        h0, w0 = img.shape[:2]
        ch, cw = canvas_hw
        if geo["keep_ratio"]:
            long_e, short_e = max(geo["img_scale"]), min(geo["img_scale"])
            sf = min(long_e / max(h0, w0), short_e / min(h0, w0), ch / h0, cw / w0)
            new_h, new_w = int(h0 * sf + 0.5), int(w0 * sf + 0.5)
        else:
            new_h, new_w = ch, cw
        resized = resize_linear_u8(img, new_w, new_h).astype(np.float32)
        if geo["to_rgb"]:
            resized = resized[..., ::-1]
        resized = (resized - np.asarray(geo["mean"], np.float32)) / np.asarray(geo["std"],
                                                                                np.float32)
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:new_h, :new_w] = resized
        scale = np.array([new_w / w0, new_h / h0] * 2, np.float32)
        return canvas, np.array([new_h, new_w], np.int32), scale

    def predict_batch(self, images, max_batch: int = 8):
        """Per-image per-class [k, 5] arrays, in input order; images grouped
        by orientation into the programs' fixed batch (padding rows repeat
        the chunk's first image and are dropped). `max_batch` is the
        Batcher's; the programs' batch is the manifest's."""
        from ...engine.batch import EvalBatch
        from ...engine.eval import detections_to_per_class
        from .export_model import run_program

        results = [None] * len(images)
        groups = {}
        for idx, img in enumerate(images):
            h0, w0 = img.shape[:2]
            orient = "landscape" if w0 / h0 > 1 else "portrait"
            if orient not in self.programs:
                orient = "landscape"  # letterbox fallback (_prepare)
            groups.setdefault(orient, []).append(idx)
        ch, cw = self.geo["canvas"]
        for orient, idxs in groups.items():
            canvas_hw = (ch, cw) if orient == "landscape" else (cw, ch)
            for lo in range(0, len(idxs), self.batch):
                chunk = idxs[lo:lo + self.batch]
                prepped = [self._prepare(images[i], canvas_hw) for i in chunk]
                prepped += [prepped[0]] * (self.batch - len(chunk))
                bvalid = np.arange(self.batch) < len(chunk)
                dets = run_program(self.programs[orient], EvalBatch(
                    *(np.stack([p[k] for p in prepped]) for k in range(3)), bvalid))
                per = detections_to_per_class(dets, self.num_fg, batch_valid=bvalid)
                for j, i in enumerate(chunk):
                    results[i] = per[j]
        return results


def decode_image(body: bytes) -> Optional[np.ndarray]:
    """Raw JPEG bytes, or base64 of the same (mmdet_handler.py:33-38), as
    uint8 BGR; None for a payload the decoder does not read (what
    cv2.imdecode gives back for what it cannot decode)."""
    try:
        body = base64.b64decode(body, validate=True)
    except (binascii.Error, ValueError):
        pass
    try:
        return decode(body)
    except ValueError:
        return None


class Batcher:
    """Coalesce concurrent requests into one padded device batch.

    Requests enqueue (image, Event, slot); the worker drains up to
    max_batch of them, waiting at most delay_ms for stragglers after the
    first arrival, then runs ONE predict_batch call and wakes every
    waiter; an exception reaches every waiter of that batch. The worker
    thread runs on the detector's CUDA device. `close` stops it."""

    def __init__(self, detector, max_batch: int = 8, delay_ms: float = 5.0):
        self.detector = detector
        self.max_batch = max(1, max_batch)
        self.delay = delay_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def predict(self, img):
        done = threading.Event()
        slot = {}
        self.q.put((img, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker after the batches already queued."""
        self.q.put(None)
        self._thread.join(timeout)

    def _run(self):
        dev = getattr(self.detector, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            first = self.q.get()  # block for the first request
            if first is None:
                return
            items = [first]
            t0 = time.monotonic()
            stop = False
            while len(items) < self.max_batch:
                remaining = self.delay - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    item = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                items.append(item)
            try:
                results = self.detector.predict_batch([im for im, _, _ in items],
                                                      max_batch=self.max_batch)
                for (_, done, slot), res in zip(items, results):
                    slot["result"] = res
                    done.set()
            except Exception as e:  # the worker keeps serving; each waiter raises it
                for _, done, slot in items:
                    slot["error"] = e
                    done.set()
            if stop:
                return


def make_handler(batcher, classes, score_thr):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ping":  # torchserve health endpoint
                self._reply(200, {"status": "Healthy"})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                self._predict()
            except Exception as e:  # keep the connection protocol-clean
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _predict(self):
            length = int(self.headers.get("Content-Length", 0))
            img = decode_image(self.rfile.read(length)) if length else None
            if img is None:
                self._reply(400, {"error": "undecodable image payload"})
                return
            per_class = batcher.predict(img)
            out = []
            for ci, dets in enumerate(per_class):
                name = classes[ci] if ci < len(classes) else str(ci)
                for row in dets:
                    if float(row[4]) >= score_thr:
                        out.append({"class_name": name,
                                    "bbox": [float(v) for v in row[:4]],
                                    "score": float(row[4])})
            self._reply(200, out)

        def log_message(self, fmt, *a):
            print("[serve]", fmt % a, flush=True)

    return Handler


def parse_args(argv: Optional[Sequence[str]] = None):
    from .export_model import EXPORTED_FAMILIES

    ap = argparse.ArgumentParser(description="HTTP detection server")
    ap.add_argument("--family", default="retinanet", choices=EXPORTED_FAMILIES,
                    help="retinanet, ssd or a ported zoo family (utils/config.py "
                         "ZOO_FAMILIES) but fast_rcnn, whose eval takes proposals")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--archive", default=None,
                    help="serve a package_model.py archive instead of (family, checkpoint)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--score-thr", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--mini", action="store_true", help="tiny model smoke mode")
    ap.add_argument("--warmup", action="store_true",
                    help="run the landscape eval step once before listening")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="dynamic batcher: max images per device step")
    ap.add_argument("--batch-delay-ms", type=float, default=5.0,
                    help="dynamic batcher: max wait for stragglers after the first request "
                         "(TorchServe max_batch_delay)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from ...data.voc import VOC_CLASSES

    pin_numerics()
    if args.archive:
        detector = ArchiveDetector(args.archive)
        if args.cpu != (detector.device.type == "cpu"):
            raise ValueError(f"{args.archive} was exported on {detector.device}")
        classes = detector.manifest.get("classes") or VOC_CLASSES[:detector.num_fg]
        max_batch = detector.batch  # the exported program's fixed shape
    else:
        detector = build_detector(args)
        classes = VOC_CLASSES[:detector.cfg.num_fg_classes]
        max_batch = args.max_batch
        if args.warmup:
            h, w = detector.cfg.canvas
            detector.predict_batch([np.zeros((min(600, h), min(1000, w), 3), np.uint8)],
                                   max_batch=max_batch)
            print("warmup done", flush=True)

    batcher = Batcher(detector, max_batch=max_batch, delay_ms=args.batch_delay_ms)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(batcher, classes, args.score_thr))
    print(f"serving {args.family} on :{args.port} (POST image bytes to /predictions, "
          f"GET /ping; batch<= {max_batch}, delay {args.batch_delay_ms} ms)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
