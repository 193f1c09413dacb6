"""REST inference server (stdlib ``http.server``, no framework).

Counterpart of ``mmidet_tpu/deploy/serve.py``; reference
``utils/flask_rest_api/restapi.py:16-29`` (a POST endpoint taking an image
and returning detections as JSON records), extended to two streams: POST
``/v1/detect`` (or ``/v1/object-detection``) with JSON base64 fields
``rgb`` and optional ``ir``, or multipart ``image``/``rgb`` and ``ir``.

``DetectionService`` answers one request at a time.  ``BatchingService`` is
the production path: a dispatcher thread collects up to ``max_batch``
concurrent requests (or waits ``max_wait_ms``) and runs ONE forward + NMS
at the fixed shape ``(max_batch, s, s, 3)``, short batches padded with
zeros, as the JAX package does.  Serve on the card:

    python -m mmidet_tpu_torch.deploy.serve --cfg yolov5l_fuse3_fourier \\
        [--weights model.pt|bundle_dir] [--int8 --calib-rgb d --calib-ir d]

``main(argv, device="cpu")`` serves from the CPU.
"""

from __future__ import annotations

import base64
import io
import json
import os
import queue
import threading
import time
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)

import numpy as np
import torch

from mmidet_tpu_torch.data.datasets import letterbox_np
from mmidet_tpu_torch.eval.evaluator import eval_device
from mmidet_tpu_torch.nn.quant import make_quant_deploy
from mmidet_tpu_torch.ops.nms import non_max_suppression
from mmidet_tpu_torch.parallel.mesh import default_devices, shard_inference


def _preprocess(img_bytes: bytes, s: int):
    """decode -> letterbox; returns (lb_uint8, ratio, (dw, dh))."""
    from PIL import Image
    img0 = np.asarray(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
    lb, r, (dw, dh) = letterbox_np(img0, (s, s))
    return lb, r, (dw, dh)


def _records(dets: np.ndarray, valid: np.ndarray, r: float, dw: float,
             dh: float, names) -> list[dict]:
    out = []
    for x1, y1, x2, y2, conf, cls in dets[valid]:
        out.append({
            "xmin": float((x1 - dw) / r), "ymin": float((y1 - dh) / r),
            "xmax": float((x2 - dw) / r), "ymax": float((y2 - dh) / r),
            "confidence": float(conf),
            "class": int(cls),
            "name": names[int(cls)],
        })
    return out


class DetectionService:
    """One request at a time: holds the model on ``device`` plus
    pre/postprocessing.  The default device is the card; without CUDA the
    constructor raises instead of running on the CPU (pass
    ``device="cpu"`` for that)."""

    def __init__(self, model: torch.nn.Module, names, img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionService: CUDA is not available "
                               "(pass device='cpu' to run on the CPU)")
        self.model = model.to(self.device).eval()
        self.names = names
        self.img_size = img_size
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        # warm up at construction so the first request does not pay for
        # the kernels' build and the first launches
        z = np.zeros((img_size, img_size, 3), np.uint8)
        self._infer(z, z)

    @torch.inference_mode()
    def _infer(self, lb_rgb: np.ndarray, lb_ir: np.ndarray):
        def batch(lb):
            return (torch.from_numpy(lb).to(self.device)[None].float()
                    / 255.0)
        pred = self.model(batch(lb_rgb), batch(lb_ir))["pred"]
        dets, valid = non_max_suppression(pred.float(),
                                          conf_thres=self.conf_thres,
                                          iou_thres=self.iou_thres)
        return dets[0].cpu().numpy(), valid[0].cpu().numpy()

    def predict(self, rgb_bytes: bytes, ir_bytes: bytes) -> list[dict]:
        s = self.img_size
        lb_r, r, (dw, dh) = _preprocess(rgb_bytes, s)
        lb_i, _, _ = _preprocess(ir_bytes, s)
        dets, valid = self._infer(lb_r, lb_i)
        return _records(dets, valid, r, dw, dh, self.names)


class BatchingService:
    """Micro-batching front end: requests from concurrent connections are
    collected (up to ``max_batch``, or ``max_wait_ms`` after the first) and
    served by one forward + NMS at the fixed shape ``(max_batch, s, s,
    3)``; a short batch is padded with zeros.  The letterboxed uint8 images
    of a batch go to the card in one copy from a pinned staging buffer and
    become [0, 1] floats there.

    The warm-up runs at construction in the caller's thread (the kernels
    build there); the dispatcher thread binds the service's device and
    enters inference mode itself (both are per thread).  An error in a
    batch reaches every waiter of that batch.  ``close()`` ends the
    thread.  The default device is the card; without CUDA the constructor
    raises unless ``device="cpu"``.  ``devices`` with more than one entry
    and ``max_batch`` divisible by their count (JAX :116) serve each batch
    over a replica of the model on every entry
    (``parallel.mesh.shard_inference``), the first entry holding the
    staging copy and the NMS; otherwise one device serves it.

    ``batch_log`` holds (requests, seconds of forward + NMS and copies) per
    batch the dispatcher ran, for measurement."""

    def __init__(self, model: torch.nn.Module, names, img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 device: str | torch.device = "cuda", devices=None):
        devices = [eval_device(d) for d in devices or ()]
        shard = len(devices) > 1 and max_batch % len(devices) == 0
        self.device = devices[0] if shard else eval_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the dispatcher thread binds this device by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = shard_inference(model.eval(), devices) if shard else \
            model.to(self.device).eval()
        self.names = names
        self.img_size = img_size
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        s = img_size
        stage = torch.zeros((2, max_batch, s, s, 3), dtype=torch.uint8)
        self._stage = stage.pin_memory() if self.device.type == "cuda" \
            else stage
        self._stage_np = self._stage.numpy()
        self.batch_log: list[tuple[int, float]] = []
        self._q: queue.Queue = queue.Queue()
        # the one fixed-shape program, warmed here (the kernels build in
        # the caller's thread)
        with torch.inference_mode():
            self._run(0)
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def _run(self, n: int):
        """Forward + NMS on the staging buffer, the first ``n`` rows real
        and the rest zeros; returns numpy (dets, valid)."""
        self._stage_np[:, n:] = 0
        x = self._stage.to(self.device, non_blocking=True).float() / 255.0
        pred = self.model(x[0], x[1])["pred"]
        dets, valid = non_max_suppression(pred.float(),
                                          conf_thres=self.conf_thres,
                                          iou_thres=self.iou_thres)
        return dets.cpu().numpy(), valid.cpu().numpy()

    def _collect(self):
        """The next batch of requests, or None once ``close`` was called."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                item = self._q.get(timeout=left)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # serve this batch, then stop
                break
            batch.append(item)
        return batch

    def _dispatch(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while (batch := self._collect()) is not None:
                try:
                    t0 = time.perf_counter()
                    for k, (lb_r, lb_i, _fut) in enumerate(batch):
                        self._stage_np[0, k] = lb_r
                        self._stage_np[1, k] = lb_i
                    dets, valid = self._run(len(batch))
                    self.batch_log.append((len(batch),
                                           time.perf_counter() - t0))
                    for k, (_r, _i, fut) in enumerate(batch):
                        fut["result"] = (dets[k], valid[k])
                        fut["event"].set()
                except Exception as e:  # surface to every waiter
                    for _r, _i, fut in batch:
                        fut["error"] = e
                        fut["event"].set()

    def predict(self, rgb_bytes: bytes, ir_bytes: bytes) -> list[dict]:
        s = self.img_size
        lb_r, r, (dw, dh) = _preprocess(rgb_bytes, s)
        lb_i, _, _ = _preprocess(ir_bytes, s)
        fut = {"event": threading.Event()}
        self._q.put((lb_r, lb_i, fut))
        while not fut["event"].wait(1.0):
            if not self._thread.is_alive():
                raise RuntimeError("the dispatcher thread has stopped")
        if "error" in fut:
            raise fut["error"]
        dets, valid = fut["result"]
        return _records(dets, valid, r, dw, dh, self.names)

    def close(self):
        self._q.put(None)
        self._thread.join()


def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """Minimal multipart/form-data parser: {field name: raw bytes}
    (``email.parser`` handles the framing; stdlib ``cgi`` is gone in
    Python 3.13)."""
    import email.parser
    import email.policy
    msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    parts = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            parts[str(name)] = part.get_payload(decode=True)
    return parts


def make_handler(service):
    """The request handler class over ``service`` (either service)."""
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path.rstrip("/") not in ("/v1/detect",
                                             "/v1/object-detection"):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    # the reference protocol (restapi.py:16-29 posts an
                    # image file field); fields 'image' (or 'rgb') and 'ir'
                    parts = _parse_multipart(body, ctype)
                    rgb = parts.get("image") or parts.get("rgb")
                    if rgb is None:
                        raise ValueError(
                            "multipart needs an 'image' or 'rgb' part")
                    ir = parts.get("ir", rgb)
                else:
                    payload = json.loads(body)
                    rgb = base64.b64decode(payload["rgb"])
                    ir = base64.b64decode(payload.get("ir", payload["rgb"]))
                records = service.predict(rgb, ir)
                out = json.dumps(records).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
            except Exception as e:
                self.send_error(400, str(e))

        def log_message(self, *a):  # quiet
            pass
    return Handler


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for bursts of
    concurrent connections: the standard library's 5 resets the rest when
    the accepting thread waits for the GIL."""
    request_queue_size = 128
    daemon_threads = True


def serve(service, host: str = "0.0.0.0", port: int = 5000,
          threaded: bool = True):
    """``threaded=True`` (default) serves each connection in its own
    thread (``Server``), so that concurrent requests overlap, which
    ``BatchingService`` needs to batch."""
    cls = Server if threaded else HTTPServer
    srv = cls((host, port), make_handler(service))
    print(f"serving on http://{host}:{port}/v1/detect")
    srv.serve_forever()


def _calibrate_int8(model, rgb_dir: str, ir_dir: str, img_size: int,
                    max_images: int = 4, clip: float = 1.0):
    """Startup calibration of the s8-storage serving mode: letterbox up to
    ``max_images`` pairs from the calibration dirs and hand them to
    ``nn.quant.make_quant_deploy``; returns the quantized model.  The
    images should match the serving distribution (per-tensor absmax
    scales)."""
    from PIL import Image

    if not rgb_dir or not ir_dir:
        raise SystemExit("--int8 requires --calib-rgb and --calib-ir "
                         "(a few representative paired images)")
    dev = next(model.parameters()).device

    def _load(d):
        fs = sorted(os.path.join(d, f) for f in os.listdir(d)
                    if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if not fs:
            raise SystemExit(f"--int8: no images in {d}")
        out = [letterbox_np(np.asarray(Image.open(f).convert("RGB")),
                            (img_size, img_size))[0] for f in fs[:max_images]]
        return torch.from_numpy(np.stack(out)).to(dev).float() / 255.0

    rgb, ir = _load(rgb_dir), _load(ir_dir)
    n = min(rgb.shape[0], ir.shape[0])
    return make_quant_deploy(model, [(rgb[:n], ir[:n])], clip=clip)


def build_parser():
    import argparse
    p = argparse.ArgumentParser("mmidet-tpu-torch serve")
    p.add_argument("--cfg", type=str, default="yolov5s_add")
    p.add_argument("--weights", type=str, default="",
                   help=".pt state dict or deploy bundle dir")
    p.add_argument("--names", type=str, nargs="*", default=None)
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batch size (one fixed-shape forward)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time to hold a request while batching")
    p.add_argument("--no-batching", action="store_true",
                   help="single-request mode (the reference's behavior)")
    p.add_argument("--int8", action="store_true",
                   help="s8-storage quantized deploy (activations stored "
                        "as int8; requires --calib-rgb/--calib-ir)")
    p.add_argument("--calib-rgb", type=str, default="",
                   help="dir of RGB images for --int8 scale calibration")
    p.add_argument("--calib-ir", type=str, default="",
                   help="dir of IR images paired with --calib-rgb")
    p.add_argument("--int8-clip", type=float, default=1.0,
                   help="calibration absmax clip for --int8")
    return p


def main(argv=None, device="cuda"):
    """Serve CLI: ``python -m mmidet_tpu_torch.deploy.serve --cfg
    yolov5l_fuse3_fourier --weights model.pt --names People Car ...``"""
    from mmidet_tpu_torch.cli.val import load_model_and_vars

    args = build_parser().parse_args(argv)
    model, _ = load_model_and_vars(args.cfg, args.weights, nc=args.nc,
                                   device=device)
    if args.int8:
        model = _calibrate_int8(model, args.calib_rgb, args.calib_ir,
                                args.img_size, clip=args.int8_clip)
    names = args.names or [str(i) for i in range(args.nc)]
    kw = dict(img_size=args.img_size, conf_thres=args.conf_thres,
              iou_thres=args.iou_thres, device=device)
    if args.no_batching:
        service = DetectionService(model, names, **kw)
    else:
        # JAX serve.py: a batch over every attached device when divisible
        service = BatchingService(model, names, max_batch=args.max_batch,
                                  max_wait_ms=args.max_wait_ms,
                                  devices=default_devices(device), **kw)
    serve(service, args.host, args.port)
    return service


if __name__ == "__main__":
    main()
