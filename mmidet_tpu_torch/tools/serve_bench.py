"""Serving benchmark: the production REST surface, end to end.

Counterpart of ``tools/serve_bench.py``.  It measures ``BatchingService``
behind the threading HTTP server, the stack ``python -m
mmidet_tpu_torch.deploy.serve`` runs: JPEG bytes -> HTTP POST (JSON
base64) -> PIL decode + letterbox -> a micro-batched fixed-shape forward +
NMS on the card -> JSON records, round-tripped over localhost.  Two
closed-loop operating points:

  * concurrency 1 -> latency (``serve_<cfg>_<img>_c1_latency``: p50/p99 ms)
  * concurrency C -> throughput (``serve_<cfg>_<img>_c<C>_throughput``:
    req/s, p50/p99 ms, the batches' mean fill, the dispatcher's forward +
    NMS ms a batch and its busy share of the wall time)

    python -m mmidet_tpu_torch.tools.serve_bench [--cfg yolov5s_gpt4]
        [--img 640] [--concurrency 32] [--requests 200] [--max-batch 16]
        [--device cpu] [--out records.jsonl]

It runs on the card (``--device cpu`` for a smoke run on the CPU), prints
one JSON record per point, each with the card's name and power limit, and
writes them to ``--out`` only when asked.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import subprocess
import threading
import time
import urllib.request


def _jpeg_pair(img: int, shift: int = 0) -> tuple[bytes, bytes]:
    """An RGB/IR pair of JPEGs with natural-ish content (smooth gradients
    plus noise), so that JPEG size and decode cost are realistic;
    ``shift`` rolls the content sideways for distinct pairs."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:img, 0:img]
    base = (96 + 64 * np.sin(x / 37.0) + 48 * np.cos(y / 53.0))
    rgb = np.stack([base, base[::-1], base.T[:img, :img]], -1)
    rgb = np.clip(rgb + rng.normal(0, 8, rgb.shape), 0, 255).astype("uint8")
    rgb = np.roll(rgb, shift, axis=1)

    def enc(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", quality=85)
        return buf.getvalue()

    return enc(rgb), enc(255 - rgb)


def json_payload(rgb: bytes, ir: bytes) -> bytes:
    return json.dumps({"rgb": base64.b64encode(rgb).decode(),
                       "ir": base64.b64encode(ir).decode()}).encode()


def _post(url: str, payload: bytes, timeout: float = 300.0):
    """One request; returns (seconds, records).  A status other than 200
    raises."""
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
    recs = json.loads(body)  # the response parse is in the round trip
    return time.perf_counter() - t0, recs


def _closed_loop(url: str, payloads, concurrency: int, n_requests: int,
                 answers: dict | None = None):
    """``concurrency`` client threads issue ``n_requests`` requests back to
    back, request k carrying ``payloads[k % len(payloads)]`` (or
    ``payloads`` itself, bytes); returns (latencies, wall seconds), and
    each request's records into ``answers`` by k when given.  Any failed
    request raises after the threads end."""
    if isinstance(payloads, bytes):
        payloads = [payloads]
    lat: list[float] = []
    errors: list[Exception] = []
    lock = threading.Lock()
    counter = {"next": 0}

    def worker():
        while True:
            with lock:
                k = counter["next"]
                if k >= n_requests or errors:
                    return
                counter["next"] += 1
            try:
                dt, recs = _post(url, payloads[k % len(payloads)])
            except Exception as e:  # re-raised below, after the join
                with lock:
                    errors.append(e)
                return
            with lock:
                lat.append(dt)
                if answers is not None:
                    answers[k] = recs

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} request(s) failed: {errors[0]!r}")
    return lat, wall


@contextlib.contextmanager
def serving(svc):
    """``svc`` behind the threading HTTP server on a free localhost port:
    yields its detect URL; on exit the server stops and ``svc`` closes,
    an exception in the body included."""
    from mmidet_tpu_torch.deploy.serve import Server, make_handler
    srv = Server(("127.0.0.1", 0), make_handler(svc))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}/v1/detect"
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[device.index or 0]


def pct(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values) * 1e3, q))


def batching_stats(log: list, wall: float) -> dict:
    """The dispatcher's batches in ``log`` ((requests, seconds) each) over
    ``wall`` seconds: mean fill, ms a batch, busy share."""
    busy = sum(t for _, t in log)
    return {"batches": len(log),
            "mean_batch_fill": sum(n for n, _ in log) / max(len(log), 1),
            "forward_nms_ms_per_batch": 1e3 * busy / max(len(log), 1),
            "dispatcher_busy_share": busy / wall}


def main(argv=None):
    ap = argparse.ArgumentParser("serve_bench")
    ap.add_argument("--cfg", default="yolov5s_gpt4")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--nc", type=int, default=6)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--requests", type=int, default=200,
                    help="total requests at the throughput point")
    ap.add_argument("--latency-requests", type=int, default=200,
                    help="requests at the concurrency-1 point")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for a smoke run")
    ap.add_argument("--out", default="",
                    help="also write the records to this file (JSON lines)")
    args = ap.parse_args(argv)

    import torch

    from mmidet_tpu_torch.cli.val import load_model_and_vars
    from mmidet_tpu_torch.deploy.serve import BatchingService
    from mmidet_tpu_torch.eval.evaluator import eval_device

    dev = eval_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    card = card_line(dev)
    model, _ = load_model_and_vars(args.cfg, "", nc=args.nc, device=dev)
    svc = BatchingService(model, [str(i) for i in range(args.nc)],
                          img_size=args.img, conf_thres=0.25,
                          max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms, device=dev)
    payload = json_payload(*_jpeg_pair(args.img))
    common = {"device": kind, "card": card, "cfg": args.cfg,
              "img": args.img, "max_batch": args.max_batch,
              "max_wait_ms": args.max_wait_ms}
    records = []
    with serving(svc) as url:
        print(f"device={kind} card={card} cfg={args.cfg} img={args.img} "
              f"payload={len(payload) / 1024:.0f} KiB", flush=True)
        for _ in range(4):  # warm the HTTP + decode + dispatch path
            _post(url, payload)
        lat1, _ = _closed_loop(url, payload, 1, args.latency_requests)
        records.append({"metric": f"serve_{args.cfg}_{args.img}_c1_latency",
                        "value": pct(lat1, 50), "unit": "ms_p50",
                        "p99_ms": pct(lat1, 99), "n": len(lat1), **common})
        svc.batch_log.clear()
        lat, wall = _closed_loop(url, payload, args.concurrency,
                                 args.requests)
        records.append({
            "metric": f"serve_{args.cfg}_{args.img}_c{args.concurrency}"
                      "_throughput",
            "value": len(lat) / wall, "unit": "req/s",
            "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99), "n": len(lat),
            "concurrency": args.concurrency,
            **batching_stats(svc.batch_log, wall), **common})
    for r in records:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in records)
    return records


if __name__ == "__main__":
    main()
