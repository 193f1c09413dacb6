"""The port's serving front end (``deploy/serve.py``: ``BatchingService``,
the HTTP handler, ``_calibrate_int8``, ``main``; ``tools/serve_bench.py``)
on the CPU, against the JAX package's ``DetectionService`` on the same
bytes and weights.

The model is JAX's ``tests/test_serve.py`` one, ``yolov5s_add`` without
the CEM at 32 px, its variables perturbed (so that scores spread apart and
NMS keeps the same boxes on both sides) and carried across by the bridge.
Gates: records of the same count, classes and order (up to swaps among
confidences equal within the tolerance), boxes within 1e-3 px and
confidences within 1e-4 relative (f32 on both sides, sums in another
order); a batched request equals the single-request service's
answer within the same tolerances (the batch of 8 and the batch of 1 sum
in another order)."""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from mmidet_tpu.deploy import serve as jax_serve
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.deploy import serve
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.nn.layers import ConvBnAct
from mmidet_tpu_torch.tools import serve_bench

from test_torch_port_detector import _randomized
from test_torch_port_quant import (SCALE_RTOL, _by_port_key, _jax_fast,
                                   _jax_variables)

ROOT = Path(__file__).resolve().parent.parent
BOX_TOL = 1e-3
CONF_RTOL = 1e-4
NAMES = ["a", "b"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny models gain nothing from more intra-op threads; fewer keep this
    file from crowding the test workers that share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _png(img) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _close(g, w) -> bool:
    return (g["class"], g["name"]) == (w["class"], w["name"]) and all(
        abs(g[k] - w[k]) <= BOX_TOL for k in ("xmin", "ymin", "xmax",
                                               "ymax")) and \
        abs(g["confidence"] - w["confidence"]) <= CONF_RTOL * w["confidence"]


def _same(got, want):
    """The same records; in the same order but among confidences equal
    within the tolerance, which sums in another order may swap."""
    assert len(got) == len(want) and len(want) > 0
    left = list(want)
    for i, g in enumerate(got):
        match = [j for j, w in enumerate(left) if _close(g, w)]
        assert match, (i, g)
        w = left.pop(match[0])
        assert abs(want.index(w) - i) == 0 or abs(
            w["confidence"] - want[i]["confidence"]) <= \
            CONF_RTOL * w["confidence"], (i, g)


@pytest.fixture(scope="module")
def stack():
    """JAX's DetectionService and the port's, plus the port's
    BatchingService behind a ThreadingHTTPServer, on the same weights."""
    jmodel = JaxDetector(spec=jax_get_spec("yolov5s_add", nc=2),
                         use_cem=False, aux_mode="off")
    torch.manual_seed(0)
    seeded = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                               use_cem=False)
    variables = _randomized(_jax_variables(jmodel, seeded.state_dict(), 32),
                            np.random.default_rng(0))
    jsvc = jax_serve.DetectionService(jmodel, variables, NAMES, img_size=32,
                                      conf_thres=1e-4)
    model = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2),
                              use_cem=False)
    from_jax_variables(model, variables)
    model = fold_batchnorm(model.eval())
    single = serve.DetectionService(model, NAMES, img_size=32,
                                    conf_thres=1e-4, device="cpu")
    svc = serve.BatchingService(model, NAMES, img_size=32, conf_thres=1e-4,
                                max_batch=8, max_wait_ms=30.0, device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield {"url": f"http://127.0.0.1:{srv.server_port}", "jax": jsvc,
           "single": single, "batching": svc, "model": model,
           "jax_model": jmodel, "variables": variables}
    srv.shutdown()
    srv.server_close()
    svc.close()


def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_json_answers_match_jax(stack):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (48, 64, 3), np.uint8)
    rgb, ir = _png(img), _png(255 - img)
    got = _post(stack["url"] + "/v1/detect",
                json.dumps({"rgb": _b64(rgb), "ir": _b64(ir)}).encode())
    _same(got, stack["jax"].predict(rgb, ir))
    # without ``ir`` the RGB image serves for both
    got = _post(stack["url"] + "/v1/detect/",
                json.dumps({"rgb": _b64(rgb)}).encode())
    _same(got, stack["jax"].predict(rgb, rgb))


def test_multipart_answers_match_jax(stack):
    """The reference protocol is a multipart file upload
    (restapi.py:16-29): 'image' (or 'rgb') and optional 'ir' parts."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (40, 56, 3), np.uint8)
    parts = {"image": _png(img), "ir": _png(img[::-1].copy())}
    boundary = "xBOUNDx"
    body = b""
    for name, raw in parts.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"; filename="{name}.png"\r\n'
                 "Content-Type: image/png\r\n\r\n").encode() + raw + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    got = _post(stack["url"] + "/v1/object-detection", body,
                f"multipart/form-data; boundary={boundary}")
    _same(got, stack["jax"].predict(parts["image"], parts["ir"]))
    assert serve._parse_multipart(
        body, f"multipart/form-data; boundary={boundary}") == parts


def test_bad_payload_and_path(stack):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(stack["url"] + "/v1/detect", b"not-json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(stack["url"] + "/v1/detect", b"--x--",
              "multipart/form-data; boundary=x")
    assert e.value.code == 400 and "image" in e.value.reason
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(stack["url"] + "/nope", b"{}")
    assert e.value.code == 404


def test_batched_concurrent_requests(stack):
    """Six concurrent posts are served in one micro-batch (JAX
    test_batched_concurrent_requests), each answer equal to the port's
    single-request service."""
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (40, 48, 3), np.uint8) for _ in range(6)]
    results = [None] * len(imgs)
    svc = stack["batching"]
    svc.batch_log.clear()

    def post(k):
        results[k] = _post(stack["url"] + "/v1/detect", json.dumps(
            {"rgb": _b64(_png(imgs[k]))}).encode())

    threads = [threading.Thread(target=post, args=(k,), daemon=True)
               for k in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sum(n for n, _ in svc.batch_log) == 6 and len(svc.batch_log) <= 2
    for k, img in enumerate(imgs):
        _same(results[k], stack["single"].predict(_png(img), _png(img)))


class _Failing(torch.nn.Module):
    """A detector that raises once ``fail`` is set (after the warm-up)."""

    def __init__(self, inner):
        super().__init__()
        self.inner, self.spec, self.fail = inner, inner.spec, False

    def forward(self, rgb, ir=None):
        if self.fail:
            raise RuntimeError("kernel failed")
        return self.inner(rgb, ir)


def test_error_reaches_every_waiter_and_close_ends_the_thread(stack):
    model = _Failing(stack["model"])
    svc = serve.BatchingService(model, NAMES, img_size=32, max_batch=4,
                                max_wait_ms=500.0, device="cpu")
    model.fail = True
    raw = _png(np.zeros((32, 32, 3), np.uint8))
    errors = []

    def call():
        try:
            svc.predict(raw, raw)
        except RuntimeError as e:
            errors.append(str(e))
    threads = [threading.Thread(target=call, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == ["kernel failed"] * 3
    assert len(svc.batch_log) == 0
    # the dispatcher lives on after a failed batch, and close() ends it
    model.fail = False
    assert isinstance(svc.predict(raw, raw), list)
    svc.close()
    assert not svc._thread.is_alive()
    # a request after the end is refused, not left waiting
    with pytest.raises(RuntimeError, match="dispatcher thread has stopped"):
        svc.predict(raw, raw)


def test_service_refuses_several_devices_and_a_missing_card(stack):
    """Several devices are served since A13: with ``max_batch`` divisible
    by their count the model runs as one replica on each, else on one
    (JAX ``serve.py:116``); without CUDA the default device is refused."""
    for devs, sharded in ((["cpu", "cpu"], True), (["cpu"] * 3, False)):
        svc = serve.BatchingService(stack["model"], NAMES, img_size=32,
                                    device="cpu", devices=devs)
        assert (type(svc.model).__name__ == "ShardedModel") == sharded
        svc.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.BatchingService(stack["model"], NAMES, img_size=32)


@pytest.fixture(scope="module")
def calib_dirs(tmp_path_factory):
    from PIL import Image
    rng = np.random.default_rng(3)
    root = tmp_path_factory.mktemp("calib")
    rdir, idir = root / "rgb", root / "ir"
    rdir.mkdir()
    idir.mkdir()
    for k in range(3):
        img = rng.integers(0, 255, (40, 56, 3), np.uint8)
        Image.fromarray(img).save(rdir / f"{k}.png")
        Image.fromarray(255 - img).save(idir / f"{k}.png")
    return str(rdir), str(idir)


def test_calibrate_int8_matches_jax(stack, calib_dirs, monkeypatch):
    """Startup calibration from paired image dirs: the same letterboxed
    pairs, the scales of JAX's ``_calibrate_int8`` (within 2e-6), and a
    quantized service that answers."""
    q = serve._calibrate_int8(stack["model"], *calib_dirs, img_size=32,
                              max_images=2)
    got = {k: float(v) for k, v in q.state_dict().items()
           if k.endswith("out_scale")}
    _jax_fast(monkeypatch)
    _, qvars = jax_serve._calibrate_int8(
        stack["jax_model"], stack["variables"], *calib_dirs, img_size=32,
        max_images=2)
    want = _by_port_key(qvars["quant"])
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= SCALE_RTOL * want[k] for k in got)
    raw = _png(np.full((32, 40, 3), 90, np.uint8))
    svc = serve.DetectionService(q, NAMES, img_size=32, conf_thres=1e-4,
                                 device="cpu")
    assert isinstance(svc.predict(raw, raw), list)
    with pytest.raises(SystemExit):
        serve._calibrate_int8(stack["model"], "", "", 32)
    with pytest.raises(SystemExit, match="no images"):
        serve._calibrate_int8(stack["model"], calib_dirs[0],
                              os.path.dirname(calib_dirs[0]), 32)


def test_main_chooses_the_service(monkeypatch, calib_dirs):
    chosen = []
    monkeypatch.setattr(serve, "serve",
                        lambda svc, host, port: chosen.append((svc, port)))
    common = ["--cfg", "yolov5t_add", "--nc", "2", "--img-size", "32",
              "--port", "5123"]
    single = serve.main(common + ["--no-batching"], device="cpu")
    assert type(single) is serve.DetectionService
    batching = serve.main(common + ["--max-batch", "2", "--int8",
                                    "--calib-rgb", calib_dirs[0],
                                    "--calib-ir", calib_dirs[1]],
                          device="cpu")
    assert type(batching) is serve.BatchingService
    assert batching.max_batch == 2 and all(
        m.quant for m in batching.model.modules() if isinstance(m, ConvBnAct))
    batching.close()
    assert [c[0] for c in chosen] == [single, batching]
    assert chosen[0][1] == 5123
    with pytest.raises(SystemExit):
        serve.main(common + ["--int8"], device="cpu")


def test_serve_bench_cpu_smoke(capsys):
    """The port's serve_bench through the real HTTP and batching stack on
    the CPU: two well-formed records, and no file of the repo touched."""
    def tree():
        return {p: p.stat().st_mtime_ns for p in ROOT.iterdir()
                if p.is_file()}
    before = tree()
    records = serve_bench.main([
        "--cfg", "yolov5t_add", "--nc", "2", "--img", "32",
        "--device", "cpu", "--concurrency", "4", "--requests", "8",
        "--latency-requests", "4", "--max-batch", "4",
        "--max-wait-ms", "20"])
    assert tree() == before
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == records and len(records) == 2
    lat, thr = records
    assert lat["metric"] == "serve_yolov5t_add_32_c1_latency"
    assert thr["metric"] == "serve_yolov5t_add_32_c4_throughput"
    assert lat["unit"] == "ms_p50" and thr["unit"] == "req/s"
    assert lat["n"] == 4 and thr["n"] == 8
    assert thr["card"] == "cpu" and 1 <= thr["mean_batch_fill"] <= 4
    assert 0 < thr["dispatcher_busy_share"] <= 1
    assert all(r["value"] > 0 and r["p99_ms"] >= 0 for r in records)
    assert not os.path.exists(ROOT / "serve_bench.jsonl")
