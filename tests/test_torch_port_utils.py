"""The port's ``utils/`` leftovers against the JAX package's on the CPU:
class and image weights, ``apply_classifier``, ``gsutil_upload`` (a
recording stub ``gsutil`` first on ``PATH``, never a real one),
Dempster-Shafer fusion, the offline download paths, the profiler
(``model_cost`` against XLA's cost analysis, its kernel route against the
plain versions, ``bench_fn``, ``trace``) and ``feature_heatmap`` with the
JAX package's layer lookup.  JAX applies ``yolov5t`` two-stream models
(Add and GPT4 fusion, one layer) at 64 px, from seeded numpy variables
bridged into the port."""

import functools
import json
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import two_stream_spec as jax_spec
from mmidet_tpu.utils import downloads as jdl
from mmidet_tpu.utils import ds_fusion as jds
from mmidet_tpu.utils import general as jgen
from mmidet_tpu.utils import gradcam as jcam
from mmidet_tpu.utils import profiler as jprof
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.utils import downloads as pdl
from mmidet_tpu_torch.utils import ds_fusion as pds
from mmidet_tpu_torch.utils import general as pgen
from mmidet_tpu_torch.utils import gradcam as pcam
from mmidet_tpu_torch.utils import profiler as pprof

IMG = 64
# the heatmaps: f32 on both sides, min-max normalised to [0, 1]
HEATMAP_TOL = 1e-4
# 1 - port gflops / XLA's: XLA's cost analysis counts elementwise
# operations (activations, adds, normalisations, softmax, the Detect
# decode), which torch's flop counter leaves out, and leaves out the
# convolution taps that fall on the zero padding, which torch's counts (a
# 3x3 conv on a 4x4 map: 200 flops against 288): at 64 px the P5 maps are
# 2x2, so the second weighs on the convolution-only Add model (measured
# -2.0%) and the first on the GPT4 model's attention (+10.1%)
XLA_FLOP_GAP = (-0.05, 0.15)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _seeded(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "conv_kernel_s2d"):
            v = rng.normal(0, np.sqrt(1.0 / np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("scale", "sobel_factor"):
            v = 1.0 + rng.normal(0, 0.1, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


IMAGES = np.random.default_rng(7).random((2, 1, IMG, IMG, 3), np.float32)


@functools.lru_cache(maxsize=None)
def _models(fusion):
    """(fusion, JAX model, variables, port model) of
    ``two_stream_spec("t", fusion)``, the port's weights bridged from the
    variables."""
    jm = JaxDetector(spec=jax_spec("t", fusion, nc=2, fusion_layers=1),
                     aux_mode="off", dtype=jnp.float32)
    x = jnp.zeros((1, IMG, IMG, 3))
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k}, x, x, train=False),
        jax.random.PRNGKey(0))
    v = _seeded(shapes, 1)
    pm = TwoStreamDetector(two_stream_spec("t", fusion, nc=2,
                                           fusion_layers=1))
    from_jax_variables(pm, v)
    return fusion, jm, v, pm.eval()


@pytest.fixture(scope="module", params=["add", "gpt4"])
def models(request):
    return _models(request.param)


class _CapturedOnce:
    """The JAX model with ``apply`` run once, compiled: ``feature_heatmap``
    calls it the same way for every layer on the same images, and an eager
    flax apply of the model costs seconds here."""

    def __init__(self, jm):
        self.jm, self.out = jm, None

    def apply(self, *args, **kw):
        if self.out is None:
            self.out = jax.jit(lambda *a: self.jm.apply(*a, **kw))(*args)
        return self.out


# (spec, layer, the name both take): "l1" takes l10_* before l1_* (sorted
# order, "0" < "_"); "l2" on the Add model passes over the parameter-free
# rows 20-22 (Add), which neither side names; "l3" on the GPT4 model over
# rows 30-34 (Add2, Add), and takes l35_Conv before l3_Focus; l6_GPT is a
# fusion row (its first output)
LOOKUPS = [("add", "l1", "l10_Focus"), ("add", "l2", "l23_Conv"),
           ("add", "enhance", "enhance"), ("gpt4", "l1", "l10_C3"),
           ("gpt4", "l3", "l35_Conv"), ("gpt4", "l6", "l6_GPT")]


def test_feature_heatmap_against_jax(models):
    fusion, jm, v, pm = models
    once = _CapturedOnce(jm)
    rgb, ir = IMAGES
    for spec, layer, name in LOOKUPS:
        if spec != fusion:
            continue
        names = sorted(pcam.capture_names(pm))
        assert next(k for k in names if k.startswith(layer)) == name
        want = jcam.feature_heatmap(once, v, jnp.asarray(rgb),
                                    jnp.asarray(ir), layer=layer)
        got = pcam.feature_heatmap(pm, torch.from_numpy(rgb),
                                   torch.from_numpy(ir), layer=layer)
        assert got.shape == want.shape, (layer, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=HEATMAP_TOL, rtol=0,
                                   err_msg=f"{fusion} {layer}")
    # the port's names are the ones JAX captured, "__call__" (the whole
    # model's output) aside
    assert set(pcam.capture_names(pm)) == \
        set(once.out[1]["intermediates"]) - {"__call__"}
    img = (np.random.default_rng(0).random((64, 80, 3)) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(pcam.overlay_heatmap(img, got),
                                  jcam.overlay_heatmap(img, want))


def test_model_cost_against_xla():
    """On the GPT4 model: ``params_m`` equal to the JAX package's count of
    its variables; ``gflops`` within ``XLA_FLOP_GAP`` of XLA's; the kernel
    route (K1 as the custom op, counted by its flop formula) equal to its
    plain version's products."""
    from unittest import mock

    from mmidet_tpu_torch.nn import fusion, transformer_cuda
    _, jm, v, pm = _models("gpt4")
    x = jnp.asarray(IMAGES[0])
    want = jprof.model_cost(jm, v, x, x, train=False)
    t = torch.from_numpy(IMAGES[0])
    got = pprof.model_cost(pm, t, t)
    assert got["params_m"] == pytest.approx(want["params_m"], abs=1e-9)
    gap = 1 - got["gflops"] / want["gflops"]
    assert XLA_FLOP_GAP[0] < gap < XLA_FLOP_GAP[1], (got, want)
    assert got["bytes_accessed"] > 0
    for mod in pm.modules():
        if hasattr(mod, "merge_kernel"):
            mod.use_kernel = True
    kernel_route = pprof.model_cost(pm, t, t)

    def plain(x, stacked, num_heads=8):
        return transformer_cuda.fused_token_transformer_reference(
            x, transformer_cuda._split_qkv(stacked), num_heads)
    with mock.patch.object(fusion, "fused_token_transformer", plain):
        plain_route = pprof.model_cost(pm, t, t)
    for mod in pm.modules():
        if hasattr(mod, "merge_kernel"):
            mod.use_kernel = False
    assert kernel_route["gflops"] == plain_route["gflops"]
    # the module route differs from the plain version in its products
    # only by K1's q, k, v being one product there
    assert abs(kernel_route["gflops"] / got["gflops"] - 1) < 0.05


def test_bench_fn_trace_and_time_synchronized(tmp_path):
    t0 = pprof.time_synchronized()
    a = torch.randn(64, 64)
    assert pprof.bench_fn(torch.mm, a, a, iters=3) > 0
    with pprof.trace(str(tmp_path)) as prof:
        torch.mm(a, a)
    assert pprof.time_synchronized() >= t0
    assert prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names


def test_class_and_image_weights_against_jax():
    rng = np.random.default_rng(0)
    nc = 5
    labels = [np.concatenate([rng.integers(0, nc, (k, 1)),
                              rng.random((k, 4))], 1).astype(np.float32)
              for k in (3, 0, 7, 1, 4, 0, 2)]
    labels[3][:, 0] = 4  # a rare class
    cw = pgen.labels_to_class_weights(labels, nc)
    np.testing.assert_array_equal(cw, jgen.labels_to_class_weights(labels,
                                                                   nc))
    maps = rng.random(nc)
    for w in (cw, cw * (1 - maps) ** 2):
        np.testing.assert_array_equal(
            pgen.labels_to_image_weights(labels, nc, w),
            jgen.labels_to_image_weights(labels, nc, w))
    np.testing.assert_array_equal(pgen.labels_to_class_weights([], nc),
                                  jgen.labels_to_class_weights([], nc))


def test_apply_classifier_against_jax():
    rng = np.random.default_rng(1)
    img = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
    dets = np.array([[10, 10, 40, 50, 0.9, 0], [60, 20, 120, 90, 0.8, 1],
                     [0, 0, 5, 5, 0.5, 1], [30, 30, 31, 31, 0.4, 0]],
                    np.float32)

    def classify(batch):  # brightness decides the class
        return (batch.mean((1, 2, 3)) > 0.5).astype(np.int64)
    np.testing.assert_array_equal(pgen.apply_classifier(dets, classify, img),
                                  jgen.apply_classifier(dets, classify, img))
    assert len(pgen.apply_classifier(dets[:0], classify, img)) == 0


def _stub(tmp_path, code: int):
    """A ``gsutil`` that records its arguments and exits ``code``."""
    d = tmp_path / f"bin{code}"
    d.mkdir()
    log = tmp_path / f"gsutil{code}.log"
    exe = d / "gsutil"
    exe.write_text(f"#!{sys.executable}\nimport sys\n"
                   f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) "
                   f"+ '\\n')\nsys.exit({code})\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return d, log


def test_gsutil_upload_against_jax(tmp_path, monkeypatch):
    f = tmp_path / "results.txt"
    f.write_text("0/1 box 0.1\n")
    ok_dir, ok_log = _stub(tmp_path, 0)
    monkeypatch.setenv("PATH", f"{ok_dir}{os.pathsep}{os.environ['PATH']}")
    assert pgen.gsutil_upload("bkt", str(f)) is True
    assert jgen.gsutil_upload("bkt", str(f)) is True
    assert pgen.gsutil_upload("gs://bkt/run/", str(f)) is True
    lines = ok_log.read_text().splitlines()
    assert lines[0] == lines[1] == f"cp {f} gs://bkt/"
    assert lines[2] == f"cp {f} gs://bkt/run/"
    assert pgen.gsutil_upload("", str(f)) is False
    bad_dir, bad_log = _stub(tmp_path, 1)
    monkeypatch.setenv("PATH", f"{bad_dir}{os.pathsep}{os.environ['PATH']}")
    assert pgen.gsutil_upload("bkt", str(f)) is False
    assert jgen.gsutil_upload("bkt", str(f)) is False
    assert len(bad_log.read_text().splitlines()) == 2
    # no gsutil on PATH at all
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert pgen.gsutil_upload("bkt", str(f)) is False


def test_ds_fusion_against_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        a, b = rng.random(4), rng.random(4)
        for fn in ("mass_from_confidences", "fuse_modal_confidences"):
            args = (a,) if fn == "mass_from_confidences" else (a, b)
            np.testing.assert_array_equal(getattr(pds, fn)(*args, 0.2),
                                          getattr(jds, fn)(*args, 0.2))
        ma, mb = jds.mass_from_confidences(a), jds.mass_from_confidences(b)
        np.testing.assert_array_equal(pds.dempster_combine(ma, mb),
                                      jds.dempster_combine(ma, mb))
    total = (np.array([1.0, 0, 0, 0]), np.array([0, 1.0, 0, 0]))
    np.testing.assert_array_equal(pds.dempster_combine(*total),
                                  jds.dempster_combine(*total))
    np.testing.assert_array_equal(pds.mass_from_confidences(np.zeros(3)),
                                  [0, 0, 0, 1.0])


def test_downloads_offline_paths(tmp_path):
    local = tmp_path / "w.pt"
    local.write_bytes(b"x")
    assert pdl.attempt_download(str(local)) == jdl.attempt_download(
        str(local)) == str(local)
    with pytest.raises(FileNotFoundError):
        pdl.attempt_download(str(tmp_path / "missing.pt"))
    # a refused connection (nothing listens on port 9): no network needed
    url = "http://127.0.0.1:9/yolov5s.pt"
    for mod in (pdl, jdl):
        with pytest.raises(mod.DownloadUnavailable, match="place the file"):
            mod.attempt_download(url, str(tmp_path / mod.__name__))
    cached = tmp_path / "cache"
    cached.mkdir()
    (cached / "yolov5s.pt").write_bytes(b"y")
    assert pdl.attempt_download(url, str(cached)) == str(cached /
                                                         "yolov5s.pt")
    with pytest.raises(pdl.DownloadUnavailable, match="Google Drive"):
        pdl.gdrive_download("abc", str(tmp_path / "g.pt"))
    assert pdl.gdrive_download("abc", str(local)) == str(local)
