"""The tiny two-stream gpt4 detector of the PyTorch port against the JAX
package end to end: the unfused f32 path, a layer-by-layer sweep over the
fusion blocks, the deploy path (BN folded by each package itself, fused
token transformer: Pallas interpret mode vs the kernel's plain version),
and ``DetectionService.predict`` on PNG bytes."""

import io

import jax
import numpy as np
import pytest
import torch

from mmidet_tpu.deploy.serve import DetectionService as JaxService
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import two_stream_spec as jax_spec
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.deploy.serve import DetectionService
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.nn.fuse import fold_batchnorm

from test_torch_port_train import _threads  # noqa: F401

GPT_LAYERS = (6, 13, 20, 29)  # the four fusion levels of the gpt4 grammar
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, sum order only
# deploy path: the fused transformer rounds to bf16 inside (both sides)
DEPLOY_TOL = dict(rtol=2e-2, atol=2e-2)


def _randomized(variables, rng):
    """Perturb every leaf so that a leaf landing in the wrong place shows:
    kernels scaled by U(0.9, 1.1) (layer gains stay near the init's),
    BN variances drawn from U(0.5, 1.5), everything else + N(0, 0.1)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            v = np.asarray(v) if not isinstance(v, dict) else v
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("kernel", "conv_kernel_s2d"):
                out[k] = (v * rng.uniform(0.9, 1.1, v.shape)).astype(
                    np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        return out
    return walk(jax.tree_util.tree_map(np.asarray, dict(variables)))


@pytest.fixture(scope="module")
def ref():
    spec = jax_spec("t", "gpt4", fusion_layers=2)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    plain = JaxDetector(spec=spec, aux_mode="off")
    v = jax.jit(lambda k: plain.init({"params": k}, rgb[:1], ir[:1],
                                     train=False))(jax.random.PRNGKey(0))
    v = _randomized(v, rng)
    out, inter = jax.jit(lambda v, a, b: plain.apply(
        v, a, b, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(v, rgb, ir)
    deploy = JaxDetector(spec=spec, aux_mode="off", fused=True,
                         pallas_fusion=True)
    folded_f32 = JaxDetector(spec=spec, aux_mode="off", fused=True)
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(v))
    dout = jax.jit(lambda v, a, b: deploy.apply(v, a, b, train=False))(
        folded, rgb, ir)
    gpt = {i: [np.asarray(t) for t in
               inter["intermediates"][f"l{i}_GPT"]["__call__"][0]]
           for i in GPT_LAYERS}
    return {"v": v, "folded": folded, "rgb": rgb, "ir": ir,
            "plain": out, "deploy": dout, "gpt": gpt,
            "folded_model": folded_f32}


def _port(v, kernel_fusion=False, fold=False, truncate_at=None, **flags):
    model = TwoStreamDetector(two_stream_spec("t", "gpt4", fusion_layers=2),
                              kernel_fusion=kernel_fusion,
                              truncate_at=truncate_at, **flags)
    from_jax_variables(model, v)
    return (fold_batchnorm(model) if fold else model).eval()


def _run(model, ref):
    with torch.no_grad():
        return model(torch.from_numpy(ref["rgb"]), torch.from_numpy(ref["ir"]))


def _check(out, want, tol):
    np.testing.assert_allclose(out["pred"].numpy(), np.asarray(want["pred"]),
                               **tol)
    assert len(out["train_outs"]) == len(want["train_outs"]) == 3
    for got, w in zip(out["train_outs"], want["train_outs"]):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)


def test_unfused_f32_matches_jax(ref):
    _check(_run(_port(ref["v"]), ref), ref["plain"], F32_TOL)


@pytest.mark.parametrize("layer", GPT_LAYERS)
def test_truncate_sweep_over_fusion_layers(ref, layer):
    out = _run(_port(ref["v"], truncate_at=layer), ref)["trunc"]
    for got, want in zip(out, ref["gpt"][layer]):
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_deploy_path_matches_jax(ref):
    """JAX: fold_batchnorm variables, fused=True, pallas_fusion=True.
    Port: bridged from the UNFUSED variables, BN folded by the port."""
    model = _port(ref["v"], kernel_fusion=True, fold=True)
    assert all(m.bn is None for m in model.modules() if hasattr(m, "bn"))
    _check(_run(model, ref), ref["deploy"], DEPLOY_TOL)


def test_cem_and_merge_kernel_flags_match_jax_deploy(ref):
    """The same JAX deploy output as above (K1 inside unmerged fusion
    blocks) against the port with the CEM kernel and the merge kernel on
    (their plain versions on the CPU): the merge rounds the streams to bf16
    once more per level, so the gate is the merge kernel's own against its
    unfused module, 0.06 (tests/test_fusion_pallas.py)."""
    model = _port(ref["v"], fold=True, kernel_cem=True, kernel_merge=True)
    _check(_run(model, ref), ref["deploy"], dict(rtol=0.06, atol=0.06))
    with pytest.raises(ValueError, match="BN-folded"):
        _run(_port(ref["v"], kernel_cem=True), ref)


def _png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def test_detection_service_matches_jax(ref):
    """BN-folded f32 models on both sides, so that boxes can be held to
    1e-2 px (the bf16 fusion kernel is held by the test above)."""
    names = [str(i) for i in range(6)]
    kw = dict(img_size=64, conf_thres=1e-4)
    jsvc = JaxService(ref["folded_model"], ref["folded"], names, **kw)
    svc = DetectionService(_port(ref["v"], fold=True), names, device="cpu",
                           **kw)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (48, 80, 3), np.uint8)
    want = jsvc.predict(_png(img), _png(255 - img))
    got = svc.predict(_png(img), _png(255 - img))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["class"] == w["class"] and g["name"] == w["name"]
        np.testing.assert_allclose(
            [g[k] for k in ("xmin", "ymin", "xmax", "ymax")],
            [w[k] for k in ("xmin", "ymin", "xmax", "ymax")], atol=1e-2,
            rtol=0)
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   atol=1e-3)
