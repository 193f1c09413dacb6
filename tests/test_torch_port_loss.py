"""The port's losses against the JAX package's, in f32 on both sides: the
box functions, the detection loss (``compute_loss``: duplicate cells,
``nc`` 1 and > 1, focal, label smoothing, a combine loss; values and
gradients with respect to ``train_outs`` against ``jax.grad``) and the
fusion losses with their gradients.  Same numpy-seeded inputs on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.losses import detection as jdet
from mmidet_tpu.losses import fusion as jfus
from mmidet_tpu.ops import boxes as jbox
from mmidet_tpu_torch.losses import detection as pdet
from mmidet_tpu_torch.losses import fusion as pfus
from mmidet_tpu_torch.ops import boxes as pbox

from test_torch_port_train import _threads  # noqa: F401

# f32 on both sides, the same operations in another order: values and
# gradients within 1e-5 relative (plus 1e-6 absolute near 0)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(1, 30, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["xyxy2xywh", "xywh2xyxy", "xywhn2xyxy",
                                  "clip_coords", "scale_coords",
                                  "scale_coords_ratio_pad", "box_iou",
                                  "wh_iou"])
def test_box_functions_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    calls = {
        "xyxy2xywh": lambda m: m.xyxy2xywh(a),
        "xywh2xyxy": lambda m: m.xywh2xyxy(a),
        "xywhn2xyxy": lambda m: m.xywhn2xyxy(a / 64, 320, 256, 3, 5),
        "clip_coords": lambda m: m.clip_coords(a - 10, (40, 30)),
        "scale_coords": lambda m: m.scale_coords((64, 64), a, (48, 80)),
        "scale_coords_ratio_pad": lambda m: m.scale_coords(
            None, a, (40, 60), ((0.8, 0.8), (3.0, 7.5))),
        "box_iou": lambda m: m.box_iou(a, b),
        "wh_iou": lambda m: m.wh_iou(a[:, 2:], b[:, 2:]),
    }
    fn = calls[name]
    want = np.asarray(fn(_JaxArrays(jbox)))
    got = fn(_TorchArrays(pbox)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


class _JaxArrays:
    """The module's functions with numpy arrays passed as jnp arrays."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        return lambda *a, **k: fn(*(jnp.asarray(x) if isinstance(
            x, np.ndarray) else x for x in a), **k)


class _TorchArrays(_JaxArrays):
    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        return lambda *a, **k: fn(*(_t(x) if isinstance(x, np.ndarray)
                                    else x for x in a), **k)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xywh", [False, True])
def test_bbox_iou_and_its_gradient_match_jax(kind, xywh):
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 9), _boxes(rng, 9)
    if xywh:
        a, b = (np.array(jbox.xyxy2xywh(x)) for x in (a, b))
    b[3] = a[3]  # identical boxes
    b[4] = a[4] + 100.0  # disjoint
    flags = {"GIoU": kind == "giou", "DIoU": kind == "diou",
             "CIoU": kind == "ciou"}

    def jf(x):
        return jnp.sum(jbox.bbox_iou(x, jnp.asarray(b), xywh=xywh, **flags)
                       * jnp.arange(1.0, 10.0))
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(a))
    x = _t(a).requires_grad_(True)
    got = (pbox.bbox_iou(x, _t(b), xywh=xywh, **flags)
           * torch.arange(1.0, 10.0)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["bce", "focal", "qfocal", "blur"])
def test_elementwise_losses_match_jax(name):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (6, 4)).astype(np.float32)
    t = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    fns = {
        "bce": lambda m, a, b: m.bce_with_logits(a, b, 1.5),
        "focal": lambda m, a, b: m.focal_modulation(
            a, b, m.bce_with_logits(a, b), 1.5),
        "qfocal": lambda m, a, b: m.qfocal_modulation(
            a, b, m.bce_with_logits(a, b), 2.0),
        "blur": lambda m, a, b: m.bce_blur_with_logits(a, b),
    }
    want = np.asarray(fns[name](jdet, jnp.asarray(x), jnp.asarray(t)))
    got = fns[name](pdet, _t(x), _t(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert pdet.smooth_bce(0.1) == jdet.smooth_bce(0.1)


def _loss_case(nc: int, seed: int):
    """train_outs for a 64 px input (8x8, 4x4, 2x2; na 3), anchors in grid
    units, and padded targets with duplicate cells: target 1 repeats target
    0, target 2 lands in target 0's cell, target 4 is padding."""
    rng = np.random.default_rng(seed)
    b, na, no = 2, 3, nc + 5
    outs = [rng.normal(0, 1.0, (b, na, g, g, no)).astype(np.float32)
            for g in (8, 4, 2)]
    anchors = (np.asarray([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59,
                                                       119],
                           [116, 90, 156, 198, 373, 326]], np.float32)
               .reshape(3, 3, 2) / np.asarray([8, 16, 32],
                                              np.float32)[:, None, None])
    t = 5
    targets = np.zeros((b, t, 5), np.float32)
    targets[..., 0] = rng.integers(0, nc, (b, t))
    targets[..., 1:3] = rng.uniform(0.1, 0.9, (b, t, 2))
    targets[..., 3:5] = rng.uniform(0.05, 0.5, (b, t, 2))
    targets[:, 1] = targets[:, 0]
    targets[:, 2, 1:3] = targets[:, 0, 1:3] + 0.01
    mask = np.ones((b, t), bool)
    mask[:, 4] = False
    return outs, targets, mask, anchors


@pytest.mark.parametrize("nc,hyp_kw,combine", [
    (1, {}, None),
    (3, {}, None),
    (3, {"fl_gamma": 1.5}, None),
    (3, {"label_smoothing": 0.1}, 0.7),
    (2, {"gr": 0.5, "obj_pw": 1.3, "cls_pw": 0.8}, 1.2),
])
def test_compute_loss_and_gradients_match_jax(nc, hyp_kw, combine):
    outs, targets, mask, anchors = _loss_case(nc, 3 + nc)
    jhyp, phyp = jdet.LossHyp(**hyp_kw), pdet.LossHyp(**hyp_kw)

    def jf(o):
        return jdet.compute_loss(o, jnp.asarray(targets), jnp.asarray(mask),
                                 jnp.asarray(anchors), jhyp,
                                 combine_loss=combine)
    (want, want_m), want_g = jax.value_and_grad(jf, has_aux=True)(
        [jnp.asarray(o) for o in outs])
    xs = [_t(o).requires_grad_(True) for o in outs]
    got, got_m = pdet.compute_loss(xs, _t(targets), _t(mask), _t(anchors),
                                   phyp, combine_loss=combine)
    got.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k].detach()),
                                   float(want_m[k]), **TOL)
    for x, g in zip(xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("mode", ["last", "max"])
def test_duplicate_cells_resolve_as_jax(mode, monkeypatch):
    """Both arms of the duplicate-cell rule give JAX's objectness loss; the
    two arms differ on this case, so each is really exercised."""
    outs, targets, mask, anchors = _loss_case(2, 11)
    monkeypatch.setattr(jdet, "OBJ_DUP_MODE", mode)
    monkeypatch.setattr(pdet, "OBJ_DUP_MODE", mode)
    _, want = jdet.compute_loss([jnp.asarray(o) for o in outs],
                                jnp.asarray(targets), jnp.asarray(mask),
                                jnp.asarray(anchors))
    _, got = pdet.compute_loss([_t(o) for o in outs], _t(targets),
                               _t(mask), _t(anchors))
    np.testing.assert_allclose(float(got["obj"]), float(want["obj"]), **TOL)
    monkeypatch.setattr(pdet, "OBJ_DUP_MODE",
                        "max" if mode == "last" else "last")
    _, other = pdet.compute_loss([_t(o) for o in outs], _t(targets),
                                 _t(mask), _t(anchors))
    assert float(other["obj"]) != float(got["obj"])


def test_scatter_max_drops_out_of_range_indices():
    # -1 counts from the end, as in numpy; 5 and -6 lie outside
    idx = torch.tensor([0, 2, 5, -1, 2, -6])
    src = torch.tensor([3.0, 1.0, 9.0, 8.0, 4.0, 7.0])
    got = pdet._scatter_max(4, idx, src)
    want = jnp.zeros(4).at[jnp.asarray(idx.numpy())].max(
        jnp.asarray(src.numpy()), mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _feats(seed, shape=(3, 6, 5, 8)):
    """An NHWC pair for JAX, NCHW views for the port."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0.4, 0.3, shape).astype(np.float32),
            rng.normal(0.5, 0.25, shape).astype(np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["contrastive", "ssim", "fusing",
                                  "entropy_hard", "entropy_soft",
                                  "entropy_loss"])
def test_fusion_losses_and_gradients_match_jax(name):
    a, b = _feats(7)
    fused = (0.5 * (a + b)).astype(np.float32)
    fns = {
        "contrastive": lambda m, x, y, f: m.contrastive_loss(x, y),
        "ssim": lambda m, x, y, f: m.ssim_global(x, y),
        "fusing": lambda m, x, y, f: m.fusing_loss(x, y, f, f * 1.1),
        "entropy_hard": lambda m, x, y, f: m.entropy_256(x),
        "entropy_soft": lambda m, x, y, f: m.entropy_256(x, soft=True),
        "entropy_loss": lambda m, x, y, f: m.entropy_loss(x, y, f),
    }
    fn = fns[name]
    want, want_g = jax.value_and_grad(
        lambda x: fn(jfus, x, jnp.asarray(b), jnp.asarray(fused)))(
        jnp.asarray(a))
    x = _nchw(a).contiguous().requires_grad_(True)
    got = fn(pfus, x, _nchw(b), _nchw(fused))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    if got.requires_grad:
        got.backward()
        grad = x.grad.permute(0, 2, 3, 1).numpy()
    else:  # the hard histogram: no gradient, as torch.histc
        grad = np.zeros_like(a)
    np.testing.assert_allclose(grad, np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


def test_contrastive_loss_is_zero_at_batch_one():
    a, b = _feats(8, (1, 4, 4, 8))
    assert float(pfus.contrastive_loss(_nchw(a), _nchw(b))) == 0.0
    assert float(jfus.contrastive_loss(jnp.asarray(a), jnp.asarray(b))) == 0
