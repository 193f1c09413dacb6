"""The port's losses against the JAX package's, in f32 on both sides: the
box functions, the detection loss (``compute_loss``: duplicate cells,
``nc`` 1 and > 1, focal, label smoothing, a combine loss; values and
gradients with respect to ``train_outs`` against ``jax.grad``) and the
fusion losses with their gradients.  Same numpy-seeded inputs on both
sides.  This file holds the box functions and the elementwise losses;
the IoUs and duplicate cells are ``test_torch_port_loss_iou.py``'s,
``compute_loss`` and the fusion losses ``test_torch_port_loss_grads.py``'s."""

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


def test_contrastive_loss_is_zero_at_batch_one():
    a, b = _feats(8, (1, 4, 4, 8))
    assert float(pfus.contrastive_loss(_nchw(a), _nchw(b))) == 0.0
    assert float(jfus.contrastive_loss(jnp.asarray(a), jnp.asarray(b))) == 0
