"""``compute_loss`` and the fusion losses with their gradients against
``jax.grad`` on the CPU (the box functions and the elementwise losses are
``test_torch_port_loss.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmidet_tpu.losses import detection as jdet
from mmidet_tpu.losses import fusion as jfus
from mmidet_tpu_torch.losses import detection as pdet
from mmidet_tpu_torch.losses import fusion as pfus

from test_torch_port_train import _threads  # noqa: F401
from test_torch_port_loss import TOL, _feats, _nchw, _t


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
