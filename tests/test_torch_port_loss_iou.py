"""The port's box IoUs (IoU, GIoU, DIoU, CIoU) and their gradients, and
``build_targets``' duplicate cells, against the JAX package on the CPU
(the box functions and the elementwise losses are
``test_torch_port_loss.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.losses import detection as jdet
from mmidet_tpu.ops import boxes as jbox
from mmidet_tpu_torch.losses import detection as pdet
from mmidet_tpu_torch.ops import boxes as pbox

from test_torch_port_train import _threads  # noqa: F401
from test_torch_port_loss import TOL, _boxes, _t
from test_torch_port_loss_grads import _loss_case


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
