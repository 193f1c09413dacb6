"""Greedy NMS and the batched ``non_max_suppression`` of the port against the
JAX package: ``nms_greedy_reference`` against ``_nms_single`` and the Pallas
kernel in interpret mode (identical indices), and ``non_max_suppression``
in all its modes: boxes at atol 1e-5 (the same f32 operations on both
sides) plus rtol 1e-6, because merge-NMS's weighted mean is a sum over the
pool whose order differs between XLA and PyTorch (a few f32 steps at 50
px)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.ops.nms import _nms_single
from mmidet_tpu.ops.nms import non_max_suppression as jax_nms
from mmidet_tpu.ops.nms_pallas import nms_greedy_pallas
from mmidet_tpu_torch.ops import nms_cuda
from mmidet_tpu_torch.ops.nms import non_max_suppression


def _pool(rng, b, k, n_cls=3):
    """Class-offset boxes with distinct scores, 20% of the pool invalid."""
    xy = rng.uniform(0, 100, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (b, k, 2))], -1)
    cls = rng.integers(0, n_cls, (b, k, 1))
    boxes = (boxes + cls * 4096.0).astype(np.float32)
    scores = np.stack([rng.permutation(k) for _ in range(b)]).astype(
        np.float32) / k + 0.01
    scores[rng.random((b, k)) < 0.2] = -np.inf
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("iou", [0.3, 0.45, 0.7])
def test_greedy_matches_jax(iou):
    b, k, max_det = 2, 256, 60
    boxes, scores = _pool(np.random.default_rng(int(iou * 10)), b, k)
    scores[1] = -np.inf  # an empty pool
    ki, kv = nms_cuda.nms_greedy_reference(torch.from_numpy(boxes),
                                           torch.from_numpy(scores), iou,
                                           max_det)
    pi, pv = nms_greedy_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                               iou_thres=iou, max_det=max_det,
                               interpret=True)
    np.testing.assert_array_equal(ki.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(pv))
    assert not kv[1].any() and kv[0].any()
    for i in range(b):
        ri, rv = _nms_single(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                             jnp.zeros(k), iou, max_det, 4096.0, True)
        np.testing.assert_array_equal(kv[i].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(ki[i].numpy(), np.asarray(ri))
    assert ki.dtype == torch.int32 and kv.dtype == torch.bool


def _prediction(seed, b=2, n=400, nc=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 64, (b, n, 2))
    wh = rng.uniform(2, 30, (b, n, 2))
    conf = rng.uniform(0, 1, (b, n, 1 + nc))
    return np.concatenate([xy, wh, conf], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {},
    {"multi_label": True},
    {"classes": (0, 2)},
    {"multi_label": True, "classes": (1,)},
    {"merge": True},
    {"agnostic": True, "iou_thres": 0.6},
], ids=["best", "multi", "classes", "multi_classes", "merge", "agnostic"])
def test_non_max_suppression_matches_jax(kw):
    pred = _prediction(len(kw) + 7 * ("merge" in kw))
    args = dict(conf_thres=0.25, max_det=50, pre_nms_topk=256, **kw)
    want_d, want_v = jax_nms(jnp.asarray(pred), **args)
    got_d, got_v = non_max_suppression(torch.from_numpy(pred), **args)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.any()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5,
                               rtol=1e-6)


def test_greedy_wrapper_cpu_and_other_devices():
    boxes, scores = _pool(np.random.default_rng(0), 1, 128)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = nms_cuda.nms_greedy.launches
    for got, want in zip(nms_cuda.nms_greedy(b, s, 0.45, 20),
                         nms_cuda.nms_greedy_reference(b, s, 0.45, 20)):
        torch.testing.assert_close(got, want)
    assert nms_cuda.nms_greedy.launches == before
    with pytest.raises(ValueError, match="no NMS kernel"):
        nms_cuda.nms_greedy(b.to("meta"), s.to("meta"))

