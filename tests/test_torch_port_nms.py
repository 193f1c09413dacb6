"""Greedy NMS and the batched ``non_max_suppression`` of the port against the
JAX package: ``nms_greedy_reference`` against ``_nms_single`` and the Pallas
kernel in interpret mode (identical indices), and ``non_max_suppression``
in all its modes: boxes at atol 1e-5 (the same f32 operations on both
sides) plus rtol 1e-6, because merge-NMS's weighted mean is a sum over the
pool whose order differs between XLA and PyTorch (a few f32 steps at 50
px)."""

import functools
import importlib.util
from pathlib import Path

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


def test_greedy_wrapper_stats_come_from_the_kernel_only():
    """``stats`` is the kernel's count of its scan: the plain version, which
    a CPU tensor reaches, has none to give."""
    boxes, scores = _pool(np.random.default_rng(0), 1, 128)
    with pytest.raises(ValueError, match="stats count the kernel's scan"):
        nms_cuda.nms_greedy(torch.from_numpy(boxes), torch.from_numpy(scores),
                            stats=torch.zeros(1, 4, dtype=torch.int32))


# --- the algorithm of csrc/nms_greedy.cu, rehearsed on the CPU -------------
# The kernel sorts each image's pool by (score descending, index ascending)
# and walks it in chunks: per chunk it drops the candidates that a box kept
# in an earlier chunk suppresses, then scans the rest in order, each kept
# box clearing the later candidates it suppresses.  This mirror (sort, then
# a chunked scan with the chunk size as a parameter) must give greedy's
# indices exactly, ties included.

def _iou(b, ab, j, aj):
    """IoU of pool boxes ``b`` against selected boxes ``j``, in the
    operations and order of ``nms_greedy_reference``."""
    xx1 = torch.maximum(b[..., 0], j[..., 0])
    yy1 = torch.maximum(b[..., 1], j[..., 1])
    xx2 = torch.minimum(b[..., 2], j[..., 2])
    yy2 = torch.minimum(b[..., 3], j[..., 3])
    inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
    return inter / (ab + aj - inter + 1e-9)


def _sorted_chunked_scan(boxes, scores, iou_thres, max_det, chunk):
    """One image: boxes (K, 4), scores (K,) -> (keep_idx, keep_valid,
    count), count as the kernel's ``stats`` row: (rounds, consumed, kept,
    n_valid)."""
    valid = scores > -torch.inf
    key = torch.where(valid, -scores, torch.inf)
    order = torch.sort(key, stable=True).indices      # ties: lower index first
    n_valid = int(valid.sum())
    sb = boxes[order[:n_valid]]
    sa = (sb[:, 2] - sb[:, 0]) * (sb[:, 3] - sb[:, 1])
    kept = []                                          # sorted positions
    rounds = consumed = 0
    for base in range(0, n_valid, chunk):
        if len(kept) >= max_det:
            break
        rounds += 1
        cb, ca = sb[base:base + chunk], sa[base:base + chunk]
        m = len(cb)
        consumed = base + m
        live = torch.ones(m, dtype=torch.bool)
        if kept:                                       # earlier chunks
            live = ~(_iou(cb[:, None], ca[:, None], sb[kept][None],
                          sa[kept][None]) > iou_thres).any(1)
        # rows[a, b]: kept a suppresses the later b (b as the pool element)
        rows = (_iou(cb[None], ca[None], cb[:, None], ca[:, None])
                > iou_thres) & torch.ones(m, m, dtype=torch.bool).triu(1)
        for a in range(m):
            if len(kept) >= max_det:
                break
            if live[a]:
                kept.append(base + a)
                live &= ~rows[a]
                if len(kept) == max_det:
                    consumed = base + a + 1
    idx = torch.zeros(max_det, dtype=torch.int32)
    val = torch.zeros(max_det, dtype=torch.bool)
    idx[:len(kept)] = order[kept].to(torch.int32)
    val[:len(kept)] = True
    return idx, val, (rounds, consumed, len(kept), n_valid)


def _scan_pool(name):
    """(boxes (2, K, 4), scores (2, K), max_det) of the named pool."""
    rng = np.random.default_rng(len(name))
    if name == "unsorted":
        return (*_pool(rng, 2, 256), 60)
    if name == "tie_heavy":  # scores on a 1/16 grid: many equal
        boxes, scores = _pool(rng, 2, 256)
        return boxes, np.where(np.isfinite(scores),
                               np.floor(scores * 16) / 16, scores), 60
    if name == "all_invalid":
        boxes, scores = _pool(rng, 2, 96)
        return boxes, np.full_like(scores, -np.inf), 20
    if name == "k_not_multiple":  # K = 100: a ragged last chunk
        return (*_pool(rng, 2, 100), 100)
    if name == "max_det_above_valid":
        boxes, scores = _pool(rng, 2, 40)
        return boxes, scores, 60
    # duplicate boxes (IoU 1 with their copy) and zero-area boxes
    boxes, scores = _pool(rng, 2, 128)
    boxes[:, 64:] = boxes[:, :64]
    boxes[:, ::5, 2] = boxes[:, ::5, 0]
    return boxes, scores, 128


_SCAN_POOLS = ("unsorted", "tie_heavy", "all_invalid", "k_not_multiple",
               "max_det_above_valid", "duplicate_and_zero_area")


@functools.lru_cache(maxsize=None)
def _greedy_answers(name, iou):
    """The pool and both greedy answers on it: the plain version's and the
    JAX package's ``_nms_single`` (the same numpy inputs)."""
    boxes, scores, max_det = _scan_pool(name)
    ref = nms_cuda.nms_greedy_reference(torch.from_numpy(boxes),
                                        torch.from_numpy(scores), iou,
                                        max_det)
    jax_out = [_nms_single(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                           jnp.zeros(boxes.shape[1]), iou, max_det, 4096.0,
                           True) for i in range(len(boxes))]
    return boxes, scores, max_det, ref, jax_out


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("name", _SCAN_POOLS)
def test_sorted_chunked_scan_is_greedy(name, chunk):
    iou = 0.45
    boxes, scores, max_det, (ri, rv), jax_out = _greedy_answers(name, iou)
    for i in range(len(boxes)):
        ki, kv, _ = _sorted_chunked_scan(torch.from_numpy(boxes[i]),
                                         torch.from_numpy(scores[i]), iou,
                                         max_det, chunk)
        assert torch.equal(ki, ri[i]) and torch.equal(kv, rv[i])
        np.testing.assert_array_equal(kv.numpy(), np.asarray(jax_out[i][1]))
        np.testing.assert_array_equal(ki.numpy(), np.asarray(jax_out[i][0]))
    kept = int(rv.sum())
    if name == "all_invalid":
        assert kept == 0
    else:
        assert kept > 0
    if name == "max_det_above_valid":
        assert not rv[:, -1].any()
    if name == "tie_heavy":
        assert len(np.unique(scores[np.isfinite(scores)])) <= 17


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("name", _SCAN_POOLS)
def test_scan_count_follows_from_greedy(name, chunk):
    """The scan's count (the kernel's ``stats``, here the mirror's) is what
    ``chip_smoke.py:expected_scan`` reads off greedy's answer: the sorted
    pool consumed up to the max_det-th kept box, or all of its valid
    candidates when fewer are kept, in ceil(consumed / chunk) rounds."""
    boxes, scores, max_det, (ri, rv), _ = _greedy_answers(name, 0.45)
    want = _chip_smoke().expected_scan(torch, torch.from_numpy(scores), ri,
                                       rv, max_det, chunk)
    got = torch.tensor([_sorted_chunked_scan(
        torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), 0.45,
        max_det, chunk)[2] for i in range(len(boxes))], dtype=torch.int32)
    assert torch.equal(got, want)
    n_valid = got[:, 3]
    short = got[:, 2] < max_det  # fewer kept than max_det: all consumed
    assert torch.equal(got[short, 1], n_valid[short])


def test_non_max_suppression_evaluator_pool_matches_jax():
    """The evaluator's call (``mmidet_tpu/eval/evaluator.py:56-63``:
    multi-label, ``pre_nms_topk=30000``, conf 0.001) on a pool past the
    4096 slots of K2's small form: 10000 boxes x 6 classes, distinct
    scores, so the top-30000 pool is full."""
    pred = _prediction(11, b=2, n=10000, nc=6)
    args = dict(conf_thres=0.001, iou_thres=0.45, max_det=300,
                pre_nms_topk=30000, multi_label=True)
    want_d, want_v = jax_nms(jnp.asarray(pred), **args)
    # 300 greedy steps of small operations on (2, 30000) tensors: beside
    # other test processes, torch's intra-op threads wait on each other for
    # minutes, where one thread takes a second
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got_d, got_v = non_max_suppression(torch.from_numpy(pred), **args)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.sum() > 100
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5,
                               rtol=0)


# --- the large-pool form's sort, rehearsed on the CPU ----------------------
# For pools of 4096 < K <= 30000 the kernel sorts each run of 4096 slots in
# one block of a cluster of eight and places each valid key at its position
# in its run plus, for each other run, the number of that run's keys below
# it (a branchless binary search).  The scan then reads the pool in that
# order: it must be the order of one stable sort by descending score.

def _descending(s):
    """csrc/nms_greedy.cu:descending: 32 bits that ascend as s descends."""
    u = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32)
    u = u ^ np.where(u >> 31 == 1, np.uint32(0xffffffff),
                     np.uint32(0x80000000))
    return ~u


def _cluster_order(scores, run=4096, cluster=8):
    """The pool positions in the order the large form's workspace holds
    them (its ``ws_idx``), valid candidates only."""
    k = len(scores)
    valid = scores > -np.inf
    key = np.full(run * cluster, np.uint64(0xffffffffffffffff))
    desc = np.where(valid, _descending(np.where(valid, scores, 0)),
                    np.uint32(0xffffffff)).astype(np.uint64)
    key[:k] = (desc << np.uint64(32)) | np.arange(k, dtype=np.uint64)
    runs = np.sort(key.reshape(cluster, run), axis=1)
    order = np.full(int(valid.sum()), -1)
    for r in range(cluster):
        mine = runs[r][:int(valid[r * run:(r + 1) * run].sum())]
        place = np.arange(len(mine))
        for q in range(cluster):
            if q == r:
                continue
            pos = np.zeros(len(mine), dtype=np.int64)
            step = run // 2
            while step:
                pos += step * (runs[q][pos + step - 1] < mine)
                step //= 2
            place += pos + (runs[q][pos] < mine)
        order[place] = (mine & np.uint64(0xffffffff)).astype(np.int64)
    return order


@pytest.mark.parametrize("k", [4097, 12289, 30000])
@pytest.mark.parametrize("kind", ["distinct", "tie_heavy", "signed_zeros"])
def test_cluster_sort_is_one_stable_sort(kind, k):
    rng = np.random.default_rng(k)
    scores = (rng.permutation(k) + 1).astype(np.float32) / (k + 1)
    if kind == "tie_heavy":  # a 1/16 grid: thousands of equal scores
        scores = np.floor(scores * 16) / 16
    elif kind == "signed_zeros":  # -0 ties +0, negative scores sort last
        scores = rng.choice(np.float32([-0.0, 0.0, 0.5, -0.25]), k)
    scores[rng.random(k) < 0.1] = -np.inf
    t = torch.from_numpy(scores)
    key = torch.where(t > -torch.inf, -t, torch.inf)
    want = torch.sort(key, stable=True).indices[:int((t > -torch.inf).sum())]
    np.testing.assert_array_equal(_cluster_order(scores), want.numpy())
