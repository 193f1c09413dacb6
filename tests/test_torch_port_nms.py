"""Greedy NMS and the batched ``non_max_suppression`` of the port against the
JAX package: ``nms_greedy_reference`` against ``_nms_single`` and the Pallas
kernel in interpret mode (identical indices), and ``non_max_suppression``
in all its modes: boxes at atol 1e-5 (the same f32 operations on both
sides) plus rtol 1e-6, because merge-NMS's weighted mean is a sum over the
pool whose order differs between XLA and PyTorch (a few f32 steps at 50
px)."""

import functools
import importlib.util
import re
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
# The kernel orders each image's pool by (score descending, index ascending)
# and keeps, in that order, every candidate that no earlier kept box
# suppresses.  Two mirrors must give greedy's indices exactly, ties
# included: a chunked scan (per chunk: drop what boxes kept in earlier
# chunks suppress, then scan the rest in order, each kept box clearing the
# later candidates it suppresses), and the kernel's windowed scan (per
# window: drop what boxes kept before the window suppress, compact the
# survivors in order, walk them in chunks as above).

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


def _windowed_scan(boxes, scores, iou_thres, max_det, window, chunk):
    """One image, as the kernel's ``scan``: boxes (K, 4), scores (K,) ->
    (keep_idx, keep_valid, count), count as the kernel's ``stats`` row of
    the small form: (rounds, consumed, kept, n_valid, path 0), rounds the
    windows plus the walk's chunks.  The walk takes, as the kernel's does,
    only the live candidates that suppress a later live one."""
    valid = scores > -torch.inf
    key = torch.where(valid, -scores, torch.inf)
    order = torch.sort(key, stable=True).indices
    n_valid = int(valid.sum())
    sb = boxes[order[:n_valid]]
    sa = (sb[:, 2] - sb[:, 0]) * (sb[:, 3] - sb[:, 1])

    def suppressed(cand, by):  # any box at positions ``by`` suppresses
        if not by:
            return torch.zeros(len(cand), dtype=torch.bool)
        return (_iou(sb[cand][:, None], sa[cand][:, None], sb[by][None],
                     sa[by][None]) > iou_thres).any(1)
    kept = []                                          # ordered positions
    rounds = consumed = 0
    for wbase in range(0, n_valid, window):
        if len(kept) >= max_det:
            break
        rounds += 1
        pos = torch.arange(wbase, min(wbase + window, n_valid))
        surv = pos[~suppressed(pos, kept)]             # compacted in order
        first = len(kept)
        for cb in range(0, len(surv), chunk):
            if len(kept) >= max_det:
                break
            rounds += 1
            cp = surv[cb:cb + chunk]
            live = ~suppressed(cp, kept[first:])       # kept in this window
            rows = (_iou(sb[cp][None], sa[cp][None], sb[cp][:, None],
                         sa[cp][:, None]) > iou_thres) & torch.ones(
                len(cp), len(cp), dtype=torch.bool).triu(1)
            # only live candidates that suppress a later live one are
            # walked; the others are kept and clear nothing
            for a in torch.nonzero(live & (rows & live).any(1))[:, 0]:
                if live[a]:
                    live &= ~rows[a]
            new = cp[live][:max_det - len(kept)].tolist()
            kept += new
            if len(kept) == max_det:
                consumed = new[-1] + 1
        if len(kept) < max_det:
            consumed = int(pos[-1]) + 1
    idx = torch.zeros(max_det, dtype=torch.int32)
    val = torch.zeros(max_det, dtype=torch.bool)
    idx[:len(kept)] = order[kept].to(torch.int32)
    val[:len(kept)] = True
    return idx, val, (rounds, consumed, len(kept), n_valid, 0)


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


@pytest.mark.parametrize("window", [8, 64, 1024])
@pytest.mark.parametrize("name", _SCAN_POOLS)
def test_windowed_scan_is_greedy(name, window):
    iou = 0.45
    boxes, scores, max_det, (ri, rv), jax_out = _greedy_answers(name, iou)
    for i in range(len(boxes)):
        ki, kv, _ = _windowed_scan(torch.from_numpy(boxes[i]),
                                   torch.from_numpy(scores[i]), iou, max_det,
                                   window, min(window, 64))
        assert torch.equal(ki, ri[i]) and torch.equal(kv, rv[i])
        np.testing.assert_array_equal(ki.numpy(), np.asarray(jax_out[i][0]))
        np.testing.assert_array_equal(kv.numpy(), np.asarray(jax_out[i][1]))


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("name", _SCAN_POOLS)
def test_scan_count_follows_from_greedy(name, chunk):
    """The scan's count (the kernel's ``stats``, here the windowed mirror's,
    in windows of 8 chunks and of the kernel's 1024) is what
    ``chip_smoke.py:expected_scan`` reads off greedy's answer: the ordered
    pool consumed up to the max_det-th kept box, or all of its valid
    candidates when fewer are kept; per window reached, one filter step
    plus a walk step a chunk of survivors; path 0, the small form."""
    window = {8: 64, 64: 1024}[chunk]
    boxes, scores, max_det, (ri, rv), _ = _greedy_answers(name, 0.45)
    want = _chip_smoke().expected_scan(
        torch, torch.from_numpy(boxes), torch.from_numpy(scores), ri, rv,
        max_det, 0.45, window, chunk)
    got = torch.tensor([_windowed_scan(
        torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), 0.45,
        max_det, window, chunk)[2] for i in range(len(boxes))],
        dtype=torch.int32)
    assert torch.equal(got, want)
    n_valid = got[:, 3]
    short = got[:, 2] < max_det  # fewer kept than max_det: all consumed
    assert torch.equal(got[short, 1], n_valid[short])
    assert (got[:, 4] == nms_cuda.PATH_SMALL).all()


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


# --- the large-pool form, rehearsed on the CPU ------------------------------
# For pools of 4096 < K <= 30000 the kernel takes one of three paths to the
# ordered pool.  (1) A pool in order is scanned as it is.  (2) Otherwise a
# cluster of eight blocks selects the first keys of the order by radix
# histograms and scans those.  (3) Where the scan uses them up, each block
# sorts its run of 4096 slots and places each valid key at its position in
# its run plus, for each other run, the number of that run's keys below it
# (a branchless binary search).  Each must agree with one stable sort by
# descending score.

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


def _keys(scores, cluster_slots=4096 * 8):
    """csrc/nms_greedy.cu:load_keys over the whole cluster: (descending
    score bits, invalid largest) << 32 | slot, padding all ones."""
    valid = scores > -np.inf
    hi = np.where(valid, _descending(np.where(valid, scores, 0)),
                  np.uint32(0xffffffff)).astype(np.uint64)
    key = np.full(cluster_slots, np.uint64(0xffffffffffffffff))
    key[:len(scores)] = (hi << np.uint64(32)) | np.arange(len(scores),
                                                         dtype=np.uint64)
    return key


def _in_order(scores):
    """The kernel's in-order check: every slot's score bits (invalid, -inf
    or NaN, the largest) at most the next slot's."""
    hi = _keys(scores, len(scores)) >> np.uint64(32)
    return bool(np.all(hi[:-1] <= hi[1:]))


def _order_case(name):
    rng = np.random.default_rng(len(name))
    s = np.floor(rng.random(5000) * 16).astype(np.float32) / 16  # ties
    s[rng.random(5000) < 0.2] = -np.inf
    top = torch.topk(torch.from_numpy(s), 5000).values.numpy()
    if name == "topk_ties":
        return top
    if name == "signed_zeros":  # -0 ties +0 whatever their order
        return np.float32([0.5, 0.0, -0.0, 0.0, -0.0, -0.25, -np.inf])
    if name == "neg_inf_tail":
        return np.concatenate([top[top > -np.inf],
                               np.full(3000, -np.inf, np.float32)])
    if name == "valid_after_invalid":
        out = top.copy()
        out[-1] = 0.0
        return out
    if name == "nan_invalid_tail":  # NaN counts as invalid, like -inf
        out = top.copy()
        out[-2] = np.nan
        return out
    if name == "nan_inside":
        out = top.copy()
        out[10] = np.nan
        return out
    out = top.copy()  # two valid slots swapped
    out[[20, 21]] = out[[21, 20]] if out[20] != out[21] else [0.1, 0.2]
    return out


@pytest.mark.parametrize("name", [
    "topk_ties", "signed_zeros", "neg_inf_tail", "valid_after_invalid",
    "nan_invalid_tail", "nan_inside", "swapped"])
def test_in_order_check_is_identity_sort(name):
    """The check is true exactly when the stable sort of the valid keys is
    the identity and every valid slot precedes every invalid one."""
    scores = _order_case(name)
    t = torch.from_numpy(scores)
    valid = t > -torch.inf
    nv = int(valid.sum())
    key = torch.where(valid, -t, torch.inf)
    want = bool(valid[:nv].all()) and torch.equal(
        torch.sort(key[:nv], stable=True).indices, torch.arange(nv))
    assert _in_order(scores) == want
    assert want == (name in ("topk_ties", "signed_zeros", "neg_inf_tail",
                             "nan_invalid_tail"))


_DIGIT_SHIFTS = (56, 48, 40, 32, 8, 0)  # slots < 2^16: bits 16-31 are 0


def _select_top(key, top, cap):
    """The kernel's selection: with more than ``cap`` valid keys, radix
    histograms (summed over the cluster's blocks) over 8-bit digits from
    the top, refined until the bucket where the count reaches ``top``
    fits under ``cap``; then every key up to that bucket.  Else every
    valid key.  Returns the selected keys in order."""
    invalid = np.uint64(0xffffffff) << np.uint64(32)
    if int((key < invalid).sum()) <= cap:
        return np.sort(key[key < invalid])
    prefix = fixed = np.uint64(0)
    below = 0
    for shift in map(np.uint64, _DIGIT_SHIFTS):
        match = key[(key & fixed) == prefix]
        hist = np.bincount(((match >> shift) & np.uint64(255)).astype(
            np.int64), minlength=256)
        incl = np.cumsum(hist)
        d = int(np.argmax(below + incl >= top))
        if below + incl[d] <= cap:
            thr = prefix | (np.uint64(d) << shift) | (
                (np.uint64(1) << shift) - np.uint64(1))
            break
        below += int(incl[d] - hist[d])
        prefix |= np.uint64(d) << shift
        fixed |= np.uint64(255) << shift
    return np.sort(key[key <= thr])


@pytest.mark.parametrize("share", [0.9, 0.02], ids=["T_below_valid",
                                                    "T_above_valid"])
@pytest.mark.parametrize("k", [4097, 12289, 30000])
@pytest.mark.parametrize("kind", ["distinct", "tie_heavy", "signed_zeros",
                                  "all_equal"])
def test_top_selection_is_first_of_stable_sort(kind, k, share):
    rng = np.random.default_rng(k + int(share * 100))
    scores = (rng.permutation(k) + 1).astype(np.float32) / (k + 1)
    if kind == "tie_heavy":
        scores = np.floor(scores * 16) / 16
    elif kind == "signed_zeros":
        scores = rng.choice(np.float32([-0.0, 0.0, 0.5, -0.25]), k)
    elif kind == "all_equal":  # score digits separate nothing: the index's
        scores = np.full(k, 0.5, np.float32)
    scores[rng.random(k) >= share] = -np.inf
    sel = _select_top(_keys(scores), nms_cuda.TOP, nms_cuda.TOP_CAP)
    t = torch.from_numpy(scores)
    n_valid = int((t > -torch.inf).sum())
    if n_valid > nms_cuda.TOP_CAP:
        assert nms_cuda.TOP <= len(sel) <= nms_cuda.TOP_CAP
    else:
        assert len(sel) == n_valid
    key = torch.where(t > -torch.inf, -t, torch.inf)
    want = torch.sort(key, stable=True).indices[:len(sel)]
    np.testing.assert_array_equal((sel & np.uint64(0xffffffff)).astype(
        np.int64), want.numpy())


def test_wrapper_constants_are_the_kernels():
    """``nms_cuda``'s constants, which ``expected_scan`` and the mirrors
    use, are those of ``csrc/nms_greedy.cu``."""
    src = (Path(nms_cuda.__file__).resolve().parents[1] / "csrc"
           / "nms_greedy.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kThreads") == nms_cuda.WINDOW
    assert const("kChunk") == nms_cuda.CHUNK
    assert const("kMaxPool") == nms_cuda.SMALL_POOL
    assert const("kMaxLarge") == nms_cuda.MAX_POOL
    assert const("kTop") == nms_cuda.TOP
    assert const("kTopCap") == nms_cuda.TOP_CAP
    assert const("kKeptShared") == nms_cuda.KEPT_SHARED
    assert "int* s = stats + 5 * img;" in src
    assert nms_cuda.STATS_COLUMNS == 5
    shifts = re.search(r"kDigitShift\[6\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(x) for x in shifts.split(",")) == _DIGIT_SHIFTS
