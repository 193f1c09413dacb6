"""The port's mosaic augmentation, its loader, the ``--quad`` collate and
the single-stream extras against the JAX package's, on the CPU in f32:
each random function's deterministic core fed the JAX function's own
draws (the mosaic centre, the warp's draws or matrix, HSV gains, flips,
the quad, mixup, cutout, crop and replica draws); the collates and the
loader bit for bit against the JAX package's same decode leg (the quad,
mixup, cutout, crop and replica functions and the port's own draws:
``test_torch_port_mosaic_extras.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.data import augment as ja
from mmidet_tpu.data import datasets as jds
from mmidet_tpu.data import loader as jloader
from mmidet_tpu.data import native as jnative
from mmidet_tpu_torch.data import augment as pa
from mmidet_tpu_torch.data import datasets as pds
from mmidet_tpu_torch.data import loader as ploader
from mmidet_tpu_torch.data import native as pnative
from test_torch_port_augment import (_jax_gains,  # noqa: F401
                                     _jax_perspective_draws)
from test_torch_port_data import rect  # noqa: F401
from test_torch_port_train import _threads  # noqa: F401

FILL = 114.0 / 255.0
# images: f32 on both sides; the per-axis taps sum two products a row and
# a column in another order than JAX's weight-matrix contraction (and the
# HSV maps add their own f32 rounding): 1e-5 of values in [0, 1]
IMG_TOL = dict(rtol=0, atol=1e-5)
# the general branch samples the canvas through the inverse warp matrix,
# computed in another order of sums (tests/test_torch_port_augment.py's
# warp tolerance)
WARP_TOL = dict(rtol=1e-4, atol=1e-4)
# normalized labels; pixel boxes go through the same matrix in f32
LAB_TOL = dict(rtol=0, atol=1e-5)
S = 32
PADS = np.asarray([[[4, 0, 24, 32], [0, 6, 32, 20], [0, 0, 32, 32],
                    [10, 2, 12, 28]],
                   [[0, 0, 32, 32], [8, 0, 16, 32], [0, 11, 32, 10],
                    [3, 3, 26, 26]]], np.float32)
DEFAULT = dict(flipud=0.5)  # the default hyp, with up-down flips taken too
GENERAL = dict(flipud=0.5, degrees=10.0, shear=2.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiles(seed, b, n=4, s=S):
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0, 1, (b, n, s, s, 3)).astype(np.float32)
    labels = np.zeros((b, n, 8, 5), np.float32)
    labels[..., 0] = rng.integers(0, 3, (b, n, 8))
    labels[..., 1:3] = rng.uniform(0.2, 0.8, (b, n, 8, 2))
    labels[..., 3:] = rng.uniform(0.1, 0.5, (b, n, 8, 2))
    mask = rng.uniform(0, 1, (b, n, 8)) < 0.6
    return tiles, labels, mask


def _jax_center(key, s=S):
    return np.asarray(jax.random.uniform(key, (2,), minval=0.5 * s,
                                         maxval=1.5 * s))


@pytest.mark.parametrize("pads", [False, True])
def test_mosaic_geometry_and_labels_match_jax(pads):
    _, labels, mask = _tiles(0, 2)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    p4 = _t(PADS) if pads else None
    xc, yc, offs = pa._mosaic_geometry(
        _t(np.stack([_jax_center(k) for k in keys])), S, p4)
    boxes, cls, m = pa._mosaic_labels(_t(labels), _t(mask), offs, S)
    for i, k in enumerate(keys):
        jxc, jyc, joffs = ja._mosaic_geometry(
            k, S, jnp.asarray(PADS[i]) if pads else None)
        assert (float(xc[i]), float(yc[i])) == (float(jxc), float(jyc))
        np.testing.assert_array_equal(offs[i].numpy(), np.asarray(
            [[float(a), float(b)] for a, b in joffs]))
        jb, jc, jm = ja._mosaic_labels(jnp.asarray(labels[i]),
                                       jnp.asarray(mask[i]), joffs, S)
        np.testing.assert_allclose(boxes[i].numpy(), np.asarray(jb),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(cls[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(m[i].numpy(), np.asarray(jm))
    # the centre rounds half to even, as jnp.round
    c = np.asarray([[40.5, 41.5], [16.5, 17.5]], np.float32)
    got = pa._mosaic_geometry(_t(c), S)[:2]
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(c))))


def _fast_inputs(kind, pads, b=2):
    """JAX's centres and warp matrices for ``b`` samples: drawn from the
    default hyp, or (``edge``) a zoom-out whose left and top canvas edges
    land inside the output, so that the tiles' outer rows and columns
    blend toward the fill through the 1-px pad."""
    keys = jax.random.split(jax.random.PRNGKey(2), b)
    centers, Ms = [], []
    for i, key in enumerate(keys):
        k_mosaic, k_warp = jax.random.split(key)
        centers.append(_jax_center(k_mosaic))
        if kind == "drawn":
            M, _ = ja._perspective_matrix(k_warp, ja.AugmentHyp(), 2 * S,
                                          2 * S, S // 2)
        else:
            M = jnp.asarray([[0.45 + 0.1 * i, 0, 3.3], [0, 0.45 + 0.1 * i,
                                                         2.7], [0, 0, 1]],
                            jnp.float32)
        Ms.append(np.asarray(M))
    p4 = PADS[:b] if pads else None
    return keys, np.stack(centers), np.stack(Ms), p4


@pytest.mark.parametrize("kind", ["drawn", "edge"])
@pytest.mark.parametrize("pads", [False, True])
def test_mosaic_warp_fast_given_jax_center_and_matrix(kind, pads):
    tiles, _, _ = _tiles(3, 2)
    keys, centers, Ms, p4 = _fast_inputs(kind, pads)
    xc, yc, offs = pa._mosaic_geometry(_t(centers), S,
                                       None if p4 is None else _t(p4))
    got = pa.mosaic_warp_fast(_t(tiles), offs, (xc, yc), _t(Ms), S)
    assert got.shape == (2, S, S, 3)
    for i in range(2):
        jxc, jyc, joffs = ja._mosaic_geometry(
            jax.random.split(keys[i])[0], S,
            None if p4 is None else jnp.asarray(p4[i]))
        want = np.asarray(jax.jit(ja.mosaic_warp_fast, static_argnums=4)(
            jnp.asarray(tiles[i]), joffs, (jxc, jyc), jnp.asarray(Ms[i]), S))
        np.testing.assert_allclose(got[i].numpy(), want, **IMG_TOL)
        if kind == "edge":  # tiles' outer edges in view: fill, content
            left = np.abs(want[:, :S // 2] - FILL)
            assert (left < 1e-6).any() and (left > 1e-3).any()


@pytest.mark.parametrize("pads", [False, True])
def test_mosaic4_given_jax_center(pads):
    tiles, labels, mask = _tiles(4, 2)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    p4 = _t(PADS) if pads else None
    canvas, boxes, cls, m = pa.mosaic4(
        _t(tiles), _t(labels), _t(mask),
        _t(np.stack([_jax_center(k) for k in keys])), S, pads=p4)
    assert canvas.shape == (2, 2 * S, 2 * S, 3)
    for i, k in enumerate(keys):
        jc, jb, jcls, jm = ja.mosaic4(
            jnp.asarray(tiles[i]), jnp.asarray(labels[i]),
            jnp.asarray(mask[i]), k, S,
            pads=jnp.asarray(PADS[i]) if pads else None)
        # integer translations: the same pixels, fill elsewhere
        np.testing.assert_array_equal(canvas[i].numpy(), np.asarray(jc))
        np.testing.assert_allclose(boxes[i].numpy(), np.asarray(jb),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(cls[i].numpy(), np.asarray(jcls))
        np.testing.assert_array_equal(m[i].numpy(), np.asarray(jm))


def _jax_draws(keys, hyp, s=S):
    """The draws ``ja.augment_pair_mosaic`` takes from each sample's key."""
    out = {"center": [], "gains_rgb": [], "gains_ir": [], "flipud": [],
           "fliplr": []}
    warps = []
    for key in keys:
        k_mosaic, k_warp, k_r, k_i, k_flip = jax.random.split(key, 5)
        kud, klr = jax.random.split(k_flip)
        out["center"].append(_jax_center(k_mosaic, s))
        warps.append(_jax_perspective_draws(k_warp, hyp))
        out["gains_rgb"].append(_jax_gains(k_r, hyp))
        out["gains_ir"].append(_jax_gains(k_i, hyp))
        out["flipud"].append(bool(jax.random.uniform(kud) < hyp.flipud))
        out["fliplr"].append(bool(jax.random.uniform(klr) < hyp.fliplr))
    draws = {k: torch.tensor(np.asarray(v)) for k, v in out.items()}
    draws["warp"] = {k: _t(np.concatenate([w[k] for w in warps]))
                     for k in warps[0]}
    return draws


@pytest.mark.parametrize("branch", ["default", "general"])
def test_augment_pair_mosaic_given_jax_draws(branch):
    """``make_batch_augment(mosaic=True)``'s core on 4 samples against the
    JAX package's batch augmentation on the same key; sample 0 has more
    valid labels than ``max_labels``."""
    hyp = ja.AugmentHyp(**(DEFAULT if branch == "default" else GENERAL))
    rgb4, labels4, mask4 = _tiles(6, 4)
    ir4 = _tiles(7, 4)[0]
    labels4[0, :, :, 1:3] = np.random.default_rng(8).uniform(
        0.35, 0.65, (4, 8, 2))
    mask4[0] = True
    pads4 = np.concatenate([PADS, PADS[::-1]])
    batch = {"rgb4": rgb4, "ir4": ir4, "labels4": labels4, "mask4": mask4,
             "pads4": pads4}
    key = jax.random.PRNGKey(12)
    want = jax.jit(ja.make_batch_augment(S, hyp, 16, mosaic=True))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = _jax_draws(jax.random.split(key, 4), hyp)
    assert draws["fliplr"].any() and not draws["fliplr"].all()
    assert draws["flipud"].any() and not draws["flipud"].all()
    got = pa.augment_pair_mosaic(_t(rgb4), _t(ir4), _t(labels4), _t(mask4),
                                 draws, S, pa.AugmentHyp(
                                     **dataclasses.asdict(hyp)), 16,
                                 pads4=_t(pads4))
    tol = IMG_TOL if branch == "default" else WARP_TOL
    for g, k in zip(got[:2], ("rgb", "ir")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), **tol)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want["mask"]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want["targets"]),
                               **LAB_TOL)
    assert got[3][0].all()  # cropped to max_labels, valid first
    assert 0 < int(got[3].sum()) < got[3].numel()


def _pool_data(rect, tmp_path):  # noqa: F811
    rgb, ir = rect
    return (pds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path / "p")),
            jds.PairedDataset(rgb, ir, nc=2, cache_dir=str(tmp_path / "j")))


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("leg", ["pil", "native"])
def test_collate_mosaic_pool_bit_for_bit(rect, tmp_path, leg):  # noqa: F811
    if leg == "native" and not (pnative.available() and jnative.available()):
        pytest.skip("the native fastloader does not build here")
    p, j = _pool_data(rect, tmp_path)
    groups = [[0, 1, 2, 3], [4, 1, 3, 0]]
    if leg == "pil":
        got = ploader.collate_mosaic_pool([[p[i] for i in g] for g in groups],
                                          48, max_labels_tile=3)
        want = jloader.collate_mosaic_pool(
            [[j[i] for i in g] for g in groups], 48, max_labels_tile=3)
    else:
        got = ploader.collate_mosaic_pool_native(p, groups, 48, 3)
        want = jloader.collate_mosaic_pool_native(j, groups, 48, 3)
    _same(got, want)
    assert (got["pads4"][..., 2:] < 48).any()  # aspect-shaped content
    assert got["mask4"][1, 0].sum() == 3       # cropped to the tile's 3


@pytest.mark.parametrize("leg", ["pil", "native"])
def test_mosaic_loader_matches_jax_over_two_epochs(rect, tmp_path,  # noqa
                                                   leg):
    if leg == "native" and not (pnative.available() and jnative.available()):
        pytest.skip("the native fastloader does not build here")
    p, j = _pool_data(rect, tmp_path)
    native = leg == "native"
    got = ploader.MosaicLoader(p, 2, 48, max_labels_tile=4, seed=3,
                               prefetch=1, use_native=native)
    want = jloader.MosaicLoader(j, 2, 48, max_labels_tile=4, seed=3,
                                prefetch=1, use_native=native)
    assert len(got) == len(want) == 2
    for _ in range(2):
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == 2
        for g, w in pairs:
            _same(g, w)
    assert got.epoch == want.epoch == 2
    # per-image weights: the next epoch's base images drawn by them, as
    # JAX's loader draws them
    for loader in (got, want):
        loader.set_image_weights(np.arange(1.0, len(p) + 1))
    for g, w in zip(got, want, strict=True):
        _same(g, w)
