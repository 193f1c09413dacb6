"""The port's mosaic augmentation, its loader, the ``--quad`` collate and
the single-stream extras against the JAX package's, on the CPU in f32:
each random function's deterministic core fed the JAX function's own
draws (the mosaic centre, the warp's draws or matrix, HSV gains, flips,
the quad, mixup, cutout, crop and replica draws); the collates and the
loader bit for bit against the JAX package's same decode leg; the port's
own draws in their ranges."""

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


def test_quad_batch_given_jax_take_up():
    rng = np.random.default_rng(10)
    b, s = 12, 8
    rgb, ir = (rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
               for _ in range(2))
    targets = rng.uniform(0.1, 0.9, (b, 3, 5)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, 3)) < 0.7
    key = jax.random.PRNGKey(11)
    take_up = np.asarray(jax.random.uniform(key, (3,)) < 0.5)
    assert take_up.any() and not take_up.all()
    want = ja.quad_batch(*(jnp.asarray(x) for x in (rgb, ir, targets, mask)),
                         key)
    got = pa.quad_batch(_t(rgb), _t(ir), _t(targets), _t(mask),
                        _t(take_up))
    for k in ("rgb", "ir", "targets"):
        # the 2x upscale: torch's bilinear against JAX's weight matrices
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert got["rgb"].shape == (3, 2 * s, 2 * s, 3)
    with pytest.raises(ValueError, match="batch % 4"):
        pa.quad_batch(_t(rgb[:6]), _t(ir[:6]), _t(targets[:6]),
                      _t(mask[:6]), _t(take_up[:1]))


def test_mixup_given_jax_ratio():
    rng = np.random.default_rng(12)
    a, b = (rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    la, lb = (rng.uniform(0, 1, (2, 3, 5)).astype(np.float32)
              for _ in range(2))
    ma, mb = rng.uniform(0, 1, (2, 2, 3)) < 0.5
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    r = np.asarray([float(jax.random.beta(k, 8.0, 8.0)) for k in keys],
                   np.float32)
    got = pa.mixup(_t(a), _t(la), _t(ma), _t(b), _t(lb), _t(mb), _t(r))
    for i, k in enumerate(keys):
        want = ja.mixup(*(jnp.asarray(x[i]) for x in (a, la, ma, b, lb, mb)),
                        k)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))


def _jax_cutout_draws(keys, h, w):
    """The draws ``ja.cutout`` takes from each key."""
    def one(key):
        ks = jax.random.split(key, len(pa.CUTOUT_SCALES) * 5)
        row = {"mh": [], "mw": [], "cy": [], "cx": [], "fill": []}
        for i, s in enumerate(pa.CUTOUT_SCALES):
            kh, kw, ky, kx, kf = ks[5 * i:5 * i + 5]
            row["mh"].append(jax.random.randint(
                kh, (), 1, max(int(h * s), 1) + 1))
            row["mw"].append(jax.random.randint(
                kw, (), 1, max(int(w * s), 1) + 1))
            row["cy"].append(jax.random.randint(ky, (), 0, h + 1))
            row["cx"].append(jax.random.randint(kx, (), 0, w + 1))
            row["fill"].append(jax.random.uniform(
                kf, (3,), minval=64 / 255, maxval=191 / 255))
        return {k: np.asarray(v) for k, v in row.items()}
    rows = [one(k) for k in keys]
    return {k: _t(np.stack([r[k] for r in rows])) if k == "fill" else
            _t(np.stack([r[k] for r in rows])).long() for k in rows[0]}


def test_cutout_given_jax_draws():
    rng = np.random.default_rng(14)
    img = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    xy = rng.uniform(0, 20, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 12, (2, 6, 2))],
                           -1).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 6)) < 0.8
    keys = jax.random.split(jax.random.PRNGKey(15), 2)
    draws = _jax_cutout_draws(keys, 24, 32)
    got_img, got_keep = pa.cutout(_t(img), draws, _t(boxes), _t(mask))
    plain = pa.cutout(_t(img), draws)
    for i, k in enumerate(keys):
        want_img, want_keep = ja.cutout(jnp.asarray(img[i]), k,
                                        jnp.asarray(boxes[i]),
                                        jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got_img[i].numpy(),
                                      np.asarray(want_img))
        np.testing.assert_array_equal(plain[i].numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(got_keep[i].numpy(),
                                      np.asarray(want_keep))
    assert (got_keep != _t(mask)).any()  # some label was obscured


@pytest.mark.parametrize("clahe", [True, False])
def test_hist_equalize_matches_jax(clahe):
    rng = np.random.default_rng(16)
    # low-contrast images, so that the mapping moves every level
    img = (0.3 + 0.4 * rng.uniform(0, 1, (2, 32, 48, 3))).astype(np.float32)
    got = pa.hist_equalize(_t(img), clahe=clahe)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: ja.hist_equalize(x, clahe=clahe)))(jnp.asarray(img)))
    # the luma's level (y * 255 truncated) is the same integer on both
    # sides; the maps and the blend add f32 rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert np.abs(want - img).max(axis=(1, 2, 3)).min() > 0.05


def test_mosaic9_given_jax_offsets():
    tiles, labels, mask = _tiles(17, 2, n=9, s=16)
    keys = jax.random.split(jax.random.PRNGKey(18), 2)
    off = np.stack([np.asarray(jax.random.randint(k, (2,), 0, 32))
                    for k in keys])
    got = pa.mosaic9(_t(tiles), _t(labels), _t(mask), _t(off), 16)
    for i, k in enumerate(keys):
        want = ja.mosaic9(jnp.asarray(tiles[i]), jnp.asarray(labels[i]),
                          jnp.asarray(mask[i]), k, 16)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3][i].numpy(), np.asarray(want[3]))


def test_replicate_labels_given_jax_draws():
    rng = np.random.default_rng(19)
    img = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    xy = rng.uniform(0, 24, (2, 7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 10, (2, 7, 2))],
                           -1).astype(np.float32)
    cls = rng.integers(0, 3, (2, 7)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 7)) < 0.8
    keys = jax.random.split(jax.random.PRNGKey(20), 2)
    def draws(key):  # the draws ``ja.replicate_labels`` takes from key
        return jnp.stack([jnp.stack([jax.random.uniform(k1),
                                     jax.random.uniform(k2)])
                          for k1, k2 in (jax.random.split(kk) for kk in
                                         jax.random.split(key, 4))])
    u = np.asarray(jax.jit(jax.vmap(draws))(keys))
    got_img, (gb, gc, gm) = pa.replicate_labels(_t(img), _t(boxes), _t(cls),
                                                _t(mask), _t(u))
    w_img, (wb, wc, wm) = jax.jit(jax.vmap(ja.replicate_labels))(
        jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(cls),
        jnp.asarray(mask), keys)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(w_img))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert (got_img != _t(img)).any()


def test_own_draws_lie_in_their_ranges_and_repeat_from_the_seed():
    hyp = pa.AugmentHyp()
    gen = torch.Generator().manual_seed(0)
    d = pa.mosaic_draws(4000, 64, hyp, gen)
    assert 32 <= float(d["center"].min()) and float(d["center"].max()) <= 96
    assert set(d["warp"]) == {"p", "a", "s", "sh", "t"}
    assert abs(float(pa.quad_draws(4000, gen).float().mean()) - 0.5) < 0.05
    r = pa.mixup_draws(4000, gen)
    # Beta(8, 8): mean 1/2, variance 1/68
    assert ((r > 0) & (r < 1)).all() and abs(float(r.mean()) - 0.5) < 0.01
    assert abs(float(r.var()) - 1 / 68) < 0.002
    c = pa.cutout_draws(500, 24, 32, gen)
    for i, s in enumerate(pa.CUTOUT_SCALES):
        assert int(c["mh"][:, i].min()) == 1
        assert int(c["mh"][:, i].max()) == max(int(24 * s), 1)
        assert int(c["mw"][:, i].max()) == max(int(32 * s), 1)
    assert int(c["cy"].max()) == 24 and int(c["cx"].min()) == 0
    assert 64 / 255 <= float(c["fill"].min()) <= float(c["fill"].max()) \
        <= 191 / 255
    off = pa.mosaic9_draws(500, 16, gen)
    assert int(off.min()) == 0 and int(off.max()) == 31
    u = pa.replicate_draws(500, gen)
    assert u.shape == (500, 4, 2) and 0 <= float(u.min()) < float(u.max()) < 1
    again = pa.mosaic_draws(8, 64, hyp, torch.Generator().manual_seed(1))
    other = pa.mosaic_draws(8, 64, hyp, torch.Generator().manual_seed(1))
    assert torch.equal(again["center"], other["center"])
    assert torch.equal(again["warp"]["t"], other["warp"]["t"])


def test_batch_mosaic_augment_from_a_generator():
    """``make_batch_augment``'s mosaic function end to end on its own
    draws: shapes, labels inside the image, and the same result from the
    same seed; without pads the tiles are anchored whole."""
    rgb4, labels4, mask4 = _tiles(21, 3)
    batch = {"rgb4": _t(rgb4), "ir4": _t(rgb4[:, ::-1].copy()),
             "labels4": _t(labels4), "mask4": _t(mask4)}
    fn = pa.make_batch_augment(S, pa.AugmentHyp(), 12)
    out = fn(batch, torch.Generator().manual_seed(2))
    again = fn(batch, torch.Generator().manual_seed(2))
    assert out["rgb"].shape == out["ir"].shape == (3, S, S, 3)
    assert out["targets"].shape == (3, 12, 5) and out["mask"].shape == (3, 12)
    lab = out["targets"][out["mask"]]
    assert len(lab) and (lab[:, 1:] >= 0).all() and (lab[:, 1:] <= 1).all()
    assert all(torch.equal(out[k], again[k]) for k in out)
