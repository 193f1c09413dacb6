"""The rest of ``data/augment.py`` against the JAX package on the CPU, each
random function's core fed JAX's draws: ``quad_batch``, mixup, cutout,
``hist_equalize``, ``mosaic9``, ``replicate_labels``, and the port's
own draws (mosaic itself and its loader are
``test_torch_port_mosaic.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.data import augment as ja
from mmidet_tpu_torch.data import augment as pa

from test_torch_port_train import _threads  # noqa: F401
from test_torch_port_mosaic import S, _t, _tiles


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
