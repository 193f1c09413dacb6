"""The port's augmentation against the JAX package's: every random
function's deterministic core fed the JAX function's own draws (HSV gains,
flips, the perspective draws, the warp matrix), and the ranges of the
port's own draws from a ``torch.Generator``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.data import augment as ja
from mmidet_tpu_torch.data import augment as pa

from test_torch_port_train import _threads  # noqa: F401

# f32 on both sides; the colour maps have branch points (hue wrap, max
# channel ties) that random inputs do not hit, so the same operations agree
# to f32 rounding
TOL = dict(rtol=1e-5, atol=2e-6)
HYP = dict(hsv_h=0.3, hsv_s=0.7, hsv_v=0.4, degrees=10.0, translate=0.1,
           scale=0.5, shear=3.0, perspective=0.0005, flipud=0.5,
           fliplr=0.5)


def _img(seed, shape=(2, 24, 20, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_hsv_maps_match_jax_and_round_trip():
    x = _img(0)
    hsv = pa.rgb_to_hsv(_t(x))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(ja.rgb_to_hsv(
        jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(pa.hsv_to_rgb(hsv).numpy(), x, atol=1e-5)
    np.testing.assert_allclose(
        pa.hsv_to_rgb(hsv).numpy(),
        np.asarray(ja.hsv_to_rgb(jnp.asarray(hsv.numpy()))), **TOL)


def _jax_gains(key, hyp):
    """The gains ``ja.augment_hsv`` draws from ``key``."""
    r = jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0)
    return np.asarray(r * jnp.asarray([hyp.hsv_h, hyp.hsv_s, hyp.hsv_v])
                      + 1.0)


def test_augment_hsv_given_jax_gains():
    hyp = ja.AugmentHyp(**HYP)
    x = _img(1)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = np.stack([np.asarray(ja.augment_hsv(jnp.asarray(x[i]), keys[i],
                                               hyp)) for i in range(2)])
    gains = np.stack([_jax_gains(k, hyp) for k in keys])
    got = pa.augment_hsv(_t(x), _t(gains)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_perspective_draws(key, hyp):
    """The draws ``ja._perspective_matrix`` takes from ``key``."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    u = jax.random.uniform
    p = [u(k1, minval=-hyp.perspective, maxval=hyp.perspective),
         u(k2, minval=-hyp.perspective, maxval=hyp.perspective)]
    return {"p": np.asarray(jnp.stack(p))[None],
            "a": np.asarray(u(k3, minval=-hyp.degrees,
                              maxval=hyp.degrees))[None],
            "s": np.asarray(u(k4, minval=1 - hyp.scale,
                              maxval=1 + hyp.scale))[None],
            "sh": np.asarray(u(k5, (2,), minval=-hyp.shear,
                               maxval=hyp.shear))[None],
            "t": np.asarray(u(k6, (2,), minval=0.5 - hyp.translate,
                              maxval=0.5 + hyp.translate))[None]}


@pytest.mark.parametrize("border", [0, -8])
def test_perspective_matrix_given_jax_draws(border):
    hyp = ja.AugmentHyp(**HYP)
    key = jax.random.PRNGKey(5)
    M, s = ja._perspective_matrix(key, hyp, 40, 32, border)
    draws = {k: _t(v) for k, v in _jax_perspective_draws(key, hyp).items()}
    pm, ps = pa._perspective_matrix(draws, 40, 32, border)
    np.testing.assert_allclose(pm[0].numpy(), np.asarray(M), rtol=1e-5,
                               atol=1e-6)
    assert float(ps[0]) == float(s)


@pytest.mark.parametrize("seed", [6, 7])
def test_warp_image_given_jax_matrix(seed):
    hyp = ja.AugmentHyp(**HYP)
    x = _img(seed, (24, 20, 3))
    M, _ = ja._perspective_matrix(jax.random.PRNGKey(seed), hyp, 20, 24, 0)
    want = np.asarray(ja.warp_image(jnp.asarray(x), M, (22, 26)))
    got = pa.warp_image(_t(x)[None], _t(np.asarray(M))[None], (22, 26))
    assert got.shape == (1, 22, 26, 3)
    # the inverse matrix in another order of sums moves a source
    # coordinate by about 1e-5 px; a bilinear weight moves with it
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("perspective", [False, True])
def test_transform_labels_given_jax_matrix(perspective):
    hyp = ja.AugmentHyp(**HYP)
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 30, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 12, (6, 2))],
                           -1).astype(np.float32)
    mask = np.asarray([True, True, True, False, True, True])
    M, s = ja._perspective_matrix(jax.random.PRNGKey(9), hyp, 40, 40, 0)
    want_b, want_m = ja.transform_labels(jnp.asarray(boxes),
                                         jnp.asarray(mask), M, (40, 40),
                                         perspective, s)
    got_b, got_m = pa.transform_labels(_t(boxes), _t(mask),
                                       _t(np.asarray(M)), (40, 40),
                                       perspective, float(s))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # batched: the same boxes and matrix twice
    bb, bm = pa.transform_labels(_t(boxes).expand(2, -1, -1),
                                 _t(mask).expand(2, -1),
                                 _t(np.asarray(M)).expand(2, -1, -1),
                                 (40, 40), perspective,
                                 torch.full((2,), float(s)))
    np.testing.assert_allclose(bb[1].numpy(), got_b.numpy())
    np.testing.assert_array_equal(bm[1].numpy(), got_m.numpy())


def _jax_basic_draws(keys, hyp):
    """The draws ``ja.augment_pair_basic`` takes from each key."""
    out = {"gains_rgb": [], "gains_ir": [], "flipud": [], "fliplr": []}
    for key in keys:
        k_r, k_i, k_flip = jax.random.split(key, 3)
        kud, klr = jax.random.split(k_flip)
        out["gains_rgb"].append(_jax_gains(k_r, hyp))
        out["gains_ir"].append(_jax_gains(k_i, hyp))
        out["flipud"].append(bool(jax.random.uniform(kud) < hyp.flipud))
        out["fliplr"].append(bool(jax.random.uniform(klr) < hyp.fliplr))
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def test_batch_augment_given_jax_draws():
    """``make_batch_augment(mosaic=False)``'s function, fed JAX's draws
    through ``augment_pair_basic``, against the JAX package's batch
    augmentation on the same key (4 pairs: flips taken and not)."""
    hyp = ja.AugmentHyp(**HYP)
    rng = np.random.default_rng(10)
    rgb, ir = _img(11, (4, 16, 16, 3)), _img(12, (4, 16, 16, 3))
    targets = rng.uniform(0.1, 0.9, (4, 3, 5)).astype(np.float32)
    mask = np.asarray([[1, 1, 0], [1, 0, 0], [1, 1, 1], [0, 0, 0]], bool)
    key = jax.random.PRNGKey(13)
    want = ja.make_batch_augment(16, hyp, 3, mosaic=False)(
        {"rgb": jnp.asarray(rgb), "ir": jnp.asarray(ir),
         "targets": jnp.asarray(targets), "mask": jnp.asarray(mask)}, key)
    draws = _jax_basic_draws(jax.random.split(key, 4), hyp)
    assert draws["fliplr"].any() and not draws["fliplr"].all()
    got = pa.augment_pair_basic(_t(rgb), _t(ir), _t(targets), _t(mask),
                                draws)
    for g, k in zip(got, ("rgb", "ir", "targets", "mask")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_own_draws_lie_in_their_ranges_and_repeat_from_the_seed():
    hyp = pa.AugmentHyp(**HYP)
    gen = torch.Generator().manual_seed(0)
    d = pa.basic_draws(4000, hyp, gen)
    g = torch.cat([d["gains_rgb"], d["gains_ir"]])
    lim = torch.tensor([hyp.hsv_h, hyp.hsv_s, hyp.hsv_v])
    assert ((g - 1).abs() <= lim).all()
    assert ((g - 1).abs().amax(0) > 0.95 * lim).all()  # the range is used
    for k in ("flipud", "fliplr"):
        assert d[k].dtype == torch.bool
        assert abs(d[k].float().mean() - 0.5) < 0.05
    p = pa.perspective_draws(4000, hyp, gen)
    for k, lo, hi in (("p", -hyp.perspective, hyp.perspective),
                      ("a", -hyp.degrees, hyp.degrees),
                      ("s", 1 - hyp.scale, 1 + hyp.scale),
                      ("sh", -hyp.shear, hyp.shear),
                      ("t", 0.5 - hyp.translate, 0.5 + hyp.translate)):
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
    again = pa.basic_draws(8, hyp, torch.Generator().manual_seed(1))
    other = pa.basic_draws(8, hyp, torch.Generator().manual_seed(1))
    assert all(torch.equal(again[k], other[k]) for k in again)
    off = dataclasses.replace(hyp, fliplr=0.0, hsv_h=0.0, hsv_s=0.0,
                              hsv_v=0.0)
    z = pa.basic_draws(64, off, gen)
    assert not z["fliplr"].any() and (z["gains_rgb"] == 1).all()


def test_batch_augment_without_gains_or_flips_is_the_identity():
    hyp = pa.AugmentHyp(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0)
    x = _t(_img(14, (2, 8, 8, 3)))
    batch = {"rgb": x, "ir": x.flip(1), "targets": torch.rand(2, 3, 5),
             "mask": torch.tensor([[True, False, True]] * 2)}
    out = pa.make_batch_augment(8, hyp, 3, mosaic=False)(
        batch, torch.Generator())
    torch.testing.assert_close(out["rgb"], x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out["targets"][:, 1], torch.zeros(2, 5))
