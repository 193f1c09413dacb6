"""The port's ``nn/aux_experimental.py`` against the JAX package's on the
CPU in f32: the VAE (the noise drawn by ``jax.random.normal`` with the key
the JAX call uses, passed to the port as ``eps``), both feature
extractors in eval and train mode (BN statistics), the decoder, flax's
transposed convolution against the reference's torch form, and the
losses; weights through ``bridge.from_flax_aux``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.nn import aux_experimental as jaux
from mmidet_tpu_torch.bridge import from_flax_aux
from mmidet_tpu_torch.nn import aux_experimental as paux

# f32 on both sides, the same products summed in another order
TOL = dict(rtol=1e-5, atol=1e-5)
IMG = 64
X = np.random.default_rng(0).random((2, IMG, IMG, 3), np.float32)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(
        0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomised(variables, seed):
    """Every leaf replaced by seeded normals (kernels scaled by their fan
    in, so that activations stay near unit size and the sigmoid does not
    saturate; BN variances positive), so that no zero bias or unit scale
    hides a wrong mapping."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        r = rng.standard_normal(v.shape)
        if name == "var":
            r = np.abs(r) + 0.5
        elif name == "kernel":
            r = r / np.sqrt(np.prod(v.shape[:-1]))
        else:
            r = 0.2 * r
        return r.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


@pytest.fixture(scope="module")
def vae_pair():
    jm = jaux.VAE(input_channels=3, latent_dim=16)
    key = jax.random.PRNGKey(3)
    v = _randomised(jm.init({"params": jax.random.PRNGKey(1)}, X,
                            rng=key), 1)
    pm = paux.VAE(3, 16, (IMG, IMG))
    from_flax_aux(pm, v)
    return jm, v, pm, key


def test_vae_against_jax(vae_pair):
    jm, v, pm, key = vae_pair
    want = [np.asarray(a) for a in jm.apply(v, X, rng=key)]
    eps = torch.from_numpy(np.array(jax.random.normal(key, (2, 16))))
    got = pm(_nchw(X), eps=eps)
    np.testing.assert_allclose(_nhwc(got[0]), want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    np.testing.assert_allclose(
        float(paux.vae_loss(got[0], _nchw(X), got[1], got[2])),
        float(jaux.vae_loss(want[0], X, want[1], want[2])), rtol=1e-5)
    # without eps the noise comes from the generator: same shapes, finite
    out = pm(_nchw(X), generator=torch.Generator().manual_seed(0))
    assert out[0].shape == (2, 3, IMG, IMG) and torch.isfinite(out[0]).all()


def test_flax_transposed_conv_is_not_the_reference_form():
    """flax's ConvTranspose(3, 2, SAME) pads the dilated input (2, 1);
    torch's ConvTranspose2d(3, 2, padding=1, output_padding=1) pads
    (1, 2): the port computes the former, which the latter is not."""
    import flax.linen as nn
    x = np.random.default_rng(1).standard_normal((1, 5, 6, 4)).astype(
        np.float32)
    m = nn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME")
    v = _randomised(m.init(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(m.apply(v, x))
    port = paux.FlaxConvTranspose(4, 3, 2)
    w = torch.from_numpy(np.ascontiguousarray(
        v["params"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1)))
    with torch.no_grad():
        port.weight.copy_(w)
        port.bias.copy_(torch.from_numpy(v["params"]["bias"]))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, **TOL)
    ref = torch.nn.functional.conv_transpose2d(
        _nchw(x), w, port.bias, stride=2, padding=1, output_padding=1)
    assert np.abs(_nhwc(ref) - want).max() > 0.1


@pytest.mark.parametrize("name,train", [
    ("ModalitySpecificFeatureExtractor", False),
    ("ModalitySpecificFeatureExtractor", True),
    ("ModalityAgnosticFeatureExtractor", False),
    ("ModalityAgnosticFeatureExtractor", True)])
def test_extractors_against_jax(name, train):
    jm = getattr(jaux, name)()
    v = _randomised(jm.init({"params": jax.random.PRNGKey(0)}, X), 4)
    pm = getattr(paux, name)(3)
    from_flax_aux(pm, v)
    pm.train(train)
    if train:
        want, upd = jm.apply(v, X, train=True, mutable=["batch_stats"])
        got = pm(_nchw(X))
        for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(pm.BatchNorm_0, buf).numpy(),
                np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf]), **TOL)
    else:
        want = jm.apply(v, X)
        got = pm(_nchw(X))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_decoder_against_jax():
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 8)).astype(
        np.float32)
    jm = jaux.DecoderNetwork(out_channels=8)
    v = _randomised(jm.init({"params": jax.random.PRNGKey(0)}, x), 5)
    pm = paux.DecoderNetwork(8, 8)
    from_flax_aux(pm, v)
    np.testing.assert_allclose(_nhwc(pm(_nchw(x))),
                               np.asarray(jm.apply(v, x)), **TOL)


def test_losses_and_negatives_against_jax():
    rng = np.random.default_rng(3)
    a, p, n = (rng.standard_normal((6, 32)).astype(np.float32)
               for _ in range(3))
    np.testing.assert_allclose(
        float(paux.rec_contrastive_loss(*map(torch.from_numpy, (a, p, n)))),
        float(jaux.rec_contrastive_loss(a, p, n)), rtol=1e-6)
    np.testing.assert_allclose(
        float(paux.reconstruction_loss(torch.from_numpy(a),
                                       torch.from_numpy(p))),
        float(jaux.reconstruction_loss(a, p)), rtol=1e-6)
    idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), 6))
    np.testing.assert_array_equal(
        paux.get_negative_features(torch.from_numpy(a),
                                   indices=torch.from_numpy(idx.copy())).numpy(),
        np.asarray(jaux.get_negative_features(jnp.asarray(a),
                                              jax.random.PRNGKey(0))))
    shuffled = paux.get_negative_features(
        torch.from_numpy(a), generator=torch.Generator().manual_seed(0))
    assert sorted(shuffled[:, 0].tolist()) == sorted(a[:, 0].tolist())


def test_bridge_refuses_a_missing_leaf(vae_pair):
    _, v, _, _ = vae_pair
    params = {k: val for k, val in v["params"].items() if k != "dec2"}
    with pytest.raises(KeyError, match="received no variable"):
        from_flax_aux(paux.VAE(3, 16, (IMG, IMG)), {"params": params})
