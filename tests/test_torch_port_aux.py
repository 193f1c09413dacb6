"""The detector's Info-Guided aux losses in train and eval form, against
the JAX package's, in f32 on a tiny fourier grammar (the flagship's at 1/8
of its widths): the aux dict of ``aux_mode="reference"`` and ``"full"``,
the total loss with the combine term and its gradients; the optimizer
labels of the grammar (``pos_emb``, GPT1_fourier's gate); the dropout
modules.  JAX compiles the aux losses' gradient once."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.losses.detection import compute_loss as jax_compute_loss
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu_torch.bridge import from_jax_variables, torch_key
from mmidet_tpu_torch.losses.detection import LossHyp, compute_loss
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.train import optimizer as popt

# f32 on both sides, the same operations in another order of sums
F32_TOL = dict(rtol=1e-4, atol=1e-5)
MAX_LABELS = 120


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_shapes(model, img=64):
    x = jnp.zeros((1, img, img, 3))
    return jax.eval_shape(
        lambda k: model.init({"params": k}, x, x, train=False),
        jax.random.PRNGKey(0))


def _seeded(shapes, seed):
    """Variables from numpy without a JAX init: kernels N(0, 1/fan-in), BN
    variances in U(0.5, 1.5), scales 1 + N(0, 0.1), the rest N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "conv_kernel_s2d"):
            v = rng.normal(0, np.sqrt(1.0 / np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("scale", "sobel_factor"):
            v = 1.0 + rng.normal(0, 0.1, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return jnp.asarray(v.astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _to_torch(arr, kind):
    from mmidet_tpu_torch.bridge import to_torch_layout
    return to_torch_layout(np.asarray(arr), kind)


def _anchors(spec):
    a = np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
    return a / np.asarray(spec.strides, np.float32)[:, None, None]


def _batch(seed, n_targets=3):
    rng = np.random.default_rng(seed)
    targets = np.zeros((2, MAX_LABELS, 5), np.float32)
    targets[:, :n_targets, 0] = rng.integers(0, 2, (2, n_targets))
    targets[:, :n_targets, 1:3] = rng.uniform(0.2, 0.8, (2, n_targets, 2))
    targets[:, :n_targets, 3:] = rng.uniform(0.1, 0.4, (2, n_targets, 2))
    mask = np.zeros((2, MAX_LABELS), bool)
    mask[:, :n_targets] = True
    return {"rgb": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
            "ir": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
            "targets": targets, "mask": mask}


def _tiny_fourier(zoo):
    """The flagship's fourier grammar at 1/8 of its widths, one block a
    stage, one fusion layer (GPT1_fourier takes unscaled channels, so the
    width is cut in the layer rows themselves)."""
    spec = zoo.two_stream_spec("l", "fourier", nc=2, fusion_layers=1)
    chans = {"Focus", "Conv", "C3", "SPP", "GPT", "GPT1_fourier", "Add2"}
    layers = tuple(dataclasses.replace(
        ld, n=1, args=(ld.args[0] // 8,) + tuple(ld.args[1:]))
        if ld.name in chans else ld for ld in spec.layers)
    return dataclasses.replace(spec, layers=layers)




@pytest.fixture(scope="module")
def fourier_pair():
    from mmidet_tpu.models import zoo as jzoo
    from mmidet_tpu_torch.models import zoo as pzoo
    jspec, pspec = _tiny_fourier(jzoo), _tiny_fourier(pzoo)
    full = JaxDetector(spec=jspec, aux_mode="full")
    variables = _seeded(_jax_shapes(full), 3)
    return full, variables, pspec


def test_detector_aux_losses_and_gradients_match_jax(fourier_pair):
    """The aux dict of both modes on the tiny fourier grammar, with BN in
    eval mode and dropout off (JAX ``train=False``), the total loss with
    the combine term of each, and its gradients in full mode (every term
    of the combine).  JAX's ``"full"`` model gives
    every term in one compile; its ``"reference"`` combine is the SSIM
    term, ``detector.py:259``."""
    jfull, variables, pspec = fourier_pair
    b = _batch(2)
    anchors = _anchors(jfull.spec)

    def losses(params):
        out = jfull.apply({**variables, "params": params}, b["rgb"], b["ir"],
                          train=False, decode=False)
        aux = out["aux"]
        tot = {m: jax_compute_loss(out["train_outs"], b["targets"],
                                   b["mask"], anchors, JaxLossHyp(),
                                   combine_loss=c)[0]
               for m, c in (("reference", aux["ssim"]),
                            ("full", aux["combine"]))}
        return tot, aux
    (tot, aux), grads = jax.jit(lambda p: (
        losses(p), jax.grad(lambda q: losses(q)[0]["full"])(p)))(
        variables["params"])
    for mode in ("reference", "full"):
        port = TwoStreamDetector(pspec, aux_mode=mode)
        from_jax_variables(port, jax.tree_util.tree_map(np.asarray,
                                                        variables))
        out = port.eval()(torch.from_numpy(b["rgb"]),
                          torch.from_numpy(b["ir"]))
        want = {"contrastive", "pattern", "ssim", "combine"} | (
            {"entropy"} if mode == "full" else set())
        assert set(out["aux"]) == want
        for k in want:
            w = aux["ssim"] if (k, mode) == ("combine", "reference") \
                else aux[k]
            np.testing.assert_allclose(float(out["aux"][k].detach()),
                                       float(w), **F32_TOL)
        total, _ = compute_loss(out["train_outs"],
                                torch.from_numpy(b["targets"]),
                                torch.from_numpy(b["mask"]),
                                torch.from_numpy(anchors), LossHyp(),
                                combine_loss=out["aux"]["combine"])
        np.testing.assert_allclose(float(total.detach()),
                                   float(tot[mode]), **F32_TOL)
        if mode != "full":
            continue
        total.backward()
        named = dict(port.named_parameters())
        for path, g in flax.traverse_util.flatten_dict(grads).items():
            key, kind = torch_key(path)
            want_g = _to_torch(g, kind)
            got_g = named[key].grad.numpy()
            err = np.abs(got_g - want_g).max() / max(
                1e-3, np.abs(want_g).max())
            assert err <= 1e-3, (mode, key, err)


def test_dropout_is_on_in_train_mode_only():
    from mmidet_tpu_torch.models import zoo as pzoo
    port = TwoStreamDetector(_tiny_fourier(pzoo), aux_mode="reference")
    drops = [m for m in port.modules() if isinstance(m, torch.nn.Dropout)]
    # per fusion level: embd, and per layer attn + resid + mlp
    assert len(drops) == 4 * 4 and all(m.p == 0.1 for m in drops)
    x = torch.rand(2, 64, 64, 3)
    with torch.no_grad():
        port.eval()
        a, b = (port(x, x)["pred"] for _ in range(2))
        assert torch.equal(a, b)
        torch.manual_seed(0)
        c = port.train()(x, x)["train_outs"][0]
        torch.manual_seed(1)
        d = port(x, x)["train_outs"][0]
    assert not torch.equal(c, d)


@pytest.mark.parametrize("groups", ["fixed", "reference"])
def test_label_params_of_the_fourier_grammar_match_jax(groups,
                                                       fourier_pair):
    _, variables, pspec = fourier_pair
    want = {torch_key(p)[0]: v for p, v in flax.traverse_util.flatten_dict(
        jopt.label_params(variables["params"], groups)).items()}
    got = popt.label_params(TwoStreamDetector(pspec, aux_mode="reference"),
                            groups)
    assert got == want
    pos = [k for k in got if k.endswith("pos_emb")]
    assert len(pos) == 4 and {got[k] for k in pos} == {
        "fixed": {"bn"}, "reference": {"frozen"}}[groups]
