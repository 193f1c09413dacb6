"""Weight bridge: JAX variables -> the PyTorch port's state dict.

Every leaf of the JAX ``params`` and ``batch_stats`` of the tiny gpt4 model
maps to exactly one port key of the right shape, under the reference torch
name the JAX package's own checkpoint converter computes, and no port key is
left over.  BN running statistics are copied as stored: the n/(n-1)
difference between flax's and torch's ``running_var`` arises only in
train-mode updates (PARITY.md deviation #6), and training is not ported."""

import jax
import numpy as np
import pytest

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import two_stream_spec as jax_spec
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu.train.checkpoint import _torch_key, _transform
from mmidet_tpu_torch.bridge import (from_jax_variables, to_torch_layout,
                                     torch_key)
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_vars():
    model = JaxDetector(spec=jax_spec("t", "gpt4", fusion_layers=2),
                        aux_mode="off")
    z = np.zeros((1, 64, 64, 3), np.float32)
    v = jax.jit(lambda k: model.init({"params": k}, z, z, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # distinct values everywhere, so a leaf landing on the wrong key shows
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, dict(v)))


def _port(fused=False):
    return TwoStreamDetector(two_stream_spec("t", "gpt4", fusion_layers=2),
                             fused=fused)


def test_every_leaf_lands_once(jax_vars):
    port = _port()
    used = from_jax_variables(port, jax_vars)
    leaves = [(c, p) for c in ("params", "batch_stats")
              for p, _ in _flat(jax_vars[c])]
    assert len(used) == len(leaves)
    keys = {k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert set(used) == keys
    sd = port.state_dict()
    for coll in ("params", "batch_stats"):
        for path, arr in _flat(jax_vars[coll]):
            key, kind = torch_key(path)
            # the reference torch name, as the JAX package's converter has it
            assert key == _torch_key(path, coll)[0]
            np.testing.assert_array_equal(sd[key].numpy(),
                                          to_torch_layout(arr, kind))


def test_every_leaf_of_the_fourier_spec_lands_once():
    """The flagship grammar (l scale, the only one it exists at): the
    pattern gate's ``pattern/conv1/kernel`` and ``pattern/conv2/kernel``
    land on ``conv1.weight``/``conv2.weight``, the names the JAX package's
    converter computes.  Shapes come from ``jax.eval_shape`` (no init run),
    values from numpy."""
    kw = dict(scale="l", fusion="fourier", nc=2, fusion_layers=1)
    model = JaxDetector(spec=jax_spec(**kw), aux_mode="off")
    z = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k}, z, z, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
        dict(shapes))
    port = TwoStreamDetector(two_stream_spec(**kw))
    used = from_jax_variables(port, v)
    assert len(used) == len(jax.tree_util.tree_leaves(v))
    assert set(used) == {k for k in port.state_dict()
                         if not k.endswith("num_batches_tracked")}
    sd = port.state_dict()
    gate = v["params"]["l6_GPT1_fourier"]["pattern"]
    for conv in ("conv1", "conv2"):
        path = ("l6_GPT1_fourier", "pattern", conv, "kernel")
        key, kind = torch_key(path)
        assert key == f"model.6.{conv}.weight" == _torch_key(path,
                                                             "params")[0]
        np.testing.assert_array_equal(
            sd[key].numpy(), to_torch_layout(gate[conv]["kernel"], kind))
    for coll in ("params", "batch_stats"):
        for path, _ in _flat(v[coll]):
            assert torch_key(path)[0] == _torch_key(path, coll)[0]


def test_focus_and_sobel_layouts_round_trip(jax_vars):
    port = _port()
    from_jax_variables(port, jax_vars)
    sd = port.state_dict()
    s2d = jax_vars["params"]["l0_Focus"]["conv_kernel_s2d"]
    w = sd["model.0.conv.conv.weight"].numpy()
    assert w.shape == (s2d.shape[3], s2d.shape[2], s2d.shape[0],
                       s2d.shape[1])
    np.testing.assert_array_equal(_transform(w, "conv"), s2d)
    factor = jax_vars["params"]["enhance"]["sobel"]["sobel_factor"]
    f = sd["Enhance.sobel.sobel_factor"].numpy()
    assert f.shape == (factor.shape[0], 1, 1, 1)
    np.testing.assert_array_equal(_transform(f, "factor"), factor)


def test_bn_running_stats_copied_as_stored(jax_vars):
    port = _port()
    from_jax_variables(port, jax_vars)
    bn = port.model[1].bn
    st = jax_vars["batch_stats"]["l1_Conv"]["bn"]
    np.testing.assert_array_equal(bn.running_var.numpy(), st["var"])
    np.testing.assert_array_equal(bn.running_mean.numpy(), st["mean"])


def test_folded_variables_bridge_into_fused_model(jax_vars):
    """JAX fold_batchnorm output (Focus ``conv_bias`` included) fills a
    ``fused=True`` port model completely."""
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(jax_vars))
    port = _port(fused=True)
    used = from_jax_variables(port, folded)
    assert "model.0.conv.conv.bias" in used
    assert not any(k.endswith(("running_var", "running_mean"))
                   for k in port.state_dict())


def test_missing_extra_and_misshapen_leaves_raise(jax_vars):
    params = dict(jax_vars["params"])
    missing = {**jax_vars, "params": {k: v for k, v in params.items()
                                      if k != "l1_Conv"}}
    with pytest.raises(KeyError, match="received no variable"):
        from_jax_variables(_port(), missing)
    extra = {**jax_vars, "params": {**params, "l1_Conv": {
        **params["l1_Conv"], "stray": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="no such key"):
        from_jax_variables(_port(), extra)
    bad = {**jax_vars, "params": {**params, "l1_Conv": {
        **params["l1_Conv"], "conv": {"kernel": np.zeros(
            (1, 1, 1, 1), np.float32)}}}}
    with pytest.raises(ValueError, match="shape mismatch"):
        from_jax_variables(_port(), bad)
