"""yolov5s_mamba against the JAX package on the CPU: its forward at 64 px,
each of its four MambaFusion levels, and its parameters' optimizer labels
(the mamba grammar's modules, steps and training are
``test_torch_port_mamba.py``'s)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu_torch.bridge import from_jax_variables, torch_key
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.train import optimizer as popt

from test_torch_port_train import _seeded, _threads  # noqa: F401
from test_torch_port_mamba import _close

F32_TOL = dict(rtol=1e-4, atol=1e-4)
LEVEL_TOL = 1e-4
MAMBA_LEVELS = (6, 13, 20, 29)  # the gpt4 grammar's fusion rows


@pytest.fixture(scope="module")
def s_mamba():
    """yolov5s_mamba at 64 px: JAX's seeded variables, its eval forward
    with the fusion rows' outputs captured, and the port with the same
    weights."""
    jmodel = JaxDetector(spec=jax_get_spec("yolov5s_mamba", nc=2),
                         aux_mode="off")
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(
        lambda k: jmodel.init({"params": k}, x, x, train=False),
        jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, _seeded(shapes, 0))
    rng = np.random.default_rng(0)
    rgb, ir = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(2))
    out, inter = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(v, rgb, ir)
    levels = {i: [np.asarray(t) for t in inter["intermediates"][
        f"l{i}_MambaFusion"]["__call__"][0]] for i in MAMBA_LEVELS}
    port = TwoStreamDetector(get_model_spec("yolov5s_mamba", nc=2))
    from_jax_variables(port, v)
    return v, port.eval(), rgb, ir, out, levels


def test_yolov5s_mamba_forward_matches_jax(s_mamba):
    _, port, rgb, ir, want, _ = s_mamba
    with torch.no_grad():
        out = port(torch.from_numpy(rgb), torch.from_numpy(ir))
    np.testing.assert_allclose(out["pred"].numpy(), np.asarray(want["pred"]),
                               **F32_TOL)
    for got, w in zip(out["train_outs"], want["train_outs"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("layer", MAMBA_LEVELS)
def test_yolov5s_mamba_fusion_levels_match_jax(s_mamba, layer):
    v, port, rgb, ir, _, levels = s_mamba
    port.truncate_at = layer
    try:
        with torch.no_grad():
            out = port(torch.from_numpy(rgb), torch.from_numpy(ir))["trunc"]
    finally:
        port.truncate_at = None
    for got, want in zip(out, levels[layer]):
        _close(got.numpy(), want, LEVEL_TOL)


@pytest.mark.parametrize("groups", ["fixed", "reference"])
def test_label_params_of_the_mamba_grammar_match_jax(groups, s_mamba):
    v = s_mamba[0]
    want = {torch_key(p)[0]: lab for p, lab in
            flax.traverse_util.flatten_dict(
                jopt.label_params(v["params"], groups)).items()}
    got = popt.label_params(s_mamba[1], groups)
    assert got == want
    mixer = "model.6.fwd.layers.0.mixer."
    assert {k: got[mixer + k] for k in (
        "conv1d_kernel", "conv1d_bias", "A_log", "D", "in_proj.weight",
        "dt_proj.bias")} == {
        "conv1d_kernel": "bn", "conv1d_bias": "bn", "A_log": "bn", "D": "bn",
        "in_proj.weight": "weight", "dt_proj.bias": "bias"}
    assert got["model.6.norm_f.weight"] == "bn"
