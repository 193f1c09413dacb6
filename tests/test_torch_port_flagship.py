"""The flagship grammar (GPT1_fourier at P2, GPT at P3/P4/P5, l scale) of
the PyTorch port against the JAX package end to end at 64x64 with two
fusion layers: the unfused f32 pair, and the deploy pair with every kernel
flag on (JAX: the four Pallas flags on BN-folded variables, interpret mode;
port: ``kernel_cem`` and ``kernel_merge`` on bridged weights, BN folded by
the port, the kernels' plain versions on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import two_stream_spec as jax_spec
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
from mmidet_tpu_torch.nn.fuse import fold_batchnorm

from test_torch_port_train import _threads  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, sum order only
# deploy pair: the merge kernel rounds the streams to bf16 at four levels on
# both sides, at the same points; a flipped rounding moves an activation by
# 2^-8 relative and the decode (wh = (2 sigmoid)^2 x anchor) amplifies it;
# held per channel against its range (_check_range)
DEPLOY_TOL = 2e-2
SPEC_ARGS = dict(scale="l", fusion="fourier", nc=2, fusion_layers=2)


def _seeded_variables(model, rgb, ir, rng):
    """Variables of the JAX model without running its init: shapes from
    ``jax.eval_shape``, values from numpy (kernels N(0, 1/fan-in), which
    keeps activations of order 1 through all 50 layers; BN near the
    identity with variances in U(0.5, 1.5); LN, bias and pos-emb N(0, 0.1)
    around their defaults), so that every leaf is distinct."""
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k}, rgb[:1], ir[:1], train=False),
        jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "conv_kernel_s2d"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.normal(0, np.sqrt(1.0 / fan_in), leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("scale", "sobel_factor"):
            v = 1.0 + rng.normal(0, 0.1, leaf.shape)
        else:  # bias, mean, pos_emb
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def ref():
    spec = jax_spec(**SPEC_ARGS)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    plain = JaxDetector(spec=spec, aux_mode="off")
    v = _seeded_variables(plain, rgb, ir, rng)
    out = jax.jit(lambda v, a, b: plain.apply(v, a, b, train=False))(
        v, rgb, ir)
    deploy = JaxDetector(spec=spec, aux_mode="off", fused=True,
                         pallas_fusion=True, pallas_cem=True,
                         merge_fusion_kernel=True)
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(v))
    dout = jax.jit(lambda v, a, b: deploy.apply(v, a, b, train=False))(
        folded, rgb, ir)
    return {"v": v, "folded": folded, "rgb": rgb, "ir": ir, "plain": out,
            "deploy": dout}


def _run(model, ref):
    with torch.no_grad():
        return model(torch.from_numpy(ref["rgb"]), torch.from_numpy(ref["ir"]))


def _check(out, want, tol):
    np.testing.assert_allclose(out["pred"].numpy(), np.asarray(want["pred"]),
                               **tol)
    assert len(out["train_outs"]) == len(want["train_outs"]) == 3
    for got, w in zip(out["train_outs"], want["train_outs"]):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)


def _check_range(out, want, tol):
    """bf16 paths: per output channel (the last axis), max error within
    ``tol`` of that channel's range, or of 1 where the range is smaller.
    bf16 roundings flipped by another order of sums compound through the
    fusion layers and move large and small elements alike, so a per-element
    gate has too little margin; box coordinates reach hundreds where
    confidences stay below 1, so each channel keeps its own range."""
    pairs = [(out["pred"], want["pred"])]
    pairs += list(zip(out["train_outs"], want["train_outs"]))
    assert len(out["train_outs"]) == len(want["train_outs"]) == 3
    for got, w in pairs:
        w = np.asarray(w)
        assert tuple(got.shape) == w.shape
        err = np.abs(got.numpy() - w).reshape(-1, w.shape[-1]).max(0)
        top = np.abs(w).reshape(-1, w.shape[-1]).max(0)
        assert (err <= tol * np.maximum(top, 1.0)).all(), (err, top)


def test_every_leaf_of_the_fourier_model_lands_once(ref):
    port = TwoStreamDetector(two_stream_spec(**SPEC_ARGS))
    used = from_jax_variables(port, ref["v"])
    n_leaves = len(jax.tree_util.tree_leaves(ref["v"]))
    assert len(used) == n_leaves
    assert set(used) == {k for k in port.state_dict()
                         if not k.endswith("num_batches_tracked")}
    assert used["model.6.conv1.weight"][-3:] == ("pattern", "conv1", "kernel")
    # the BN-folded variables fill a fused port model completely too
    fused = TwoStreamDetector(two_stream_spec(**SPEC_ARGS), fused=True)
    assert len(from_jax_variables(fused, ref["folded"])) == len(
        jax.tree_util.tree_leaves(ref["folded"]))


def test_unfused_f32_matches_jax(ref):
    model = TwoStreamDetector(two_stream_spec(**SPEC_ARGS))
    from_jax_variables(model, ref["v"])
    _check(_run(model.eval(), ref), ref["plain"], F32_TOL)


def test_all_kernel_flags_match_jax_with_all_pallas_flags(ref):
    model = TwoStreamDetector(two_stream_spec(**SPEC_ARGS), kernel_cem=True,
                              kernel_merge=True)
    from_jax_variables(model, ref["v"])
    model = fold_batchnorm(model).eval()
    counts = (cem_cuda.fused_cem, fusion_cuda.fused_gpt_merge,
              transformer_cuda.fused_token_transformer)
    before = [f.launches for f in counts]
    out = _run(model, ref)
    assert [f.launches for f in counts] == before  # plain versions on the CPU
    _check_range(out, ref["deploy"], DEPLOY_TOL)


def test_add2_rows_become_selects_only_with_the_merge_kernel(ref):
    """With ``kernel_merge`` the eight Add2 rows pass the merged stream
    through; the fusion layer's output then IS the next stage's input."""
    base = TwoStreamDetector(two_stream_spec(**SPEC_ARGS), fused=True)
    from_jax_variables(base, ref["folded"])
    outs = {}
    for merge in (False, True):
        for layer in (6, 7):
            base.truncate_at = layer
            for m in base.modules():
                if hasattr(m, "merge_kernel"):
                    m.merge_kernel = merge
            outs[merge, layer] = _run(base.eval(), ref)["trunc"]
    torch.testing.assert_close(outs[True, 7], outs[True, 6][0], rtol=0,
                               atol=0)
    # unmerged: layer 7 = stream + fusion output; merged (bf16 inside) within
    # 2% of its range, K4's gate: the rounding moves small and large
    # elements alike, which a per-element gate held with less than 2x margin
    err = (outs[True, 7] - outs[False, 7]).abs().max()
    assert float(err) <= 0.02 * float(outs[False, 7].abs().max())
    assert float((outs[False, 7] - outs[False, 6][0]).abs().max()) > 0.1
