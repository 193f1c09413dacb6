"""The PyTorch port's layers against the JAX package's, in float32.

Same numpy inputs, same weights (bridged with ``from_jax_variables``).
Both sides compute in f32 and differ only in the order of the
convolutions' sums: modules within 1e-5 of their output's range, the
resampling ops at rtol 1e-5 / atol 1e-5."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from mmidet_tpu.nn import layers as jl
from mmidet_tpu.nn import resize as jr
from mmidet_tpu.nn.cem import ContourEnhance as JaxCEM
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.nn import layers as tl
from mmidet_tpu_torch.nn import resize as tr
from mmidet_tpu_torch.nn.cem import ContourEnhance
from mmidet_tpu_torch.nn.fuse import fold_batchnorm

TOL = dict(rtol=1e-5, atol=1e-5)


class _Holder(nn.Module):
    """Puts one module at ``model.0`` (or ``Enhance``), where the bridge
    looks for the JAX top-level ``l0_*`` (``enhance``) scope."""

    def __init__(self, mod, cem=False):
        super().__init__()
        if cem:
            self.Enhance = mod
        else:
            self.model = nn.ModuleList([mod])


def _randomized(variables, seed=0):
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (np.asarray(v) + rng.normal(0, 0.1, v.shape)
                          ).astype(np.float32)
        return out
    return walk(jax.tree_util.tree_map(np.asarray, dict(variables)))


def _compare(jax_mod, port_mod, x, scope="l0_m", fold=False, seed=0):
    """Init the JAX module, randomise, bridge into the port module, and
    compare (NHWC on the JAX side, NCHW on the port side)."""
    v = _randomized(jax_mod.init(jax.random.PRNGKey(0), x), seed)
    cem = scope == "enhance"
    holder = _Holder(port_mod, cem)
    from_jax_variables(holder, {c: {scope: t} for c, t in v.items()})
    if fold:
        v = jax_fold(v)
        jax_mod = jax_mod.clone(fused=True)
        fold_batchnorm(holder)
    want = np.asarray(jax_mod.apply(v, x))
    with torch.no_grad():
        got = port_mod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    # f32 on both sides, sums in another order: the rounding error of a sum
    # scales with its terms, not with its result, so an element that
    # cancels to near 0 inside an output that reaches tens (the CEM's, 1.8e-5
    # at 0.09 where the output reaches 35) misses any per-element gate.
    # The gate is relative to the output's range.
    err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("fold", [False, True])
def test_conv_bn_act(fold):
    _compare(jl.ConvBnAct(16, 3, 2), tl.ConvBnAct(8, 16, 3, 2),
             _x((2, 16, 16, 8)), fold=fold)


@pytest.mark.parametrize("fold", [False, True])
def test_focus(fold):
    _compare(jl.Focus(16, 3), tl.Focus(3, 16, 3), _x((2, 16, 16, 3)),
             fold=fold)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c3(shortcut):
    _compare(jl.C3(16, 2, shortcut), tl.C3(16, 16, 2, shortcut),
             _x((2, 8, 8, 16)))


def test_c3_folded():
    _compare(jl.C3(16, 2), tl.C3(16, 16, 2), _x((2, 8, 8, 16)), fold=True)


def test_spp():
    _compare(jl.SPP(32), tl.SPP(32, 32), _x((2, 8, 8, 32)))


@pytest.mark.parametrize("fold", [False, True])
def test_contour_enhance(fold):
    _compare(JaxCEM(3), ContourEnhance(3), _x((2, 16, 16, 3)),
             scope="enhance", fold=fold)


@pytest.mark.parametrize("h", [160, 80, 40, 20])
def test_resize_ops(h):
    x = _x((2, h, h + 8, 4))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    pooled = tr.adaptive_avg_pool(xt, (8, 8))
    np.testing.assert_allclose(pooled.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jr.adaptive_avg_pool(x, (8, 8))),
                               **TOL)
    p = np.ascontiguousarray(pooled.permute(0, 2, 3, 1).numpy())
    up = tr.bilinear_resize(pooled, (h, h + 8))
    np.testing.assert_allclose(up.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jr.bilinear_resize(p, (h, h + 8))),
                               **TOL)
    np.testing.assert_array_equal(
        tr.nearest_upsample(xt, 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jr.nearest_upsample(x, 2)))
