"""The Fusion Focus Module of the PyTorch port against the JAX package in
f32: the frequency split, the separation loss, ``PatternFusion`` and
``FourierPatternFusion`` (outputs and pattern loss) on bridged weights, and
the named l-scale fourier spec against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.models import spec as jax_spec_mod
from mmidet_tpu.models import zoo as jax_zoo
from mmidet_tpu.nn import fusion as jf
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.models import spec as port_spec_mod
from mmidet_tpu_torch.models import zoo as port_zoo
from mmidet_tpu_torch.nn import fusion as pf

F32_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, sum order only


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# 8x8 is the pooled grid (the "highpass" zeroes exactly one element there);
# the others take the slice arithmetic's negative bounds and odd sizes
@pytest.mark.parametrize("hw", [(8, 8), (6, 10), (5, 7), (16, 4)])
def test_frequency_split_matches_jax(hw):
    assert all(np.array_equal(a, b) for a, b in
               zip(pf._freq_masks(*hw), jf._freq_masks(*hw)))
    rng = np.random.default_rng(hw[0])
    x = rng.normal(0, 1, (2, *hw, 5)).astype(np.float32)
    want_low, want_high = (np.asarray(t) for t in
                           jf.frequency_split(jnp.asarray(x)))
    low, high = pf.frequency_split(_nchw(x))
    assert low.dtype == high.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(low), want_low, **F32_TOL)
    np.testing.assert_allclose(_nhwc(high), want_high, **F32_TOL)


def test_frequency_split_keeps_the_input_dtype():
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    low, high = pf.frequency_split(x.to(torch.bfloat16))
    assert low.dtype == high.dtype == torch.bfloat16
    torch.testing.assert_close(low.float() + high.float(),
                               x.to(torch.bfloat16).float(), rtol=0.02,
                               atol=0.02)


@pytest.mark.parametrize("l,d", [(2, 3), (36, 64)])
def test_separation_loss_matches_jax_and_the_pair_loop(l, d):
    rng = np.random.default_rng(l)
    m = rng.uniform(0, 1, (l, d)).astype(np.float32)
    got = float(pf.separation_loss(torch.from_numpy(m)))
    np.testing.assert_allclose(got, float(jf.separation_loss(jnp.asarray(m))),
                               rtol=1e-5)
    loop = sum(float(m[i] @ m[j]) for i in range(l) for j in range(i + 1, l))
    np.testing.assert_allclose(got, loop / (l * (l - 1)), rtol=1e-4)


@pytest.fixture(scope="module", params=["GPT1", "GPT1_fourier"])
def pair(request):
    name = request.param
    jcls, pcls = {"GPT1": (jf.PatternFusion, pf.PatternFusion),
                  "GPT1_fourier": (jf.FourierPatternFusion,
                                   pf.FourierPatternFusion)}[name]
    d, b = 64, 3
    rng = np.random.default_rng(len(name))
    rgb = rng.normal(0, 1, (b, 20, 24, d)).astype(np.float32)
    ir = (rgb * 0.5 + rng.normal(0, 0.3, rgb.shape)).astype(np.float32)
    jm = jcls(d, n_layer=2)
    v = jm.init(jax.random.PRNGKey(0), rgb[:1], ir[:1])
    v = {"params": jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.2, a.shape).astype(np.float32),
        v["params"])}
    want = [np.asarray(t) for t in jm.apply(v, rgb, ir)]
    holder = torch.nn.Module()
    holder.model = torch.nn.ModuleList([pcls(d, n_layer=2)])
    used = from_jax_variables(holder, {"params": {f"l0_{name}": v["params"]}})
    return name, holder.model[0].eval(), used, rgb, ir, want


def test_gate_weights_land_on_the_reference_names(pair):
    name, _, used, *_ = pair
    assert used["model.0.conv1.weight"] == (
        "params", f"l0_{name}", "pattern", "conv1", "kernel")
    assert used["model.0.conv2.weight"] == (
        "params", f"l0_{name}", "pattern", "conv2", "kernel")


def test_pattern_fusion_f32_matches_jax(pair):
    """Outputs and the pattern loss (computed in eval mode too, with the
    fourier branch's ``[:b]`` row slice) against JAX's XLA f32 path."""
    _, mod, _, rgb, ir, want = pair
    with torch.no_grad():
        r, i, loss = mod(_nchw(rgb), _nchw(ir))
    np.testing.assert_allclose(_nhwc(r), want[0], **F32_TOL)
    np.testing.assert_allclose(_nhwc(i), want[1], **F32_TOL)
    assert loss.shape == ()
    np.testing.assert_allclose(float(loss), float(want[2]), rtol=1e-4)


def test_fourier_branch_changes_only_the_loss():
    torch.manual_seed(0)
    plain = pf.PatternFusion(64, n_layer=1).eval()
    fourier = pf.FourierPatternFusion(64, n_layer=1).eval()
    fourier.load_state_dict(plain.state_dict())
    gen = torch.Generator().manual_seed(1)
    rgb = torch.randn(2, 64, 12, 12, generator=gen)
    ir = torch.randn(2, 64, 12, 12, generator=gen)
    with torch.no_grad():
        a, b = plain(rgb, ir), fourier(rgb, ir)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert float(a[2]) != float(b[2])


def test_mask_rows_order_is_batch_major_then_channel():
    m = torch.arange(2 * 8 * 2 * 3, dtype=torch.float32).reshape(2, 8, 2, 3)
    want = np.asarray(jf._mask_rows(jnp.asarray(m.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_array_equal(pf._mask_rows(m).numpy(), want)


@pytest.mark.parametrize("name", ["yolov5l_fuse3_fourier", "yolov5s_gpt4"])
def test_named_spec_resolves_as_the_jax_package_does(name):
    """Same ``c_out``, ``n``, ``args``, routes, save set and strides; at l
    scale the C3 rows carry their depth (9) in ``args`` and the GPT1* width
    is not width-scaled."""
    ps, js = port_zoo.get_model_spec(name), jax_zoo.get_model_spec(name)
    assert (ps.nc, ps.anchors, ps.strides, ps.depth_multiple,
            ps.width_multiple, ps.fusion_layers) == (
        js.nc, js.anchors, js.strides, js.depth_multiple, js.width_multiple,
        js.fusion_layers)
    (pl, psave), (jl, jsave) = port_spec_mod.resolve(ps), jax_spec_mod.resolve(js)
    assert psave == jsave and len(pl) == len(jl)
    for a, b in zip(pl, jl):
        assert (a.index, a.f, a.name, a.n, a.args, a.c_out) == (
            b.index, b.f, b.name, b.n, b.args, b.c_out)
    if name == "yolov5l_fuse3_fourier":
        assert pl[6].name == "GPT1_fourier" and pl[6].args == (128,)
        assert pl[10].name == "C3" and pl[10].args[:2] == (256, 9)
        assert [pl[i].c_out for i in (6, 13, 20, 29)] == [128, 256, 512, 1024]


def test_get_model_spec_overrides_and_refuses():
    spec = port_zoo.get_model_spec("yolov5l_fuse3_fourier", nc=2)
    assert spec.nc == 2 and spec.no == 21
    assert port_zoo.get_model_spec("yolov5l_fuse3_fourier").nc == 6
    with pytest.raises(ValueError, match="not ported"):
        port_zoo.get_model_spec("yolov5m_add")
    with pytest.raises(ValueError, match="GPT1_fourier d_model"):
        port_spec_mod.resolve(port_zoo.get_model_spec("yolov5s_fuse3_fourier"))


def test_get_model_spec_override_keeps_every_other_field():
    base = port_zoo.get_model_spec("yolov5l_fuse3_fourier")
    anchors = [[1, 2, 3, 4, 5, 6]] * 3
    spec = port_zoo.get_model_spec("yolov5l_fuse3_fourier", nc=3,
                                   anchors=anchors)
    assert spec.anchors == tuple(tuple(a) for a in anchors)
    assert dataclasses.replace(spec, nc=base.nc, anchors=base.anchors) == base


@pytest.mark.parametrize("cls", [pf.PatternFusion, pf.FourierPatternFusion])
def test_without_loss_the_streams_are_the_same_and_the_loss_is_zero(cls):
    """``with_loss=False`` (the deploy detector's setting) skips only what
    feeds the pattern loss."""
    torch.manual_seed(0)
    full = cls(64, n_layer=1).eval()
    lean = cls(64, n_layer=1, with_loss=False).eval()
    lean.load_state_dict(full.state_dict())
    gen = torch.Generator().manual_seed(1)
    rgb = torch.randn(2, 64, 12, 12, generator=gen)
    ir = torch.randn(2, 64, 12, 12, generator=gen)
    with torch.no_grad():
        a, b = full(rgb, ir), lean(rgb, ir)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert float(a[2]) != 0.0 and float(b[2]) == 0.0 and b[2].shape == ()
