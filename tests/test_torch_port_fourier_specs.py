"""The fourier grammar's named specs and ``get_model_spec``'s overrides
against the JAX package's, and the pattern-fusion modules without their
loss (the modules with it are ``test_torch_port_fourier.py``'s)."""

import dataclasses

import pytest
import torch

from mmidet_tpu.models import spec as jax_spec_mod
from mmidet_tpu.models import zoo as jax_zoo
from mmidet_tpu_torch.models import spec as port_spec_mod
from mmidet_tpu_torch.models import zoo as port_zoo
from mmidet_tpu_torch.nn import fusion as pf

from test_torch_port_train import _threads  # noqa: F401


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
    # the mamba family builds now; an unknown fusion still raises
    mamba = port_zoo.get_model_spec("yolov5m_mamba")
    assert [l.name for l in mamba.layers].count("MambaFusion") == 4
    with pytest.raises(ValueError, match="unknown fusion"):
        port_zoo.two_stream_spec("m", "nosuch")
    with pytest.raises(KeyError):
        port_zoo.get_model_spec("yolov5m_nosuch")
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
