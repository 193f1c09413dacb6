"""The rest of the model zoo's layers in the PyTorch port against the JAX
package's, on the CPU in f32: every layer and activation ``nn/layers.py``
and ``nn/activations.py`` add, ``contract``/``expand``, ``fold_batchnorm``
where a BatchNorm has no single conv partner, ``sparsity`` and
``prune_variables``, ``summarize``, the CEM's composed tail, the s8 mode
of SPPF and DWConv, and one reference-format YAML with every new row
through both detectors, plain and BN-folded.

Tolerances: modules within 1e-5 of their output's range (f32 on both
sides, sums in another order: ``tests/test_torch_port_layers.py``); the
YAML model's predictions at rtol 1e-4, atol 1e-4 (the detectors' f32 gate,
``tests/test_torch_port_detector.py``); the s8 modules' int8 levels within
one level of JAX's in at most 0.5% of their values (a sum that lands
within rounding of a .5 takes the neighbouring level on one side:
``tests/test_torch_port_quant.py``'s row gate); pruning bit for bit."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.models import spec as jspec
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.summary import summarize as jax_summarize
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.nn import activations as ja
from mmidet_tpu.nn import cem as jcem
from mmidet_tpu.nn import layers as jl
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu.nn.fuse import prune_variables as jax_prune
from mmidet_tpu.nn.fuse import sparsity as jax_sparsity
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu_torch.bridge import from_jax_variables, torch_key
from mmidet_tpu_torch.models import spec as pspec
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.summary import summarize
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.nn import activations as pa
from mmidet_tpu_torch.nn import cem as pcem
from mmidet_tpu_torch.nn import layers as tl
from mmidet_tpu_torch.nn.fuse import (fold_batchnorm, prune_variables,
                                      sparsity)
from mmidet_tpu_torch.train import optimizer as popt

from test_torch_port_layers import _Holder, _x
from test_torch_port_train import _seeded, _threads  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=1e-4)
LEVEL_SHARE = 5e-3


def _vars(jmod, *args):
    """Variables of JAX's init shapes (``eval_shape``: a traced init costs
    seconds a module on the CPU), drawn by ``test_torch_port_train``'s
    ``_seeded``: kernels N(0, 1/fan-in), BN variances U(0.5, 1.5), scales
    1 + N(0, 0.1), the rest N(0, 0.1)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, _seeded(shapes, 0))


def _at_l0(v: dict) -> dict:
    return {c: {"l0_m": t} for c, t in v.items()}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the output's range (f32 sums in another order)."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _compare(jmod, pmod, x, fold=False):
    """Bridge JAX's variables into the port module (BN folded by each side
    itself with ``fold``) and compare the NHWC outputs."""
    v = _vars(jmod, x)
    holder = _Holder(pmod)
    from_jax_variables(holder, _at_l0(v))
    if fold:
        v, jmod = jax_fold(v), jmod.clone(fused=True)
        fold_batchnorm(holder)
    want = jax.jit(jmod.apply)(v, x)
    with torch.no_grad():
        got = pmod.eval()(_nchw(x))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


# (JAX module, port module, input NHWC shape, whether both fold)
LAYERS = {
    "DWConv": (lambda: jl.DWConv(16, 3, 2), lambda: tl.DWConv(8, 16, 3, 2),
               (2, 16, 16, 8), True),
    "C3TR": (lambda: jl.C3TR(16, 2), lambda: tl.C3TR(16, 16, 2),
             (2, 8, 8, 16), True),
    "BottleneckCSP": (lambda: jl.BottleneckCSP(16, 2),
                      lambda: tl.BottleneckCSP(16, 16, 2), (2, 8, 8, 16),
                      True),
    "BottleneckCSP_noshortcut": (
        lambda: jl.BottleneckCSP(16, 1, False),
        lambda: tl.BottleneckCSP(8, 16, 1, False), (2, 8, 8, 8), False),
    "SPPF": (lambda: jl.SPPF(32), lambda: tl.SPPF(32, 32), (2, 8, 8, 32),
             True),
    "CrossConv": (lambda: jl.CrossConv(16, 3, 1, 1, 1.0, True),
                  lambda: tl.CrossConv(16, 16, 3, 1, 1, 1.0, True),
                  (2, 8, 8, 16), False),
    "CrossConv_s2": (lambda: jl.CrossConv(16, 3, 2, 2, 0.5),
                     lambda: tl.CrossConv(8, 16, 3, 2, 2, 0.5),
                     (2, 8, 8, 8), False),
    "GhostConv": (lambda: jl.GhostConv(16, 3, 2),
                  lambda: tl.GhostConv(8, 16, 3, 2), (2, 16, 16, 8), True),
    "GhostBottleneck": (lambda: jl.GhostBottleneck(16, 3, 1),
                        lambda: tl.GhostBottleneck(16, 16, 3, 1),
                        (2, 8, 8, 16), True),
    "GhostBottleneck_s2": (lambda: jl.GhostBottleneck(32, 3, 2),
                           lambda: tl.GhostBottleneck(16, 32, 3, 2),
                           (2, 8, 8, 16), True),
    "MixConv2d": (lambda: jl.MixConv2d(16, (1, 3, 5)),
                  lambda: tl.MixConv2d(16, 16, (1, 3, 5)), (2, 8, 8, 16),
                  False),
    "FReLU": (lambda: ja.FReLU(16), lambda: pa.FReLU(16), (2, 8, 8, 16),
              False),
    "AconC": (lambda: ja.AconC(16), lambda: pa.AconC(16), (2, 8, 8, 16),
              False),
    "MetaAconC": (lambda: ja.MetaAconC(16), lambda: pa.MetaAconC(16),
                  (2, 8, 8, 16), False),
}


@pytest.mark.parametrize("name,fold", [(n, False) for n in LAYERS] + [
    (n, True) for n, case in LAYERS.items() if case[3]])
def test_layer_matches_jax(name, fold):
    """Folded too where the JAX package has the module's fused form; the
    others keep their BatchNorms (``test_unpaired_batchnorms_stay_after_
    the_fold``)."""
    jmod, pmod, shape, _ = LAYERS[name]
    _compare(jmod(), pmod(), _x(shape), fold=fold)


def test_c3tr_attention_bridges_onto_four_linears():
    v = _vars(jl.C3TR(16, 1), _x((2, 8, 8, 16)))
    used = from_jax_variables(_Holder(tl.C3TR(16, 16, 1)), _at_l0(v))
    ma = "model.0.m.tr.0.ma."
    assert used[ma + "query.weight"][-3:] == ("ma", "query", "kernel")
    assert used[ma + "out.bias"][-3:] == ("ma", "out", "bias")
    assert used["model.0.m.linear.bias"][-2:] == ("linear", "bias")


@pytest.mark.parametrize("many", [False, True])
def test_classify_matches_jax(many):
    xs = [_x((2, 8, 8, 16)), _x((2, 4, 4, 8), 2)]
    x = xs if many else xs[0]
    jmod = jl.Classify(10, 3)
    v = _vars(jmod, x)
    pmod = tl.Classify(24 if many else 16, 10, 3)
    from_jax_variables(_Holder(pmod), _at_l0(v))
    with torch.no_grad():
        got = pmod([_nchw(a) for a in xs] if many else _nchw(x)).numpy()
    assert got.shape == (2, 10)
    _close(got, jax.jit(jmod.apply)(v, x))


@pytest.mark.parametrize("weighted", [False, True])
def test_sum_matches_jax(weighted):
    xs = [_x((2, 4, 4, 3), s) for s in range(3)]
    jmod = jl.Sum(3, weighted)
    pmod = tl.Sum(3, weighted)
    v = _vars(jmod, xs)
    if weighted:
        from_jax_variables(_Holder(pmod), _at_l0(v))
    with torch.no_grad():
        got = pmod([_nchw(a) for a in xs])
    _close(got.permute(0, 2, 3, 1).numpy(), jmod.apply(v, xs), 1e-6)


@pytest.mark.parametrize("gain", [2, 4])
def test_contract_and_expand_order_match_jax(gain):
    x = _x((2, 8, 16, 16 * gain))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    c = tl.contract(xt, gain)
    np.testing.assert_array_equal(c.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jl.contract(x, gain)))
    e = tl.expand(xt, gain)
    np.testing.assert_array_equal(e.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jl.expand(x, gain)))
    assert torch.equal(tl.expand(c, gain), xt)
    # the reference's channel index: (sh * s + sw) * C + c
    assert torch.equal(c[:, (1 * gain + 0) * xt.shape[1] + 3],
                       xt[:, 3, 1::gain, 0::gain])


@pytest.mark.parametrize("name", ["BottleneckCSP", "MixConv2d", "CrossConv"])
def test_unpaired_batchnorms_stay_after_the_fold(name):
    """JAX's ``fold_batchnorm`` leaves BottleneckCSP's ``bn`` over the
    concat, MixConv2d's ``bn`` and CrossConv's ``cv1_bn``/``cv2_bn`` with
    their ``batch_stats``; the port's fold leaves the same BatchNorms, and
    the port's deploy build takes JAX's folded variables, those stats
    included, through the bridge."""
    jmod, pmod, shape, _ = LAYERS[name]
    jm_, x = jmod(), _x(shape)
    v = _vars(jm_, x)
    folded = jax_fold(v)
    kept = {
        "BottleneckCSP": {"bn"}, "MixConv2d": {"bn"},
        "CrossConv": {"cv1_bn", "cv2_bn"}}[name]
    assert set(folded["batch_stats"]) == kept
    jfused = jm_.clone(fused=True) if name == "BottleneckCSP" else jm_
    want = jax.jit(jfused.apply)(folded, x)
    port = pmod()
    from_jax_variables(_Holder(port), _at_l0(v))
    fold_batchnorm(port)
    bns = {n for n, m in port.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    assert bns == {k.replace("_", ".") for k in kept}
    deploy = tl.BottleneckCSP(16, 16, 2, fused=True) \
        if name == "BottleneckCSP" else pmod()
    from_jax_variables(_Holder(deploy), _at_l0(folded))
    with torch.no_grad():
        for mod in (port.eval(), deploy.eval()):
            _close(mod(_nchw(x)).permute(0, 2, 3, 1).numpy(), want)


# --------------------------------------------------- the reference YAML

def _yaml():
    """A single-stream reference-format YAML with every row the JAX
    detector takes beyond the named grammars: ZeroPad2d + MaxPool2d (hub
    yolov3-tiny.yaml), a repeated Bottleneck row (hub yolov3.yaml), C3TR
    (hub yolov5s-transformer.yaml), SPPF, BottleneckCSP, Ghost, Mix,
    Cross and depthwise convs, Contract, Expand, a bilinear Upsample."""
    return {
        "nc": 2, "depth_multiple": 1.0, "width_multiple": 0.25,
        "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
        "backbone": [
            [-1, 1, "Conv", [32, 3, 2]],                  # 0  /2
            [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],      # 1
            [-1, 1, "nn.MaxPool2d", [2, 1, 0]],           # 2
            [-1, 1, "GhostBottleneck", [64, 3, 2]],       # 3  /4
            [-1, 2, "Bottleneck", [64]],                  # 4  repeated
            [-1, 1, "BottleneckCSP", [64, 1]],            # 5
            [-1, 1, "MixConv2d", [64, [1, 3]]],           # 6
            [-1, 1, "CrossConv", [64, 3, 1]],             # 7
            [-1, 1, "GhostConv", [64, 3, 1]],             # 8
            [-1, 1, "Contract", [2]],                     # 9  /8
            [-1, 1, "Conv", [128, 1, 1]],                 # 10
            [-1, 1, "C3TR", [128]],                       # 11
            [-1, 1, "SPPF", [128, 5]],                    # 12
            [-1, 1, "DWConv", [128, 3, 2]],               # 13 /16
        ],
        "head": [
            [-1, 1, "nn.Upsample", [None, 2, "bilinear"]],  # 14 /8
            [[-1, 12], 1, "Concat", [1]],                 # 15
            [-1, 1, "Conv", [64, 1, 1]],                  # 16
            [-1, 1, "Expand", [2]],                       # 17 /4
            [-1, 1, "Conv", [64, 3, 2]],                  # 18 /8
            [[18, 13], 1, "Detect", ["nc", "anchors"]],   # 19
        ],
    }


@pytest.fixture(scope="module")
def yaml_pair():
    js = jspec.load_yolo_yaml(_yaml())
    ps = pspec.load_yolo_yaml(_yaml())
    jmodel = JaxDetector(spec=js, use_cem=False, aux_mode="off")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, _seeded(jax.eval_shape(
        lambda k: jmodel.init({"params": k}, x[:1], None, train=False),
        jax.random.PRNGKey(0)), 0))
    return js, ps, jmodel, v, x


def test_yaml_spec_loads_as_the_jax_package(yaml_pair):
    js, ps = yaml_pair[:2]
    assert dataclasses.astuple(ps) == dataclasses.astuple(js)
    assert ps.strides == (8, 16)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3",
                                  "yolov5s-transformer"])
def test_chip_smoke_yaml_models_load_as_the_jax_package(name):
    """The YAML text ``chip_smoke.py``'s ``yaml_path`` drives: the same
    rows, channels and inferred strides as the JAX package reads."""
    import importlib.util
    from pathlib import Path

    import yaml
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    loader = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(cs)
    d = yaml.safe_load(cs.YAML_MODELS[name])
    ps = cs.yaml_spec(name)
    assert dataclasses.astuple(ps) == dataclasses.astuple(
        jspec.load_yolo_yaml(d))
    assert pspec.resolve(ps)[0] == [
        pspec.ResolvedLayer(**dataclasses.asdict(r))
        for r in jspec.resolve(jspec.load_yolo_yaml(d))[0]]


@pytest.mark.parametrize("fold", [False, True])
def test_yaml_model_matches_jax(yaml_pair, fold):
    js, ps, jmodel, v, x = yaml_pair
    port = TwoStreamDetector(ps, use_cem=False)
    used = from_jax_variables(port, v)
    assert used["model.4.1.cv2.conv.weight"][:2] == ("params",
                                                     "l4_Bottleneck_r1")
    assert used["model.4.0.cv1.bn.running_var"][:2] == ("batch_stats",
                                                        "l4_Bottleneck")
    if fold:
        v = jax.tree_util.tree_map(np.asarray, jax_fold(v))
        jmodel = jmodel.clone(fused=True)
        fold_batchnorm(port)
        # the deploy build takes JAX's folded variables (unfolded BNs
        # included) as they are
        deploy = TwoStreamDetector(ps, use_cem=False, fused=True)
        from_jax_variables(deploy, v)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, None, train=False))(v, x)
    with torch.no_grad():
        for model in [port] + ([deploy] if fold else []):
            out = model.eval()(torch.from_numpy(x))
            np.testing.assert_allclose(out["pred"].numpy(),
                                       np.asarray(want["pred"]), **F32_TOL)
            for got, w in zip(out["train_outs"], want["train_outs"]):
                np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                           **F32_TOL)


@pytest.mark.parametrize("groups", ["fixed", "reference"])
def test_label_params_of_the_yaml_model_match_jax(yaml_pair, groups):
    """C3TR's Dense and attention kernels in ``weight``, their biases in
    ``bias``; the unpaired BNs' scales in ``weight``, as JAX labels a BN
    scale outside a ``BatchNorm*`` scope."""
    _, ps, _, v, _ = yaml_pair
    want = {torch_key(p, frozenset({4}))[0]: lab for p, lab in
            flax.traverse_util.flatten_dict(
                jopt.label_params(v["params"], groups)).items()}
    got = popt.label_params(TwoStreamDetector(ps, use_cem=False), groups)
    assert got == want
    assert got["model.11.m.tr.0.ma.query.weight"] == "weight"
    assert got["model.11.m.tr.0.ma.query.bias"] == "bias"
    assert got["model.5.bn.weight"] == "weight"


def test_sparsity_and_pruning_match_jax(yaml_pair):
    _, ps, _, v, _ = yaml_pair
    port = TwoStreamDetector(ps, use_cem=False)
    from_jax_variables(port, v)
    sd = port.state_dict()
    assert sparsity(sd) == jax_sparsity(v) == 0.0
    pruned = prune_variables(sd, 0.3)
    jpruned = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v: jax_prune(v, 0.3))(v))
    want = TwoStreamDetector(ps, use_cem=False)
    from_jax_variables(want, jpruned)
    for k, t in want.state_dict().items():
        assert torch.equal(pruned[k], t), k
    assert abs(sparsity(pruned) - jax_sparsity(jpruned)) < 1e-9
    assert 0.29 < sparsity(pruned) < 0.31
    assert prune_variables(sd, 0.0)["model.0.conv.weight"] is \
        sd["model.0.conv.weight"]


@pytest.mark.parametrize("which", ["yaml", "yolov5s_mamba"])
def test_summarize_matches_jax(yaml_pair, which):
    if which == "yaml":
        js, ps = yaml_pair[:2]
        params = yaml_pair[3]["params"]
        port = TwoStreamDetector(ps, use_cem=False)
    else:
        js, ps = jax_get_spec(which), get_model_spec(which)
        x = jnp.zeros((1, 64, 64, 3))
        params = jax.eval_shape(lambda k: JaxDetector(spec=js).init(
            {"params": k}, x, x, train=False), jax.random.PRNGKey(0))[
                "params"]
        with torch.device("meta"):
            port = TwoStreamDetector(ps)
    for kw in ({}, {"flops": 1.25e10}):
        assert summarize(ps, 320, params=port, **kw) == jax_summarize(
            js, 320, params=params, **kw)
    assert summarize(ps) == jax_summarize(js)


# ------------------------------------------------------ the CEM's tail

def _tail_params(seed=0, c2=24, co=3):
    rng = np.random.default_rng(seed)
    return {"factor": rng.normal(1, 0.3, c2).astype(np.float32),
            "bias_s": rng.normal(0, 0.2, c2).astype(np.float32),
            "w3": rng.normal(0, 0.2, (3, 3, c2, co)).astype(np.float32),
            "b3": rng.normal(0, 0.2, co).astype(np.float32)}


def _port_tail(p):
    return (torch.from_numpy(p["factor"]), torch.from_numpy(p["bias_s"]),
            torch.from_numpy(p["w3"]).permute(3, 2, 0, 1),
            torch.from_numpy(p["b3"]))


@pytest.mark.parametrize("shape", [(2, 12, 16), (1, 5, 7)])
def test_tail_composed_matches_jax(shape):
    p = _tail_params()
    k, b = pcem.compose_tail_kernel(*_port_tail(p))
    jk, jb = jcem.compose_tail_kernel(p["factor"], p["bias_s"], p["w3"],
                                      p["b3"])
    np.testing.assert_allclose(k.permute(2, 3, 1, 0).numpy(), np.asarray(jk),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    y = np.abs(_x((shape[0], shape[1], shape[2], 24)))
    yt = torch.from_numpy(y).permute(0, 3, 1, 2)
    got = pcem.tail_composed(yt, *_port_tail(p))
    want = np.asarray(jcem.tail_composed(y, p["factor"], p["bias_s"],
                                         p["w3"], p["b3"]))
    plain = pcem._tail_reference(yt, *_port_tail(p))
    for z in (got, plain):
        err = np.abs(z.permute(0, 2, 3, 1).numpy() - want).max()
        assert err <= 1e-5 * max(1, np.abs(want).max()), err


def test_contour_enhance_compose_tail_matches_jax():
    x = _x((2, 16, 16, 3))
    jmod = jcem.ContourEnhance(3)
    v = _vars(jmod, x)
    folded = jax_fold(v)
    want = np.asarray(jax.jit(jmod.clone(fused=True, compose_tail=True)
                              .apply)(folded, x))
    port = pcem.ContourEnhance(3, compose_tail=True)
    holder = _Holder(port, cem=True)
    from_jax_variables(holder, {c: {"enhance": t} for c, t in v.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        unfolded = port.eval()(xt)   # BN unfolded: the plain tail
        fold_batchnorm(holder)
        got = port(xt)
        port.compose_tail = False
        plain = port(xt)
    for z in (got, plain, unfolded):
        err = np.abs(z.permute(0, 2, 3, 1).numpy() - want).max()
        assert err <= 1e-5 * max(1, np.abs(want).max()), err
    assert not torch.equal(got, plain)


# ------------------------------------------------------------ s8 mode

@pytest.mark.parametrize("name", ["SPPF", "DWConv"])
def test_s8_mode_matches_jax(name):
    """The fused, quantized module on the same input and scales: JAX's
    int8 levels within one level in at most 0.5% of the values."""
    jmod, pmod = {
        "SPPF": (jl.SPPF(32, fused=True, quant=True),
                 tl.SPPF(32, 32, fused=True, quant=True)),
        "DWConv": (jl.DWConv(32, 3, 2, fused=True, quant=True),
                   tl.DWConv(16, 32, 3, 2, fused=True, quant=True)),
    }[name]
    x = _x((2, 16, 16, 32 if name == "SPPF" else 16))
    v = _vars(jmod, x)
    v["quant"] = jax.tree_util.tree_map(lambda a: np.float32(0.02),
                                        v["quant"])
    from_jax_variables(_Holder(pmod), _at_l0(v))
    want = jax.jit(jmod.apply)(v, x)
    with torch.no_grad():
        got = pmod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.v.dtype == torch.int8 and float(got.s) == float(want.s)
    levels = got.v.permute(0, 2, 3, 1).numpy().astype(int)
    diff = np.abs(levels - np.asarray(want.v).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= LEVEL_SHARE
    assert np.abs(levels).max() > 20   # the scale resolves the values


def test_s8_deploy_of_the_yaml_model_quantizes_the_jax_rows(yaml_pair):
    """``make_quant_deploy`` quantizes the convolutions the JAX package
    does (its ``quant`` collection: the Conv, Bottleneck, SPPF and DWConv
    rows), not GhostConv's, BottleneckCSP's, C3TR's or GhostBottleneck's,
    and the s8 model runs."""
    from mmidet_tpu_torch.nn.quant import make_quant_deploy
    js, ps, _, v, x = yaml_pair
    jq = JaxDetector(spec=js, use_cem=False, aux_mode="off", fused=True,
                     quant=True)
    shapes = jax.eval_shape(lambda k: jq.init({"params": k}, x[:1], None,
                                              train=False),
                            jax.random.PRNGKey(0))
    want = {torch_key(p, frozenset({4}))[0] for p in
            flax.traverse_util.flatten_dict(shapes["quant"])}
    port = TwoStreamDetector(ps, use_cem=False)
    from_jax_variables(port, v)
    q = make_quant_deploy(port, [(torch.from_numpy(x), None)])
    got = {k for k in q.state_dict() if k.endswith("out_scale")}
    assert got == want and any(k.startswith("model.13.") for k in got)
    with torch.no_grad():
        out = q(torch.from_numpy(x))["pred"]
        ref = fold_batchnorm(port).eval()(torch.from_numpy(x))["pred"]
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().mean()) < 0.05 * float(ref.abs().mean())
