"""The port's s8-storage deploy (``nn/quant.py``, the ``quant`` flags of
``nn/layers.py`` and ``models/detector.py``, the bridge's ``quant``
collection, ``--int8`` of the val and detect CLIs) against the JAX
package's, on the CPU in f32.

Gates:
  * ``quantize`` bit for bit, exact .5 ties included (both round half to
    even); ``dequantize`` bit for bit in f32 and bf16;
  * ``calibrate_act_scales`` scale by scale within 2e-6 relative: each
    scale is an activation's absmax, which the two sides compute with f32
    sums in another order;
  * the quantized forward, JAX's calibrated scales carried across by the
    bridge.  A value whose x / s lands within rounding of a .5 takes the
    neighbouring int8 level on one side, and the flip travels downstream
    and grows: from one flip among the first layer's 16384 values, 7.6% of
    a P5 layer's values sat a level off, and after a fusion block some
    two.  So each quantized row is fed JAX's own input to it and must give
    JAX's levels within one level (one quantum) in at most 0.5% of its
    values (measured: 0.05% at most); end to end, the predictions' mean
    distance from JAX's stays within half the s8 mode's own mean error
    against the float deploy (measured: 0.0014 against 0.0053 on
    ``gpt4``, 1.1e-8 against 0.0031 on ``add``), and the Detect row fed
    JAX's int8 inputs gives JAX's predictions within rtol 1e-5, atol 1e-4
    (measured: 1.5e-5 at most, on values up to 387);
  * calibration leaves the state dict and the hooks as they were;
  * ``--int8`` of ``val`` calibrates on JAX's batch (its scales, as
    above) and runs; ``detect --int8``, each side calibrating itself on
    the first pair, writes JAX's label files: the same rows, boxes and
    confidences within 1e-3 (a level flip moves a prediction by a fraction
    of the mode's own error, above; these agree to the files' 6 digits).

JAX's calibration runs its own ``calibrate_act_scales`` and
``fold_batchnorm`` traced whole under ``jax.jit`` (eager flax takes about
20 s a model on the CPU)."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from mmidet_tpu.cli import detect as jax_detect
from mmidet_tpu.cli import val as jax_val
from mmidet_tpu.data.datasets import PairedDataset as JaxDataset
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.models.zoo import two_stream_spec as jax_spec
from mmidet_tpu.nn import quant as jq
from mmidet_tpu.nn.fuse import fold_batchnorm as jax_fold
from mmidet_tpu.train.checkpoint import (convert_torch_state_dict,
                                         load_torch_checkpoint)
from mmidet_tpu_torch.bridge import _flatten, from_jax_variables, torch_key
from mmidet_tpu_torch.cli import detect, val
from mmidet_tpu_torch.data.datasets import PairedDataset
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec, two_stream_spec
from mmidet_tpu_torch.nn import quant as pq
from mmidet_tpu_torch.nn.layers import ConvBnAct

from test_torch_port_detector import _randomized

SCALE_RTOL = 2e-6
ROW_SHARE = 5e-3
FILE_TOL = 1e-3
E2E_SHARE = 0.5
DETECT_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny models gain nothing from more intra-op threads; fewer keep this
    file from crowding the test workers that share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jitted_calibration(model, variables, batches, clip=1.0):
    """``mmidet_tpu.nn.quant.calibrate_act_scales`` on one batch, traced
    whole under ``jax.jit`` (eager flax compiles every op apart: about 20 s
    a model on the CPU)."""
    (rgb, ir), = batches
    return jax.jit(lambda v, a, b: _calibrate(model, v, [(a, b)], clip))(
        variables, rgb, ir)


_calibrate = jq.calibrate_act_scales


def _by_port_key(qcol) -> dict:
    """JAX's quant collection by the port's ``out_scale`` keys."""
    return {torch_key(p)[0]: float(a)
            for p, a in _flatten(jax.tree_util.tree_map(np.asarray,
                                                        qcol)).items()}


def test_quantize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    s = np.float32(0.25)
    # exact ties: x / s = k + 0.5 for k in -130..129 (the ends clamp)
    ties = ((np.arange(-130, 130) + 0.5) * s).astype(np.float32)
    x = np.concatenate([ties, rng.normal(0, 20, 4000).astype(np.float32),
                        np.float32([0.0, -0.0, 1e6, -1e6])])
    got = pq.quantize(torch.from_numpy(x), float(s))
    want = jq.quantize(x, s)
    assert got.v.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2
    half = pq.quantize(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5]), 1.0)
    assert half.v.tolist() == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax(dtype):
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    v = rng.integers(-127, 128, (3, 5, 7)).astype(np.int8)
    s = np.float32(0.0123)
    got = pq.dequantize(pq.QTensor(torch.from_numpy(v), torch.tensor(s)),
                        getattr(torch, dtype))
    want = jq.dequantize(jq.QTensor(jnp.asarray(v), jnp.asarray(s)),
                         getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    plain = torch.ones(2)
    assert pq.dequantize(plain) is plain
    pair = pq.deq_tree([pq.QTensor(torch.from_numpy(v), torch.tensor(s)),
                        plain], torch.float32)
    assert isinstance(pair, list) and pair[1] is plain


def _jax_variables(jmodel, sd, img: int = 64):
    """JAX variables from a port state dict through the JAX package's own
    converter (the template from ``eval_shape``: no init compile)."""
    z = jax.ShapeDtypeStruct((1, img, img, 3), np.float32)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda k, a, b: jmodel.init({"params": k}, a, b, train=False),
            jax.ShapeDtypeStruct((2,), np.uint32), z, z))
    return convert_torch_state_dict(dict(template), sd, strict=True)


@pytest.fixture(scope="module", params=["add", "gpt4"])
def case(request):
    """JAX's tiny two-stream model (perturbed, BN folded), its calibrated
    quant collection, its s8 predictions and its quantized activations
    (int8, by the port's module names)."""
    spec = jax_spec("t", request.param, nc=2, fusion_layers=1)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    torch.manual_seed(0)
    seeded = TwoStreamDetector(two_stream_spec("t", request.param, nc=2,
                                               fusion_layers=1))
    v = _jax_variables(JaxDetector(spec=spec, aux_mode="off"),
                       seeded.state_dict())
    folded = jax.tree_util.tree_map(np.asarray, jax.jit(jax_fold)(
        _randomized(v, rng)))
    f_model = JaxDetector(spec=spec, aux_mode="off", fused=True)
    q_model = JaxDetector(spec=spec, aux_mode="off", fused=True, quant=True)
    qcol = _jitted_calibration(f_model, folded, [(rgb, ir)])
    qvars = jq.quantized_variables(folded, qcol)
    out, inter = jax.jit(lambda v, a, b: q_model.apply(
        v, a, b, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(qvars, rgb, ir)
    rows = {}  # the module rows' outputs, by row index
    for name, t in inter["intermediates"].items():
        if "__call__" in t and name[0] == "l":
            rows[int(name[1:].split("_")[0])] = t["__call__"][0]
        elif name == "enhance":
            rows["cem"] = np.asarray(t["__call__"][0])
    return {"variant": request.param, "rgb": rgb, "ir": ir,
            "folded": folded, "qvars": qvars, "qcol": qcol,
            "q_pred": np.asarray(out["pred"]), "rows": rows}


def _port(case, **kw):
    model = TwoStreamDetector(two_stream_spec("t", case["variant"], nc=2,
                                              fusion_layers=1),
                              fused=True, **kw).eval()
    return model


def _inputs(case):
    return torch.from_numpy(case["rgb"]), torch.from_numpy(case["ir"])


def test_calibration_matches_jax_scale_by_scale(case):
    model = _port(case)
    from_jax_variables(model, case["folded"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = pq.calibrate_act_scales(model, [_inputs(case)])
    want = _by_port_key(case["qcol"])
    assert set(got) == set(want) and len(got) > 40
    for k, s in got.items():
        assert s.dtype == torch.float32 and s.shape == ()
        assert abs(float(s) - want[k]) <= SCALE_RTOL * want[k], k
    # the state dict and the hooks are as they were (JAX
    # test_calib_does_not_pollute_init)
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(m._forward_hooks for m in model.modules())
    # make_quant_deploy: the given model untouched, the copy quantized with
    # these scales
    q = pq.make_quant_deploy(model, [_inputs(case)])
    assert list(model.state_dict()) == list(before)
    qsd = q.state_dict()
    assert {k for k in qsd if k.endswith("out_scale")} == set(got)
    assert all(torch.equal(qsd[k], got[k]) for k in got)
    assert all(m.quant for m in q.modules() if isinstance(m, ConvBnAct))


def _nchw(t):
    """A JAX row output (NHWC array or QTensor) as the port takes it."""
    if isinstance(t, jq.QTensor):
        return pq.QTensor(torch.from_numpy(np.array(t.v)).permute(
            0, 3, 1, 2), torch.tensor(np.asarray(t.s)))
    return torch.from_numpy(np.array(t)).permute(0, 3, 1, 2)


def test_quantized_forward_matches_jax_in_quanta(case):
    model = _port(case, quant=True)
    from_jax_variables(model, case["qvars"])
    scales = {k: float(v) for k, v in model.state_dict().items()
              if k.endswith("out_scale")}
    assert scales == pytest.approx(_by_port_key(case["qcol"]), rel=0)
    # row by row, each quantized row fed JAX's input to it: JAX's int8
    # levels, up to ties inside the row
    jax_rows = case["rows"]
    fed = 0
    for rl, mod in zip(model.resolved, model.model):
        if rl.name not in ("Conv", "Focus", "C3", "SPP"):
            continue
        src = rl.index - 1 if rl.f == -1 else rl.f
        if rl.f == -4:
            x = torch.from_numpy(case["ir"]).permute(0, 3, 1, 2)
        elif rl.index == 0:
            x = _nchw(jax_rows["cem"])
        elif src in jax_rows and isinstance(jax_rows[src], jq.QTensor):
            x = _nchw(jax_rows[src])
        else:  # fed by a Concat, Add or Add2 row, which JAX does not capture
            continue
        with torch.no_grad():
            q = mod(x)
        assert isinstance(q, pq.QTensor) and q.v.dtype == torch.int8
        d = np.abs(q.v.permute(0, 2, 3, 1).numpy().astype(int)
                   - np.asarray(jax_rows[rl.index].v).astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= ROW_SHARE, rl.index
        fed += 1
    assert fed >= 10
    with torch.no_grad():
        pred = model(*_inputs(case))["pred"].numpy()
    # the float deploy forward: the port's, which sits within 1e-4 of JAX's
    # (test_torch_port_detector.py)
    float_model = _port(case)
    from_jax_variables(float_model, case["folded"])
    with torch.no_grad():
        f_pred = float_model(*_inputs(case))["pred"].numpy()
    own_error = np.abs(case["q_pred"] - f_pred).mean()
    assert own_error > 0  # the s8 mode does round
    # a forward that lost the quantization anywhere would sit at
    # own_error; the port sits at 0.26 of it on gpt4 and 4e-6 on add
    assert np.abs(pred - case["q_pred"]).mean() <= E2E_SHARE * own_error
    # the Detect row fed JAX's int8 inputs: dequantized on entry with their
    # own scales, it gives JAX's predictions to f32 rounding
    det = model.resolved[-1]
    inp = [_nchw(jax_rows[j]) for j in det.f]
    assert all(isinstance(t, pq.QTensor) for t in inp)
    with torch.no_grad():
        _, d_pred = model.model[-1](pq.deq_tree(inp, torch.float32))
    torch.testing.assert_close(d_pred, torch.from_numpy(case["q_pred"]),
                               **DETECT_TOL)
    # train mode ignores the flag, as in the JAX package
    model.train()
    with torch.no_grad():
        raw = model.model[0](torch.from_numpy(case["rgb"]).permute(0, 3, 1, 2))
    assert not isinstance(raw, pq.QTensor)


def test_quant_model_needs_its_scales(case):
    """The bridge carries the quant collection, and a quantized model
    without one refuses the variables (JAX
    test_quant_requires_calibration_collection)."""
    with pytest.raises(KeyError, match="received no variable"):
        from_jax_variables(_port(case, quant=True), case["folded"])


def test_scale_stays_f32_when_the_model_is_cast(case):
    model = _port(case, quant=True)
    from_jax_variables(model, case["qvars"])
    bf = model.to(torch.bfloat16)
    s = bf.model[0].conv.out_scale
    assert s.dtype == torch.float32
    assert float(s) == _by_port_key(case["qcol"])["model.0.conv.out_scale"]
    with torch.no_grad():
        pred = bf(*(t.bfloat16() for t in _inputs(case)))["pred"]
    assert pred.dtype == torch.bfloat16 and bool(torch.isfinite(pred).all())


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A synthetic paired set and a perturbed yolov5t_add state dict."""
    root = tmp_path_factory.mktemp("synth")
    data_yaml = make_synthetic_pair_dataset(str(root), n=4, img=96)
    torch.manual_seed(3)
    model = TwoStreamDetector(get_model_spec("yolov5t_add", nc=2))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    path = root / "model.pt"
    torch.save(model.state_dict(), path)
    return data_yaml, str(path)


def _jax_fast(monkeypatch):
    """JAX's calibration and BN folding jitted whole (see the module
    docstring)."""
    from mmidet_tpu.nn import fuse as jax_fuse
    monkeypatch.setattr(jq, "calibrate_act_scales", _jitted_calibration)
    monkeypatch.setattr(jax_fuse, "fold_batchnorm", jax.jit(jax_fold))


def test_val_int8_calibrates_as_jax(cli_data, monkeypatch):
    """The port's ``--int8`` calibration batch and scales against JAX's
    ``cli/val.py:_apply_int8`` on the same weights (JAX's variables from
    the same ``.pt`` through its converter), then the port's val CLI."""
    data_yaml, weights = cli_data
    d = yaml.safe_load(open(data_yaml))
    model, _ = val.load_model_and_vars("yolov5t_add", weights, 2,
                                       device="cpu")
    q = val.apply_int8(model, PairedDataset(d["val_rgb"], d["val_ir"], nc=2),
                       64, clip=0.9)
    got = {k: float(v) for k, v in q.state_dict().items()
           if k.endswith("out_scale")}
    jmodel = JaxDetector(spec=jax_get_spec("yolov5t_add", nc=2),
                         aux_mode="off")
    jvars = _jax_variables(jmodel, load_torch_checkpoint(weights))
    _jax_fast(monkeypatch)
    _, jq_vars = jax_val._apply_int8(
        jmodel, jvars, JaxDataset(d["val_rgb"], d["val_ir"], nc=2), 64,
        clip=0.9)
    want = _by_port_key(jq_vars["quant"])
    assert set(got) == set(want)
    for k, s in got.items():
        assert abs(s - want[k]) <= SCALE_RTOL * want[k], k
    res = val.main(["--cfg", "yolov5t_add", "--data", data_yaml,
                    "--weights", weights, "--batch-size", "4",
                    "--img-size", "64", "--int8"], device="cpu")
    assert 0.0 <= res.map50 <= 1.0 and res.speed_ms[0] > 0


def _labels(out_dir):
    rows = {}
    for f in sorted(os.listdir(out_dir)):
        if f.endswith(".txt"):
            r = np.loadtxt(os.path.join(out_dir, f), ndmin=2)
            rows[f] = r[np.lexsort(r.T[::-1])]
    return rows


def test_detect_int8_matches_jax(cli_data, tmp_path, monkeypatch):
    """JAX's detect CLI in f32 (its default is bf16), as the port's on the
    CPU, its variables from the same ``.pt`` through its converter."""
    data_yaml, weights = cli_data

    def jax_load(cfg, path, nc):
        jmodel = JaxDetector(spec=jax_get_spec(cfg, nc=nc), aux_mode="off")
        return jmodel, _jax_variables(jmodel, load_torch_checkpoint(path)), \
            jmodel.spec
    monkeypatch.setattr(jax_detect, "load_model_and_vars", jax_load)
    _jax_fast(monkeypatch)
    d = yaml.safe_load(open(data_yaml))
    common = ["--cfg", "yolov5t_add", "--weights", weights,
              "--source1", d["val_rgb"], "--source2", d["val_ir"],
              "--img-size", "64", "--nc", "2", "--conf-thres", "0.004",
              "--nosave", "--save-txt", "--save-conf", "--int8",
              "--int8-clip", "0.9", "--name", "exp"]
    ours = detect.main(common + ["--project", str(tmp_path / "port")],
                       device="cpu")
    jax_detect.main(common + ["--project", str(tmp_path / "jax")])
    got, want = _labels(ours), _labels(str(tmp_path / "jax" / "exp"))
    assert set(got) == set(want) and len(got) == 4
    assert sum(len(r) for r in got.values()) > 0
    for f in got:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=FILE_TOL)
