"""The port's user tools (``mmidet_tpu_torch/tools/split_dataset.py``,
``log_dataset.py``, ``resume_all.py``, ``s8_gate.py``) against the JAX
package's ``tools/`` on the CPU.

Gates:
  * ``create_split``: the same tree, byte for byte, from two copies of one
    seeded M3FD-style layout;
  * ``log_dataset``: the same ``_wandb.yaml`` keys and artifact paths,
    each side with its own store;
  * ``find_interrupted``: a runs tree in the JAX layout (orbax step
    folders) and the same runs in the port's (``ckpt/epoch<N>.pt``) give
    the same ``(workdir, epochs, last_epoch)``; the port names a JAX run
    and skips it;
  * ``s8_gate.gate_record``: JAX's float and int8 mAP50 within 1e-6 on the
    same variables.  A seeded init scores every box at the Detect prior
    (no ranking) and matches no synthetic label, so the weights are first
    conditioned (unit activation spread, as ``chip_smoke.py``'s
    ``condition``) and the val labels are the float model's own five best
    detections an image, which both sides then score at a non-trivial
    mAP50.  Both calibrate on the same batch, the gate loader's first, so
    both quantize with the same scales.

No test trains more than two steps; the gate's convergence run is
``chip_smoke.py``'s ``s8_gate_path`` on the card."""

import filecmp
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from mmidet_tpu.data.datasets import PairedDataset as JaxDataset
from mmidet_tpu.data.loader import RectLoader as JaxRectLoader
from mmidet_tpu.eval.evaluator import evaluate as jax_evaluate
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.nn import quant as jq
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.eval.evaluator import evaluate
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.nn.layers import BatchNorm2d
from mmidet_tpu_torch.tools import (log_dataset, resume_all, s8_gate,
                                    split_dataset)
from mmidet_tpu_torch.train.trainer import TrainConfig

from test_torch_port_quant import _jax_fast, _jax_variables
from test_torch_port_train import _threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools import log_dataset as jax_log_dataset  # noqa: E402
from tools import resume_all as jax_resume_all  # noqa: E402
from tools.split_dataset import create_split as jax_create_split  # noqa: E402

MAP_TOL = 1e-6
IMG = 64
PSEUDO_TOP = 5


def _m3fd_tree(root, n=10):
    from PIL import Image
    rng = np.random.default_rng(0)
    for sub in ("Vis", "Ir", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (8, 8, 3), np.uint8)
        Image.fromarray(img).save(os.path.join(root, "Vis", f"{i:05d}.png"))
        Image.fromarray(255 - img).save(
            os.path.join(root, "Ir", f"{i:05d}.png"))
        if i % 4:   # a pair without a label file
            with open(os.path.join(root, "labels", f"{i:05d}.txt"),
                      "w") as fh:
                fh.write(f"{i % 2} 0.5 0.5 0.{i + 1} 0.2\n")


def test_create_split_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    for r in (a, b):
        _m3fd_tree(r)
    got = split_dataset.main([a, "--seed", "7"])
    jax_create_split(b, seed=7)
    assert len(got["train_8_2"]) == 8 and len(got["val_8_2"]) == 2
    tree = {}
    for r in (a, b):
        tree[r] = sorted(os.path.relpath(os.path.join(d, f), r)
                         for d, _, fs in os.walk(r) for f in fs)
    assert tree[a] == tree[b]
    assert any(p.startswith("val_8_2") for p in tree[a])
    for rel in tree[a]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


def test_log_dataset_matches_jax(tmp_path, monkeypatch):
    yaml_src = make_synthetic_pair_dataset(str(tmp_path / "data"), n=2,
                                           img=32)
    out = {}
    for side, fn in (("port", log_dataset.main),
                     ("jax", jax_log_dataset.main)):
        d = tmp_path / side
        d.mkdir()
        data_yaml = d / "synthetic.yaml"
        data_yaml.write_text(open(yaml_src).read())
        monkeypatch.setenv("MMIDET_ARTIFACT_ROOT", str(d / "store"))
        written = fn(["--data", str(data_yaml)])
        assert written == str(d / "synthetic_wandb.yaml")
        with open(written) as fh:
            out[side] = yaml.safe_load(fh)
        assert os.path.isdir(d / "store")
    assert out["port"] == out["jax"]
    assert out["port"]["train_rgb"] == \
        "wandb-artifact://mmidet_tpu/train_rgb"


def _runs(root, layout):
    """One finished, one interrupted and one run without ``ckpt/``, plus
    one that never checkpointed (an empty ``ckpt/``), in ``layout``."""
    for name, epochs, last in (("finished", 10, 9), ("interrupted", 10, 3),
                               ("nested/interrupted2", 5, 0),
                               ("no_ckpt", 10, None), ("empty", 4, -1)):
        w = os.path.join(root, name)
        os.makedirs(w)
        with open(os.path.join(w, "opt.yaml"), "w") as fh:
            yaml.safe_dump({"epochs": epochs, "model": "yolov5t_add"}, fh)
        if last is None:
            continue
        ckpt = os.path.join(w, "ckpt")
        os.makedirs(ckpt)
        for e in range(max(last - 1, 0), last + 1):
            if layout == "jax":
                os.makedirs(os.path.join(ckpt, str(e)))
            else:
                open(os.path.join(ckpt, f"epoch{e}.pt"), "wb").close()


def _found(found, root):
    return sorted((os.path.relpath(w, root), opt["epochs"], last)
                  for w, opt, last in found)


def test_find_interrupted_matches_jax(tmp_path):
    j, p = str(tmp_path / "jax"), str(tmp_path / "port")
    _runs(j, "jax")
    _runs(p, "port")
    want = _found(jax_resume_all.find_interrupted(j), j)
    assert want == [("interrupted", 10, 3), ("nested/interrupted2", 5, 0)]
    assert _found(resume_all.find_interrupted(p), p) == want
    # a JAX run is not a run of the port: skipped and named
    skipped = []
    assert resume_all.find_interrupted(j, skipped) == []
    assert sorted(os.path.relpath(w, j) for w in skipped) == [
        "finished", "interrupted", "nested/interrupted2"]


def test_resume_all_main(tmp_path, monkeypatch, capsys):
    root = str(tmp_path)
    _runs(os.path.join(root, "port"), "port")
    _runs(os.path.join(root, "jax"), "jax")
    opt = os.path.join(root, "port", "interrupted", "opt.yaml")
    with open(opt, "w") as fh:   # as the trainer writes it: every field
        yaml.safe_dump({"epochs": 10, "model": "yolov5t_add", "mesh": "off",
                        "n_model": 1, "freeze": ["l0_"],
                        "fused_loop": True, "not_a_field": 1}, fh)
    calls = []

    def fake_train(cfg, device="cuda"):
        calls.append((cfg, device))
        return {"workdir": cfg.resume}
    monkeypatch.setattr("mmidet_tpu_torch.train.trainer.train", fake_train)
    assert resume_all.main([root, "--dry-run"], device="cpu") == []
    assert not calls
    said = capsys.readouterr().out
    assert "2 interrupted run(s) found" in said
    assert said.count("skipping ") == 3 and "jax/finished" in said
    got = resume_all.main([root], device="cpu")
    assert [c.resume for c, _ in calls] == [
        os.path.join(root, "port", "interrupted"),
        os.path.join(root, "port", "nested", "interrupted2")]
    assert got == [{"workdir": c.resume} for c, _ in calls]
    cfg, dev = calls[0]
    assert isinstance(cfg, TrainConfig) and dev == "cpu"
    assert (cfg.epochs, cfg.model, cfg.mesh, cfg.freeze) == (
        10, "yolov5t_add", "off", ("l0_",))


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "out")
    for call in (lambda: resume_all.main([str(tmp_path), "--dry-run"]),
                 lambda: s8_gate.main(["--epochs", "1", "--out", out]),
                 lambda: s8_gate.train_arm(1, 64, "t", 2, 2, "float32",
                                           out, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(out)   # nothing written before the refusal


def test_gate_trains_on_deterministic_cudnn(tmp_path, monkeypatch):
    """``train_arm`` trains with cuDNN's deterministic algorithms, and
    leaves the switch as it found it."""
    seen = []

    def fake_train(cfg, device="cuda"):
        seen.append(torch.backends.cudnn.deterministic)
        return {}
    monkeypatch.setattr("mmidet_tpu_torch.train.trainer.train", fake_train)
    before = torch.backends.cudnn.deterministic
    res = s8_gate.train_arm(1, IMG, "t", 2, 2, "float32",
                            str(tmp_path / "out"), 1, device="cpu")
    assert seen == [True] and res["data"].endswith("synthetic.yaml")
    assert torch.backends.cudnn.deterministic == before


def _condition(model, rgb, ir):
    """``chip_smoke.py``'s ``condition`` for a model whose BN is not
    folded: every BatchNorm of the backbones and the neck scaled (its
    weight and bias) so that its output has unit spread, in one forward
    pass in execution order; the CEM and the head keep their init."""
    def unit(mod, inp, out):
        s = float(out.std())
        mod.weight.div_(s)
        mod.bias.div_(s)
        return out / s
    hooks = [m.register_forward_hook(unit) for n, m in model.named_modules()
             if isinstance(m, BatchNorm2d) and not n.startswith("Enhance")]
    with torch.no_grad():
        model(rgb, ir)
    for h in hooks:
        h.remove()


@pytest.fixture(scope="module")
def gate_case(tmp_path_factory):
    """The conditioned model's variables on JAX's side and, through the
    bridge, as the port's deploy state dict; a synthetic set of 2 pairs
    labelled by the float model's own best detections."""
    root = tmp_path_factory.mktemp("gate")
    yaml_path = make_synthetic_pair_dataset(str(root / "data"), n=2,
                                            img=IMG + 32)
    data = yaml.safe_load(open(yaml_path))
    spec = get_model_spec("yolov5t_add", nc=2)
    torch.manual_seed(0)
    seeded = TwoStreamDetector(spec, aux_mode="off").eval()
    batch = next(iter(_port_loader(data)))
    _condition(seeded, *(torch.from_numpy(batch[k]).float() / 255.0
                         for k in ("rgb", "ir")))
    jmodel = JaxDetector(spec=jax_get_spec("yolov5t_add", nc=2),
                         aux_mode="off")
    jvars = jax.tree_util.tree_map(np.asarray, _jax_variables(
        jmodel, seeded.state_dict(), IMG))
    port = TwoStreamDetector(spec, aux_mode="off")
    from_jax_variables(port, jvars)
    deploy = port.state_dict()
    # pseudo labels: the float model's PSEUDO_TOP best detections an image
    txt = root / "pred"
    evaluate(port, _port_loader(data), 2, save_txt_dir=str(txt),
             save_conf=True, device="cpu")
    for f in os.listdir(txt):
        rows = np.loadtxt(txt / f, ndmin=2)
        rows = rows[np.argsort(-rows[:, 5], kind="stable")][:PSEUDO_TOP]
        for split in ("val_rgb", "val_ir"):
            lab = os.path.join(os.path.dirname(data[split]), "labels", f)
            np.savetxt(lab, rows[:, :5], fmt="%d %.6f %.6f %.6f %.6f")
    return {"yaml": yaml_path, "data": data, "spec": spec,
            "jmodel": jmodel, "jvars": jvars, "deploy": deploy}


def _port_loader(data):
    from mmidet_tpu_torch.data.datasets import PairedDataset
    from mmidet_tpu_torch.data.loader import RectLoader
    return RectLoader(PairedDataset(data["val_rgb"], data["val_ir"], nc=2),
                      2, IMG)


@pytest.fixture(scope="module")
def jax_gate(gate_case):
    """JAX's gate protocol (``tools/s8_gate.py:81-91``) on the same
    variables: float, then ``make_quant_deploy`` on the gate loader's
    first batch; JAX's calibration and fold jitted whole."""
    c = gate_case
    mp = pytest.MonkeyPatch()
    _jax_fast(mp)
    try:
        dev = [jax.devices()[0]]

        def loader():
            return JaxRectLoader(JaxDataset(c["data"]["val_rgb"],
                                            c["data"]["val_ir"], nc=2), 2,
                                 IMG)
        ev_f = jax_evaluate(c["jmodel"], c["jvars"], loader(), 2,
                            conf_thres=0.001, iou_thres=0.6, devices=dev)
        calib = next(iter(loader()))
        rgb = np.asarray(calib["rgb"], np.float32) / 255.0
        ir = np.asarray(calib["ir"], np.float32) / 255.0
        qm, qv = jq.make_quant_deploy(c["jmodel"], c["jvars"], [(rgb, ir)])
        ev_q = jax_evaluate(qm, qv, loader(), 2, conf_thres=0.001,
                            iou_thres=0.6, devices=dev)
    finally:
        mp.undo()
    return ev_f.map50, ev_q.map50


@pytest.fixture(scope="module")
def port_gate(gate_case):
    c = gate_case
    return s8_gate.gate_record(TwoStreamDetector(c["spec"], aux_mode="off"),
                               c["deploy"], c["yaml"], IMG, 2, 0.02,
                               device="cpu", epochs=2, name="yolov5t_add")


def test_gate_record_matches_jax(port_gate, jax_gate):
    f_map, q_map = jax_gate
    rec = port_gate
    assert 0.3 < f_map <= 1.0 and q_map > 0.0   # neither side trivial
    assert abs(rec["float_map50"] - f_map) <= MAP_TOL
    assert abs(rec["int8_map50"] - q_map) <= MAP_TOL
    assert rec["delta"] == rec["int8_map50"] - rec["float_map50"]
    assert rec["device"] == "cpu" and rec["epochs"] == 2
    assert rec["metric"] == "s8_gate_yolov5t_add_64"
    assert rec["pass"] == (abs(rec["delta"]) <= 0.02)


@pytest.mark.parametrize("side", ["pass", "fail"])
def test_s8_gate_main_exit_code(gate_case, port_gate, side, tmp_path,
                                monkeypatch):
    """``main`` gates the trained weights' |delta| against ``--gate`` and
    writes its record: ``train_arm`` returns the conditioned weights."""
    c = gate_case
    calls = []

    def fake_arm(*args, device="cuda"):
        calls.append(args)
        return {"deploy": c["deploy"], "spec": c["spec"], "data": c["yaml"],
                "last_results": None}
    monkeypatch.setattr(s8_gate, "train_arm", fake_arm)
    gap = abs(port_gate["delta"])
    assert gap > 0
    gate = gap if side == "pass" else gap / 2
    out = tmp_path / "out"
    rc = s8_gate.main(["--epochs", "2", "--img", str(IMG), "--scale", "t",
                       "--batch", "2", "--n", "2", "--gate", repr(gate),
                       "--out", str(out)], device="cpu")
    assert rc == (0 if side == "pass" else 1)
    assert calls == [(2, IMG, "t", 2, 2, "float32", str(out), 50)]
    import json
    rec = json.loads((out / "s8_gate.json").read_text())
    assert rec == {**port_gate, "pass": side == "pass"}
