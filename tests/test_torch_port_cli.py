"""The port's ``val`` and ``detect`` CLIs on the CPU, with the invocations
of ``tests/test_cli.py``: the JSON line's keys, the label txt files and
the images written (the ``train`` CLI's are
``test_torch_port_cli_train.py``'s).  The weights file: a state dict saved from the port's
unfused model loads through ``load_model_and_vars``, and the same ``.pt``
through the JAX package's converter gives variables that the bridge maps
back onto the same tensors."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.train.checkpoint import (convert_torch_state_dict,
                                         load_torch_checkpoint)
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.cli import detect, train, val
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny models gain nothing from more intra-op threads; fewer keep this
    file from crowding the test workers that share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return make_synthetic_pair_dataset(str(root), n=6, img=96)


@pytest.fixture(scope="module")
def two_pairs(data_yaml, tmp_path_factory):
    """The first two pairs as list files, and a data yaml over them: the
    option runs below need no more."""
    d = yaml.safe_load(open(data_yaml))
    root = tmp_path_factory.mktemp("two")
    lists = {}
    for key in ("val_rgb", "val_ir"):
        files = sorted(os.listdir(d[key]))[:2]
        lists[key] = str(root / f"{key}.txt")
        with open(lists[key], "w") as fh:
            fh.write("\n".join(os.path.join(d[key], f) for f in files))
    yml = root / "two.yaml"
    yml.write_text(yaml.safe_dump({"train_rgb": lists["val_rgb"],
                                   "train_ir": lists["val_ir"], **lists,
                                   "nc": 2, "names": d["names"]}))
    return str(yml), lists


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """yolov5s_add (nc 2), seeded, BN statistics and affine parameters
    perturbed so that folding has something to fold."""
    torch.manual_seed(3)
    model = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    path = tmp_path_factory.mktemp("w") / "model.pt"
    torch.save(model.state_dict(), path)
    return path, model.eval()


def test_val_cli(data_yaml, tmp_path, capsys):
    res = val.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                    "--batch-size", "2", "--img-size", "64", "--save-txt",
                    "--save-conf", "--project", str(tmp_path), "--name",
                    "exp"], device="cpu")
    assert 0.0 <= res.map50 <= 1.0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"P", "R", "mAP50", "mAP75", "mAP", "speed_ms"}
    assert all(isinstance(v, float) for v in line.values())
    assert line["mAP50"] == res.map50 and line["speed_ms"] > 0
    labels = sorted(os.listdir(tmp_path / "exp" / "labels"))
    assert len(labels) == 6
    rows = (tmp_path / "exp" / "labels" / labels[0]).read_text().split("\n")
    assert len(rows[0].split()) == 6  # cls xywh conf


@pytest.mark.parametrize("args", [["--rect", "--augment"], ["--merge"],
                                  ["--task", "speed"]])
def test_val_cli_options(two_pairs, args):
    res = val.main(["--cfg", "yolov5s_add", "--data", two_pairs[0],
                    "--batch-size", "2", "--img-size", "64", *args],
                   device="cpu")
    assert 0.0 <= res.map <= 1.0 and res.nc == 2


def test_val_cli_refuses_int8_and_a_directory(two_pairs, tmp_path):
    """``--int8`` used to be refused; it runs now (the s8-storage deploy,
    held against the JAX package in test_torch_port_quant.py).  A
    directory is refused unless it is a deploy bundle (its ``model.json``):
    orbax checkpoints are the JAX package's format."""
    res = val.main(["--cfg", "yolov5s_add", "--data", two_pairs[0],
                    "--batch-size", "2", "--img-size", "64", "--int8",
                    "--int8-clip", "0.9"], device="cpu")
    assert 0.0 <= res.map <= 1.0 and res.nc == 2
    with pytest.raises(ValueError, match="orbax"):
        val.main(["--cfg", "yolov5s_add", "--data", two_pairs[0],
                  "--weights", str(tmp_path)], device="cpu")


def test_detect_cli(data_yaml, tmp_path, capsys):
    d = yaml.safe_load(open(data_yaml))
    out_dir = detect.main([
        "--cfg", "yolov5s_add", "--source1", d["val_rgb"],
        "--source2", d["val_ir"], "--img-size", "64",
        "--conf-thres", "0.0001", "--nc", "2",
        "--project", str(tmp_path / "det"), "--name", "exp",
        "--save-txt", "--save-conf", "--save-crop"], device="cpu")
    files = os.listdir(out_dir)
    assert sum(f.endswith("_rgb.jpg") for f in files) == 6
    assert sum(f.endswith("_ir.jpg") for f in files) == 6
    txt = sorted(f for f in files if f.endswith(".txt"))
    assert len(txt) == 6
    row = open(os.path.join(out_dir, txt[0])).readline().split()
    assert len(row) == 6 and int(row[0]) in (0, 1)
    assert all(0 <= float(v) <= 1 for v in row[1:5])
    assert os.listdir(os.path.join(out_dir, "crops"))
    assert "results saved to" in capsys.readouterr().out


def test_detect_cli_options(two_pairs, tmp_path):
    d = two_pairs[1]
    common = ["--cfg", "yolov5s_add", "--source1", d["val_rgb"],
              "--source2", d["val_ir"], "--img-size", "64", "--nc", "2",
              "--conf-thres", "0.0001", "--project", str(tmp_path),
              "--name", "exp"]
    first = detect.main(common + ["--nosave", "--save-txt", "--classes",
                                  "1", "--agnostic-nms"], device="cpu")
    assert len(os.listdir(first)) == 2  # label files only
    assert not any(f.endswith(".jpg") for f in os.listdir(first))
    for f in os.listdir(first):
        for line in open(os.path.join(first, f)):
            assert line.split()[0] == "1"
    again = detect.main(common + ["--augment", "--merge", "--hide-labels",
                                  "--hide-conf", "--line-thickness", "1"],
                        device="cpu")
    assert again != first and again.endswith("exp2")
    reused = detect.main(common + ["--exist-ok", "--nosave"], device="cpu")
    assert reused == first
    # --int8, once refused, runs (the s8-storage deploy; JAX's files in
    # test_torch_port_quant.py)
    int8 = detect.main(common + ["--int8", "--nosave", "--save-txt"],
                       device="cpu")
    assert int8.endswith("exp3") and len(os.listdir(int8)) == 2


@pytest.mark.parametrize("wrap", ["bare", "model", "ema"])
def test_state_dict_loads_through_load_model_and_vars(weights, tmp_path,
                                                      wrap):
    path, model = weights
    if wrap != "bare":
        sd = model.state_dict()
        blank = {k: torch.zeros_like(v) for k, v in sd.items()}
        wrapped = {"model": sd} if wrap == "model" else \
            {"ema": sd, "model": blank}
        path = tmp_path / "wrapped.pt"
        torch.save(wrapped, path)
    loaded, spec = val.load_model_and_vars("yolov5s_add", str(path), 2,
                                           device="cpu")
    assert spec.nc == 2 and next(loaded.parameters()).dtype == torch.float32
    rng = np.random.default_rng(0)
    rgb, ir = (torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        got = loaded(rgb, ir)["pred"]
        ref = model(rgb, ir)["pred"]
    # BN folding is exact up to f32 rounding
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)
    assert all(m.bn is None for m in loaded.modules() if hasattr(m, "bn"))


def test_state_dict_round_trips_through_the_jax_converter(weights):
    """port state dict -> .pt -> the JAX package's reader and converter ->
    JAX variables -> the bridge -> the same tensors."""
    path, model = weights
    jmodel = JaxDetector(spec=jax_get_spec("yolov5s_add", nc=2),
                         aux_mode="off")
    z = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda k, a, b: jmodel.init({"params": k}, a, b, train=False),
            jax.ShapeDtypeStruct((2,), np.uint32), z, z))
    variables = convert_torch_state_dict(
        dict(template), load_torch_checkpoint(str(path)), strict=True)
    back = TwoStreamDetector(get_model_spec("yolov5s_add", nc=2))
    from_jax_variables(back, variables)
    sd = model.state_dict()
    for k, v in back.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_cli_entry_points_default_to_the_card(data_yaml):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = yaml.safe_load(open(data_yaml))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val.main(["--cfg", "yolov5s_add", "--data", data_yaml])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect.main(["--cfg", "yolov5s_add", "--source1", d["val_rgb"],
                     "--source2", d["val_ir"]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--cfg", "yolov5s_add", "--data", data_yaml,
                    "--no-mosaic"])
