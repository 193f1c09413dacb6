"""The s8-storage deploy's accuracy gate: train ``yolov5{scale}_add`` to
convergence on the synthetic paired set, then evaluate the same weights
through the float deploy and through the ``--int8`` (s8-storage) deploy
under the gate protocol (``RectLoader``, conf 0.001, IoU 0.6) and report
the mAP50 delta (the JAX package's ``tools/s8_gate.py``).

The delta is noise until the model has converged: activation rounding
jitters borderline matches either way, so a model whose float mAP50 is
low can pass or fail by chance.  The exit code is 0 iff |delta| <=
``--gate``; the record goes to ``<out>/s8_gate.json``.

    python -m mmidet_tpu_torch.tools.s8_gate [--epochs 300] [--img 160]
        [--scale s] [--batch 8] [--n 8] [--gate 0.02] [--out DIR]

``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess

import torch

# the gate protocol's thresholds (reference test.py's mAP protocol)
CONF_THRES = 0.001
IOU_THRES = 0.6


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s8_gate")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--img", type=int, default=160)
    ap.add_argument("--scale", type=str, default="s")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=8, help="train images")
    ap.add_argument("--gate", type=float, default=0.02,
                    help="|mAP50 delta| bound to assert")
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--out", type=str, default="/tmp/s8_gate")
    ap.add_argument("--warmup-floor", type=int, default=50,
                    help="warmup iteration floor (the trainer's "
                         "reference-faithful default of 1000 swallows "
                         "whole short runs at 1 step/epoch)")
    return ap


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms while the gate trains and
    evaluates.  Its default picks may sum a convolution's weight gradient
    in another order from one call to the next, and a thousand epochs
    grow that into other converged weights: on an H100 one seed gave
    float mAP50 0.728, 0.830 and 0.728 and deltas -0.025, +0.014 and
    -0.074; with these algorithms four runs gave the same record to the
    digit, at no cost in time."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def train_arm(epochs: int, img: int, scale: str, batch: int, n: int,
              dtype: str, out: str, warmup_floor: int,
              device: str | torch.device = "cuda") -> dict:
    """Write the synthetic set under ``out/data`` (``n`` pairs at ``img +
    32``; its val split is its train split) and train the model on it
    with augmentation, mosaic and the aux losses off, on cuDNN's
    deterministic algorithms (``deterministic_cudnn``); returns the
    trainer's summary, whose ``deploy`` is the EMA state dict (the best
    checkpoint's where one was kept), with ``data``: the set's yaml."""
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.eval.evaluator import eval_device
    from mmidet_tpu_torch.train.trainer import TrainConfig, train
    eval_device(device)   # before anything is written
    os.makedirs(out, exist_ok=True)
    yaml_path = make_synthetic_pair_dataset(os.path.join(out, "data"), n=n,
                                            img=img + 32)
    aug_off = dict(degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
                   perspective=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                   fliplr=0.0, flipud=0.0, mosaic=0.0, mixup=0.0)
    cfg = TrainConfig(
        model=f"yolov5{scale}_add", data=yaml_path, hyp=aug_off,
        epochs=epochs, batch_size=batch, img_size=img, max_labels=30,
        workdir=os.path.join(out, "run"), aux_mode="off", mosaic_prob=0.0,
        dtype=dtype, eval_every=epochs, seed=0, autoanchor=False,
        notest=True, nosave=True, exist_ok=True, warmup_floor=warmup_floor)
    with deterministic_cudnn():
        res = train(cfg, device=device)
    res["data"] = yaml_path
    return res


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def gate_record(model, deploy_state: dict, yaml_path: str, img: int,
                batch: int, gate: float,
                device: str | torch.device = "cuda",
                epochs: int | None = None, name: str = "") -> dict:
    """``deploy_state`` in ``model`` (a float ``TwoStreamDetector``, BN
    not folded) evaluated on the yaml's val split, then its s8-storage
    twin (``make_quant_deploy``, calibrated on the loader's first batch)
    on the same split, both on cuDNN's deterministic algorithms; the
    record with both mAP50s and their delta (``name``: the model's, for
    the record's ``metric``)."""
    from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
    from mmidet_tpu_torch.data.loader import RectLoader
    from mmidet_tpu_torch.eval.evaluator import eval_device, evaluate
    from mmidet_tpu_torch.nn.quant import make_quant_deploy
    dev = eval_device(device)
    model.load_state_dict(deploy_state)
    model = model.to(dev).eval()
    data = load_data_yaml(yaml_path)
    nc = int(data["nc"])

    def loader():
        ds = PairedDataset(data["val_rgb"], data["val_ir"], nc=nc)
        return RectLoader(ds, batch, img)

    with deterministic_cudnn():
        ev_f = evaluate(model, loader(), nc, conf_thres=CONF_THRES,
                        iou_thres=IOU_THRES, device=dev, devices=[dev])
        calib = next(iter(loader()))
        rgb = torch.from_numpy(calib["rgb"]).to(dev).float() / 255.0
        ir = torch.from_numpy(calib["ir"]).to(dev).float() / 255.0
        q_model = make_quant_deploy(model, [(rgb, ir)])
        ev_q = evaluate(q_model, loader(), nc, conf_thres=CONF_THRES,
                        iou_thres=IOU_THRES, device=dev, devices=[dev])
    delta = ev_q.map50 - ev_f.map50
    return {"metric": f"s8_gate_{name}_{img}" if name else f"s8_gate_{img}",
            "float_map50": float(ev_f.map50),
            "int8_map50": float(ev_q.map50), "delta": float(delta),
            "epochs": epochs, "device": device_name(dev),
            "pass": abs(delta) <= gate}


def main(argv=None, device: str | torch.device = "cuda") -> int:
    """Train, gate, write ``<out>/s8_gate.json``; 0 iff |delta| <= gate."""
    args = build_parser().parse_args(argv)
    from mmidet_tpu_torch.eval.evaluator import eval_device
    from mmidet_tpu_torch.models.detector import TwoStreamDetector
    dev = eval_device(device)
    res = train_arm(args.epochs, args.img, args.scale, args.batch, args.n,
                    args.dtype, args.out, args.warmup_floor, device=dev)
    if res.get("last_results") is not None:
        print(f"trained: internal mAP50 {res['last_results'].map50:.4f}",
              flush=True)
    model = TwoStreamDetector(res["spec"], aux_mode="off")
    if args.dtype != "float32":   # the JAX gate's rule: else bf16
        model = model.to(torch.bfloat16)
    record = gate_record(model, res["deploy"], res["data"], args.img,
                         args.batch, args.gate, device=dev,
                         epochs=args.epochs, name=f"yolov5{args.scale}_add")
    print(json.dumps(record), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "s8_gate.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
