"""Each slice's modules are among the files that
``test_torch_port_rules.py``'s import rule reads, and its entry points
run on the card unless asked for the CPU."""

import pytest
import torch

from test_torch_port_rules import ROOT


def test_eval_path_modules_are_covered_and_default_to_the_card():
    """The evaluation path's modules are among the files the import rule
    above reads, and its entry points run on the card unless asked for
    the CPU."""
    import inspect

    from mmidet_tpu_torch.cli import detect, val
    from mmidet_tpu_torch.eval import evaluator
    port = ROOT / "mmidet_tpu_torch"
    files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert {"data/datasets.py", "data/synthetic.py", "data/native.py",
            "data/loader.py", "models/spec.py", "models/zoo.py",
            "models/detector.py", "models/tta.py", "eval/metrics.py",
            "eval/evaluator.py", "utils/general.py", "utils/plots.py",
            "cli/val.py", "cli/detect.py"} <= files
    for fn in (evaluator.evaluate, val.main, val.load_model_and_vars,
               detect.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluator.eval_device("cuda")


def test_training_modules_are_covered_and_default_to_the_card():
    """The training path's modules are among the files the import rule
    above reads, and ``train`` and ``cli.train`` run on the card unless
    asked for the CPU."""
    import inspect

    from mmidet_tpu_torch.cli import train as train_cli
    from mmidet_tpu_torch.train import trainer
    port = ROOT / "mmidet_tpu_torch"
    files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert {"ops/boxes.py", "losses/detection.py", "losses/fusion.py",
            "nn/fusion.py", "nn/layers.py", "models/detector.py",
            "train/schedule.py", "train/optimizer.py", "train/ema.py",
            "train/step.py", "train/checkpoint.py", "train/trainer.py",
            "data/augment.py", "utils/autoanchor.py", "utils/logger.py",
            "utils/general.py", "utils/plots.py", "cli/train.py"} <= files
    for fn in (trainer.train, train_cli.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        cfg = trainer.TrainConfig(data="unused.yaml", mosaic_prob=0.0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.train(cfg)


def test_serving_modules_are_covered_and_default_to_the_card():
    """The serving front end's modules (the s8-storage deploy, bundles,
    the hub, ensembles, the serving benchmark) are among the files the
    import rule above reads, and their entry points run on the card
    unless asked for the CPU."""
    import inspect

    from mmidet_tpu_torch import hub
    from mmidet_tpu_torch.deploy import serve
    from mmidet_tpu_torch.models import ensemble
    from mmidet_tpu_torch.tools import serve_bench
    port = ROOT / "mmidet_tpu_torch"
    files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert {"nn/quant.py", "deploy/serve.py", "deploy/export.py", "hub.py",
            "models/ensemble.py", "tools/serve_bench.py"} <= files
    for fn in (serve.BatchingService, serve.DetectionService, serve.main,
               hub.AutoShapeModel, hub._make, hub.custom,
               ensemble.attempt_load_ensemble):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.BatchingService(torch.nn.Identity(), ["a"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_bench.main([])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main([])


def test_export_modules_are_covered_and_default_to_the_card():
    """The export path's modules (the checkpoint reader, the ONNX codec,
    emitter and runner, the shared wire helpers and row walk, the TF
    graph emitter, the SavedModel and TFLite codecs and their numpy
    runner) are among the files the import rule above reads, and the
    export CLI runs on the card unless asked for the CPU."""
    import inspect

    from mmidet_tpu_torch.deploy import export
    port = ROOT / "mmidet_tpu_torch"
    files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert {"deploy/export.py", "deploy/onnx_proto.py", "deploy/onnx_np.py",
            "deploy/onnx_export.py", "train/checkpoint.py",
            "nn/resize.py", "deploy/pbwire.py", "deploy/rows.py",
            "deploy/tf_graph.py", "deploy/tf_proto.py",
            "deploy/tflite_fb.py", "deploy/tf_np.py"} <= files
    assert inspect.signature(export.main).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.main(["--cfg", "yolov5t_add"])


def test_tenth_slice_modules_are_covered_and_default_to_the_card(tmp_path):
    """The modules of the trainer's remaining options, the inference
    sources and the utils leftovers are among the files the import rule
    above reads; the trainer and the train CLI with those options (and
    ``--evolve``) still run on the card unless asked for the CPU; since
    the data-parallel options (A13) are ported too, the trainer has no
    ``unported`` check left and no port file names ROADMAP A13 or A15."""
    import inspect

    from mmidet_tpu_torch.cli import train as train_cli
    from mmidet_tpu_torch.train import trainer
    port = ROOT / "mmidet_tpu_torch"
    files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert {"data/sources.py", "train/evolve.py", "utils/artifacts.py",
            "utils/logger.py", "utils/general.py", "utils/plots.py",
            "utils/profiler.py", "utils/gradcam.py", "utils/ds_fusion.py",
            "utils/downloads.py", "nn/aux_experimental.py",
            "bridge.py"} <= files
    assert not hasattr(trainer, "unported")
    assert "cfg.n_model" in inspect.getsource(trainer.setup_mesh)
    for f in sorted(port.rglob("*.py")):
        text = f.read_text()
        assert "A15" not in text and "A13" not in text, f
    if not torch.cuda.is_available():
        cfg = trainer.TrainConfig(data="unused.yaml", mosaic_prob=0.0,
                                  image_weights=True, log_artifacts=True,
                                  bbox_interval=1, use_wandb=True,
                                  bucket="b", workdir=str(tmp_path / "x"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.train(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--data", "unused.yaml", "--evolve", "1",
                            "--project", str(tmp_path)])
