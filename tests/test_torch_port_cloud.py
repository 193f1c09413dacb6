"""The port's GPU cloud files (``mmidet_tpu_torch/deploy/cloud/``) and its
``mmidet-torch-*`` console scripts, checked statically on the CPU: no
Docker, no VM and no network here, so the image is never built and the
startup script never boots."""

import os
import shlex
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from mmidet_tpu_torch.deploy import serve

from test_torch_port_train import _threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CLOUD = ROOT / "mmidet_tpu_torch" / "deploy" / "cloud"


def _dockerfile():
    """The Dockerfile's instructions, continuation lines joined, comments
    dropped."""
    text = (CLOUD / "Dockerfile").read_text()
    lines = [ln for ln in text.splitlines() if not ln.lstrip().startswith("#")]
    return [ln.strip() for ln in "\n".join(lines).replace("\\\n", " ")
            .splitlines() if ln.strip()]


def test_dockerfile_installs_no_jax_and_copies_the_port():
    steps = _dockerfile()
    body = "\n".join(steps)
    assert "jax" not in body.lower() and "libtpu" not in body.lower()
    assert steps[0].startswith("FROM nvidia/cuda:") and "devel" in steps[0]
    copied = {s.split()[1] for s in steps if s.startswith("COPY ")}
    assert {"mmidet_tpu_torch", "native", "configs"} <= copied
    assert "mmidet_tpu" not in copied
    for src in copied:
        assert (ROOT / src).exists(), src
    pip = [s for s in steps if "pip install" in s]
    assert pip and "torch" in pip[0]


def test_dockerfile_cmd_parses_under_the_serve_cli():
    cmd, = [s for s in _dockerfile() if s.startswith("CMD ")]
    import json
    argv = json.loads(cmd[4:])
    assert argv[:3] == ["python", "-m", "mmidet_tpu_torch.deploy.serve"]
    args = serve.build_parser().parse_args(argv[3:])
    assert args.port == 5000 and args.host == "0.0.0.0"
    expose, = [s for s in _dockerfile() if s.startswith("EXPOSE ")]
    assert expose.split()[1] == str(args.port)


def test_startup_script_parses_under_bash():
    script = CLOUD / "gpu_vm_startup.sh"
    assert os.access(script, os.X_OK)
    subprocess.run(["bash", "-n", str(script)], check=True)


def test_startup_script_resumes_with_the_port():
    text = (CLOUD / "gpu_vm_startup.sh").read_text()
    code = [ln for ln in text.splitlines() if not ln.lstrip().startswith("#")]
    runs = [ln for ln in code if "python3 -m mmidet_tpu_torch." in ln]
    assert any(shlex.split(ln)[:4] == ["nohup", "python3", "-m",
                                       "mmidet_tpu_torch.tools.resume_all"]
               for ln in runs)
    body = "\n".join(code)
    assert "jax" not in body.lower() and "tools/resume_all.py" not in body
    assert "pip install --no-deps --no-build-isolation -e ." in body


def _scripts():
    with open(ROOT / "pyproject.toml", "rb") as fh:
        return tomllib.load(fh)["project"]["scripts"]


def test_every_jax_console_script_has_a_port_twin():
    scripts = _scripts()
    jax_side = {k: v for k, v in scripts.items()
                if v.startswith("mmidet_tpu.")}
    assert set(jax_side) == {"mmidet-train", "mmidet-val", "mmidet-detect",
                             "mmidet-export", "mmidet-serve"}
    for name in jax_side:
        twin = name.replace("mmidet-", "mmidet-torch-")
        assert scripts[twin].startswith("mmidet_tpu_torch."), twin


@pytest.mark.parametrize("verb,prog", [
    ("train", "mmidet-tpu-torch train"), ("val", "mmidet-tpu-torch val"),
    ("detect", "mmidet-tpu-torch detect"),
    ("export", "mmidet-tpu-torch export"),
    ("serve", "mmidet-tpu-torch serve")])
def test_console_script_targets_read_sys_argv(verb, prog, monkeypatch,
                                              capsys):
    """Each target imports and is called with no arguments, as a console
    script calls it: its parser reads ``sys.argv``."""
    import importlib
    module, func = _scripts()[f"mmidet-torch-{verb}"].split(":")
    target = getattr(importlib.import_module(module), func)
    monkeypatch.setattr(sys, "argv", [f"mmidet-torch-{verb}", "--help"])
    with pytest.raises(SystemExit) as exc:
        target()
    assert exc.value.code == 0
    assert capsys.readouterr().out.startswith(f"usage: {prog}")
