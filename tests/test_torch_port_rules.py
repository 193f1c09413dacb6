"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package, its entry point defaults to the card, and its kernel wrappers
never fall back to the plain version for a tensor that is not on the
CPU."""

import ast
from pathlib import Path

import pytest
import torch

from mmidet_tpu_torch import kernels
from mmidet_tpu_torch.deploy.serve import DetectionService
from mmidet_tpu_torch.nn import transformer_cuda
from mmidet_tpu_torch.ops import nms_cuda

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mmidet_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    if name == "mmidet_tpu_torch" or name.startswith("mmidet_tpu_torch."):
        return False
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_and_chip_scripts_import_no_jax():
    files = sorted((ROOT / "mmidet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imports(f)
           if _forbidden(n)}
    assert not bad, bad


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("mmidet_tpu.ops.nms")
    assert _forbidden("flax.linen") and not _forbidden("mmidet_tpu_torch.nn")
    assert not _forbidden("jaxtyping")


def test_detection_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectionService(torch.nn.Identity(), ["a"])


def test_kernels_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in kernels.SIGNATURES:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            kernels.load(name)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor reaches the plain version; any other device
    launches the kernel or raises."""
    x = torch.zeros(1, 128, 64, device="meta")
    with pytest.raises(ValueError, match="no token-transformer kernel"):
        transformer_cuda.fused_token_transformer(x, {})
    with pytest.raises(ValueError, match="no NMS kernel"):
        nms_cuda.nms_greedy(torch.zeros(1, 128, 4, device="meta"),
                            torch.zeros(1, 128, device="meta"))


def test_kernel_sources_are_in_the_package():
    for name in kernels.SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
