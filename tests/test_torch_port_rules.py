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
from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
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
    with pytest.raises(ValueError, match="no CEM kernel"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3, device="meta"),
                           *[None] * 6)
    s = torch.zeros(1, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no GPT-merge kernel"):
        fusion_cuda.fused_gpt_merge(s, s, {}, None, None, None)
    m = torch.zeros(128, 64, device="meta")
    with pytest.raises(ValueError, match="no layer-GEMM kernel"):
        transformer_cuda.layer_gemm(m, m, torch.zeros(128, device="meta"),
                                    "bias")


def test_every_kernel_is_registered_counted_and_has_a_plain_version():
    """Four TPU kernels, four CUDA sources, and the layer GEMM that K1 and
    K4 share as an entry point of its own; each wrapper counts its launches
    and has its plain PyTorch version beside it."""
    assert set(kernels.SIGNATURES) == {"token_transformer", "layer_gemm",
                                       "layer_gemm_tile", "nms_greedy",
                                       "cem", "gpt_merge"}
    assert kernels.LIBRARIES == ("cem", "gpt_merge", "nms_greedy",
                                 "token_transformer")
    assert kernels.SIGNATURES["layer_gemm"][:2] == ("token_transformer",
                                                    "tt_gemm")
    assert kernels.SIGNATURES["layer_gemm_tile"][:2] == ("token_transformer",
                                                         "tt_gemm_tile")
    for mod, name in ((transformer_cuda, "fused_token_transformer"),
                      (transformer_cuda, "layer_gemm"),
                      (nms_cuda, "nms_greedy"), (cem_cuda, "fused_cem"),
                      (fusion_cuda, "fused_gpt_merge")):
        assert isinstance(getattr(mod, name).launches, int)
        assert callable(getattr(mod, name + "_reference"))


def test_kernel_sources_call_no_library():
    """The CUDA sources hold their own products, convolutions, pooling and
    resampling: no cuBLAS, cuDNN or torch header is included."""
    for src in sorted(kernels.CSRC.glob("*.cu*")):
        includes = [ln for ln in src.read_text().splitlines()
                    if ln.lstrip().startswith("#include")]
        assert includes
        for word in ("cublas", "cudnn", "torch", "ATen", "cutlass"):
            assert not any(word in ln for ln in includes), (src.name, word)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to ``csrc/*.cuh`` renames every library, so that a stale
    build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kernels.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {n: kernels._lib_path(n).name for n in kernels.LIBRARIES}
    hdr = csrc / "token_transformer.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: kernels._lib_path(n).name for n in kernels.LIBRARIES}
    assert all(before[n] != after[n] for n in before)


def test_kernel_sources_are_in_the_package():
    for name in kernels.LIBRARIES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    for src in kernels.CSRC.glob("*.cu"):
        assert src.stem in kernels.LIBRARIES, src.name
