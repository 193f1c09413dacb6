"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package (its top-level ``tools/`` included), nor TensorFlow, protobuf or
flatbuffers (the card's machine has
none of them: the port's SavedModel and TFLite codecs are its own), its
entry point defaults to the card, and its kernel wrappers never fall back
to the plain version for a tensor that is not on the CPU (each slice's
entry points: ``test_torch_port_rules_entry.py``)."""

import ast
from pathlib import Path

import pytest
import torch

from mmidet_tpu_torch import kernels
from mmidet_tpu_torch.deploy.serve import DetectionService
from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda, transformer_cuda
from mmidet_tpu_torch.ops import nms_cuda
from mmidet_tpu_torch.tools import probe_cem_fb, probe_cem_r3, probe_igemm

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mmidet_tpu",
             "tools", "tensorflow", "google.protobuf", "flatbuffers")


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
    assert {"probe_igemm.py", "probe_cem_r3.py", "probe_cem_fb.py",
            "timing.py", "split_dataset.py", "log_dataset.py",
            "resume_all.py", "s8_gate.py"} <= {f.name for f in files
                             if f.parent.name == "tools"}
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imports(f)
           if _forbidden(n)}
    assert not bad, bad


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("mmidet_tpu.ops.nms")
    assert _forbidden("flax.linen") and not _forbidden("mmidet_tpu_torch.nn")
    assert not _forbidden("jaxtyping")
    assert _forbidden("tensorflow") and _forbidden("tensorflow.lite.python")
    assert _forbidden("google.protobuf.message") and _forbidden("flatbuffers")
    assert not _forbidden("google") and not _forbidden("tensorflowjs_like")
    assert _forbidden("tools.s8_gate") and _forbidden("tools")
    assert not _forbidden("mmidet_tpu_torch.tools.s8_gate")


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
    with pytest.raises(ValueError, match="no conv-chain kernel"):
        probe_igemm.conv_chain(torch.zeros(1, 8, 8, 64, device="meta"),
                               None, None)
    with pytest.raises(ValueError, match="no halo-sum kernel"):
        probe_cem_r3.halo_sum("lane_wrap",
                              torch.zeros(82, 80, 192, device="meta"))
    with pytest.raises(ValueError, match="no lane-matmul kernel"):
        probe_cem_fb.lane_matmul("slice8", torch.zeros(96, 8, device="meta"),
                                 torch.zeros(128, 128, device="meta"))


def test_every_kernel_is_registered_counted_and_has_a_plain_version():
    """The package's four TPU kernels and the three probes under ``tools/``
    (P2 and P3 in one source), six CUDA sources, and the layer GEMM that K1
    and K4 share as an entry point of its own; each wrapper counts its
    launches and has its plain PyTorch version beside it."""
    assert set(kernels.SIGNATURES) == {"token_transformer", "layer_gemm",
                                       "layer_gemm_tile", "nms_greedy",
                                       "cem", "gpt_merge", "conv_chain",
                                       "conv_chain_config", "halo_sum",
                                       "lane_matmul", "launch_floor"}
    assert kernels.LIBRARIES == ("cem", "cem_probes", "conv_chain",
                                 "gpt_merge", "nms_greedy",
                                 "token_transformer")
    assert kernels.SIGNATURES["layer_gemm"][:2] == ("token_transformer",
                                                    "tt_gemm")
    assert kernels.SIGNATURES["layer_gemm_tile"][:2] == ("token_transformer",
                                                         "tt_gemm_tile")
    assert kernels.SIGNATURES["conv_chain_config"][:2] == (
        "conv_chain", "conv_chain_config")
    for mod, name in ((transformer_cuda, "fused_token_transformer"),
                      (transformer_cuda, "layer_gemm"),
                      (nms_cuda, "nms_greedy"), (cem_cuda, "fused_cem"),
                      (fusion_cuda, "fused_gpt_merge"),
                      (probe_igemm, "conv_chain"), (probe_cem_r3, "halo_sum"),
                      (probe_cem_fb, "lane_matmul")):
        assert isinstance(getattr(mod, name).launches, int)
        assert callable(getattr(mod, name + "_reference"))
    assert isinstance(nms_cuda.nms_greedy.launches_large, int)


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


def test_ptxas_report_is_the_built_librarys_own(tmp_path, monkeypatch):
    """The build log is named after the library it built (its source
    digest): a log of another build of the same source is never read, and
    a library whose sources changed has no report until it is built."""
    monkeypatch.setattr(kernels, "BUILD", tmp_path)
    (tmp_path / "conv_chain.log").write_text(
        "ptxas info    : Compiling entry function 'stale' for 'sm_90a'\n")
    assert kernels.build_log("conv_chain") == ""
    assert kernels.ptxas_report("conv_chain") == []
    log = kernels._log_path("conv_chain")
    assert log.name == kernels._lib_path("conv_chain").stem + ".log"
    log.write_text(
        "ptxas info    : Compiling entry function 'k64' for 'sm_90a'\n"
        "ptxas info    : Function properties for k64\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 5 barriers\n"
        "ptxas info    : Compiling entry function 'k128' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 232 registers\n"
        "ptxas /tmp/x.ptx, line 9; warning : (C7520) wgmma serialized in "
        "function 'k128'\n")
    assert kernels.ptxas_report("conv_chain") == [
        {"kernel": "k64", "wgmma_serialized": False, "spill_stores": 0,
         "spill_loads": 0, "registers": 168},
        {"kernel": "k128", "wgmma_serialized": True, "spill_stores": 8,
         "spill_loads": 4, "registers": 232}]


def test_kernel_sources_are_in_the_package():
    for name in kernels.LIBRARIES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    for src in kernels.CSRC.glob("*.cu"):
        assert src.stem in kernels.LIBRARIES, src.name


def test_kernels_are_traceable_custom_ops():
    """K1, K3 and K4 are ``torch.library`` ops in one namespace, with a CPU
    implementation (the plain version), a CUDA one (the kernel) and a fake
    one; the public wrappers call them.  K2 stays a plain wrapper: no
    exported graph reaches it (the graph ends at ``pred``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops = {"fused_token_transformer": transformer_cuda.token_transformer_op,
           "fused_cem": cem_cuda.cem_op,
           "fused_gpt_merge": fusion_cuda.gpt_merge_op}
    for name, op in ops.items():
        qual = f"{kernels.OPS}::{name}"
        assert op._qualname == qual
        assert getattr(torch.ops.mmidet, name).default is not None
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key)
    assert not hasattr(torch.ops.mmidet, "nms_greedy")
    # the fake implementation gives the kernel's output on (fake) CUDA
    # tensors, where no card is needed
    with FakeTensorMode():
        x = torch.empty(2, 8, 8, 3, device="cuda")
        w = [torch.empty(s, device="cuda") for s in (
            (3, 3, 3, 24), (24,), (24,), (24,), (3, 3, 24, 3), (3,))]
        y = cem_cuda.fused_cem(x, *w)
        assert y.shape == x.shape and y.device.type == "cuda"
