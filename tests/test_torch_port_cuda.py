"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mmidet_tpu_torch.deploy.serve import DetectionService
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.nn import transformer_cuda as tc
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.ops import nms_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(d, L, gen, device):
    """Torch Linear layout (L, out, in); LN and bias vectors randomised."""
    def mat(o, i):
        return (torch.randn(L, o, i, generator=gen) / i ** 0.5).to(device)

    def vec(n, base=0.0):
        return (base + 0.2 * torch.randn(L, n, generator=gen)).to(device)
    return {"ln1_scale": vec(d, 1.0), "ln1_bias": vec(d),
            "wq": mat(d, d), "wk": mat(d, d), "wv": mat(d, d),
            "bq": vec(d), "bk": vec(d), "bv": vec(d),
            "wo": mat(d, d), "bo": vec(d),
            "ln2_scale": vec(d, 1.0), "ln2_bias": vec(d),
            "w1": mat(4 * d, d), "b1": vec(4 * d),
            "w2": mat(d, 4 * d), "b2": vec(d)}


# d = 1024 is the flagship's widest level (dk = 128, the attention block's
# largest shared-memory footprint); d = 16 and 96 (tiny and m scales) take
# the ragged GEMM edges and the narrow-head load.  Gate: max error within
# 2% of the output's range (bf16 roundings compound over the layers).
@pytest.mark.parametrize("d", [16, 64, 96, 128, 512, 1024])
def test_token_transformer_kernel_matches_plain(cuda, d):
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(4, 128, d, generator=gen).to(cuda, torch.bfloat16)
    st = _stack(d, 2, gen, cuda)
    before = tc.fused_token_transformer.launches
    got = tc.fused_token_transformer(x, st).float()
    ref = tc.fused_token_transformer_reference(x, st).float()
    torch.cuda.synchronize()
    assert tc.fused_token_transformer.launches == before + 1
    assert float((got - ref).abs().max()) <= 0.02 * float(ref.abs().max())


def test_token_transformer_kernel_rejects_bad_shapes(cuda):
    st = _stack(64, 1, torch.Generator().manual_seed(0), cuda)
    with pytest.raises(ValueError, match="kernel takes"):
        tc.fused_token_transformer(torch.zeros(2, 64, 64, device=cuda), st)
    with pytest.raises(ValueError, match="kernel takes"):
        tc.fused_token_transformer(torch.zeros(2, 128, 36, device=cuda), st)
    with pytest.raises(ValueError, match="kernel takes"):
        tc.fused_token_transformer(torch.zeros(2, 128, 1280, device=cuda),
                                   st)


def _pool(gen, b, k):
    xy = torch.rand(b, k, 2, generator=gen) * 640
    boxes = torch.cat([xy, xy + 4 + torch.rand(b, k, 2, generator=gen) * 160],
                      -1)
    boxes = boxes + torch.randint(0, 6, (b, k, 1), generator=gen) * 4096.0
    scores = (torch.stack([torch.randperm(k, generator=gen)
                           for _ in range(b)]).float() + 1) / (k + 1)
    scores[torch.rand(b, k, generator=gen) < 0.1] = -torch.inf
    return boxes, scores


@pytest.mark.parametrize("k,max_det", [(4096, 300), (1000, 300), (300, 400),
                                       (128, 10)])
def test_nms_kernel_matches_plain(cuda, k, max_det):
    boxes, scores = _pool(torch.Generator().manual_seed(k), 3, k)
    scores[2] = -torch.inf  # an empty pool
    b, s = boxes.to(cuda), scores.to(cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, max_det)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, max_det)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[1][2].any()


def test_nms_kernel_rejects_large_pools(cuda):
    with pytest.raises(ValueError, match="K <= 4096"):
        nms_cuda.nms_greedy(torch.zeros(1, 4097, 4, device=cuda),
                            torch.zeros(1, 4097, device=cuda))


def test_tiny_model_kernel_path_matches_plain_path(cuda):
    """The tiny gpt4 model in f32, kernels on the card against the plain
    versions on the CPU (bf16 inside the token transformer on both)."""
    torch.manual_seed(0)
    model = fold_batchnorm(TwoStreamDetector(
        two_stream_spec("t", "gpt4", fusion_layers=2),
        kernel_fusion=True)).eval()
    gen = torch.Generator().manual_seed(1)
    rgb, ir = torch.rand(2, 64, 64, 3, generator=gen), torch.rand(
        2, 64, 64, 3, generator=gen)
    with torch.no_grad():
        want = model(rgb, ir)["pred"]
        before = tc.fused_token_transformer.launches
        got = model.to(cuda)(rgb.to(cuda), ir.to(cuda))["pred"].cpu()
    assert tc.fused_token_transformer.launches == before + 4
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_detection_service_defaults_to_the_card(cuda):
    import io

    from PIL import Image
    torch.manual_seed(0)
    model = fold_batchnorm(TwoStreamDetector(
        two_stream_spec("t", "gpt4", fusion_layers=1),
        kernel_fusion=True)).eval()
    svc = DetectionService(model, [str(i) for i in range(6)], img_size=64,
                           conf_thres=1e-4)
    assert next(svc.model.parameters()).device.type == "cuda"
    buf = io.BytesIO()
    Image.fromarray(np.zeros((40, 56, 3), np.uint8)).save(buf, "PNG")
    before = nms_cuda.nms_greedy.launches
    recs = svc.predict(buf.getvalue(), buf.getvalue())
    assert nms_cuda.nms_greedy.launches == before + 1
    assert isinstance(recs, list)
