"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mmidet_tpu_torch.deploy.serve import DetectionService
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import two_stream_spec
from mmidet_tpu_torch.nn import cem_cuda, fusion_cuda
from mmidet_tpu_torch.nn import transformer_cuda as tc
from mmidet_tpu_torch.nn.fuse import fold_batchnorm
from mmidet_tpu_torch.ops import nms_cuda
from mmidet_tpu_torch.tools import probe_cem_fb, probe_cem_r3, probe_igemm

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
# the ragged GEMM edges and the narrow-head load; batch 1 (M = 128) is what
# DetectionService sends; d = 2048 with 16 heads takes the LayerNorm for
# rows wider than 1024.  Gate: max error within 2% of the output's range
# (bf16 roundings compound over the layers).
@pytest.mark.parametrize("d,b,heads", [
    (16, 4, 8), (64, 4, 8), (96, 4, 8), (128, 4, 8), (512, 4, 8),
    (1024, 4, 8), (1024, 1, 8), (2048, 1, 16)])
def test_token_transformer_kernel_matches_plain(cuda, d, b, heads):
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(b, 128, d, generator=gen).to(cuda, torch.bfloat16)
    st = _stack(d, 2, gen, cuda)
    before = tc.fused_token_transformer.launches
    got = tc.fused_token_transformer(x, st, heads).float()
    ref = tc.fused_token_transformer_reference(x, st, heads).float()
    torch.cuda.synchronize()
    assert tc.fused_token_transformer.launches == before + 1
    assert float((got - ref).abs().max()) <= 0.02 * float(ref.abs().max())


# The layer GEMM alone, each epilogue, the residual one in place as the
# layers run it.  (M, N, K): batch 1 at d = 96 (N and K ragged against the
# 64-wide tiles) and its qkv at d = 1024; the m scale's qkv, the flagship's
# w2 and w1 at batch 16; N = K = 16, less than one K tile.  Gate: 1e-2 of
# the output's range (sums in another order flip single bf16 roundings,
# 2^-8 of a value).
@pytest.mark.parametrize("m,n,k", [(128, 96, 96), (128, 3072, 1024),
                                   (2048, 288, 96), (2048, 1024, 4096),
                                   (2048, 4096, 1024), (256, 16, 16)])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_layer_gemm_matches_plain(cuda, m, n, k, epilogue):
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(n, k, generator=gen) / k ** 0.5).to(cuda, torch.bfloat16)
    bias = (0.2 * torch.randn(n, generator=gen)).to(cuda)
    res = None
    if epilogue == "residual":
        res = torch.randn(m, n, generator=gen).to(cuda, torch.bfloat16)
    want = tc.layer_gemm_reference(a, w, bias, epilogue, res).float()
    before = tc.layer_gemm.launches
    got = tc.layer_gemm(a, w, bias, epilogue, res)
    torch.cuda.synchronize()
    assert tc.layer_gemm.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert res is None or got is res
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max())


# Every tile the kernel offers (csrc/token_transformer.cuh's kTiles) with
# every epilogue, on a shape ragged against all of them (N = 288, K = 96),
# whichever tile the layers would pick.
@pytest.mark.parametrize("tile", range(5))
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_layer_gemm_every_tile_matches_plain(cuda, tile, epilogue):
    from mmidet_tpu_torch import kernels
    m, n, k = 320, 288, 96
    gen = torch.Generator().manual_seed(tile)
    a = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(n, k, generator=gen) / k ** 0.5).to(cuda, torch.bfloat16)
    bias = (0.2 * torch.randn(n, generator=gen)).to(cuda)
    c = torch.randn(m, n, generator=gen).to(cuda, torch.bfloat16)
    res = c.clone() if epilogue == "residual" else None
    want = tc.layer_gemm_reference(a, w, bias, epilogue, res).float()
    fn = kernels.load("layer_gemm_tile")
    kernels.check("layer_gemm_tile", fn(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), c.data_ptr(),
        c.data_ptr(), m, n, k, tc.EPILOGUES[epilogue], tile,
        kernels.stream_ptr(a)))
    torch.cuda.synchronize()
    err = float((c.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max())


def test_layer_gemm_rejects_bad_operands(cuda):
    a = torch.zeros(128, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(96, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(96, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tc.layer_gemm(a[:, :60], w[:, :60], b, "bias")
    with pytest.raises(ValueError, match="residual must be"):
        tc.layer_gemm(a, w, b, "residual", torch.zeros(128, 96, device=cuda))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc.layer_gemm(a.flatten()[4:4 + 128 * 56].view(128, 56), w[:, :56],
                      b, "bias")
    from mmidet_tpu_torch import kernels
    fn = kernels.load("layer_gemm_tile")
    out = torch.empty(128, 96, device=cuda, dtype=torch.bfloat16)
    for epilogue, tile in ((0, 5), (3, 0)):
        err = fn(a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 out.data_ptr(), 128, 96, 64, epilogue, tile,
                 kernels.stream_ptr(a))
        with pytest.raises(RuntimeError, match="unknown epilogue or tile"):
            kernels.check("layer_gemm_tile", err)


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


def _special_pool(kind, k, gen):
    """One image's pool of the named kind, on the CPU."""
    boxes, scores = _pool(gen, 1, k)
    if kind == "tie_heavy":  # scores on a 1/16 grid: many equal
        scores = torch.where(scores > -torch.inf,
                             torch.floor(scores * 16) / 16, scores)
    elif kind == "sorted":  # descending, as torch.topk hands it on
        scores, order = torch.sort(scores, 1, descending=True)
        boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    elif kind == "duplicates":  # every box twice (IoU = 1), zero areas
        half = (k + 1) // 2
        boxes = torch.cat([boxes[:, :half], boxes[:, :k - half]], 1)
        boxes[:, ::7, 2] = boxes[:, ::7, 0]
    elif kind == "few_survive":  # large boxes near the centre, one class
        xy = 280 + torch.rand(1, k, 2, generator=gen) * 80
        boxes = torch.cat([xy, xy + 300 + torch.rand(1, k, 2, generator=gen)
                           * 40], -1)
    return boxes, scores


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expected_scan():
    """``chip_smoke.py:expected_scan``: the kernel's count of its scan, as
    greedy's answer determines it."""
    return _chip_smoke().expected_scan


# The kernel sorts each pool, then scans it in chunks of 64: ties, pools
# handed on sorted, duplicate boxes, pools of which few boxes survive, pools
# of one slot and at either side of a chunk, and max_det = 1 must all give
# greedy's indices exactly, and the kernel's count of its scan (rounds,
# consumed, kept, valid) must be the one greedy's answer determines.
@pytest.mark.parametrize("kind,k,max_det", [
    ("tie_heavy", 4096, 300), ("tie_heavy", 700, 1000), ("sorted", 4096, 300),
    ("duplicates", 4096, 300), ("duplicates", 130, 200),
    ("random", 1, 300), ("random", 63, 300), ("random", 64, 300),
    ("random", 65, 300), ("random", 4095, 300), ("random", 4096, 1),
    ("tie_heavy", 65, 1), ("few_survive", 4096, 300),
    ("few_survive", 1000, 300)])
def test_nms_kernel_special_pools_match_plain(cuda, kind, k, max_det):
    gen = torch.Generator().manual_seed(k + max_det)
    pools = [_special_pool(kind, k, gen) for _ in range(3)]
    b = torch.cat([p[0] for p in pools]).to(cuda)
    s = torch.cat([p[1] for p in pools]).to(cuda)
    before = nms_cuda.nms_greedy.launches
    stats = torch.full((3, 4), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, max_det, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, max_det)
    assert nms_cuda.nms_greedy.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, _expected_scan()(torch, s, *want, max_det))
    if kind == "few_survive":  # the scan walks every valid candidate
        assert (want[1].sum(1) < max_det).all()
        assert torch.equal(stats[:, 1], stats[:, 3])


def test_nms_kernel_rejects_large_pools(cuda):
    with pytest.raises(ValueError, match="K <= 30000"):
        nms_cuda.nms_greedy(torch.zeros(1, 30001, 4, device=cuda),
                            torch.zeros(1, 30001, device=cuda))


# The large-pool form (K > 4096: a cluster of eight blocks per image, each
# sorting a run of 4096, merged by rank) on chip_smoke.py's pools at the
# evaluator's pre_nms_topk, 30000, and at pool sizes that leave runs
# partly or wholly padding: greedy's indices exactly, and the kernel's count
# of its scan as greedy's answer determines it.
@pytest.mark.parametrize("pool,k", [
    ("unsorted", 30000), ("tie_heavy", 30000), ("topk_sorted", 30000),
    ("duplicates", 30000), ("few_survive", 30000), ("unsorted", 4097),
    ("unsorted", 12289)])
def test_nms_kernel_large_pools_match_plain(cuda, pool, k):
    smoke = _chip_smoke()
    boxes, scores = smoke.nms_pool(torch, 2, k,
                                   torch.Generator().manual_seed(k))
    b, s = smoke.k2_pools(torch, boxes.to(cuda), scores.to(cuda))[pool]
    before = nms_cuda.nms_greedy.launches_large
    stats = torch.full((2, 4), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, 300, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, 300)
    torch.cuda.synchronize()
    assert nms_cuda.nms_greedy.launches_large == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, smoke.expected_scan(torch, s, *want, 300))
    if pool == "few_survive":  # the scan walks every valid candidate
        assert torch.equal(stats[:, 1], stats[:, 3])
        assert (stats[:, 0] > 64).all()


def test_nms_kernel_rejects_bad_stats(cuda):
    b, s = torch.zeros(2, 64, 4, device=cuda), torch.zeros(2, 64, device=cuda)
    for bad in (torch.zeros(2, 4, dtype=torch.int64, device=cuda),
                torch.zeros(2, 3, dtype=torch.int32, device=cuda),
                torch.zeros(2, 4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="stats must be"):
            nms_cuda.nms_greedy(b, s, stats=bad)


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


def _cem_params(gen, device):
    """Random fused-CEM parameters, JAX layouts (HWIO); biases nonzero so
    that zero padding against bias shows at the borders."""
    def rn(*shape, scale, base=0.0):
        return (base + scale * torch.randn(*shape, generator=gen)).to(device)
    return (rn(3, 3, 3, 24, scale=0.3), rn(24, scale=0.5),
            rn(24, scale=0.4, base=1.0), rn(24, scale=0.5),
            rn(3, 3, 24, 3, scale=0.2), rn(3, scale=0.5))


# shapes that cross tile borders (the bf16 form's 40x32 tiles, the f32
# form's 16x32): one tile of either exactly, two by two tiles, one row or
# column past a tile and one short of it in both directions, ragged in both,
# narrower and lower than one tile, a single pixel; widths whose rows are
# not a whole number of 16-byte chunks (W = 33, 7, 1)
@pytest.mark.parametrize("shape", [(2, 16, 32, 3), (2, 40, 32, 3),
                                   (2, 80, 64, 3), (1, 41, 33, 3),
                                   (2, 39, 31, 3), (1, 81, 97, 3),
                                   (2, 80, 80, 3), (1, 37, 53, 3),
                                   (2, 352, 608, 3), (3, 5, 7, 3),
                                   (1, 1, 1, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cem_kernel_matches_plain(cuda, shape, dtype):
    """f32: sums differ in order only (1e-4 of the output range).  bf16:
    five rounding points, one flipped rounding of y + e moves z by one
    bf16 step (2^-8 relative), so 2% of the output range."""
    gen = torch.Generator().manual_seed(shape[1])
    p = _cem_params(gen, cuda)
    x = torch.randn(*shape, generator=gen).to(cuda, dtype)
    before = cem_cuda.fused_cem.launches
    got = cem_cuda.fused_cem(x, *p).float()
    ref = cem_cuda.fused_cem_reference(x, *p).float()
    torch.cuda.synchronize()
    assert cem_cuda.fused_cem.launches == before + 1
    assert got.shape == x.shape
    tol = 1e-4 if dtype == torch.float32 else 0.02
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_cem_kernel_takes_an_unaligned_view(cuda):
    """The bf16 kernel reads x in aligned 16-byte chunks: a view that starts
    off a 16-byte boundary (the second image of a 5x7 batch, 210 bytes in)
    gives what the same values give from their own storage."""
    p = _cem_params(torch.Generator().manual_seed(2), cuda)
    x = torch.randn(3, 5, 7, 3, generator=torch.Generator().manual_seed(3)
                    ).to(cuda, torch.bfloat16)
    view = x[1:]
    assert view.data_ptr() % 16
    got = cem_cuda.fused_cem(view, *p)
    torch.cuda.synchronize()
    assert torch.equal(got, cem_cuda.fused_cem(view.clone(), *p))
    assert torch.equal(x[1:], view)  # the input is untouched


def test_cem_kernel_rejects_bad_inputs(cuda):
    p = _cem_params(torch.Generator().manual_seed(0), cuda)
    with pytest.raises(ValueError, match="takes \\(B, H, W, 3\\)"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 4, device=cuda), *p)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3, device=cuda,
                                       dtype=torch.float16), *p)
    with pytest.raises(ValueError, match="w2 has shape"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3, device=cuda),
                           p[0][..., :8], *p[1:])


def _merge_inputs(d, hw, b, L, gen, device, gated):
    rgb = torch.randn(b, *hw, d, generator=gen).to(device, torch.bfloat16)
    ir = (0.3 * torch.randn(b, *hw, d, generator=gen) + 0.2).to(
        device, torch.bfloat16)
    st = _stack(d, L, gen, device)
    pos = (0.2 * torch.randn(1, 128, d, generator=gen)).to(device)
    lns = (1 + 0.2 * torch.randn(d, generator=gen)).to(device)
    lnb = (0.2 * torch.randn(d, generator=gen)).to(device)
    gate = None
    if gated:
        gate = {"g1": (torch.randn(d, 8, generator=gen) / d ** 0.5).to(
                    device),
                "g2": (torch.randn(8, d, generator=gen) / 8 ** 0.5).to(
                    device)}
    return rgb, ir, st, pos, lns, lnb, 8, gate


# d = 128..1024 as the flagship's levels; 20x20 has overlapping pool
# windows; 5x5 and 3x11 are maps the TPU kernel refuses (H*W % 8 != 0) and
# this one runs; 1x1 pools and upsamples a single pixel.  Gate: max error
# within 2% of the merged streams' range, K1's gate (the merge adds one
# more bf16 rounding to K1's compounding ones).
# Batch 1 at the flagship's widest level: one image pair per request.
@pytest.mark.parametrize("d,hw,gated,b", [
    (128, (40, 40), True, 3), (128, (24, 24), False, 3),
    (256, (20, 20), False, 3), (512, (16, 16), True, 3),
    (1024, (20, 20), False, 3), (64, (5, 5), False, 3),
    (64, (3, 11), True, 3), (64, (1, 1), False, 3), (96, (33, 17), True, 3),
    (1024, (20, 20), False, 1)])
def test_merge_kernel_matches_plain(cuda, d, hw, gated, b):
    gen = torch.Generator().manual_seed(d + hw[0])
    args = _merge_inputs(d, hw, b, 2, gen, cuda, gated)
    before = fusion_cuda.fused_gpt_merge.launches
    got = fusion_cuda.fused_gpt_merge(*args)
    ref = fusion_cuda.fused_gpt_merge_reference(*args)
    torch.cuda.synchronize()
    assert fusion_cuda.fused_gpt_merge.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        err = float((g.float() - r.float()).abs().max())
        assert err <= 0.02 * float(r.float().abs().max())


def test_merge_kernel_rejects_bad_shapes(cuda):
    args = list(_merge_inputs(64, (8, 8), 1, 1,
                              torch.Generator().manual_seed(0), cuda, False))
    with pytest.raises(ValueError, match="share one"):
        fusion_cuda.fused_gpt_merge(args[0], args[1][:, :4], *args[2:])
    bad = torch.zeros(1, 8, 8, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="merge kernel takes"):
        fusion_cuda.fused_gpt_merge(bad, bad, *args[2:])
    wide = torch.zeros(1, 8, 8, 1280, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="merge kernel takes"):
        fusion_cuda.fused_gpt_merge(wide, wide, *args[2:])


def test_fourier_model_kernel_path_matches_plain_path(cuda):
    """The l-scale fourier grammar at small depth in f32, CEM and merge
    kernels on the card against their plain versions on the CPU (the merge
    rounds to bf16 inside on both)."""
    torch.manual_seed(0)
    model = fold_batchnorm(TwoStreamDetector(
        two_stream_spec("l", "fourier", nc=2, fusion_layers=2),
        kernel_cem=True, kernel_merge=True)).eval()
    gen = torch.Generator().manual_seed(1)
    rgb, ir = torch.rand(2, 64, 64, 3, generator=gen), torch.rand(
        2, 64, 64, 3, generator=gen)
    with torch.no_grad():
        want = model(rgb, ir)["pred"]
        before = (cem_cuda.fused_cem.launches,
                  fusion_cuda.fused_gpt_merge.launches,
                  tc.fused_token_transformer.launches)
        got = model.to(cuda)(rgb.to(cuda), ir.to(cuda))["pred"].cpu()
    assert (cem_cuda.fused_cem.launches,
            fusion_cuda.fused_gpt_merge.launches,
            tc.fused_token_transformer.launches) == (
                before[0] + 1, before[1] + 4, before[2])
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_modules_rebuild_their_kernel_weights_when_a_parameter_changes(cuda):
    """The CEM's packed buffer and the fusion's prepared stack are kept
    between forwards and follow an in-place write, a cast and a move."""
    from mmidet_tpu_torch.nn.cem import ContourEnhance
    from mmidet_tpu_torch.nn.fusion import PatternFusion
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    cem = ContourEnhance(3, fused=True, use_kernel=True).eval().to(cuda)
    fus = PatternFusion(64, n_layer=2, merge_kernel=True).eval().to(cuda)
    x = torch.rand(2, 3, 24, 40, generator=gen).to(cuda)
    rgb = torch.randn(2, 64, 12, 12, generator=gen).to(cuda)
    ir = torch.randn(2, 64, 12, 12, generator=gen).to(cuda)

    def fresh():
        """The wrappers on the parameters as they are now, nothing kept."""
        c = cem_cuda.fused_cem(
            x.permute(0, 2, 3, 1).to(cem.conv2.weight.dtype),
            cem.conv2.weight.permute(2, 3, 1, 0), cem.conv2.bias,
            cem.sobel.sobel_factor.flatten(), cem.sobel.bias,
            cem.conv3.weight.permute(2, 3, 1, 0), cem.conv3.bias)
        gate = {"g1": fus.conv1.weight.flatten(1).T,
                "g2": fus.conv2.weight.flatten(1).T}
        f = fusion_cuda.fused_gpt_merge(
            rgb.permute(0, 2, 3, 1), ir.permute(0, 2, 3, 1),
            tc.stack_block_params(fus.trans_blocks), fus.pos_emb,
            fus.ln_f.weight, fus.ln_f.bias, 8, gate)
        return c.permute(0, 3, 1, 2).float(), f[0].permute(0, 3, 1, 2).float()

    def kept(dtype):
        return (cem(x.to(dtype)).float(),
                fus(rgb.to(dtype), ir.to(dtype))[0].float())

    with torch.no_grad():
        first = kept(torch.float32)
        pack, stack = cem._pack, fus._stack
        again = kept(torch.float32)
        assert cem._pack is pack and fus._stack is stack
        for a, b, c in zip(first, again, fresh()):
            assert torch.equal(a, b) and torch.equal(a, c)
        cem.conv2.bias.add_(0.5)
        fus.trans_blocks[1].mlp[2].bias.add_(0.5)
        changed = kept(torch.float32)
        assert cem._pack is not pack and fus._stack is not stack
        for a, b, c in zip(first, changed, fresh()):
            assert not torch.equal(a, b) and torch.equal(b, c)
        cem.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
        assert torch.equal(cem(x).float(), fresh()[0])


def test_cem_kernel_rejects_a_bad_pack(cuda):
    p = _cem_params(torch.Generator().manual_seed(0), cuda)
    x = torch.zeros(1, 8, 8, 3, device=cuda)
    good = cem_cuda.pack_cem_weights(*p, x.dtype)
    assert torch.equal(cem_cuda.fused_cem(x, *p, pack=good),
                       cem_cuda.fused_cem(x, *p))
    with pytest.raises(ValueError, match="pack must be"):
        cem_cuda.fused_cem(x, *p, pack=good[:-1])
    with pytest.raises(ValueError, match="pack must be"):
        cem_cuda.fused_cem(x, *p, pack=good.cpu())


# P1, the conv chain, at both channel counts on an odd image that crosses
# the 16x16 tiles' borders, images smaller than a tile and than the input's
# 20x20 TMA box; gate: 2% of max |plain| (one flipped bf16 rounding of the
# intermediate, spread by the second conv).
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("b,h,w", [(2, 37, 45), (1, 9, 5), (1, 1, 1),
                                   (3, 2, 17)])
def test_conv_chain_kernel_matches_plain(cuda, c, b, h, w):
    before = probe_igemm.conv_chain.launches
    rec = probe_igemm.check(b, h, w, c, cuda, seed=h)
    assert probe_igemm.conv_chain.launches == before + 1
    assert rec["ok"] and rec["max_abs_ref"] > 0


# More tiles than persistent blocks: each block walks several tiles, and the
# next tile's input loads under this one across images; and a batch past
# the old grid's 65535 images.
@pytest.mark.parametrize("c,b,h,w", [(128, 40, 64, 64), (128, 5, 160, 160),
                                     (64, 40, 64, 64), (64, 70000, 1, 1)])
def test_conv_chain_kernel_walks_many_tiles(cuda, c, b, h, w):
    cfg = probe_igemm.launch_config(b, h, w, c)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cfg["tiles"] == probe_igemm.tiles(b, h, w) > cfg["blocks"]
    assert cfg["blocks"] == sms and cfg["smem_bytes"] <= 232448
    before = probe_igemm.conv_chain.launches
    rec = probe_igemm.check(b, h, w, c, cuda, seed=b)
    assert probe_igemm.conv_chain.launches == before + 1
    assert rec["ok"] and rec["max_abs_ref"] > 0


# P1's SiLU element by element.  Identity weights at the centre tap pass
# each channel straight through both convs (one product by 1, so the sums
# are exact): out = bf16(silu(bf16(silu(x)))).  x runs over every bf16
# value in [-12, 6] of magnitude 2^-6 or more, and 0, -90 and -100, where
# exp(-x) overflows f32.  A value whose SiLU, or its SiLU's SiLU, lies
# within 2^-16 (relative) of a bf16 rounding tie is left out: there an f32
# SiLU within its own error (about 1e-6 here) may round either way.  Gate:
# one bf16 step of |plain| per element, 0 where plain is 0.
def _silu_tie_distance(s):
    """|s|'s relative distance to the nearest bf16 rounding tie (f64)."""
    _, e = torch.frexp(s)
    step = torch.ldexp(torch.ones_like(s), e - 8)
    q = s.abs() / step
    d = (q - q.floor() - 0.5).abs() * step / s.abs()
    return torch.where(s == 0, torch.inf, d)


def _silu_case(c, device):
    v = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).double()
    v = v[torch.isfinite(v) & (v >= -12) & (v <= 6) & (v.abs() >= 2 ** -6)]
    v = torch.cat([v, torch.tensor([0.0, -90.0, -100.0], dtype=v.dtype)])

    def silu(s):
        return s / (1 + torch.exp(-s))
    y = silu(v).to(torch.bfloat16).double()
    v = v[(_silu_tie_distance(silu(v)) >= 2 ** -16)
          & (_silu_tie_distance(silu(y)) >= 2 ** -16)]
    v = v[torch.randperm(v.numel(), generator=torch.Generator().manual_seed(
        c))]
    side = -(-v.numel() // (6 * c))  # a 6 x side image holds every value
    x = v.repeat(2)[:6 * side * c].reshape(1, 6, side, c)
    w = torch.zeros(3, 3, c, c, dtype=torch.float64)
    w[1, 1] = torch.eye(c, dtype=torch.float64)
    return (x.to(device, torch.bfloat16), w.to(device, torch.bfloat16),
            v.numel())


def _silu_gate(got, want):
    """Per element: |got - want| within one bf16 step of |want|."""
    got, want = got.double(), want.double()
    _, e = torch.frexp(want)
    step = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                   e - 8))
    return (got - want).abs() <= step


@pytest.mark.parametrize("c", [64, 128])
def test_conv_chain_kernel_silu_per_element(cuda, c):
    x, w, n = _silu_case(c, cuda)
    assert n > 2000
    got = probe_igemm.conv_chain(x, w, w)
    want = probe_igemm.conv_chain_reference(x, w, w)
    ok = _silu_gate(got, want)
    bad = (~ok).nonzero()[:5].tolist()
    assert bool(ok.all()), (
        f"{int((~ok).sum())} of {ok.numel()} elements past one bf16 step, "
        f"e.g. x {[float(x[tuple(i)]) for i in bad]}: got "
        f"{[float(got[tuple(i)]) for i in bad]}, want "
        f"{[float(want[tuple(i)]) for i in bad]}")


# Repeated launches at the probe's full size give the same output bit for
# bit: the kernel is deterministic, so an intermittent race (one seen at
# this size only on repeated launches) shows as a difference.
@pytest.mark.parametrize("c", [64, 128])
def test_conv_chain_kernel_repeats_bit_for_bit(cuda, c):
    x, w1, w2 = probe_igemm.inputs(128, 160, 160, c, cuda)
    prep = (probe_igemm.prepare_weights(w1), probe_igemm.prepare_weights(w2))
    first = probe_igemm.conv_chain(x, w1, w2, prep)
    for i in range(10):
        again = probe_igemm.conv_chain(x, w1, w2, prep)
        diff = int((again != first).sum())
        assert diff == 0, f"launch {i + 1}: {diff} elements differ"


def test_conv_chain_kernel_builds_without_spills_or_serial_wgmma(cuda):
    probe_igemm.launch_config(1, 1, 1, 64)  # builds and loads the library
    report = probe_igemm.kernels.ptxas_report("conv_chain")
    assert len(report) == 2  # C = 64 and C = 128
    assert all(r["spill_stores"] == r["spill_loads"] == 0
               and not r["wgmma_serialized"] for r in report)


def test_conv_chain_kernel_rejects_bad_inputs(cuda):
    w = torch.zeros(3, 3, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="takes bf16"):
        probe_igemm.conv_chain(torch.zeros(1, 8, 8, 64, device=cuda), w, w)
    with pytest.raises(ValueError, match="prepared weights"):
        probe_igemm.conv_chain(
            torch.zeros(1, 8, 8, 64, device=cuda, dtype=torch.bfloat16), w, w,
            prepared=(w, w))


# P2 and P3: each probe body against its plain version (P2 one bf16 step,
# P3 1e-5 of max |plain|), one launch each.
@pytest.mark.parametrize("body", probe_cem_r3.BODIES)
def test_halo_sum_kernel_matches_plain(cuda, body):
    t = probe_cem_r3.inputs(body, cuda, seed=3)
    before = probe_cem_r3.halo_sum.launches
    got = probe_cem_r3.halo_sum(body, t)
    want = probe_cem_r3.halo_sum_reference(body, t)
    torch.cuda.synchronize()
    assert probe_cem_r3.halo_sum.launches == before + 1
    assert float((got - want).abs().max()) <= 2.0 ** -8 * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("body", probe_cem_fb.BODIES)
def test_lane_matmul_kernel_matches_plain(cuda, body):
    a, w = probe_cem_fb.inputs(body, cuda, seed=3)
    before = probe_cem_fb.lane_matmul.launches
    got = probe_cem_fb.lane_matmul(body, a, w)
    want = probe_cem_fb.lane_matmul_reference(body, a, w)
    torch.cuda.synchronize()
    assert probe_cem_fb.lane_matmul.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
