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


# The kernel sorts each pool, then scans it in windows of 1024 and chunks of
# 64: ties, pools handed on sorted, duplicate boxes, pools of which few
# boxes survive, pools of one slot and at either side of a chunk, and
# max_det = 1 must all give greedy's indices exactly, and the kernel's count
# of its scan (rounds, consumed, kept, valid, path) must be the one greedy's
# answer determines.
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
    stats = torch.full((3, 5), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, max_det, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, max_det)
    assert nms_cuda.nms_greedy.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, _expected_scan()(torch, b, s, *want, max_det,
                                               0.45))
    if kind == "few_survive":  # the scan walks every valid candidate
        assert (want[1].sum(1) < max_det).all()
        assert torch.equal(stats[:, 1], stats[:, 3])


def test_nms_kernel_rejects_large_pools(cuda):
    with pytest.raises(ValueError, match="K <= 30000"):
        nms_cuda.nms_greedy(torch.zeros(1, 30001, 4, device=cuda),
                            torch.zeros(1, 30001, device=cuda))


# The large-pool form (K > 4096: a cluster of eight blocks per image) on
# chip_smoke.py's pools at the evaluator's pre_nms_topk, 30000, and at pool
# sizes that leave runs partly or wholly padding: greedy's indices exactly,
# and the kernel's count of its scan, its path included, as greedy's answer
# determines it.
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
    stats = torch.full((2, 5), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, 300, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, 300)
    torch.cuda.synchronize()
    assert nms_cuda.nms_greedy.launches_large == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, smoke.expected_scan(torch, b, s, *want, 300,
                                                  0.45))
    if pool == "few_survive":  # the scan walks every valid candidate
        assert torch.equal(stats[:, 1], stats[:, 3])
        assert (stats[:, 0] > stats[:, 3] // nms_cuda.WINDOW).all()


# Each path of the large form: pools in order as torch.topk hands them on
# (path 1) at 4097, 12289 and 30000 slots, of which few survive too; an
# unsorted pool whose selection the scan does not use up (path 2); an
# unsorted pool of few survivors, whose selection it uses up, so that the
# cluster sorts the whole pool and the scan goes on from there (path 3);
# and scores all equal, where only the index digits separate the keys.
@pytest.mark.parametrize("pool,k,path", [
    ("topk_sorted", 4097, 1), ("topk_sorted", 12289, 1),
    ("topk_sorted", 30000, 1), ("few_survive_sorted", 30000, 1),
    ("unsorted", 30000, 2), ("few_survive", 30000, 3),
    ("all_equal", 30000, 2), ("all_equal_in_order", 30000, 1)])
def test_nms_kernel_large_pool_paths(cuda, pool, k, path):
    smoke = _chip_smoke()
    boxes, scores = smoke.nms_pool(torch, 2, k,
                                   torch.Generator().manual_seed(k + path))
    if pool.startswith("all_equal"):
        b, s = boxes, torch.where(scores > -torch.inf, 0.5, scores)
        if pool == "all_equal_in_order":
            s = torch.full_like(scores, 0.5)
    else:
        b, s = smoke.k2_pools(torch, boxes, scores)[pool]
    b, s = b.to(cuda), s.to(cuda)
    stats = torch.full((2, 5), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, 300, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, 300)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, smoke.expected_scan(torch, b, s, *want, 300,
                                                  0.45))
    assert (stats[:, 4] == path).all()


@pytest.mark.parametrize("max_det", [1024, 1025, 3000])
def test_nms_kernel_large_pool_many_kept(cuda, max_det):
    """More kept boxes than the large form holds in shared memory (1024)
    go to its workspace; the scan then filters windows against up to
    max_det kept boxes and goes past the selection (path 3)."""
    smoke = _chip_smoke()
    boxes, scores = smoke.nms_pool(torch, 2, 12289,
                                   torch.Generator().manual_seed(max_det))
    b, s = boxes.to(cuda), scores.to(cuda)
    stats = torch.full((2, 5), -1, dtype=torch.int32, device=cuda)
    got = nms_cuda.nms_greedy(b, s, 0.45, max_det, stats=stats)
    want = nms_cuda.nms_greedy_reference(b, s, 0.45, max_det)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats, smoke.expected_scan(torch, b, s, *want,
                                                  max_det, 0.45))
    assert (stats[:, 2] > 1000).all()
    assert (stats[:, 4] == nms_cuda.PATH_CLUSTER_SORT).all()


def test_nms_kernel_rejects_bad_stats(cuda):
    b, s = torch.zeros(2, 64, 4, device=cuda), torch.zeros(2, 64, device=cuda)
    for bad in (torch.zeros(2, 5, dtype=torch.int64, device=cuda),
                torch.zeros(2, 4, dtype=torch.int32, device=cuda),
                torch.zeros(2, 5, dtype=torch.int32)):
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


# P2 at shapes with a ragged last warp, rows shorter than a warp and a
# single pixel a row (halo_roll's zeros on both sides).
@pytest.mark.parametrize("r,g", [(1, 1), (7, 33), (80, 80)])
@pytest.mark.parametrize("body", probe_cem_r3.BODIES)
def test_halo_sum_kernel_any_shape(cuda, body, r, g):
    t = probe_cem_r3.inputs(body, cuda, seed=r + g, r=r, g=g)
    got = probe_cem_r3.halo_sum(body, t, r, g)
    want = probe_cem_r3.halo_sum_reference(body, t, r, g)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2.0 ** -8 * max(
        1.0, float(want.abs().max()))
    assert bool((got == got[..., :1]).all())  # one value on all 8 lanes


# P3 at any row count: one row, a ragged last 16-row tile, the probe's 96
# and more tiles than the probe has.
@pytest.mark.parametrize("m", [1, 17, 96, 200])
@pytest.mark.parametrize("body", probe_cem_fb.BODIES)
def test_lane_matmul_kernel_any_rows(cuda, body, m):
    a, w = probe_cem_fb.inputs(body, cuda, seed=m, m=m)
    got = probe_cem_fb.lane_matmul(body, a, w)
    want = probe_cem_fb.lane_matmul_reference(body, a, w)
    torch.cuda.synchronize()
    assert got.shape == (m, 128)
    assert float((got - want).abs().max()) <= probe_cem_fb.TOL * float(
        want.abs().max())


_PROBE_CALLS = [(probe_cem_r3, b) for b in probe_cem_r3.BODIES] + [
    (probe_cem_fb, b) for b in probe_cem_fb.BODIES]


def _probe_call(probe, body, device):
    if probe is probe_cem_r3:
        t = probe.inputs(body, device, seed=4)
        return lambda out=None: probe.halo_sum(body, t, out=out)
    a, w = probe.inputs(body, device, seed=4)
    return lambda out=None: probe.lane_matmul(body, a, w, out=out)


# Ten launches of each body give the first one's output bit for bit.
@pytest.mark.parametrize("probe,body", _PROBE_CALLS)
def test_probe_kernels_repeat_bit_for_bit(cuda, probe, body):
    call = _probe_call(probe, body, cuda)
    first = call()
    for i in range(10):
        diff = int((call() != first).sum())
        assert diff == 0, f"launch {i + 1}: {diff} values differ"


@pytest.mark.parametrize("probe,body", [_PROBE_CALLS[0], _PROBE_CALLS[-1]])
def test_probe_kernels_write_out_in_place_and_check_it(cuda, probe, body):
    call = _probe_call(probe, body, cuda)
    want = call()
    out = torch.full_like(want, float("nan"))
    assert call(out) is out and torch.equal(out, want)
    unaligned = torch.empty(want.numel() + 1, device=cuda)[1:].view(
        want.shape)  # contiguous, 4 bytes past a 16-byte boundary
    for bad in (out.double(), out.cpu(), unaligned, out[:1]):
        with pytest.raises(ValueError, match="out must be"):
            call(bad)


def test_lane_matmul_kernel_runs_on_the_tensor_cores(cuda):
    """P3's products are tensor-core instructions (HMMA or HGMMA in the
    SASS that cuobjdump shows), and no kernel of the library spills."""
    import shutil
    import subprocess
    probe_cem_fb.lane_matmul("slice8", *probe_cem_fb.inputs("slice8", cuda))
    report = probe_cem_fb.kernels.ptxas_report("cem_probes")
    assert report and all(r["spill_stores"] == r["spill_loads"] == 0
                          for r in report), report
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        pytest.skip("no cuobjdump in this CUDA toolkit")
    sass = subprocess.run(
        [tool, "-sass", str(probe_cem_fb.kernels._lib_path("cem_probes"))],
        check=True, capture_output=True, text=True).stdout
    bodies = [f for f in sass.split("Function : ")[1:]
              if f.split(None, 1)[0].find("lane_matmul_kernel") >= 0]
    assert len(bodies) == 3  # one instantiation per body
    assert all("HMMA" in f or "HGMMA" in f for f in bodies)


def test_launch_floor_and_stream_pointer(cuda):
    from mmidet_tpu_torch.tools import timing
    t = torch.zeros(1, device=cuda)
    assert probe_cem_fb.kernels.stream_ptr(t) == torch.cuda.current_stream(
        t.device).cuda_stream
    side = torch.cuda.Stream(t.device)
    with torch.cuda.stream(side):
        assert probe_cem_fb.kernels.stream_ptr(t) == side.cuda_stream
    floor = timing.launch_floor(t)
    rec = timing.timed(floor, floor, None, 0, 0, 1, floor=floor)
    assert len(rec["floor_ms_turns"]) == len(rec["floor_device_ms_turns"]) == 2
    assert 0 < rec["floor_device_ms"] and 0 < rec["floor_ms"]


# ------------------------------------------------------- the evaluation path
def _rect_dataset(root, n=4, w=96, h=72):
    """``n`` landscape pairs with one label each (RectLoader makes
    non-square batches of them)."""
    from PIL import Image

    from mmidet_tpu_torch.data.datasets import PairedDataset
    rng = np.random.default_rng(0)
    for mod in ("rgb", "ir"):
        (root / mod / "images").mkdir(parents=True)
    (root / "rgb" / "labels").mkdir()
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        Image.fromarray(img).save(root / "rgb" / "images" / f"p{i}.png")
        Image.fromarray(255 - img).save(root / "ir" / "images" / f"p{i}.png")
        (root / "rgb" / "labels" / f"p{i}.txt").write_text(
            "%d 0.5 0.5 0.3 0.4\n" % (i % 2))
    return PairedDataset(str(root / "rgb" / "images"),
                         str(root / "ir" / "images"), nc=2)


def _flagship_small(**flags):
    torch.manual_seed(0)
    return fold_batchnorm(TwoStreamDetector(
        two_stream_spec("l", "fourier", nc=2, fusion_layers=2),
        **flags)).eval()


def test_rect_batch_through_the_flagship_kernel_route(cuda, tmp_path):
    """A RectLoader batch that is not square (96x128: P5 3x4, K4's 8x8
    pool windows mixed) through K3 and K4 on the card against their plain
    versions on the CPU, f32, the gate of the square test above."""
    from mmidet_tpu_torch.data.loader import RectLoader
    batch = next(iter(RectLoader(_rect_dataset(tmp_path), 4, img_size=96)))
    assert batch["rgb"].shape[1:3] == (96, 128)
    rgb, ir = (torch.from_numpy(batch[k]).float() / 255.0
               for k in ("rgb", "ir"))
    model = _flagship_small(kernel_cem=True, kernel_merge=True)
    with torch.no_grad():
        want = model(rgb, ir)["pred"]
        before = (cem_cuda.fused_cem.launches,
                  fusion_cuda.fused_gpt_merge.launches)
        got = model.to(cuda)(rgb.to(cuda), ir.to(cuda))["pred"].cpu()
    assert (cem_cuda.fused_cem.launches,
            fusion_cuda.fused_gpt_merge.launches) == (before[0] + 1,
                                                      before[1] + 4)
    assert got.shape == (4, 3 * (12 * 16 + 6 * 8 + 3 * 4), 7)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_evaluate_on_the_card_counts_its_launches(cuda, tmp_path):
    """``evaluate`` with its default device (the card) over two batches at
    320 (K = 12600 candidates: K2's large form) through K3 and K4."""
    from mmidet_tpu_torch.data.loader import PairedLoader
    from mmidet_tpu_torch.eval.evaluator import evaluate
    ds = _rect_dataset(tmp_path)
    model = _flagship_small(kernel_cem=True, kernel_merge=True).to(
        torch.bfloat16)
    before = (cem_cuda.fused_cem.launches,
              fusion_cuda.fused_gpt_merge.launches,
              nms_cuda.nms_greedy.launches,
              nms_cuda.nms_greedy.launches_large)
    res = evaluate(model, PairedLoader(ds, 2, 320, drop_last=False,
                                       scaleup=False), nc=2)
    torch.cuda.synchronize()
    assert next(model.parameters()).device.type == "cuda"
    assert (cem_cuda.fused_cem.launches,
            fusion_cuda.fused_gpt_merge.launches,
            nms_cuda.nms_greedy.launches,
            nms_cuda.nms_greedy.launches_large) == (
                before[0] + 2, before[1] + 8, before[2] + 2, before[3] + 2)
    assert 0.0 <= res.map50 <= 1.0 and res.speed_ms[0] > 0


def test_val_cli_on_the_card(cuda, tmp_path, capsys):
    pytest.importorskip("yaml")
    import json

    from mmidet_tpu_torch.cli import val
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    data = make_synthetic_pair_dataset(str(tmp_path), n=6, img=96)
    before = (tc.fused_token_transformer.launches, cem_cuda.fused_cem.launches,
              nms_cuda.nms_greedy.launches)
    res = val.main(["--cfg", "yolov5s_gpt4", "--data", data,
                    "--batch-size", "2", "--img-size", "64"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"P", "R", "mAP50", "mAP75", "mAP", "speed_ms"}
    assert line["mAP"] == res.map
    # three batches: K1 at the four fusion levels, K3 and K2 once each
    assert (tc.fused_token_transformer.launches, cem_cuda.fused_cem.launches,
            nms_cuda.nms_greedy.launches) == (
                before[0] + 12, before[1] + 3, before[2] + 3)


# --------------------------------------------------------- the training path
def _train_steps(model, batch, steps=2, remat=""):
    """``steps`` f32 micro-steps of the port's train step, accumulate 1
    (the schedule's first steps at lr0 1e-3: the weights' lr 0, then
    lr0), with ``remat``."""
    from mmidet_tpu_torch.train.optimizer import build_optimizer
    from mmidet_tpu_torch.train.schedule import ScheduleConfig
    from mmidet_tpu_torch.train.step import init_state, make_train_step
    from mmidet_tpu_torch.train.trainer import anchors_grid
    sched = ScheduleConfig(epochs=2, steps_per_epoch=2, warmup_epochs=0.0,
                           warmup_floor=1, lr0=1e-3, warmup_bias_lr=1e-3)
    opt, _ = build_optimizer(model, sched, 0.0005, total_batch_size=2,
                             nbs=2)
    state = init_state(model, opt)
    step = make_train_step(anchors_grid(model.spec), remat=remat)
    dev = next(model.parameters()).device
    losses = [step(state, {k: v.to(dev) for k, v in batch.items()})
              for _ in range(steps)]
    return state, [{k: float(v) for k, v in m.items()} for m in losses]


# f32, autocast and TF32 off, dropout p = 0: the card's two train steps
# at 128 px against the CPU's from the same weights and batch, at lr 1e-3.
# Each loss term within 1e-4 of its size; each tensor's change
# (parameters, BN buffers, EMA) within 0.3 of the CPU's largest change of
# that tensor, over tensors that changed by more than 1e-6 (chip_smoke.py's
# TRAIN_F32_LOSS_TOL and TRAIN_F32_TOL, with the reasons and the H100's
# readings there)
@pytest.mark.parametrize("name", ["yolov5s_add", "flagship_small"])
def test_train_steps_on_the_card_match_the_cpu(cuda, name):
    import copy

    from mmidet_tpu_torch.models.zoo import get_model_spec
    spec = two_stream_spec("l", "fourier", nc=2, fusion_layers=2) \
        if name == "flagship_small" else get_model_spec(name, nc=2)
    torch.manual_seed(0)
    cpu = TwoStreamDetector(spec, aux_mode="reference")
    for m in cpu.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    card = copy.deepcopy(cpu).to(cuda)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    targets = torch.zeros(2, 4, 5)
    targets[:, :2] = torch.tensor([[1, 0.5, 0.5, 0.3, 0.4],
                                   [0, 0.3, 0.3, 0.1, 0.2]])
    batch = {"rgb": torch.rand(2, 128, 128, 3, generator=gen),
             "ir": torch.rand(2, 128, 128, 3, generator=gen),
             "targets": targets, "mask": torch.arange(4).expand(2, 4) < 2}
    s_card, l_card = _train_steps(card, batch)
    s_cpu, l_cpu = _train_steps(cpu, batch)
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                   for a, b in zip(l_card, l_cpu)
                   for k in ("box", "obj", "cls", "aux", "total"))
    shares = {}
    for got, want in ((s_card.model.state_dict(), s_cpu.model.state_dict()),
                      (s_card.ema.state_dict(), s_cpu.ema.state_dict())):
        for k, w in want.items():
            if not w.is_floating_point():
                continue
            dw = w - before[k]
            top = float(dw.abs().max())
            if top > 1e-6:
                dg = got[k].cpu() - before[k]
                shares[k] = max(shares.get(k, 0.0), float(
                    (dg - dw).abs().max()) / top)
    worst = max(shares, key=shares.get)
    assert loss_err <= 1e-4 and shares[worst] <= 0.3 and len(shares) > 100, \
        (loss_err, worst, shares[worst])


def test_trainer_evaluates_through_k1_and_k2_on_the_card(cuda, tmp_path,
                                                         monkeypatch):
    """One epoch of ``train`` on the card (yolov5s_gpt4, bf16, 64 px): the
    train steps launch no kernel; the evaluation of the EMA runs K1 at the
    four fusion levels and K2 once a batch."""
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.train import trainer
    data = make_synthetic_pair_dataset(str(tmp_path / "d"), n=4, img=64)
    counts, real_eval = [], trainer.evaluate

    def launches():
        return (tc.fused_token_transformer.launches,
                nms_cuda.nms_greedy.launches, cem_cuda.fused_cem.launches,
                fusion_cuda.fused_gpt_merge.launches)

    def counted(model, loader, nc, **kw):
        counts.append(launches())
        res = real_eval(model, loader, nc, **kw)
        counts.append(launches())
        return res
    monkeypatch.setattr(trainer, "evaluate", counted)
    start = launches()
    out = trainer.train(trainer.TrainConfig(
        model="yolov5s_gpt4", data=data, epochs=1, batch_size=2,
        img_size=64, workdir=str(tmp_path / "run"), mosaic_prob=0.0,
        workers=0))
    assert counts[0] == start  # nothing launched by the train steps
    k1, k2, k3, k4 = (b - a for a, b in zip(counts[0], counts[1]))
    assert (k1, k2, k3, k4) == (4 * 2, 2, 0, 0)
    assert np.isfinite(out["epochs"][0]["box"])
    assert next(out["state"].model.parameters()).device.type == "cuda"


# ------------------------------------------ mosaic, quad, extras and remat
# The augmentations on the card against the same functions on the CPU,
# the same inputs and draws: gathers, products and sums in the same order
# in f32 (1e-5 of values in [0, 1]); the general warp's stages as
# chip_smoke.py's mosaic_gate gates them (``general_warp_gate``); labels
# 1e-4
def _cpu_and_card(tree, cuda):
    if isinstance(tree, dict):
        return {k: _cpu_and_card(v, cuda) for k, v in tree.items()}
    return tree.to(cuda)


def _close(got, want, atol):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
    elif isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], atol)
    elif want.dtype == torch.bool or not want.is_floating_point():
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("branch", ["default", "general"])
def test_mosaic_augment_on_the_card_matches_the_cpu(cuda, branch):
    import dataclasses

    from mmidet_tpu_torch.data import augment as A
    hyp = A.AugmentHyp(flipud=0.5)
    if branch == "general":
        hyp = dataclasses.replace(hyp, degrees=10.0, shear=2.0)
    gen = torch.Generator().manual_seed(0)
    b, s, t = 4, 96, 8
    batch = {"rgb4": torch.rand(b, 4, s, s, 3, generator=gen),
             "ir4": torch.rand(b, 4, s, s, 3, generator=gen),
             "labels4": torch.cat([torch.randint(0, 3, (b, 4, t, 1),
                                                 generator=gen).float(),
                                   0.2 + 0.5 * torch.rand(b, 4, t, 4,
                                                          generator=gen)],
                                  -1),
             "mask4": torch.rand(b, 4, t, generator=gen) < 0.7,
             "pads4": torch.tensor([[0., 0., 96., 96.], [8., 0., 80., 96.],
                                    [0., 12., 96., 72.],
                                    [20., 4., 56., 88.]]).expand(b, 4, 4)}
    draws = A.mosaic_draws(b, s, hyp, gen)
    args = [batch[k] for k in ("rgb4", "ir4", "labels4", "mask4")]
    want = A.augment_pair_mosaic(*args, draws, s, hyp, 16,
                                 pads4=batch["pads4"])
    got = A.augment_pair_mosaic(*(a.to(cuda) for a in args),
                                _cpu_and_card(draws, cuda), s, hyp, 16,
                                pads4=batch["pads4"].to(cuda))
    if branch == "default":
        _close(got[:2], want[:2], 1e-5)
    else:
        smoke = _chip_smoke()
        err, rec = smoke.general_warp_gate(
            torch, A, batch, _cpu_and_card(batch, cuda), draws,
            [g.cpu() for g in got], want)
        assert err <= smoke.MOSAIC_IMG_TOL and \
            rec["warp_max_abs_err"] <= smoke.MOSAIC_WARP_TOL, (err, rec)
    _close(got[2:], want[2:], 1e-4)
    assert want[3].any()


def test_quad_and_extras_on_the_card_match_the_cpu(cuda):
    from mmidet_tpu_torch.data import augment as A
    gen = torch.Generator().manual_seed(1)
    img = torch.rand(8, 32, 48, 3, generator=gen)
    labels = torch.rand(8, 5, 5, generator=gen)
    mask = torch.rand(8, 5, generator=gen) < 0.7
    xy = 30 * torch.rand(8, 5, 2, generator=gen)
    boxes = torch.cat([xy, xy + 2 + 10 * torch.rand(8, 5, 2, generator=gen)],
                      -1)
    tiles9 = torch.rand(2, 9, 16, 16, 3, generator=gen)
    cases = {
        "quad": (A.quad_batch, (img[:, :, :32], img[:, :, 16:], labels,
                                mask, A.quad_draws(2, gen))),
        "mixup": (A.mixup, (img, labels, mask, img.flip(2), labels, mask,
                            A.mixup_draws(8, gen))),
        "cutout": (A.cutout, (img, A.cutout_draws(8, 32, 48, gen), boxes,
                              mask)),
        "clahe": (A.hist_equalize, (img,)),
        "equalize": (lambda x: A.hist_equalize(x, clahe=False), (img,)),
        "mosaic9": (A.mosaic9, (tiles9, torch.rand(2, 9, 3, 5, generator=gen),
                                torch.ones(2, 9, 3, dtype=torch.bool),
                                A.mosaic9_draws(2, 16, gen), 16)),
        "replicate": (A.replicate_labels, (img, boxes, labels[..., 0], mask,
                                           A.replicate_draws(8, gen)))}
    for name, (fn, args) in cases.items():
        want = fn(*args)
        got = fn(*(_cpu_and_card(a, cuda) if isinstance(a, (torch.Tensor,
                                                           dict)) else a
                   for a in args))
        _close(got, want, 1e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_step_on_the_card_matches_the_plain_step(cuda, remat):
    """f32, TF32 off: a remat step (yolov5s_gpt4: dropout 0.1) from the
    same weights, batch and seed as the plain step; BN counts once."""
    import copy
    from mmidet_tpu_torch.models.zoo import get_model_spec
    torch.manual_seed(0)
    base = TwoStreamDetector(get_model_spec("yolov5s_gpt4", nc=2),
                             aux_mode="reference").to(cuda)
    gen = torch.Generator().manual_seed(2)
    targets = torch.zeros(2, 4, 5)
    targets[:, :2] = torch.tensor([[1, 0.5, 0.5, 0.3, 0.4],
                                   [0, 0.3, 0.3, 0.1, 0.2]])
    batch = {"rgb": torch.rand(2, 96, 96, 3, generator=gen),
             "ir": torch.rand(2, 96, 96, 3, generator=gen),
             "targets": targets, "mask": torch.arange(4).expand(2, 4) < 2}
    out = {}
    for r in ("", remat):
        model = copy.deepcopy(base)
        torch.manual_seed(3)
        _train_steps(model, batch, steps=1, remat=r)
        out[r] = model.state_dict()
    for k, v in out[""].items():
        if v.is_floating_point():
            assert float((out[remat][k] - v).abs().max()) <= 1e-5 * max(
                1.0, float(v.abs().max())), k
        else:
            assert torch.equal(out[remat][k], v), k
    assert int(out[remat]["model.0.conv.bn.num_batches_tracked"]) == 1


def test_trainer_with_mosaic_quad_and_multi_scale_on_the_card(cuda,
                                                              tmp_path):
    """One epoch of ``train`` on the card with its defaults (mosaic on),
    ``quad`` and ``multi_scale``: the batches reach the steps at twice
    the size, regrouped by 4, at a drawn size."""
    from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
    from mmidet_tpu_torch.train import trainer
    data = make_synthetic_pair_dataset(str(tmp_path / "d"), n=8, img=64)
    out = trainer.train(trainer.TrainConfig(
        model="yolov5s_add", data=data, epochs=1, batch_size=4,
        img_size=64, workdir=str(tmp_path / "run"), quad=True,
        multi_scale=True, workers=0))
    assert out["epochs"][0]["batches"] == 2
    assert np.isfinite(out["epochs"][0]["box"])


# ---------------------------------------------------------- the serving path
def _png(img):
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _records_close(got, want, box_px, conf_rtol):
    """The same records: count, classes, boxes within ``box_px``,
    confidences within ``conf_rtol``; swaps among confidences equal within
    the tolerance allowed."""
    assert len(got) == len(want) and len(want) > 0
    left = list(want)
    for g in got:
        match = [j for j, w in enumerate(left) if g["class"] == w["class"]
                 and all(abs(g[k] - w[k]) <= box_px
                         for k in ("xmin", "ymin", "xmax", "ymax"))
                 and abs(g["confidence"] - w["confidence"])
                 <= conf_rtol * w["confidence"]]
        assert match, g
        left.pop(match[0])


def _conditioned(model, size=64, seed=0):
    """The model's weights conditioned to unit activations (``chip_smoke.py``
    ``condition``), so that scores follow the image."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(2, size, size, 6, generator=gen).to(
        next(model.parameters()).device)
    _chip_smoke().condition(torch, model, x[..., :3], x[..., 3:])
    return model


def test_batching_service_on_the_card_matches_detection_service(cuda):
    """A tiny two-stream model (f32) through K3 and K2 on the card: a
    padded batch (3 of 4) and a full one, each request's records equal to
    ``DetectionService``'s on the card (the batch of 4 and the batch of 1
    sum in another order: boxes within 1e-2 px, confidences 1e-3)."""
    import threading

    from mmidet_tpu_torch.deploy.serve import BatchingService
    torch.manual_seed(0)
    model = _conditioned(fold_batchnorm(TwoStreamDetector(
        two_stream_spec("t", "add", nc=2), kernel_cem=True)).eval().to(cuda))
    names = ["a", "b"]
    from mmidet_tpu_torch.tools.serve_bench import _jpeg_pair
    svc = BatchingService(model, names, img_size=64, conf_thres=1e-3,
                          max_batch=4, max_wait_ms=300.0)
    single = DetectionService(model, names, img_size=64, conf_thres=1e-3)
    imgs = [_jpeg_pair(64, shift=9 * k)[0] for k in range(4)]
    try:
        for n in (3, 4):
            svc.batch_log.clear()
            before = (cem_cuda.fused_cem.launches,
                      nms_cuda.nms_greedy.launches)
            out = [None] * n

            def post(k):
                out[k] = svc.predict(imgs[k], imgs[-1 - k])
            threads = [threading.Thread(target=post, args=(k,), daemon=True)
                       for k in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert [b for b, _ in svc.batch_log] == [n]
            assert (cem_cuda.fused_cem.launches,
                    nms_cuda.nms_greedy.launches) == (before[0] + 1,
                                                      before[1] + 1)
            for k in range(n):
                _records_close(out[k], single.predict(imgs[k], imgs[-1 - k]),
                               1e-2, 1e-3)
    finally:
        svc.close()


def test_quantized_tiny_model_kernel_route_matches_plain(cuda):
    """The s8-storage deploy of a small flagship (f32, fusion depth 2)
    through K3 and K4 on the card against the same quantized model with
    each kernel replaced by its plain version on the card: the f32 model
    path's gate (2e-2; the merge rounds to bf16 inside on both)."""
    from mmidet_tpu_torch.nn.quant import QTensor, make_quant_deploy
    model = _flagship_small(kernel_cem=True, kernel_merge=True).to(cuda)
    gen = torch.Generator().manual_seed(1)
    rgb, ir = (torch.rand(2, 64, 64, 3, generator=gen).to(cuda)
               for _ in range(2))
    q = make_quant_deploy(model, [(rgb, ir)])
    assert isinstance(q.model[1](torch.zeros(1, 64, 16, 16, device=cuda)),
                      QTensor)
    with torch.no_grad():
        before = (cem_cuda.fused_cem.launches,
                  fusion_cuda.fused_gpt_merge.launches)
        got = q(rgb, ir)["pred"]
        assert (cem_cuda.fused_cem.launches,
                fusion_cuda.fused_gpt_merge.launches) == (before[0] + 1,
                                                          before[1] + 4)
        with _chip_smoke().plain_versions(torch):
            want = q(rgb, ir)["pred"]
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_autoshape_through_k1_and_k2(cuda):
    """``AutoShapeModel`` over the tiny gpt4 model (f32) on the card
    through K1 (4 a forward) and K2 (1 a call), against the same model's
    plain route on the CPU (K1 rounds to bf16 inside on both: boxes within
    0.5 px, confidences 2e-2)."""
    import copy

    from mmidet_tpu_torch.hub import AutoShapeModel
    torch.manual_seed(0)
    model = _conditioned(fold_batchnorm(TwoStreamDetector(
        two_stream_spec("t", "gpt4", nc=2, fusion_layers=1),
        kernel_fusion=True)).eval())
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(2)]
    ir = [255 - a for a in imgs]
    want = AutoShapeModel(copy.deepcopy(model), ["a", "b"], img_size=64,
                          conf=0.01, two_stream=True, device="cpu")(imgs, ir)
    m = AutoShapeModel(model, ["a", "b"], img_size=64, conf=0.01,
                       two_stream=True)
    before = (tc.fused_token_transformer.launches,
              nms_cuda.nms_greedy.launches)
    got = m(imgs, ir)
    assert (tc.fused_token_transformer.launches,
            nms_cuda.nms_greedy.launches) == (before[0] + 4, before[1] + 1)
    for g, w in zip(got.pandas(), want.pandas()):
        _records_close(g, w, 0.5, 2e-2)


def _card_against_cpu(cuda, model, *images, conf=0.001):
    """``model`` (f32) on the card against itself on the CPU (TF32 off:
    sums in another order only, 1e-3), then NMS at ``conf`` on the card's
    predictions through K2 (one launch) against greedy's plain version on
    the CPU."""
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    with torch.no_grad():
        want = model(*images)["pred"]
        got = model.to(cuda)(*(t.to(cuda) for t in images))["pred"]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    before = nms_cuda.nms_greedy.launches
    d_gpu, v_gpu = non_max_suppression(got, conf_thres=conf)
    torch.cuda.synchronize()
    assert nms_cuda.nms_greedy.launches == before + 1
    d_cpu, v_cpu = non_max_suppression(got.cpu(), conf_thres=conf)
    assert torch.equal(v_gpu.cpu(), v_cpu) and int(v_cpu.sum()) > 0
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=0, atol=1e-5)


def test_mamba_model_on_the_card_matches_cpu(cuda):
    """yolov5s_mamba (four MambaFusion levels; the selective scan in plain
    PyTorch), BN folded, at 128 px."""
    from mmidet_tpu_torch.models.zoo import get_model_spec
    torch.manual_seed(0)
    model = fold_batchnorm(TwoStreamDetector(
        get_model_spec("yolov5s_mamba", nc=2))).eval()
    gen = torch.Generator().manual_seed(1)
    _card_against_cpu(cuda, model, torch.rand(2, 128, 128, 3, generator=gen),
                      torch.rand(2, 128, 128, 3, generator=gen))


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3",
                                  "yolov5s-transformer"])
def test_yaml_model_on_the_card_matches_cpu(cuda, name):
    """``chip_smoke.py``'s reference-format YAML models (MaxPool2d and
    ZeroPad2d rows, repeated Bottleneck rows, C3TR), single-stream, BN
    folded and conditioned, at 128 px, NMS at ``chip_smoke.YAML_CONF`` (80
    classes: a seeded model's scores sit below 0.001)."""
    cs = _chip_smoke()
    torch.manual_seed(0)
    model = fold_batchnorm(TwoStreamDetector(cs.yaml_spec(name),
                                             use_cem=False)).eval()
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    cs.condition(torch, model, x, None)
    _card_against_cpu(cuda, model, x, conf=cs.YAML_CONF)


# ------------------------------------------- the kernels as torch.library ops

# a stand-in for the reference checkout's ``models/yolo.py``: ``Model``
# holds a state dict by the reference's names, as the pickled
# ``models.yolo.Model`` of a reference checkpoint does
STUB_YOLO = '''
import torch
from torch import nn


class Model(nn.Module):
    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if name not in mod._modules:
                    mod.add_module(name, nn.Module())
                mod = mod._modules[name]
            if value.is_floating_point() and "running" not in leaf:
                mod.register_parameter(leaf, nn.Parameter(value.clone()))
            else:
                mod.register_buffer(leaf, value.clone())
'''


def write_reference_checkpoint(root, model_sd, ema_sd):
    """A reference-format checkpoint under ``root``: a stub checkout
    (``reference/models/yolo.py``) and ``best.pt``, pickled
    ``models.yolo.Model`` objects in fp16 under ``model`` and ``ema``.
    Returns (path, checkout); the checkout leaves ``sys.path`` and
    ``sys.modules`` as it found them."""
    import sys
    repo = root / "reference"
    (repo / "models").mkdir(parents=True)
    (repo / "models" / "__init__.py").write_text("")
    (repo / "models" / "yolo.py").write_text(STUB_YOLO)
    saved = {n: sys.modules.pop(n) for n in list(sys.modules)
             if n == "models" or n.startswith("models.")}
    sys.path.insert(0, str(repo))
    try:
        from models.yolo import Model
        path = str(root / "best.pt")
        torch.save({"epoch": -1, "model": Model(model_sd).half(),
                    "ema": Model(ema_sd).half(), "updates": 7}, path)
    finally:
        sys.path.remove(str(repo))
        for name in ("models.yolo", "models"):
            sys.modules.pop(name, None)
        sys.modules.update(saved)
    return path, str(repo)


def _op_cases(gen, device):
    """(op, args) of each custom op at small shapes: K1, K4 gated and not,
    K3 in f32 with its weights and in bf16 with its pack."""
    d = 16
    ws = tc.prepare_stack(_stack(d, 2, gen, device), device)
    stack = [ws[k] for k in tc.STACK_KEYS]
    rgb, ir, _, pos, lns, lnb, _, gate = _merge_inputs(d, (9, 11), 2, 2, gen,
                                                       device, True)
    cem = _cem_params(gen, device)
    x = torch.rand(2, 10, 12, 3, generator=gen).to(device)
    return {"K1": (tc.token_transformer_op,
                   (torch.randn(2, 128, d, generator=gen).to(
                       device, torch.bfloat16), stack, 2)),
            "K4_gated": (fusion_cuda.gpt_merge_op,
                         (rgb, ir, stack, pos, lns, lnb, 2, gate["g1"],
                          gate["g2"])),
            "K4": (fusion_cuda.gpt_merge_op,
                   (rgb, ir, stack, pos, lns, lnb, 2, None, None)),
            "K3_f32": (cem_cuda.cem_op, (x, *cem, None)),
            "K3_bf16": (cem_cuda.cem_op, (
                x.bfloat16(), *cem,
                cem_cuda.pack_cem_weights(*cem, torch.bfloat16)))}


@pytest.mark.parametrize("case", ["K1", "K4_gated", "K4", "K3_f32",
                                  "K3_bf16"])
def test_opcheck_on_the_card(cuda, case):
    """Schema, fake implementation (shape, dtype and strides against the
    kernel's real output), autograd registration and AOT dispatch of each
    custom op on CUDA tensors."""
    op, args = _op_cases(torch.Generator().manual_seed(0), cuda)[case]
    torch.library.opcheck(op, args)


_DIRECT = {tc.token_transformer_op: tc._token_transformer_cuda,
           fusion_cuda.gpt_merge_op: fusion_cuda._gpt_merge_cuda,
           cem_cuda.cem_op: cem_cuda._fused_cem_cuda}


@pytest.mark.parametrize("case", ["K1", "K4_gated", "K4", "K3_f32",
                                  "K3_bf16"])
def test_op_is_the_direct_launch(cuda, case):
    """The op launches the kernel once, and gives what the direct ctypes
    call gives, to the bit."""
    op, args = _op_cases(torch.Generator().manual_seed(1), cuda)[case]
    counter = {tc.token_transformer_op: tc.fused_token_transformer,
               fusion_cuda.gpt_merge_op: fusion_cuda.fused_gpt_merge,
               cem_cuda.cem_op: cem_cuda.fused_cem}[op]
    before = counter.launches
    got = op(*args)
    want = _DIRECT[op](*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _export_counts():
    return (tc.fused_token_transformer.launches,
            cem_cuda.fused_cem.launches,
            fusion_cuda.fused_gpt_merge.launches)


@pytest.mark.parametrize("name", ["gpt4", "fourier"])
def test_exported_model_on_the_card_matches_eager(cuda, name):
    """``export_program`` of a small BN-folded bf16 model on its kernel
    routes, loaded back: the graph's custom ops launch their kernels (K1 at
    each of the 4 levels; K3 once and K4 at each level), and ``pred`` is
    the eager module's to the bit (the same kernels and ATen ops on the
    same inputs)."""
    from mmidet_tpu_torch.deploy.export import export_program, load_program
    torch.manual_seed(0)
    if name == "gpt4":
        spec, flags, want = two_stream_spec("t", "gpt4", nc=2,
                                            fusion_layers=2), {
            "kernel_fusion": True}, (4, 0, 0)
    else:
        spec, flags, want = two_stream_spec("l", "fourier", nc=2,
                                            fusion_layers=1), {
            "kernel_cem": True, "kernel_merge": True}, (0, 1, 4)
    model = fold_batchnorm(TwoStreamDetector(spec, **flags)).eval().to(
        cuda, torch.bfloat16)
    prog = load_program(export_program(model, 64, 2))
    gen = torch.Generator().manual_seed(2)
    rgb, ir = (torch.rand(2, 64, 64, 3, generator=gen).to(cuda)
               for _ in range(2))
    with torch.no_grad():
        eager = model(rgb, ir)["pred"]
        before = _export_counts()
        got = prog(rgb, ir)
        torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_export_counts(), before)) == want
    assert got.dtype == eager.dtype and torch.equal(got, eager)


def test_reference_checkpoint_loads_on_the_card(cuda, tmp_path):
    """A reference-format ``.pt`` (pickled modules, fp16, ``model`` and
    ``ema``) through ``cli.val.load_model_and_vars`` on the card: the EMA
    is taken and every tensor of the model received."""
    import sys

    from mmidet_tpu_torch.cli import val
    spec = two_stream_spec("t", "add", nc=2)
    sds = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        sds.append(TwoStreamDetector(spec).state_dict())
    path, repo = write_reference_checkpoint(tmp_path, *sds)
    saved = {n: sys.modules.pop(n) for n in list(sys.modules)
             if n == "models" or n.startswith("models.")}
    sys.path.insert(0, repo)
    try:
        model, _ = val.load_model_and_vars("yolov5t_add", path, 2,
                                           device=cuda)
    finally:
        sys.path.remove(repo)
        for name in ("models.yolo", "models"):
            sys.modules.pop(name, None)
        sys.modules.update(saved)
    ema = {k: v.half().float() if v.is_floating_point() else v
           for k, v in sds[1].items()}
    want = fold_batchnorm(val.build_model(spec, ema).eval()).to(
        cuda, torch.bfloat16).state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------- inference sources, heatmaps and the profiler
def _fourier_model():
    """The l-scale fourier grammar at small depth, BN folded, f32, on the
    kernel routes (K3, K4 at its four levels)."""
    torch.manual_seed(0)
    return fold_batchnorm(TwoStreamDetector(
        two_stream_spec("l", "fourier", nc=2, fusion_layers=2),
        kernel_cem=True, kernel_merge=True)).eval()


def test_sources_forward_through_k3_k4_k2_on_the_card(cuda, tmp_path):
    """Two ``LoadImages`` in lockstep (stills, then an MJPG video that cv2
    writes here) through the model at batch 1: each pair's forward + NMS
    on the card (K3 1, K4 4, K2 1 a frame) against the CPU's."""
    import cv2
    from PIL import Image

    from mmidet_tpu_torch.data.sources import LoadImages
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    rng = np.random.default_rng(0)
    for mod in ("rgb", "ir"):
        (tmp_path / mod).mkdir()
        for i in range(2):
            Image.fromarray((rng.random((48, 64, 3)) * 255).astype(
                np.uint8)).save(tmp_path / mod / f"p{i}.jpg")
        w = cv2.VideoWriter(str(tmp_path / mod / "clip.avi"),
                            cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
        for _ in range(3):
            w.write((rng.random((48, 64, 3)) * 255).astype(np.uint8))
        w.release()
    model = _fourier_model()
    card = _fourier_model().to(cuda)
    n = 0
    for (_, a, *_), (_, b, *_) in zip(LoadImages(str(tmp_path / "rgb"), 64),
                                      LoadImages(str(tmp_path / "ir"), 64)):
        rgb = torch.from_numpy(a[None]).float() / 255
        ir = torch.from_numpy(b[None]).float() / 255
        with torch.no_grad():
            want = model(rgb, ir)["pred"]
            before = (cem_cuda.fused_cem.launches,
                      fusion_cuda.fused_gpt_merge.launches,
                      nms_cuda.nms_greedy.launches)
            got = card(rgb.to(cuda), ir.to(cuda))["pred"]
            dets, valid = non_max_suppression(got, 0.001, 0.6)
        assert (cem_cuda.fused_cem.launches - before[0],
                fusion_cuda.fused_gpt_merge.launches - before[1],
                nms_cuda.nms_greedy.launches - before[2]) == (1, 4, 1)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=2e-2)
        assert dets.shape == (1, 300, 6) and valid.any()
        n += 1
    assert n == 5


def test_feature_heatmap_on_the_card_matches_cpu(cuda):
    """``feature_heatmap`` at a backbone row after the CEM (K3) and at two
    fusion rows (K4's merged first output) of the model conditioned on a
    checkerboard pair (``chip_smoke.py``'s ``condition``), card against
    CPU, within 2% of the [0, 1] range.  At the seeded init the fusion
    rows' channel sums nearly cancel, so that one bf16 step of K4's merged
    outputs moves the min-max normalised map by its whole range;
    conditioned, a bf16 step of every channel moves it by 0.4% at most
    (measured on the CPU)."""
    from mmidet_tpu_torch.utils.gradcam import capture_names, feature_heatmap
    gen = torch.Generator().manual_seed(1)
    yy, xx = torch.meshgrid(torch.arange(64), torch.arange(64),
                            indexing="ij")
    board = ((xx // 16 + yy // 16) % 2).float()[None, :, :, None].expand(
        1, 64, 64, 3)
    rgb = 0.8 * board + 0.2 * torch.rand(1, 64, 64, 3, generator=gen)
    ir = 0.8 * (1 - board) + 0.2 * torch.rand(1, 64, 64, 3, generator=gen)
    model = _fourier_model()
    _chip_smoke().condition(torch, model, rgb, ir)
    card = _fourier_model()
    card.load_state_dict(model.state_dict())
    card = card.to(cuda)
    names = sorted(capture_names(model))
    layers = ["l1_", "l6", next(k for k in names if k.endswith("_GPT"))]
    for layer in layers:
        want = feature_heatmap(model, rgb, ir, layer)
        got = feature_heatmap(card, rgb.to(cuda), ir.to(cuda), layer)
        assert got.shape == want.shape and got.max() == pytest.approx(1.0)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0,
                                   err_msg=layer)


def test_profiler_on_the_card(cuda, tmp_path):
    """``trace`` names K3's and K4's kernels in its Chrome trace;
    ``model_cost`` counts on the card what it counts on the CPU (the ops'
    flop formulas); ``bench_fn`` times the forward."""
    import json

    from mmidet_tpu_torch.utils.profiler import bench_fn, model_cost, trace
    model = _fourier_model()
    card = _fourier_model().to(cuda)
    x = torch.rand(1, 64, 64, 3)
    xc = x.to(cuda)
    with torch.no_grad():
        with trace(str(tmp_path)):
            card(xc, xc)
        assert bench_fn(lambda: card(xc, xc), iters=3) > 0
    names = [e.get("name", "") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]]
    assert any("cem_kernel" in n for n in names)
    assert any("merge_kernel" in n for n in names)
    want, got = model_cost(model, x, x), model_cost(card, xc, xc)
    assert got["gflops"] == want["gflops"] > 0
    assert got["params_m"] == want["params_m"]
