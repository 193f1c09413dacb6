"""The ports of the TPU probes under ``tools/`` against the probes' own
functions: P1's plain conv chain against ``xla_chain`` and the Pallas
kernel (``pallas_chain``) in interpret mode; the plain version of each P2
and P3 probe body against that body run by ``pl.pallas_call`` in interpret
mode.  The same seeded numpy inputs go to both sides.

Gates: P1 2% of max |want| (the bf16 gate of K3: one flipped rounding of
the intermediate, spread by the second conv); P2 one bf16 step, 2^-8 of
max(1, |want|) (the sums round once to bf16, after f32 sums in another
order); P3 1e-5 of max |want| (f32 sums of exact bf16 products in another
order)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import _probe_cem_fb  # noqa: E402
import _probe_cem_r3  # noqa: E402
import _probe_igemm  # noqa: E402

from mmidet_tpu_torch.tools import (probe_cem_fb, probe_cem_r3,  # noqa: E402
                                    probe_igemm)


def _bf16(a):
    """numpy f32 -> the bf16 values as numpy f32 (round to nearest even)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _torch_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("c", [64, 128])
def test_conv_chain_matches_xla_chain_and_pallas_interpret(c):
    rng = np.random.default_rng(c)
    x = _bf16(rng.standard_normal((2, 32, 32, c)).astype(np.float32))
    w1, w2 = (_bf16(0.05 * rng.standard_normal((3, 3, c, c)).astype(
        np.float32)) for _ in range(2))
    got = probe_igemm.conv_chain(_torch_bf16(x), _torch_bf16(w1),
                                 _torch_bf16(w2)).float().numpy()
    assert got.shape == (2, 32, 32, c)
    xb, w1b, w2b = (jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2))
    for want in (_probe_igemm.xla_chain(xb, w1b, w2b),
                 _probe_igemm.pallas_chain(xb, w1b, w2b, interpret=True)):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_conv_chain_wrapper_cpu_and_other_devices():
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    before = probe_igemm.conv_chain.launches
    assert torch.equal(probe_igemm.conv_chain(x, w, w),
                       probe_igemm.conv_chain_reference(x, w, w))
    assert probe_igemm.conv_chain.launches == before
    with pytest.raises(ValueError, match="C in"):
        probe_igemm.conv_chain(torch.zeros(1, 8, 8, 32), w, w)
    with pytest.raises(ValueError, match="no conv-chain kernel"):
        probe_igemm.conv_chain(x.to("meta"), w, w)


def test_prepare_weights_is_each_tap_transposed():
    w = torch.arange(9 * 64 * 64, dtype=torch.float32).reshape(3, 3, 64, 64)
    p = probe_igemm.prepare_weights(w)
    assert p.shape == (9, 64, 64) and p.dtype == torch.bfloat16
    # [tap = 3 dy + dx][co][ci] = HWIO[dy, dx, ci, co]
    assert p[5, 7, 3] == w[1, 2, 3, 7].to(torch.bfloat16)


@pytest.mark.parametrize("b,h,w,n", [(1, 1, 1, 1), (3, 2, 17, 6),
                                     (128, 160, 160, 12800),
                                     (70000, 1, 1, 70000)])
def test_conv_chain_tiles_any_batch(b, h, w, n):
    """The persistent grid takes any batch: the kernel's 16x16 tiles of
    (B, H, W), none refused below 2^31 tiles."""
    assert probe_igemm.tiles(b, h, w) == n
    probe_igemm.check_launch(b, h, w)


def test_conv_chain_launch_rules():
    for shape in ((0, 8, 8), (1, 0, 8), (1, 8, 0)):
        with pytest.raises(ValueError, match="B, H, W >= 1"):
            probe_igemm.check_launch(*shape)
    probe_igemm.check_launch(2 ** 31 - 1, 16, 16)
    with pytest.raises(ValueError, match="at most 2147483647 tiles"):
        probe_igemm.check_launch(2 ** 31 - 1, 17, 16)


def test_conv_chain_entry_point_on_the_cpu(capsys):
    recs = probe_igemm.main(["2", "32", "64"], device="cpu")
    assert [r["c"] for r in recs] == [64, 128]
    assert all(r["finite"] and r["shape"] == [2, 32, 32, r["c"]]
               for r in recs)
    assert "plain version only" in capsys.readouterr().out


def _pallas(body, *args, out_shape):
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*(jnp.asarray(a, jnp.bfloat16) for a in args)))


_R3_BODIES = {"halo_concat": _probe_cem_r3._k_a,
              "halo_roll": _probe_cem_r3._k_b,
              "lane_wrap": _probe_cem_r3._k_c,
              "flat_gather": _probe_cem_r3._k_d}


@pytest.mark.parametrize("body", probe_cem_r3.BODIES)
def test_halo_sum_matches_probe_body(body):
    shape_in, shape_out = probe_cem_r3.shapes(body)
    t = _bf16(np.random.default_rng(len(body)).standard_normal(
        shape_in).astype(np.float32))
    want = _pallas(_R3_BODIES[body], t, out_shape=shape_out)
    got = probe_cem_r3.halo_sum(body, _torch_bf16(t)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** -8 * max(1.0,
                                                        np.abs(want).max())
    assert (got == got[..., :1]).all()  # one value on all 8 lanes


_FB_BODIES = {"slice192": _probe_cem_fb._k_slice192,
              "slice8": _probe_cem_fb._k_slice8,
              "ones_matmul": _probe_cem_fb._k_ones_matmul}


@pytest.mark.parametrize("body", probe_cem_fb.BODIES)
def test_lane_matmul_matches_probe_body(body):
    a, w = (t.float().numpy() for t in probe_cem_fb.inputs(body, "cpu"))
    want = _pallas(_FB_BODIES[body], a, w, out_shape=(probe_cem_fb.M, 128))
    got = probe_cem_fb.lane_matmul(body, _torch_bf16(a),
                                   _torch_bf16(w)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_probe_wrappers_refuse_bad_input_and_other_devices():
    t = probe_cem_r3.inputs("halo_roll", "cpu")
    with pytest.raises(ValueError, match="takes"):
        probe_cem_r3.halo_sum("halo_concat", t)
    with pytest.raises(ValueError, match="no halo-sum kernel"):
        probe_cem_r3.halo_sum("halo_roll", t.to("meta"))
    a, w = probe_cem_fb.inputs("slice8", "cpu")
    with pytest.raises(ValueError, match="takes a"):
        probe_cem_fb.lane_matmul("slice192", a, w)
    with pytest.raises(ValueError, match="no lane-matmul kernel"):
        probe_cem_fb.lane_matmul("slice8", a.to("meta"), w.to("meta"))


def test_cem_probe_entry_points_on_the_cpu():
    for mod, n in ((probe_cem_r3, 4), (probe_cem_fb, 3)):
        recs = mod.main(device="cpu")
        assert len(recs) == n and all(r["ok"] and r["max_abs_err"] == 0
                                      for r in recs)


# The yardsticks beside P2 and P3: one PyTorch call per body against the
# plain version, at the plain version's gates (P2 one bf16 step of max(1,
# |want|), after the call's own bf16 rounding; P3 1e-5 of max |want|).
@pytest.mark.parametrize("probe,body", [
    *((probe_cem_r3, b) for b in probe_cem_r3.BODIES),
    *((probe_cem_fb, b) for b in probe_cem_fb.BODIES)])
def test_library_call_matches_plain(probe, body):
    args = probe.inputs(body, "cpu", seed=5)
    if probe is probe_cem_r3:
        want = probe.halo_sum_reference(body, args)[..., 0].reshape(-1)
        got = probe.library_call(body, args)().float().reshape(-1)
        tol = 2.0 ** -8 * max(1.0, float(want.abs().max()))
    else:
        want = probe.lane_matmul_reference(body, *args)
        got = probe.library_call(body, *args)()
        tol = probe.TOL * float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("body", probe_cem_fb.BODIES)
def test_widen_index_is_widen(body):
    """The index map the kernel stages a's rows by gives ``widen``'s rows:
    column k reads lane widen_index[k] of a, or is zero where it is -1."""
    a, _ = probe_cem_fb.inputs(body, "cpu", seed=6, m=5)
    idx = probe_cem_fb.widen_index(body)
    assert idx.shape == (probe_cem_fb.WIDTH[body][1],)
    got = torch.where(idx >= 0, a[:, idx.clamp(min=0)], torch.zeros(
        (), dtype=a.dtype))
    assert torch.equal(got, probe_cem_fb.widen(body, a))
    # slice192 and ones_matmul move whole 16-byte chunks (the kernel's
    # Body<>::CHUNKED): 8 columns read 8 consecutive lanes from a multiple
    # of 8, or none; slice8 does not
    chunks = idx.view(-1, 8)
    first = chunks[:, :1]
    chunked = bool(((chunks == -1).all(1) | ((first[:, 0] % 8 == 0) & (
        chunks == first + torch.arange(8)).all(1))).all())
    assert chunked == (body != "slice8")


@pytest.mark.parametrize("body,steps", [("slice192", 15), ("slice8", 1),
                                        ("ones_matmul", 12)])
def test_k16_tiled_products_mirror_matches_plain(body, steps):
    """A CPU mirror of the kernel's products: 16 rows at a time (the last
    tile ragged), k16 steps in order with f32 sums, the steps past the
    last that holds a lane of a (all zero, the kernel's Body<>::STEPS)
    skipped; within P3's gate of the plain version."""
    held = (probe_cem_fb.widen_index(body) >= 0).view(-1, 16).any(1)
    assert int(held.nonzero().max()) + 1 == steps
    a, w = probe_cem_fb.inputs(body, "cpu", seed=7, m=37)
    p = probe_cem_fb.widen(body, a).float()
    acc = torch.zeros(len(a), 128)
    for m0 in range(0, len(a), 16):
        for s in range(steps):
            k = slice(16 * s, 16 * s + 16)
            acc[m0:m0 + 16] += p[m0:m0 + 16, k] @ w[k].float()
    want = probe_cem_fb.lane_matmul_reference(body, a, w)
    assert float((acc - want).abs().max()) <= probe_cem_fb.TOL * float(
        want.abs().max())


@pytest.mark.parametrize("r,g", [(80, 80), (7, 33)])
def test_lane_wrap_eight_threads_a_pixel_mirror_matches_plain(r, g):
    """A CPU mirror of lane_wrap's reduction: thread j of a pixel's 8 sums
    its 16-byte chunks j, j + 8, j + 16, weighted by
    ``lane_wrap_weights`` (2 for chunks 0-2 and 21-23), then three xor
    steps (j ^ 1, j ^ 2, j ^ 4) add the 8 partial sums; one bf16 rounding;
    within one bf16 step of the plain version."""
    weights = probe_cem_r3.lane_wrap_weights().view(3, 8, 8)
    assert (weights == weights[..., :1]).all()  # one weight a chunk
    assert weights[..., 0].tolist() == [[2, 2, 2, 1, 1, 1, 1, 1], [1] * 8,
                                        [1, 1, 1, 1, 1, 2, 2, 2]]
    y = probe_cem_r3.inputs("lane_wrap", "cpu", seed=8, r=r, g=g)
    chunks = y.float().reshape(-1, 3, 8, 8).sum(-1)  # (pixel, i, j)
    s = (chunks * weights[..., 0]).sum(1)            # (pixel, j)
    j = torch.arange(8)
    for step in (1, 2, 4):
        s = s + s[:, j ^ step]
    got = s[:, 0].to(torch.bfloat16).float()
    want = probe_cem_r3.halo_sum_reference("lane_wrap", y, r, g)[..., 0]
    assert (s == s[:, :1]).all()  # every thread holds the sum
    assert float((got - want.reshape(-1)).abs().max()) <= 2.0 ** -8 * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("probe", [probe_cem_r3, probe_cem_fb])
def test_probe_wrappers_write_out_in_place_and_check_it(probe):
    if probe is probe_cem_r3:
        args = (probe.inputs("halo_roll", "cpu", seed=9, r=3, g=5),)
        call = lambda out: probe.halo_sum("halo_roll", *args, 3, 5, out=out)
        shape = (5, 5, 8)
    else:
        args = probe.inputs("slice8", "cpu", seed=9, m=7)
        call = lambda out: probe.lane_matmul("slice8", *args, out=out)
        shape = (7, 128)
    out = torch.full(shape, float("nan"))
    assert call(out) is out
    assert torch.equal(out, call(None))
    for bad in (torch.empty(shape[0] + 1, *shape[1:]),
                torch.empty(shape, dtype=torch.float64),
                torch.empty(*shape[:-1], 2 * shape[-1])[..., ::2]):
        with pytest.raises(ValueError, match="out must be"):
            call(bad)


# The bound of a P2 or P3 body counts the values its function reads, no
# more: the input values on which the plain version's output depends (a
# nonzero gradient) are the ones ``work`` counts, and so are its sums.
@pytest.mark.parametrize("probe,body", [
    *((probe_cem_r3, b) for b in probe_cem_r3.BODIES),
    *((probe_cem_fb, b) for b in probe_cem_fb.BODIES)])
def test_bound_counts_what_the_function_reads(probe, body):
    if probe is probe_cem_r3:
        r, g = 3, 5
        t = probe.inputs(body, "cpu", seed=10, r=r, g=g).float()
        t.requires_grad_(True)
        out = probe.halo_sum_reference(body, t, r, g)
        out[..., 0].sum().backward()
        values, sums = int((t.grad != 0).sum()), out[..., 0].numel()
        taps = {"halo_concat": 10, "halo_roll": 10, "lane_wrap": 240,
                "flat_gather": 9}[body]
        assert probe.work(body, r, g) == (sums * (taps - 1),
                                          values * 2 + out.numel() * 4)
    else:
        m = 5
        a, w = (x.float().requires_grad_(True)
                for x in probe.inputs(body, "cpu", seed=10, m=m))
        out = probe.lane_matmul_reference(body, a, w)
        out.sum().backward()
        rows = int((w.grad != 0).any(1).sum())
        assert bool((a.grad != 0).all())
        assert rows == {"slice192": 240, "slice8": 10,
                        "ones_matmul": 192}[body]
        assert probe.work(body, m) == (2 * m * rows * 128,
                                       a.numel() * 2 + rows * 128 * 2
                                       + out.numel() * 4)
