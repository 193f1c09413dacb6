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
