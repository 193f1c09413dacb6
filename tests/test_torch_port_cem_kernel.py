"""The fused CEM's plain PyTorch version against the JAX Pallas kernel (run
in interpret mode, as the JAX package's own tests run it) and against the
port's unfused module; ``ContourEnhance(use_kernel=True)`` against
``ContourEnhance(use_pallas=True)`` on bridged weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.nn.cem import ContourEnhance as JaxCEM
from mmidet_tpu.nn.cem_pallas import fused_cem as jax_fused_cem
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.nn import cem_cuda
from mmidet_tpu_torch.nn.cem import ContourEnhance

_NAMES = ("w2", "b2", "factor", "bias_s", "w3", "b3")


def _params(rng):
    """Random fused-CEM parameters in the JAX layouts (HWIO); the biases are
    nonzero so that zero padding against bias shows at the borders."""
    def rn(shape, scale, base=0.0):
        return (base + rng.normal(0, scale, shape)).astype(np.float32)
    return {"w2": rn((3, 3, 3, 24), 0.3), "b2": rn((24,), 0.5),
            "factor": rn((24,), 0.4, 1.0), "bias_s": rn((24,), 0.5),
            "w3": rn((3, 3, 24, 3), 0.2), "b3": rn((3,), 0.5)}


def _torch(p):
    return [torch.from_numpy(p[k]) for k in _NAMES]


def _variables(p):
    return {"params": {
        "conv2": {"kernel": p["w2"], "bias": p["b2"]},
        "sobel": {"sobel_factor": p["factor"], "bias": p["bias_s"]},
        "conv3": {"kernel": p["w3"], "bias": p["b3"]}}}


def test_reference_f32_matches_pallas_interpret():
    """f32 on both sides (``precise=True``), two row blocks of the Pallas
    grid: the two differ in the order of f32 sums only.  The rounding error
    of a sum scales with its terms, not its result, so the gate is 1e-4 of
    the output's range, max(1, max |want|), as in
    ``test_torch_port_layers.py:_compare``."""
    rng = np.random.default_rng(0)
    p = _params(rng)
    x = rng.normal(0, 1, (1, 160, 16, 3)).astype(np.float32)
    want = np.asarray(jax_fused_cem(jnp.asarray(x),
                                    *(jnp.asarray(p[k]) for k in _NAMES),
                                    interpret=True, precise=True))
    got = cem_cuda.fused_cem_reference(torch.from_numpy(x), *_torch(p))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


def test_reference_bf16_matches_pallas_interpret():
    """bf16 on both sides, three row blocks.  Same rounding points, another
    order of f32 sums: a flipped rounding of y or y + e moves z by one bf16
    step, so the gate is 2% of the output range (one step is 0.8% at the
    top of a binade); the mean error shows that flips are rare."""
    rng = np.random.default_rng(1)
    p = _params(rng)
    x = rng.normal(0, 1, (2, 120, 24, 3)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_fused_cem(xb, *(jnp.asarray(p[k]) for k in _NAMES),
                                    interpret=True).astype(jnp.float32))
    got = cem_cuda.fused_cem_reference(
        torch.from_numpy(x).to(torch.bfloat16), *_torch(p))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= 0.02 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


# shapes the TPU kernel refuses (H % 40, W % 8) run in the port: the plain
# version, and so the kernel it is held against, takes any H, W >= 1
@pytest.mark.parametrize("shape", [(2, 40, 16, 3), (1, 37, 53, 3),
                                   (2, 5, 7, 3), (1, 1, 1, 3)])
def test_reference_f32_matches_unfused_module(shape):
    rng = np.random.default_rng(shape[1])
    p = _params(rng)
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    holder = torch.nn.Module()
    holder.Enhance = ContourEnhance(3, fused=True)
    from_jax_variables(holder, {"params": {"enhance": _variables(p)["params"]}})
    with torch.no_grad():
        want = holder.Enhance.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = cem_cuda.fused_cem_reference(x, *_torch(p))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_contour_enhance_kernel_flag_matches_pallas_flag():
    """Both modules in f32 on the same (bridged) parameters: the JAX one
    runs its Pallas kernel in interpret mode with f32 patches, the port's
    runs the kernel's plain version on the CPU; 1e-4."""
    rng = np.random.default_rng(2)
    p = _params(rng)
    x = rng.normal(0, 1, (1, 80, 16, 3)).astype(np.float32)
    want = np.asarray(JaxCEM(3, fused=True, use_pallas=True).apply(
        _variables(p), jnp.asarray(x), train=False))
    holder = torch.nn.Module()
    holder.Enhance = ContourEnhance(3, fused=True, use_kernel=True)
    from_jax_variables(holder, {"params": {"enhance": _variables(p)["params"]}})
    before = cem_cuda.fused_cem.launches
    with torch.no_grad():
        got = holder.Enhance.eval()(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert cem_cuda.fused_cem.launches == before  # plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_kernel_flag_needs_folded_module_and_eval_mode():
    x = torch.zeros(1, 3, 8, 8)
    mod = ContourEnhance(3, fused=False, use_kernel=True)
    with pytest.raises(ValueError, match="BN-folded"):
        mod.eval()(x)
    mod.train()(x)  # training runs the unfused module


def test_wrapper_checks_shapes_and_devices():
    rng = np.random.default_rng(3)
    p = _torch(_params(rng))
    with pytest.raises(ValueError, match="takes \\(B, H, W, 3\\)"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 4), *p)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3, dtype=torch.float16), *p)
    with pytest.raises(ValueError, match="w3 has shape"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3), *p[:4], p[4][..., :2],
                           p[5])
    with pytest.raises(ValueError, match="no CEM kernel"):
        cem_cuda.fused_cem(torch.zeros(1, 8, 8, 3, device="meta"), *p)


def test_pack_layout_matches_the_kernel_source():
    """The offsets the wrapper packs at are the ones ``csrc/cem.cu`` reads,
    and each block of the buffer holds what the source says it holds."""
    from mmidet_tpu_torch import kernels
    src = (kernels.CSRC / "cem.cu").read_text()
    assert ("kOffW2 = 0, kOffWB = 672, kOffW3 = 960, kOffB2 = 1608" in src
            and "kOffBS = 1632, kOffB3 = 1656, kPack = 1660" in src)
    rng = np.random.default_rng(4)
    p = _params(rng)
    pack = cem_cuda.pack_cem_weights(*_torch(p), torch.float32).numpy()
    assert pack.shape == (1660,)
    w2 = pack[:672].reshape(24, 28)
    np.testing.assert_array_equal(w2[:, :27],
                                  p["w2"].reshape(27, 24).T)  # (ky, kx, c)
    assert not w2[:, 27].any()
    wb = pack[672:960].reshape(24, 12)
    from mmidet_tpu_torch.nn.cem import edge_filter_bank
    bank = edge_filter_bank(8, 1, 3)[:, :, 0, :]
    for m in (0, 9, 23):
        np.testing.assert_allclose(
            wb[m, :9], (bank[:, :, m % 8] * p["factor"][m]).reshape(9))
    np.testing.assert_array_equal(pack[960:1608], p["w3"].reshape(-1))
    np.testing.assert_array_equal(pack[1608:1632], p["b2"])
    np.testing.assert_array_equal(pack[1632:1656], p["bias_s"])
    np.testing.assert_array_equal(pack[1656:1659], p["b3"])
    # bf16 form: matrices rounded, vectors kept
    pack16 = cem_cuda.pack_cem_weights(*_torch(p), torch.bfloat16)
    torch.testing.assert_close(
        pack16[960:1608],
        torch.from_numpy(p["w3"]).to(torch.bfloat16).float().reshape(-1),
        rtol=0, atol=0)
    np.testing.assert_array_equal(pack16[1608:1632].numpy(), p["b2"])
