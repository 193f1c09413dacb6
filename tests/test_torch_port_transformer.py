"""The fused token transformer's plain PyTorch version against the JAX
Pallas kernel (run in interpret mode, as the JAX package's own tests run
it), and the port's fusion block against the JAX fusion block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.nn.fusion import CrossModalTransformer as JaxGPT
from mmidet_tpu.nn.transformer_pallas import \
    fused_token_transformer as jax_kernel
from mmidet_tpu_torch.bridge import from_jax_variables
from mmidet_tpu_torch.nn import transformer_cuda as tc
from mmidet_tpu_torch.nn.fusion import CrossModalTransformer

_MATS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _stack(d, L, rng):
    """JAX layout: matrices (L, in, out), vectors (L, n)."""
    def mat(i, o):
        return rng.normal(0, 1 / np.sqrt(i), (L, i, o)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + rng.normal(0, 0.2, (L, n))).astype(np.float32)
    return {"ln1_scale": vec(d, 1.0), "ln1_bias": vec(d),
            "wq": mat(d, d), "wk": mat(d, d), "wv": mat(d, d),
            "bq": vec(d), "bk": vec(d), "bv": vec(d),
            "wo": mat(d, d), "bo": vec(d),
            "ln2_scale": vec(d, 1.0), "ln2_bias": vec(d),
            "w1": mat(d, 4 * d), "b1": vec(4 * d),
            "w2": mat(4 * d, d), "b2": vec(d)}


def _port_stack(st):
    """Torch Linear layout: matrices (L, out, in)."""
    return {k: torch.from_numpy(v.transpose(0, 2, 1).copy() if k in _MATS
                                else v) for k, v in st.items()}


# Both sides compute in bf16 with the same rounding points; they differ in
# the order of f32 sums and in erf (the Pallas kernel's is a polynomial,
# |err| < 1.5e-7), which flip bf16 roundings of intermediates.  A flip in
# an early layer compounds through the later ones, so an element of 0.4
# can move by 0.025 where the output reaches 8: a per-element gate misses
# it on some machines and not on others.  The gate is chip_smoke.py's K1
# gate, relative to the output's range: max error within 2% of max |want|.
# d = 96 takes the m scale's width (no multiple of 64).
@pytest.mark.parametrize("d,b", [(64, 2), (256, 2), (96, 1)])
def test_reference_matches_pallas_interpret(d, b):
    rng = np.random.default_rng(d)
    x = rng.normal(0, 1, (b, 128, d)).astype(np.float32)
    st = _stack(d, 2, rng)
    want = np.asarray(jax_kernel(jnp.asarray(x), {k: jnp.asarray(v)
                                                  for k, v in st.items()},
                                 num_heads=8, interpret=True), np.float32)
    got = tc.fused_token_transformer_reference(torch.from_numpy(x),
                                               _port_stack(st),
                                               num_heads=8)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.02 * np.abs(want).max(), err


def test_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 128, 64)).astype(np.float32))
    st = _port_stack(_stack(64, 1, rng))
    before = tc.fused_token_transformer.launches
    torch.testing.assert_close(tc.fused_token_transformer(x, st),
                               tc.fused_token_transformer_reference(x, st))
    assert tc.fused_token_transformer.launches == before


@pytest.fixture(scope="module")
def gpt_pair():
    d, b = 64, 2
    rng = np.random.default_rng(1)
    rgb = rng.normal(0, 1, (b, 20, 24, d)).astype(np.float32)
    ir = (rgb * 0.5 + 0.1).astype(np.float32)
    jm = JaxGPT(d, n_layer=2)
    v = jm.init(jax.random.PRNGKey(0), rgb[:1], ir[:1])
    # randomise every leaf so that biases, LN and pos-emb are exercised
    v = {"params": jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.2, a.shape).astype(np.float32),
        v["params"])}
    want = [np.asarray(t) for t in jm.apply(v, rgb, ir)]
    return d, rgb, ir, v, want


def _port_gpt(d, v, use_kernel):
    holder = torch.nn.Module()
    holder.model = torch.nn.ModuleList([
        CrossModalTransformer(d, n_layer=2, use_kernel=use_kernel)])
    from_jax_variables(holder, {"params": {"l0_GPT": v["params"]}})
    return holder.model[0].eval()


def _run(mod, rgb, ir):
    with torch.no_grad():
        out = mod(torch.from_numpy(rgb).permute(0, 3, 1, 2),
                  torch.from_numpy(ir).permute(0, 3, 1, 2))
    return [t.permute(0, 2, 3, 1).numpy() for t in out]


def test_cross_modal_transformer_f32(gpt_pair):
    """The plain f32 block against JAX's XLA f32 path: f32 on both sides,
    different summation order only."""
    d, rgb, ir, v, want = gpt_pair
    for got, w in zip(_run(_port_gpt(d, v, False), rgb, ir), want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)


def test_cross_modal_transformer_kernel_path(gpt_pair):
    """The kernel path (bf16 inside) against JAX's XLA f32 path, at the
    tolerance the JAX package holds its Pallas kernel to
    (tests/test_transformer_pallas.py)."""
    d, rgb, ir, v, want = gpt_pair
    for got, w in zip(_run(_port_gpt(d, v, True), rgb, ir), want):
        np.testing.assert_allclose(got, w, rtol=0.05, atol=0.05)

