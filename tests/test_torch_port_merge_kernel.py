"""The fused GPT merge's plain PyTorch version against the JAX Pallas kernel
(run in interpret mode, both of its grid variants) and against the port's
unfused fusion modules followed by the two Add2 sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidet_tpu.nn.fusion_pallas import fused_gpt_merge as jax_merge
from mmidet_tpu_torch.nn import fusion_cuda as fc
from mmidet_tpu_torch.nn.fusion import CrossModalTransformer, PatternFusion
from mmidet_tpu_torch.nn.transformer_cuda import stack_block_params

from test_torch_port_train import _threads  # noqa: F401

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


def _inputs(d, hw, b, gated, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.normal(0, 1, (b, *hw, d)).astype(np.float32)
    ir = (rgb * 0.3 + 0.2 + rng.normal(0, 0.2, rgb.shape)).astype(np.float32)
    st = _stack(d, 2, rng)
    pos = rng.normal(0, 0.2, (1, 128, d)).astype(np.float32)
    lns = (1 + rng.normal(0, 0.2, d)).astype(np.float32)
    lnb = rng.normal(0, 0.2, d).astype(np.float32)
    gate = None
    if gated:
        gate = {"g1": rng.normal(0, 1 / np.sqrt(d), (d, 8)).astype(np.float32),
                "g2": rng.normal(0, 1 / np.sqrt(8), (8, d)).astype(np.float32)}
    return rgb, ir, st, pos, lns, lnb, gate


# (d, map, batch, gated): the resident-weight grid of the Pallas kernel; its
# layer-major streaming grid (d = 256); W % 8 != 0 with overlapping pool
# windows (20 -> 8); the pattern gate.
#
# Both sides round at the same points; they differ in the order of f32 sums
# (and the Pallas erf polynomial), which flips bf16 roundings of
# intermediates, and a flip in one layer compounds through the next.  The
# merged streams reach about 8, where one bf16 step is 0.03125; measured
# errors reach two steps on any element, small or large, so a per-element
# gate had less than 2x margin.  The gate is K4's on the card, relative to
# the range: max error within 2% of max |want|, and a small mean error.
@pytest.mark.parametrize("d,hw,b,gated", [
    (128, (24, 24), 2, False), (256, (16, 16), 3, False),
    (64, (20, 20), 2, False), (64, (24, 16), 2, True)])
def test_reference_matches_pallas_interpret(d, hw, b, gated):
    rgb, ir, st, pos, lns, lnb, gate = _inputs(d, hw, b, gated, d + hw[0])
    jgate = None if gate is None else {k: jnp.asarray(v)
                                       for k, v in gate.items()}
    want = jax_merge(jnp.asarray(rgb).astype(jnp.bfloat16),
                     jnp.asarray(ir).astype(jnp.bfloat16),
                     {k: jnp.asarray(v) for k, v in st.items()},
                     jnp.asarray(pos), jnp.asarray(lns), jnp.asarray(lnb),
                     num_heads=8, interpret=True, gate=jgate)
    tgate = None if gate is None else {k: torch.from_numpy(v)
                                       for k, v in gate.items()}
    got = fc.fused_gpt_merge_reference(
        torch.from_numpy(rgb).to(torch.bfloat16),
        torch.from_numpy(ir).to(torch.bfloat16), _port_stack(st),
        torch.from_numpy(pos), torch.from_numpy(lns), torch.from_numpy(lnb),
        8, tgate)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w)
        assert err.max() <= 0.02 * np.abs(w).max(), err.max()
        assert err.mean() < 2e-3


def _randomized(mod, seed):
    """LN, bias and pos-emb parameters to normal * 0.2, so that they are
    exercised; the matrices keep the reference's init."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if p.dim() == 1 or name == "pos_emb":
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return mod.eval()


# The unfused f32 module + Add2 against the merge path (bf16 inside) of the
# same module: the JAX package holds its kernel to its XLA module at 0.06
# (tests/test_fusion_pallas.py); 5x5 is the map the TPU kernel refuses
# (H*W % 8 != 0) and falls back on: here the merge path runs it.
@pytest.mark.parametrize("cls,hw", [(CrossModalTransformer, (24, 16)),
                                    (CrossModalTransformer, (5, 5)),
                                    (PatternFusion, (20, 20))])
def test_merge_path_matches_unfused_module_plus_add2(cls, hw):
    torch.manual_seed(0)
    mod = _randomized(cls(64, n_layer=2), 1)
    gen = torch.Generator().manual_seed(2)
    rgb = torch.randn(2, 64, *hw, generator=gen)
    ir = 0.3 * rgb + 0.2
    with torch.no_grad():
        plain = mod(rgb, ir)
        mod.merge_kernel = True
        merged = mod(rgb, ir)
    torch.testing.assert_close(merged[0], rgb + plain[0], rtol=0.06,
                               atol=0.06)
    torch.testing.assert_close(merged[1], ir + plain[1], rtol=0.06, atol=0.06)
    if cls is PatternFusion:  # training-only dataflow: zero with the kernel
        assert float(plain[2]) > 0 and float(merged[2]) == 0.0


def test_merge_path_is_for_eval_mode_only():
    torch.manual_seed(0)
    mod = CrossModalTransformer(64, n_layer=1, merge_kernel=True)
    for m in mod.modules():  # train mode runs dropout; this holds the route
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    x = torch.randn(1, 64, 8, 8)
    with torch.no_grad():
        unmerged = mod.train()(x, x)
        merged = mod.eval()(x, x)
    torch.testing.assert_close(merged[0], x + unmerged[0], rtol=0.06,
                               atol=0.06)
    with pytest.raises(ValueError, match="8x8 grid"):
        CrossModalTransformer(64, grid=(4, 4), merge_kernel=True)


def test_wrapper_uses_plain_version_on_cpu_and_checks_shapes():
    rgb, ir, st, pos, lns, lnb, _ = _inputs(64, (8, 8), 1, False, 0)
    args = [torch.from_numpy(rgb), torch.from_numpy(ir), _port_stack(st),
            torch.from_numpy(pos), torch.from_numpy(lns),
            torch.from_numpy(lnb)]
    before = fc.fused_gpt_merge.launches
    for g, w in zip(fc.fused_gpt_merge(*args),
                    fc.fused_gpt_merge_reference(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fc.fused_gpt_merge.launches == before
    with pytest.raises(ValueError, match="share one"):
        fc.fused_gpt_merge(args[0], args[1][:, :4], *args[2:])
    with pytest.raises(ValueError, match="merge kernel takes"):
        fc.fused_gpt_merge(torch.zeros(1, 8, 8, 36), torch.zeros(1, 8, 8, 36),
                           *args[2:])
    with pytest.raises(ValueError, match="pos_emb has shape"):
        fc.fused_gpt_merge(args[0], args[1], args[2], args[3][:, :64],
                           *args[4:])
    with pytest.raises(ValueError, match="gate weights"):
        fc.fused_gpt_merge(*args, 8, {"g1": torch.zeros(8, 64),
                                      "g2": torch.zeros(8, 64)})
    with pytest.raises(ValueError, match="no GPT-merge kernel"):
        fc.fused_gpt_merge(args[0].to("meta"), args[1].to("meta"), *args[2:])


def test_pool_and_upsample_forms_match_the_torch_operators():
    """In f32-exact cases (values on a coarse binary grid, so that no bf16
    rounding occurs) the plain version's pooling equals
    ``adaptive_avg_pool2d`` and its upsample equals ``F.interpolate``:
    windows, clamping and token order are torch's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-4, 5, (2, 20, 12, 8), generator=gen).float()
    x[:, :, :, 1] = 0  # a zero channel stays zero
    # window sizes at 20 -> 8 are 3 and 4 (overlapping): means are not all
    # bf16-exact, so compare at bf16 resolution
    want = torch.nn.functional.adaptive_avg_pool2d(
        x.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1).reshape(2, 64, 8)
    torch.testing.assert_close(fc._pool8(x), want, rtol=2e-2, atol=2e-2)
    z = torch.randint(-8, 9, (2, 8, 8, 4), generator=gen).float()
    want = torch.nn.functional.interpolate(
        z.permute(0, 3, 1, 2), size=(20, 12), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(fc._upsample(z, 20, 12), want, rtol=1e-2,
                               atol=1e-2)
    assert fc._pool_windows(20) == [(0, 3), (2, 3), (5, 3), (7, 3), (10, 3),
                                    (12, 3), (15, 3), (17, 3)]


def test_stacked_params_feed_the_merge_as_the_token_kernel():
    """The merge path takes its weights from the module's own blocks
    (``stack_block_params``), pos-emb and ln_f: changing one changes the
    output."""
    torch.manual_seed(0)
    mod = _randomized(CrossModalTransformer(64, n_layer=1, merge_kernel=True),
                      3)
    assert set(stack_block_params(mod.trans_blocks)) == set(_stack(
        8, 1, np.random.default_rng(0)))
    x = torch.randn(1, 64, 8, 8, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        a = mod(x, x)[0]
        mod.ln_f.bias.add_(1.0)
        b = mod(x, x)[0]
    assert float((b - a).abs().mean()) > 0.5


def test_prepared_stack_holds_the_kernels_buffers():
    """``prepare_stack``: matrices bf16, vectors f32, q/k/v joined in that
    order; a prepared dict passes through unchanged."""
    from mmidet_tpu_torch.nn.transformer_cuda import prepare_stack
    torch.manual_seed(0)
    mod = CrossModalTransformer(16, n_layer=2).eval()
    raw = stack_block_params(mod.trans_blocks)
    ws = prepare_stack(raw, torch.device("cpu"))
    assert prepare_stack(ws, torch.device("cpu")) is ws
    assert ws["wqkv"].shape == (2, 48, 16) and ws["bqkv"].shape == (2, 48)
    assert ws["wqkv"].dtype == ws["w1"].dtype == torch.bfloat16
    assert ws["bqkv"].dtype == ws["ln1_scale"].dtype == torch.float32
    assert not ws["wqkv"].requires_grad and "wq" not in ws
    for i, (w, b) in enumerate((("wq", "bq"), ("wk", "bk"), ("wv", "bv"))):
        torch.testing.assert_close(ws["wqkv"][:, 16 * i:16 * (i + 1)],
                                   raw[w].detach().to(torch.bfloat16),
                                   rtol=0, atol=0)
        torch.testing.assert_close(ws["bqkv"][:, 16 * i:16 * (i + 1)],
                                   raw[b].detach(), rtol=0, atol=0)


def test_stamp_tells_a_changed_parameter():
    """What the modules key their kernel-ready weight copies on."""
    from mmidet_tpu_torch import kernels
    mod = torch.nn.Linear(4, 4)
    before = kernels.stamp(mod.parameters())
    assert kernels.stamp(mod.parameters()) == before
    with torch.no_grad():
        mod.bias.copy_(torch.ones(4))
    after_write = kernels.stamp(mod.parameters())
    assert after_write != before
    mod.load_state_dict({k: v.clone() for k, v in mod.state_dict().items()})
    after_load = kernels.stamp(mod.parameters())
    assert after_load != after_write
    assert kernels.stamp(mod.to(torch.bfloat16).parameters()) != after_load
    with torch.inference_mode():
        frozen = torch.nn.Linear(4, 4)
    assert kernels.stamp(frozen.parameters()) == kernels.stamp(
        frozen.parameters())
