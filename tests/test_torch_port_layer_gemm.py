"""The layer GEMM that K1 and K4 share, on the CPU: its plain version
(``nn/transformer_cuda.py:layer_gemm_reference``) against a float64 product
of the same bf16-rounded operands, and its wrapper, which takes the plain
version for a CPU tensor.  The kernel itself is held against the plain
version on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmidet_tpu_torch.nn import transformer_cuda as tc


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
    return t(m, k), t(n, k, scale=k ** -0.5), t(n, scale=0.2), t(m, n)


def _bf16_exact(t):
    return t.to(torch.bfloat16).double()


# Both round once to bf16 from the same function of the same bf16 operands;
# the f32 sums differ from the f64 ones by about 1e-7 of the sum of |terms|,
# so an element moves only where that crosses a rounding boundary, and
# then by one bf16 step: at most 2^-7 of its value (bf16 keeps 8
# significant bits), plus 1e-5 for elements that cancel to near 0.
@pytest.mark.parametrize("m,n,k", [(128, 96, 96), (64, 40, 200),
                                   (256, 16, 16)])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_plain_gemm_matches_float64(m, n, k, epilogue):
    a, w, b, r = _operands(m, n, k, m + n + k)
    res = r if epilogue == "residual" else None
    got = tc.layer_gemm_reference(a, w, b, epilogue, res)
    y = _bf16_exact(a) @ _bf16_exact(w).T + b.double()
    if epilogue == "gelu":
        y = F.gelu(y)
    elif epilogue == "residual":
        y = _bf16_exact(r) + y
    want = y.to(torch.bfloat16).double()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    diff = (got.double() - want).abs()
    assert bool((diff <= 2.0 ** -7 * want.abs() + 1e-5).all())
    assert float((diff == 0).double().mean()) > 0.99


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_layer_gemm_uses_plain_version_on_cpu(epilogue):
    a, w, b, r = _operands(128, 96, 96, 0)
    res = r.to(torch.bfloat16) if epilogue == "residual" else None
    want = tc.layer_gemm_reference(a, w, b, epilogue, res)
    before = tc.layer_gemm.launches
    got = tc.layer_gemm(a, w, b, epilogue, res)
    assert tc.layer_gemm.launches == before
    assert torch.equal(got, want)
    assert res is None or got is res  # the residual is updated in place


def test_layer_gemm_checks_its_epilogue():
    a, w, b, r = _operands(128, 96, 96, 1)
    with pytest.raises(ValueError, match="epilogue must be"):
        tc.layer_gemm(a, w, b, "relu")
    with pytest.raises(ValueError, match="epilogue must be"):
        tc.layer_gemm_reference(a, w, b, "relu")
    with pytest.raises(ValueError, match="residual goes with"):
        tc.layer_gemm(a, w, b, "bias", r)
    with pytest.raises(ValueError, match="residual goes with"):
        tc.layer_gemm(a, w, b, "residual")
