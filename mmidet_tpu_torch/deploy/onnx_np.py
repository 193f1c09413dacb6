"""Minimal numpy evaluator for the ONNX op subset ``onnx_export`` emits.

Counterpart of ``mmidet_tpu/deploy/onnx_np.py``, with the same op set and
semantics.  Executes the *serialized* .onnx file (decoded by
``onnx_proto``), so export tests exercise the full encode -> bytes ->
decode -> execute path, pinning both the wire format and the op semantics
against the port's f32 forward.  Op semantics follow the ONNX operator
spec (opset 13+, LayerNormalization per opset 17); this is a conformance
oracle for tests, not a production runtime.  ``_conv2d``'s product is
``np.matmul`` (BLAS) where the JAX package's copy sums with ``einsum``:
the oracle is faster, the model is not.
"""

from __future__ import annotations

import math

import numpy as np

from mmidet_tpu_torch.deploy.onnx_proto import Graph, Model


def _conv2d(x, w, b, strides, pads, group):
    """NCHW conv via im2col (exact, fp32)."""
    bn, ci, h, wd = x.shape
    co, cig, kh, kw = w.shape
    sh, sw = strides
    pt, pl, pb, pr = pads[0], pads[1], pads[2], pads[3]
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    ho = (h + pt + pb - kh) // sh + 1
    wo = (wd + pl + pr - kw) // sw + 1
    out = np.zeros((bn, co, ho, wo), np.float32)
    cpg_o = co // group
    for g in range(group):
        xs = xp[:, g * cig:(g + 1) * cig]
        wg = w[g * cpg_o:(g + 1) * cpg_o]       # (cpg_o, cig, kh, kw)
        cols = np.empty((bn, cig * kh * kw, ho * wo), np.float32)
        idx = 0
        for di in range(kh):
            for dj in range(kw):
                patch = xs[:, :, di:di + sh * ho:sh, dj:dj + sw * wo:sw]
                cols[:, idx * cig:(idx + 1) * cig] = patch.reshape(
                    bn, cig, -1)
                idx += 1
        # weight laid out to match cols: (kh*kw, cig) blocks
        wm = wg.transpose(2, 3, 1, 0).reshape(kh * kw * cig, cpg_o)
        out[:, g * cpg_o:(g + 1) * cpg_o] = np.matmul(
            wm.T, cols).reshape(bn, cpg_o, ho, wo)
    if b is not None:
        out += b.reshape(1, co, 1, 1)
    return out


def _maxpool(x, k, strides, pads):
    bn, c, h, w = x.shape
    kh, kw = k
    sh, sw = strides
    pt, pl, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                constant_values=-np.inf)
    ho = (h + pt + pb - kh) // sh + 1
    wo = (w + pl + pr - kw) // sw + 1
    out = np.full((bn, c, ho, wo), -np.inf, np.float32)
    for di in range(kh):
        for dj in range(kw):
            out = np.maximum(
                out, xp[:, :, di:di + sh * ho:sh, dj:dj + sw * wo:sw])
    return out


def _resize_nearest(x, scales):
    sh, sw = int(scales[2]), int(scales[3])
    return np.repeat(np.repeat(x, sh, axis=2), sw, axis=3)


def _slice(x, starts, ends, axes, steps=None):
    sl = [slice(None)] * x.ndim
    steps = steps or [1] * len(starts)
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[int(a)] = slice(int(s), int(e), int(st))
    return x[tuple(sl)]


def _layernorm(x, scale, bias, axis, eps):
    mu = x.mean(axis=axis, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=axis, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * scale + bias


def _softmax(x, axis):
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _erf(x):
    return np.vectorize(math.erf)(x).astype(np.float32)


def _reshape(x, shape, allowzero=0):
    shape = [int(s) for s in shape]
    out = [x.shape[i] if (s == 0 and not allowzero) else s
           for i, s in enumerate(shape)]
    return x.reshape(out)


def run(model: Model | Graph, feeds: dict[str, np.ndarray],
        outputs: list[str] | None = None) -> dict[str, np.ndarray]:
    g = model.graph if isinstance(model, Model) else model
    env: dict[str, np.ndarray] = {t.name: t.array for t in g.initializers}
    env.update({k: np.asarray(v, np.float32) if v.dtype.kind == "f" else v
                for k, v in feeds.items()})
    want = set(outputs or [v.name for v in g.outputs])

    for n in g.nodes:
        i = [env[s] if s else None for s in n.inputs]
        a = n.attrs
        t = n.op_type
        if t == "Conv":
            out = _conv2d(i[0], i[1], i[2] if len(i) > 2 else None,
                          a.get("strides", [1, 1]), a.get("pads",
                                                          [0, 0, 0, 0]),
                          a.get("group", 1))
        elif t == "Add":
            out = i[0] + i[1]
        elif t == "Sub":
            out = i[0] - i[1]
        elif t == "Mul":
            out = i[0] * i[1]
        elif t == "Div":
            out = i[0] / i[1]
        elif t == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-i[0]))
        elif t == "Relu":
            out = np.maximum(i[0], 0)
        elif t == "LeakyRelu":
            al = a.get("alpha", 0.01)
            out = np.where(i[0] >= 0, i[0], al * i[0])
        elif t == "HardSwish":
            out = i[0] * np.clip(i[0] / 6.0 + 0.5, 0, 1)
        elif t == "Erf":
            out = _erf(i[0])
        elif t == "Concat":
            out = np.concatenate(i, axis=a["axis"])
        elif t == "MaxPool":
            out = _maxpool(i[0], a["kernel_shape"],
                           a.get("strides", [1, 1]),
                           a.get("pads", [0, 0, 0, 0]))
        elif t == "Resize":
            assert a.get("mode") == "nearest", a
            out = _resize_nearest(i[0], i[2])
        elif t == "Reshape":
            out = _reshape(i[0], i[1], a.get("allowzero", 0))
        elif t == "Transpose":
            out = np.transpose(i[0], a["perm"])
        elif t == "MatMul":
            out = np.matmul(i[0], i[1])
        elif t == "Softmax":
            out = _softmax(i[0], a.get("axis", -1))
        elif t == "LayerNormalization":
            out = _layernorm(i[0], i[1], i[2], a.get("axis", -1),
                             a.get("epsilon", 1e-5))
        elif t == "Slice":
            out = _slice(i[0], i[1], i[2],
                         i[3] if len(i) > 3 else range(len(i[1])),
                         i[4] if len(i) > 4 else None)
        elif t == "Identity":
            out = i[0]
        else:
            raise NotImplementedError(f"op {t}")
        env[n.outputs[0]] = (out.astype(np.float32)
                             if out.dtype == np.float64 else out)

    return {k: env[k] for k in want}
