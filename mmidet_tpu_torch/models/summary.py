"""Per-layer model summary: the reference's ``parse_model`` build log and
``model_info`` report (out-channels, output resolution, parameters; total
FLOPs when given).

Counterpart of ``mmidet_tpu/models/summary.py`` (the same text table);
reference yolo_test.py:548-639 (build log), torch_utils.model_info:204-225.
"""

from __future__ import annotations

from mmidet_tpu_torch.models.spec import SECOND_INPUT, ModelSpec, resolve

_DOWN2 = {"Focus"}


def summarize(spec: ModelSpec, img_size: int = 640, params=None,
              flops: float | None = None) -> str:
    """Text table: idx, from, module, args, out-ch, out-res + totals.

    ``params``: a module (its parameters are counted) or an iterable of
    tensors; ``flops``: the total, when measured elsewhere (the reference
    uses thop).
    """
    resolved, save = resolve(spec)
    res: dict[int, int] = {}

    def res_of(j, prev):
        if j == -1:
            return prev
        if j == SECOND_INPUT:
            return img_size
        return res[j]

    lines = ["%3s %16s %-14s %-30s %6s %7s" % (
        "idx", "from", "module", "args", "ch", "res")]
    prev = img_size
    for rl in resolved:
        j0 = rl.f[0] if isinstance(rl.f, tuple) else rl.f
        r = res_of(j0, prev)
        if rl.name in _DOWN2:
            r //= 2
        elif rl.name == "Conv" and len(rl.args) > 2:
            r //= int(rl.args[2])
        elif rl.name in ("Upsample", "nn.Upsample"):
            r *= 2
        elif rl.name == "Contract":
            r //= int(rl.args[0])
        elif rl.name == "Expand":
            r *= int(rl.args[0])
        res[rl.index] = r
        prev = r
        lines.append("%3d %16s %-14s %-30s %6d %7d" % (
            rl.index, str(rl.f), rl.name, str(rl.args)[:30], rl.c_out, r))
    foot = "layers: %d, save: %d" % (len(resolved), len(save))
    if params is not None:
        tensors = params.parameters() if hasattr(params, "parameters") \
            else params
        n = sum(int(t.numel()) for t in tensors)
        foot += ", params: %.2fM" % (n / 1e6)
    if flops is not None:
        foot += ", GFLOPs: %.1f" % (flops / 1e9)
    lines.append(foot)
    return "\n".join(lines)
