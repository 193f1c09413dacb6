"""Declarative model specification and channel resolution.

A verbatim copy of ``mmidet_tpu/models/spec.py`` up to ``resolve`` (the
port imports nothing of the JAX package).

Replaces the reference's ``parse_model`` (``models/yolo_test.py:548-639``),
which ``eval()``s module names out of YAML rows and mutates a channel list.
Here the graph is an explicit, validated spec:

  * ``LayerDef(f, n, name, args)`` mirrors the YAML row ``[from, number,
    module, args]`` — ``f`` is -1 (previous layer), the sentinel ``-4``
    (second-stream/IR input, ``yolo_test.py:222-223``), an absolute layer
    index, or a list of those;
  * ``resolve()`` applies the same channel bookkeeping (width gain via
    ``make_divisible(c*gw, 8)``, depth gain ``max(round(n*gd), 1)``, Focus
    forcing ``c1=3``, fusion modules taking ``d_model`` from their first
    input) and emits ``ResolvedLayer`` records plus the savelist;
  * no ``eval`` — module names index a closed registry table.

Negative ``f`` other than -1/-4 are resolved relative to the current index
(the reference's ``ch[f]`` python-negative-indexing gives the same layer
because the channel list holds exactly ``i`` entries at layer ``i``).
"""

from __future__ import annotations

import dataclasses
import math
SECOND_INPUT = -4  # sentinel: layer consumes the second (IR) input image


def make_divisible(x: float, divisor: int = 8) -> int:
    """Ref: utils/general.py make_divisible."""
    return math.ceil(x / divisor) * divisor


@dataclasses.dataclass(frozen=True)
class LayerDef:
    f: int | tuple[int, ...]
    n: int
    name: str
    args: tuple = ()


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    nc: int
    anchors: tuple[tuple[int, ...], ...]  # per-level flat (w,h) pairs, pixels
    layers: tuple[LayerDef, ...]
    depth_multiple: float = 1.0
    width_multiple: float = 1.0
    ch_in: int = 3
    strides: tuple[int, ...] = (8, 16, 32)
    # depth of each fusion transformer (GPT/GPT1*; ref hardcodes 8 blocks,
    # common.py:1286).  Smoke/dryrun specs cut this to keep compiles cheap.
    fusion_layers: int = 8

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def no(self) -> int:
        return self.na * (self.nc + 5)


@dataclasses.dataclass(frozen=True)
class ResolvedLayer:
    index: int
    f: int | tuple[int, ...]    # absolute indices (or -1 / SECOND_INPUT)
    name: str
    n: int                      # post-depth-gain repeat count
    args: tuple                 # module build args (post channel math)
    c_out: int


# module-name -> channel rule category
_CONV_LIKE = {"Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
              "SPPF", "DWConv", "MixConv2d", "Focus", "CrossConv",
              "BottleneckCSP", "C3", "C3TR"}
_REPEAT_INSERT = {"BottleneckCSP", "C3", "C3TR"}
_PASSTHROUGH = {"Upsample", "nn.Upsample", "BatchNorm2d", "nn.BatchNorm2d",
                "nn.MaxPool2d", "nn.ZeroPad2d"}
KNOWN_MODULES = _CONV_LIKE | _PASSTHROUGH | {
    "Concat", "Add", "Add2", "GPT", "GPT1", "GPT1_fourier", "Detect",
    "Contract", "Expand", "MambaFusion"}


def is_two_stream(spec: ModelSpec) -> bool:
    """True if any layer consumes the second (IR) input (the reference's
    ``-4`` routing, yolo_test.py:222-223); single-stream specs (yolo.py
    models) have no such ref."""
    return any((isinstance(l.f, tuple) and SECOND_INPUT in l.f)
               or l.f == SECOND_INPUT for l in spec.layers)


def _abs_from(f, i: int):
    """Resolve relative 'from' refs to absolute layer indices.
    -1 and SECOND_INPUT keep their sentinel meaning."""
    def one(j):
        if not isinstance(j, int):
            raise ValueError(
                f"non-integer 'from' ref {j!r} at layer {i} (the reference's "
                "parse_model would crash on this too — e.g. the literal 'k' "
                "typo in yolov5l_fusion_transformer_FLIR_aligned.yaml:73)")
        if j in (-1, SECOND_INPUT):
            return j
        return j if j >= 0 else i + j
    if isinstance(f, (list, tuple)):
        return tuple(one(j) for j in f)
    return one(f)


def resolve(spec: ModelSpec) -> tuple[list[ResolvedLayer], set[int]]:
    """Channel/depth math over the spec -> resolved layers + savelist."""
    gd, gw = spec.depth_multiple, spec.width_multiple
    no = spec.no
    ch: list[int] = []   # ch[i] = out channels of layer i
    out: list[ResolvedLayer] = []
    save: set[int] = set()

    def ch_of(j: int, i: int) -> int:
        if j == -1:
            return ch[i - 1] if i > 0 else spec.ch_in
        if j == SECOND_INPUT:
            return spec.ch_in
        return ch[j]

    for i, ld in enumerate(spec.layers):
        if ld.name not in KNOWN_MODULES:
            raise ValueError(f"unknown module {ld.name!r} at layer {i}")
        f = _abs_from(ld.f, i)
        n = max(round(ld.n * gd), 1) if ld.n > 1 else ld.n
        args = list(ld.args)
        m = ld.name

        if m in _CONV_LIKE:
            if m == "Focus":
                c1, c2 = 3, args[0]  # ref forces c1=3 (yolo_test.py:571-576)
            else:
                c1 = ch_of(f if isinstance(f, int) else f[0], i)
                c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            if m in _REPEAT_INSERT:
                args.insert(1, n)  # repeats folded into module
                n = 1
        elif m == "Concat":
            c2 = sum(ch_of(j, i) for j in f)
        elif m in ("Add", "Add2"):
            c2 = ch_of(f[0], i)
            args = [] if m == "Add" else [args[-1]]  # Add2 keeps index
        elif m in ("GPT", "MambaFusion"):
            c2 = ch_of(f[0], i)
            args = [c2]
        elif m in ("GPT1", "GPT1_fourier"):
            c2 = args[0]  # NOT width-scaled (ref quirk, yolo_test.py:604-609)
            c_in = ch_of(f[0], i)
            if c2 != c_in:
                raise ValueError(
                    f"{m} d_model={c2} != input channels {c_in} at layer {i} "
                    "(the reference does not width-scale GPT1* args; this "
                    "config is invalid there too — use width_multiple=1.0 "
                    "or pass the scaled channel count)")
            args = [c2]
        elif m == "Detect":
            args = [spec.nc, spec.anchors,
                    tuple(ch_of(j, i) for j in f)]
            c2 = no
        elif m == "Contract":
            c2 = ch_of(f, i) * args[0] ** 2
        elif m == "Expand":
            c2 = ch_of(f, i) // args[0] ** 2
        else:  # passthrough (Upsample, BatchNorm)
            c2 = ch_of(f if isinstance(f, int) else f[0], i)

        out.append(ResolvedLayer(i, f, m, n, tuple(args), c2))
        refs = f if isinstance(f, tuple) else (f,)
        save.update(j for j in refs if j not in (-1, SECOND_INPUT))
        ch.append(c2)

    return out, save
