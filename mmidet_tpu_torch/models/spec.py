"""Declarative model specification and channel resolution.

A copy of ``mmidet_tpu/models/spec.py`` (the port imports nothing of the
JAX package); ``_infer_strides`` runs the port's detector on the ``meta``
device where the JAX package uses ``jax.eval_shape``.

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


def load_yolo_yaml(path_or_dict, nc: int | None = None,
                   anchors=None) -> ModelSpec:
    """Compatibility loader for reference-format model YAMLs
    (``[from, number, module, args]`` rows, ``models/*.yaml``).

    Module names are validated against the registry — no ``eval``.  String
    args like ``'nearest'`` are kept verbatim; ``None`` likewise.
    """
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        import yaml
        with open(path_or_dict) as fh:
            d = yaml.safe_load(fh)
    the_nc = nc or d["nc"]
    anc = anchors or d["anchors"]
    if isinstance(anc, int):
        # 'anchors: <na>' yamls (hub/yolov5-p2/p6/p7) leave anchors to
        # AutoAnchor; synthesize per-level placeholders (the standard P3
        # triple scaled 2x per level, cycled to na pairs) for the head to
        # be constructible — utils/autoanchor refits them before training.
        na = anc
        detect_rows = [r for r in d["head"] if r[2] == "Detect"]
        nl = len(detect_rows[-1][0])
        base = [(10, 13), (16, 30), (33, 23)]
        anc = [[v * (2 ** i) for p in range(na)
                for v in base[p % 3]] for i in range(nl)]
    # reference YAMLs use symbolic args the reference eval()s against the
    # yaml dict (yolo_test.py:560): we substitute the known symbols instead
    symbols = {"None": None, "nc": the_nc, "anchors": anc}
    layers = []
    for row in list(d["backbone"]) + list(d["head"]):
        f, n, m, args = row
        if m.startswith("models.") or m.startswith("common."):
            m = m.split(".")[-1]
        fixed = []
        for a in args:
            if isinstance(a, str) and a in symbols:
                a = symbols[a]
            if isinstance(a, str) and a not in ("nearest", "bilinear"):
                raise ValueError(f"non-literal arg {a!r} in YAML (eval is "
                                 "not supported)")
            fixed.append(tuple(tuple(x) for x in a)
                         if isinstance(a, list) and a and
                         isinstance(a[0], list) else
                         (tuple(a) if isinstance(a, list) else a))
        layers.append(LayerDef(
            f=tuple(f) if isinstance(f, list) else f,
            n=n, name=m, args=tuple(fixed)))
    nl = len(anc)
    spec = ModelSpec(
        nc=the_nc,
        anchors=tuple(tuple(a) for a in anc),
        layers=tuple(layers),
        strides=tuple(8 * 2 ** i for i in range(nl)),  # provisional
        depth_multiple=d.get("depth_multiple", 1.0),
        width_multiple=d.get("width_multiple", 1.0),
        ch_in=d.get("ch", 3),
    )
    return _infer_strides(spec)


def _infer_strides(spec: ModelSpec) -> ModelSpec:
    """Replace the provisional strides with shape-inferred ones (the
    reference runs a dummy forward and reads 256/ny, yolo_test.py:127;
    required for P2/P6/P7/tiny head arrangements).  Shape-only: the model
    is built and run on the ``meta`` device, no memory, no FLOPs."""
    import torch

    from mmidet_tpu_torch.models.detector import TwoStreamDetector

    size = 256
    with torch.device("meta"):
        model = TwoStreamDetector(spec, use_cem=False).eval()
        x = torch.empty(1, size, size, spec.ch_in)
    with torch.no_grad():
        out = model(x, x if is_two_stream(spec) else None)
    strides = tuple(size // t.shape[2] for t in out["train_outs"])
    if strides == spec.strides:
        return spec
    return dataclasses.replace(spec, strides=strides)
