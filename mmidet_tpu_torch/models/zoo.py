"""Programmatic model zoo: every reference architecture family generated from
one parametric grammar.

A copy of ``mmidet_tpu/models/zoo.py`` (the port imports nothing of the
JAX package).  Families (reference ``models/transformer/*.yaml`` +
``models/*.yaml``):
  * ``fusion='fourier'`` -- GPT1_fourier at P2, GPT at P3/P4/P5
    (``yolov5l_fusion_transformer_M3FD_fuse3_fourier.yaml``, the flagship)
  * ``fusion='gpt1'``    -- GPT1 at P2
  * ``fusion='gpt4'``    -- GPT at P2+P3+P4+P5 (``*_fusion_transformer_*``)
  * ``fusion='gpt3'``    -- GPT at P3/P4/P5 only (``*_transformerx3_*``)
  * ``fusion='add'``     -- late elementwise Add fusion (``*_fusion_add_*``)
  * ``fusion='mamba'``   -- the gpt4 grammar with ``MambaFusion`` at every
    level (the JAX package's state-space fusion, ``yolov5{s,m,l,x}_mamba``)
  * ``single_stream_spec`` / ``single_stream_p6_spec`` -- vanilla YOLOv5
    and YOLOv5-P6 (``models/yolov5{s,m,l,x}.yaml``, ``models/hub/*6.yaml``)

Scales use YOLOv5's (depth, width) multiples; anchor defaults are the COCO
anchors every reference config ships.
"""

from __future__ import annotations

from mmidet_tpu_torch.models.spec import SECOND_INPUT, LayerDef, ModelSpec

SCALES = {
    "t": (0.25, 0.125),  # tiny smoke scale (dryrun/CI; no reference analog)
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

COCO_ANCHORS = (
    (10, 13, 16, 30, 33, 23),      # P3/8
    (30, 61, 62, 45, 59, 119),     # P4/16
    (116, 90, 156, 198, 373, 326),  # P5/32
)

_P2_FUSION = {"fourier": "GPT1_fourier", "gpt1": "GPT1", "gpt4": "GPT"}


def _head(p3: int, p4: int, p5: int, base: int) -> list[LayerDef]:
    """PANet head; ``base`` is the index the head starts at; p3/p4/p5 are the
    fused backbone feature indices."""
    L = LayerDef
    b = base
    return [
        L(-1, 1, "Conv", (512, 1, 1)),              # b
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # b+1
        L((-1, p4), 1, "Concat", (1,)),             # b+2
        L(-1, 3, "C3", (512, False)),               # b+3
        L(-1, 1, "Conv", (256, 1, 1)),              # b+4
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # b+5
        L((-1, p3), 1, "Concat", (1,)),             # b+6
        L(-1, 3, "C3", (256, False)),               # b+7  P3 out
        L(-1, 1, "Conv", (256, 3, 2)),              # b+8
        L((-1, b + 4), 1, "Concat", (1,)),          # b+9
        L(-1, 3, "C3", (512, False)),               # b+10 P4 out
        L(-1, 1, "Conv", (512, 3, 2)),              # b+11
        L((-1, b), 1, "Concat", (1,)),              # b+12
        L(-1, 3, "C3", (1024, False)),              # b+13 P5 out
        L((b + 7, b + 10, b + 13), 1, "Detect", ()),  # b+14
    ]


def two_stream_spec(scale: str = "l", fusion: str = "fourier", nc: int = 6,
                    anchors=COCO_ANCHORS, fusion_layers: int = 8) -> ModelSpec:
    """Two-stream RGB+IR detector spec."""
    L = LayerDef
    gd, gw = SCALES[scale]
    layers: list[LayerDef] = []

    if fusion in _P2_FUSION:
        # fused-at-every-level grammar (fuse3_fourier / fusion_transformer)
        p2_mod = _P2_FUSION[fusion]
        layers += [
            # P2 stage, stream one / stream two
            L(-1, 1, "Focus", (64, 3)),            # 0
            L(-1, 1, "Conv", (128, 3, 2)),         # 1
            L(-1, 3, "C3", (128,)),                # 2
            L(SECOND_INPUT, 1, "Focus", (64, 3)),  # 3
            L(-1, 1, "Conv", (128, 3, 2)),         # 4
            L(-1, 3, "C3", (128,)),                # 5
            L((2, 5), 1, p2_mod, (128,)),          # 6
            L((2, 6), 1, "Add2", (128, 0)),        # 7
            L((5, 6), 1, "Add2", (128, 1)),        # 8
            # P3
            L(7, 1, "Conv", (256, 3, 2)),          # 9
            L(-1, 9, "C3", (256,)),                # 10
            L(8, 1, "Conv", (256, 3, 2)),          # 11
            L(-1, 9, "C3", (256,)),                # 12
            L((10, 12), 1, "GPT", (256,)),         # 13
            L((10, 13), 1, "Add2", (256, 0)),      # 14
            L((12, 13), 1, "Add2", (256, 1)),      # 15
            # P4
            L(14, 1, "Conv", (512, 3, 2)),         # 16
            L(-1, 9, "C3", (512,)),                # 17
            L(15, 1, "Conv", (512, 3, 2)),         # 18
            L(-1, 9, "C3", (512,)),                # 19
            L((17, 19), 1, "GPT", (512,)),         # 20
            L((17, 20), 1, "Add2", (512, 0)),      # 21
            L((19, 20), 1, "Add2", (512, 1)),      # 22
            # P5
            L(-2, 1, "Conv", (1024, 3, 2)),        # 23 (from 21)
            L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 24
            L(-1, 3, "C3", (1024, False)),         # 25
            L(22, 1, "Conv", (1024, 3, 2)),        # 26
            L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 27
            L(-1, 3, "C3", (1024, False)),         # 28
            L((25, 28), 1, "GPT", (1024,)),        # 29
            L((25, 29), 1, "Add2", (1024, 0)),     # 30
            L((28, 29), 1, "Add2", (1024, 1)),     # 31
            # fused pyramid
            L((14, 15), 1, "Add", (1,)),           # 32 P3
            L((21, 22), 1, "Add", (1,)),           # 33 P4
            L((30, 31), 1, "Add", (1,)),           # 34 P5
        ]
        layers += _head(p3=32, p4=33, p5=34, base=35)
    elif fusion == "gpt3":
        # GPT at P3/P4/P5 (transformerx3 grammar)
        layers += [
            L(-1, 1, "Focus", (64, 3)),            # 0
            L(-1, 1, "Conv", (128, 3, 2)),         # 1
            L(-1, 3, "C3", (128,)),                # 2
            L(-1, 1, "Conv", (256, 3, 2)),         # 3
            L(-1, 9, "C3", (256,)),                # 4
            L(SECOND_INPUT, 1, "Focus", (64, 3)),  # 5
            L(-1, 1, "Conv", (128, 3, 2)),         # 6
            L(-1, 3, "C3", (128,)),                # 7
            L(-1, 1, "Conv", (256, 3, 2)),         # 8
            L(-1, 9, "C3", (256,)),                # 9
            L((4, 9), 1, "GPT", (256,)),           # 10
            L((4, 10), 1, "Add2", (256, 0)),       # 11
            L((9, 10), 1, "Add2", (256, 1)),       # 12
            L(11, 1, "Conv", (512, 3, 2)),         # 13
            L(-1, 9, "C3", (512,)),                # 14
            L(12, 1, "Conv", (512, 3, 2)),         # 15
            L(-1, 9, "C3", (512,)),                # 16
            L((14, 16), 1, "GPT", (512,)),         # 17
            L((14, 17), 1, "Add2", (512, 0)),      # 18
            L((16, 17), 1, "Add2", (512, 1)),      # 19
            L(18, 1, "Conv", (1024, 3, 2)),        # 20
            L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 21
            L(-1, 3, "C3", (1024, False)),         # 22
            L(19, 1, "Conv", (1024, 3, 2)),        # 23
            L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 24
            L(-1, 3, "C3", (1024, False)),         # 25
            L((22, 25), 1, "GPT", (1024,)),        # 26
            L((22, 26), 1, "Add2", (1024, 0)),     # 27
            L((25, 26), 1, "Add2", (1024, 1)),     # 28
            L((11, 12), 1, "Add", (1,)),           # 29 P3
            L((18, 19), 1, "Add", (1,)),           # 30 P4
            L((27, 28), 1, "Add", (1,)),           # 31 P5
        ]
        layers += _head(p3=29, p4=30, p5=31, base=32)
    elif fusion == "add":
        # two full backbones + late Add (fusion_add grammar)
        def backbone(first_f):
            return [
                L(first_f, 1, "Focus", (64, 3)),
                L(-1, 1, "Conv", (128, 3, 2)),
                L(-1, 3, "C3", (128,)),
                L(-1, 1, "Conv", (256, 3, 2)),
                L(-1, 9, "C3", (256,)),
                L(-1, 1, "Conv", (512, 3, 2)),
                L(-1, 9, "C3", (512,)),
                L(-1, 1, "Conv", (1024, 3, 2)),
                L(-1, 1, "SPP", (1024, (5, 9, 13))),
                L(-1, 3, "C3", (1024, False)),
            ]
        layers += backbone(-1)               # 0-9
        layers += backbone(SECOND_INPUT)     # 10-19
        layers += [
            L((4, 14), 1, "Add", (1,)),      # 20 P3
            L((6, 16), 1, "Add", (1,)),      # 21 P4
            L((9, 19), 1, "Add", (1,)),      # 22 P5
        ]
        layers += _head(p3=20, p4=21, p5=22, base=23)
    elif fusion == "mamba":
        # gpt4 grammar with Mamba SSM fusion in place of attention (the
        # reference ships Mamba unwired; BASELINE names a yolov5x+mamba
        # variant) — cross-modal state-space fusion at all four levels
        base = two_stream_spec(scale, "gpt4", nc, anchors)
        layers = [LayerDef(l.f, l.n, "MambaFusion" if l.name == "GPT"
                           else l.name, l.args) for l in base.layers]
    else:
        raise ValueError(f"unknown fusion {fusion!r}")

    return ModelSpec(nc=nc, anchors=tuple(anchors), layers=tuple(layers),
                     depth_multiple=gd, width_multiple=gw,
                     fusion_layers=fusion_layers)


def dryrun_spec(nc: int = 2, fusion_layers: int = 1) -> ModelSpec:
    """Minimal two-stream spec for the multi-chip dryrun (CI-only; no
    reference analog).  ONE cross-modal GPT fusion level plus a one-branch
    PANet-style neck — covers every module class the full two-stream
    grammar uses (Focus/Conv/C3/SPP/GPT/Add2/Add/Upsample/Concat/Detect +
    SECOND_INPUT routing, so the sharding/psum semantics exercised are
    identical to the 's'/'l' specs) at a fraction of the compile cost:
    21 layers vs gpt4's 50."""
    L = LayerDef
    layers = (
        # stream 1 -> P3/8
        L(-1, 1, "Focus", (64, 3)),            # 0  /2
        L(-1, 1, "Conv", (128, 3, 2)),         # 1  /4
        L(-1, 1, "C3", (128,)),                # 2
        L(-1, 1, "Conv", (256, 3, 2)),         # 3  /8
        # stream 2 -> P3/8
        L(SECOND_INPUT, 1, "Focus", (64, 3)),  # 4
        L(-1, 1, "Conv", (128, 3, 2)),         # 5
        L(-1, 1, "C3", (128,)),                # 6
        L(-1, 1, "Conv", (256, 3, 2)),         # 7
        # cross-modal transformer fusion (the TP-sharded attention path)
        L((3, 7), 1, "GPT", (256,)),           # 8
        L((3, 8), 1, "Add2", (256, 0)),        # 9
        L((7, 8), 1, "Add2", (256, 1)),        # 10
        L((9, 10), 1, "Add", (1,)),            # 11 P3 out
        # shared neck down
        L(-1, 1, "Conv", (512, 3, 2)),         # 12 /16
        L(-1, 1, "C3", (512,)),                # 13
        L(-1, 1, "Conv", (1024, 3, 2)),        # 14 /32
        L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 15 P5 out
        # one PANet branch (Upsample/Concat coverage)
        L(-1, 1, "Conv", (512, 1, 1)),         # 16
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # 17
        L((-1, 13), 1, "Concat", (1,)),        # 18
        L(-1, 1, "C3", (512, False)),          # 19 P4 out
        L((11, 19, 15), 1, "Detect", ()),      # 20
    )
    return ModelSpec(nc=nc, anchors=COCO_ANCHORS, layers=layers,
                     depth_multiple=0.25, width_multiple=0.125,
                     fusion_layers=fusion_layers)


def single_stream_spec(scale: str = "s", nc: int = 80,
                       anchors=COCO_ANCHORS) -> ModelSpec:
    """Vanilla YOLOv5 (reference ``models/yolov5{s,m,l,x}.yaml``)."""
    L = LayerDef
    gd, gw = SCALES[scale]
    layers = [
        L(-1, 1, "Focus", (64, 3)),            # 0
        L(-1, 1, "Conv", (128, 3, 2)),         # 1
        L(-1, 3, "C3", (128,)),                # 2
        L(-1, 1, "Conv", (256, 3, 2)),         # 3
        L(-1, 9, "C3", (256,)),                # 4
        L(-1, 1, "Conv", (512, 3, 2)),         # 5
        L(-1, 9, "C3", (512,)),                # 6
        L(-1, 1, "Conv", (1024, 3, 2)),        # 7
        L(-1, 1, "SPP", (1024, (5, 9, 13))),   # 8
        L(-1, 3, "C3", (1024, False)),         # 9
    ]
    layers += _head(p3=4, p4=6, p5=9, base=10)
    return ModelSpec(nc=nc, anchors=tuple(anchors), layers=tuple(layers),
                     depth_multiple=gd, width_multiple=gw)


P6_ANCHORS = ((19, 27, 44, 40, 38, 94),
              (96, 68, 86, 152, 180, 137),
              (140, 301, 303, 264, 238, 542),
              (436, 615, 739, 380, 925, 792))


def single_stream_p6_spec(scale: str = "s", nc: int = 80,
                          anchors=P6_ANCHORS) -> ModelSpec:
    """YOLOv5-P6 (stride-64 fourth level; reference
    ``models/hub/yolov5{s,m,l,x}6.yaml``)."""
    L = LayerDef
    gd, gw = SCALES[scale]
    layers = [
        L(-1, 1, "Focus", (64, 3)),            # 0
        L(-1, 1, "Conv", (128, 3, 2)),         # 1
        L(-1, 3, "C3", (128,)),                # 2
        L(-1, 1, "Conv", (256, 3, 2)),         # 3
        L(-1, 9, "C3", (256,)),                # 4
        L(-1, 1, "Conv", (512, 3, 2)),         # 5
        L(-1, 9, "C3", (512,)),                # 6
        L(-1, 1, "Conv", (768, 3, 2)),         # 7
        L(-1, 3, "C3", (768,)),                # 8
        L(-1, 1, "Conv", (1024, 3, 2)),        # 9
        L(-1, 1, "SPP", (1024, (3, 5, 7))),    # 10
        L(-1, 3, "C3", (1024, False)),         # 11
        # head
        L(-1, 1, "Conv", (768, 1, 1)),         # 12
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # 13
        L((-1, 8), 1, "Concat", (1,)),         # 14
        L(-1, 3, "C3", (768, False)),          # 15
        L(-1, 1, "Conv", (512, 1, 1)),         # 16
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # 17
        L((-1, 6), 1, "Concat", (1,)),         # 18
        L(-1, 3, "C3", (512, False)),          # 19
        L(-1, 1, "Conv", (256, 1, 1)),         # 20
        L(-1, 1, "Upsample", (None, 2, "nearest")),  # 21
        L((-1, 4), 1, "Concat", (1,)),         # 22
        L(-1, 3, "C3", (256, False)),          # 23 P3/8
        L(-1, 1, "Conv", (256, 3, 2)),         # 24
        L((-1, 20), 1, "Concat", (1,)),        # 25
        L(-1, 3, "C3", (512, False)),          # 26 P4/16
        L(-1, 1, "Conv", (512, 3, 2)),         # 27
        L((-1, 16), 1, "Concat", (1,)),        # 28
        L(-1, 3, "C3", (768, False)),          # 29 P5/32
        L(-1, 1, "Conv", (768, 3, 2)),         # 30
        L((-1, 12), 1, "Concat", (1,)),        # 31
        L(-1, 3, "C3", (1024, False)),         # 32 P6/64
        L((23, 26, 29, 32), 1, "Detect", (nc, tuple(anchors))),  # 33
    ]
    return ModelSpec(nc=nc, anchors=tuple(anchors), layers=tuple(layers),
                     strides=(8, 16, 32, 64),
                     depth_multiple=gd, width_multiple=gw)


def _named(name: str) -> ModelSpec:
    """Named model registry: e.g. 'yolov5l_fuse3_fourier', 'yolov5s_gpt4',
    'yolov5m_add', 'yolov5s' (single-stream)."""
    parts = name.split("_", 1)
    scale = parts[0].removeprefix("yolov5")
    if len(parts) == 1:
        if scale.endswith("6"):
            return single_stream_p6_spec(scale[:-1])
        return single_stream_spec(scale)
    fusion = {"fuse3": "fourier", "fuse3_fourier": "fourier",
              "fourier": "fourier", "gpt4": "gpt4", "transformer": "gpt4",
              "gpt3": "gpt3", "transformerx3": "gpt3", "add": "add",
              "gpt1": "gpt1", "mamba": "mamba"}[parts[1]]
    return two_stream_spec(scale, fusion)


def get_model_spec(name: str, nc: int | None = None,
                   anchors=None) -> ModelSpec:
    spec = _named(name)
    if nc is not None or anchors is not None:
        spec = ModelSpec(
            nc=nc if nc is not None else spec.nc,
            anchors=tuple(tuple(a) for a in anchors) if anchors else spec.anchors,
            layers=spec.layers, depth_multiple=spec.depth_multiple,
            width_multiple=spec.width_multiple, ch_in=spec.ch_in,
            strides=spec.strides)
    return spec
