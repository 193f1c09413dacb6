"""Model zoo: the two-stream specs the port runs.

A copy of ``mmidet_tpu/models/zoo.py`` (``SCALES``, ``COCO_ANCHORS``,
``_head``, the fused-at-every-level branch of ``two_stream_spec`` and
``dryrun_spec``), so that the port imports nothing of the JAX package.
Families (reference ``models/transformer/*.yaml``):
  * ``fusion='fourier'`` — GPT1_fourier at P2, GPT at P3/P4/P5
    (``yolov5l_fusion_transformer_M3FD_fuse3_fourier.yaml``)
  * ``fusion='gpt1'``    — GPT1 at P2
  * ``fusion='gpt4'``    — GPT at P2+P3+P4+P5
    (``*_fusion_transformer_*.yaml``)

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
    else:
        raise ValueError(f"fusion {fusion!r} is not ported yet")

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
