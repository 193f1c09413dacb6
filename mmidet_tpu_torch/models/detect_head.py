"""Anchor-based YOLOv5 detection head.

Counterpart of ``mmidet_tpu/models/detect_head.py``; reference ``Detect``
(``models/yolo_test.py:29-73``) and its bias initialisation
(``yolo_test.py:280-290``).  Training output per level is
``(B, na, ny, nx, no)``; inference also returns the decoded
``(B, sum(na*ny*nx), no)`` tensor that NMS takes.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Detect(nn.Module):
    def __init__(self, nc: int, anchors, ch, strides=(8, 16, 32)):
        super().__init__()
        self.nc, self.no = nc, nc + 5
        self.na = len(anchors[0]) // 2
        self.strides = tuple(strides)
        self.register_buffer("anchor_wh", torch.tensor(
            anchors, dtype=torch.float32).view(len(anchors), self.na, 2),
            persistent=False)
        self.m = nn.ModuleList(nn.Conv2d(c, self.na * self.no, 1) for c in ch)
        with torch.no_grad():  # focal-style prior (arXiv:1708.02002 §3.3)
            for conv, s in zip(self.m, self.strides):
                b = conv.bias.view(self.na, self.no)
                b.zero_()
                b[:, 4] += math.log(8 / (640 / s) ** 2)
                b[:, 5:] += math.log(0.6 / (nc - 0.99))

    def forward(self, xs):
        """xs: per-level NCHW maps. Returns (train_outs, pred)."""
        train_outs, decoded = [], []
        for i, x in enumerate(xs):
            b, _, ny, nx = x.shape
            y = self.m[i](x).view(b, self.na, self.no, ny, nx)
            y = y.permute(0, 1, 3, 4, 2)
            train_outs.append(y)
            dt = y.dtype
            gy, gx = torch.meshgrid(
                torch.arange(ny, device=y.device, dtype=dt),
                torch.arange(nx, device=y.device, dtype=dt), indexing="ij")
            grid = torch.stack([gx, gy], -1)[None, None]
            anchor = self.anchor_wh[i].to(dt).view(1, self.na, 1, 1, 2)
            z = torch.sigmoid(y)
            xy = (z[..., 0:2] * 2.0 - 0.5 + grid) * float(self.strides[i])
            wh = torch.square(z[..., 2:4] * 2.0) * anchor
            z = torch.cat([xy, wh, z[..., 4:]], -1)
            decoded.append(z.reshape(b, -1, self.no))
        return train_outs, torch.cat(decoded, 1)
