#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA card.

    python3 chip_profile.py

Builds the same seeded yolov5s_gpt4 deploy model as ``chip_smoke.py``
(BN folded, bf16, batch 16 at 640x640) and prints JSON lines:
  * ``memory_format``: forward time in NCHW and in channels_last memory
    format, timed in turns (nchw, cl, cl, nchw) with CUDA events;
  * ``breakdown``: one forward + NMS under ``torch.profiler``: device time
    by kernel group (the two hand-written kernels, convolutions, the rest),
    the host wall time of the window and the device's idle share of it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GROUPS = (
    ("k1_token_transformer", ("layernorm_kernel", "gemm_kernel",
                              "attention_kernel")),
    ("k2_nms_greedy", ("nms_kernel",)),
    ("convolution", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn",
                     "sm90_", "nhwc", "nchw")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import build_model, card_line, time_ms
    from mmidet_tpu_torch.models.zoo import two_stream_spec
    from mmidet_tpu_torch.ops.nms import non_max_suppression
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    card = card_line()
    model = build_model(torch, two_stream_spec("s", "gpt4", nc=6)).to(
        dev, torch.bfloat16)
    B, S = 16, 640
    gen = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(B, S, S, 3, generator=gen, device=dev)
    ir = torch.rand(B, S, S, 3, generator=gen, device=dev)

    def step():
        return non_max_suppression(model(rgb, ir)["pred"].float(),
                                   conf_thres=0.001, iou_thres=0.45)

    with torch.inference_mode():
        times = {"nchw": [], "channels_last": []}
        for fmt in ("nchw", "channels_last", "channels_last", "nchw"):
            model.to(memory_format=torch.channels_last
                     if fmt == "channels_last" else torch.contiguous_format)
            times[fmt].append(time_ms(lambda: model(rgb, ir), reps=10,
                                      warmup=2))
        print(json.dumps({"phase": "memory_format", "card": card,
                          "forward_ms_per_batch": times, "batch": B,
                          "img": S}), flush=True)

        model.to(memory_format=torch.contiguous_format)
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_group: dict[str, float] = {}
    launches: dict[str, int] = {}
    top: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = evt.self_device_time_total
        g = group_of(evt.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3
        launches[g] = launches.get(g, 0) + evt.count
        top[evt.key[:80]] = dev_us / 1e3
    busy = sum(by_group.values())
    print(json.dumps({
        "phase": "breakdown", "card": card, "batch": B, "img": S,
        "window": "one forward + NMS", "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "idle_share": (1 - busy / wall_ms) if busy else "not measured",
        "device_ms_by_group": by_group, "launches_by_group": launches,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                               [:12])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
