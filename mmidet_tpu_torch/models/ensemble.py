"""Model ensembling.

Counterpart of ``mmidet_tpu/models/ensemble.py``; reference ``Ensemble`` +
``attempt_load`` (``models/experimental.py:100-134``): run each member and
concatenate their decoded predictions along the box axis before NMS (the
reference's NMS-ensemble mode).
"""

from __future__ import annotations

import torch
from torch import nn


class Ensemble(nn.Module):
    """Detectors run in turn; ``pred`` concatenated along the box axis,
    ``train_outs`` and ``aux`` the last member's (ref ``Ensemble.forward``,
    'nms ensemble')."""

    def __init__(self, members: list[nn.Module]):
        super().__init__()
        assert members, "empty ensemble"
        self.members = nn.ModuleList(members)
        self.spec = members[0].spec

    def forward(self, rgb: torch.Tensor, ir: torch.Tensor | None = None):
        preds, out = [], None
        for model in self.members:
            out = model(rgb, ir)
            preds.append(out["pred"])
        return {"pred": torch.cat(preds, 1), "train_outs": out["train_outs"],
                "aux": out.get("aux", {})}


def attempt_load_ensemble(bundles: list[str], device="cuda",
                          dtype: torch.dtype | None = None) -> Ensemble:
    """Several deploy bundles as one ``Ensemble`` in the deploy form on
    ``device`` (ref ``attempt_load`` with a list of weights).  Each
    member's ``use_cem`` comes from its spec (single-stream bundles have
    no CEM), as ``hub.custom`` takes it."""
    from mmidet_tpu_torch.cli.val import deploy_model
    from mmidet_tpu_torch.deploy.export import load_deploy_bundle
    from mmidet_tpu_torch.eval.evaluator import eval_device
    from mmidet_tpu_torch.models.spec import is_two_stream
    dev = eval_device(device)
    members = []
    for path in bundles:
        spec, sd, _ = load_deploy_bundle(path)
        members.append(deploy_model(spec, sd, use_cem=is_two_stream(spec),
                                    dev=dev, dtype=dtype))
    return Ensemble(members)
