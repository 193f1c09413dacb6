"""Standalone dataset-artifact upload, the "Dataset Creation" job
(reference ``utils/wandb_logging/log_dataset.py``; the JAX package's
``tools/log_dataset.py``).

Versions every split of a data yaml (both modalities and their labels)
into the artifact store (W&B when it imports and a run is live, else the
local store under ``MMIDET_ARTIFACT_ROOT``) and writes
``<data>_wandb.yaml``, whose paths are ``wandb-artifact://`` references:
train from that yaml directly, pinned with ``--artifact-alias``.

    python -m mmidet_tpu_torch.tools.log_dataset --data <data.yaml>
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Log the data yaml's splits; returns the path of the yaml written."""
    p = argparse.ArgumentParser("log_dataset")
    p.add_argument("--data", type=str, required=True, help="data yaml")
    p.add_argument("--project", type=str, default="mmidet_tpu")
    args = p.parse_args(argv)

    import yaml

    from mmidet_tpu_torch.utils.artifacts import (default_backend,
                                                  log_dataset_artifact)
    with open(args.data) as fh:
        data = yaml.safe_load(fh)
    out_yaml = "_wandb.".join(args.data.rsplit(".", 1))
    backend = default_backend(project=args.project)
    logged = log_dataset_artifact(data, backend, project=args.project,
                                  out_yaml=out_yaml)
    print(f"dataset artifacts logged; artifact-path yaml -> {out_yaml}")
    for k, v in logged.items():
        print(f"  {k}: {v}")
    return out_yaml


if __name__ == "__main__":
    main()
