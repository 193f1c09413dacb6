"""Dataset and model artifact versioning with ``wandb-artifact://`` resume.

Counterpart of ``mmidet_tpu/utils/artifacts.py``; reference W&B artifact
subsystem (``utils/wandb_logging/wandb_utils.py:80-306``): dataset
artifact upload (``log_dataset_artifact``), artifact paths resolved when
the loaders are built (``download_dataset_artifact``), per-epoch model
checkpoint artifacts with metadata and ``latest`` / ``epoch N`` / ``best``
aliases (``log_model``), and resuming a run straight from
``wandb-artifact://<project>/<run_id>`` (``check_wandb_resume`` +
``download_model_artifact``).

  * model artifacts hold the port's checkpoint files
    (``<run>/ckpt/epoch<N>.pt``, ``train/checkpoint.py``);
  * dataset artifacts carry both modalities (``train_rgb``/``train_ir``/
    ``val_rgb``/``val_ir``) with the shared label dir;
  * two backends: ``WandbBackend`` when the wandb package and a run
    exist, else ``LocalBackend``, a directory store with the JAX
    package's layout (``<root>/<project>/<name>/v<N>``, ``aliases.json``,
    ``.metadata.json``) under ``MMIDET_ARTIFACT_ROOT``, by default
    ``~/.cache/mmidet_tpu_torch/artifacts`` (a JAX store holds orbax
    directories, which the port does not restore).
"""

from __future__ import annotations

import json
import logging
import os
import shutil

logger = logging.getLogger(__name__)

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"
_DEFAULT_ROOT = os.path.join(os.path.expanduser("~"), ".cache",
                             "mmidet_tpu_torch", "artifacts")
# data-dict keys that may point at dataset artifacts (the paired superset
# of the reference's train/val)
DATA_KEYS = ("train_rgb", "train_ir", "val_rgb", "val_ir", "train", "val")


def is_artifact_path(p) -> bool:
    return isinstance(p, str) and p.startswith(WANDB_ARTIFACT_PREFIX)


def remove_prefix(p: str) -> str:
    return p[len(WANDB_ARTIFACT_PREFIX):]


def get_run_info(run_path: str) -> tuple[str, str, str]:
    """``wandb-artifact://<project>/<run_id>`` -> (run_id, project,
    model_artifact_name), the reference's resume addressing
    (wandb_utils.py:35-40)."""
    parts = remove_prefix(run_path).strip("/").split("/")
    run_id = parts[-1]
    project = parts[-2] if len(parts) > 1 else "mmidet_tpu"
    return run_id, project, f"run_{run_id}_model"


class LocalBackend:
    """Content-versioned directory store.

    Layout: ``<root>/<project>/<name>/v<N>/<files...>`` with
    ``<root>/<project>/<name>/aliases.json`` mapping alias -> version and
    ``.../v<N>/.metadata.json`` holding the artifact metadata.  Files are
    hard-linked when possible (datasets and checkpoints are large), copied
    otherwise.
    """

    def __init__(self, root: str | None = None, project: str = "mmidet_tpu"):
        self.root = root or os.environ.get("MMIDET_ARTIFACT_ROOT",
                                           _DEFAULT_ROOT)
        self.project = project

    def _art_dir(self, name: str, project: str | None = None) -> str:
        return os.path.join(self.root, project or self.project, name)

    @staticmethod
    def _link_or_copy(src: str, dst: str) -> None:
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)

    def log_artifact(self, name: str, type: str, contents: dict,
                     metadata: dict | None = None,
                     aliases: tuple = ("latest",),
                     project: str | None = None) -> str:
        """``contents`` maps an artifact-relative name to a local file or
        directory.  Returns the new version, ``v<N>``."""
        base = self._art_dir(name, project)
        os.makedirs(base, exist_ok=True)
        versions = [int(d[1:]) for d in os.listdir(base)
                    if d.startswith("v") and d[1:].isdigit()]
        ver = f"v{max(versions, default=-1) + 1}"
        vdir = os.path.join(base, ver)
        for rel, src in contents.items():
            dst = os.path.join(vdir, rel)
            if os.path.isdir(src):
                for dirpath, _, files in os.walk(src):
                    sub = os.path.relpath(dirpath, src)
                    for f in files:
                        self._link_or_copy(
                            os.path.join(dirpath, f),
                            os.path.join(dst, sub, f) if sub != "." else
                            os.path.join(dst, f))
            else:
                self._link_or_copy(src, dst)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, ".metadata.json"), "w") as fh:
            json.dump({"type": type, **(metadata or {})}, fh)
        alias_path = os.path.join(base, "aliases.json")
        amap = {}
        if os.path.isfile(alias_path):
            with open(alias_path) as fh:
                amap = json.load(fh)
        for a in aliases:
            if a:
                amap[a] = ver
        with open(alias_path, "w") as fh:
            json.dump(amap, fh)
        return ver

    def download(self, qualified: str, project: str | None = None) -> str:
        """``[<project>/]<name>:<alias>`` -> the local version dir (no
        copy: the store is local)."""
        name, _, alias = qualified.partition(":")
        alias = alias or "latest"
        if "/" in name:
            project, _, name = name.rpartition("/")
        base = self._art_dir(name, project)
        alias_path = os.path.join(base, "aliases.json")
        if not os.path.isfile(alias_path):
            raise FileNotFoundError(
                f"artifact {qualified!r} not found under {base}")
        with open(alias_path) as fh:
            amap = json.load(fh)
        if alias in amap:
            ver = amap[alias]
        elif alias.startswith("v") and \
                os.path.isdir(os.path.join(base, alias)):
            ver = alias
        else:
            raise FileNotFoundError(
                f"artifact {name!r} has no alias/version {alias!r} "
                f"(have {sorted(amap)})")
        return os.path.join(base, ver)

    def metadata(self, qualified: str, project: str | None = None) -> dict:
        d = self.download(qualified, project)
        try:
            with open(os.path.join(d, ".metadata.json")) as fh:
                return json.load(fh)
        except OSError:
            return {}


class WandbBackend:
    """Thin adapter over the wandb Artifact API (needs a live run)."""

    def __init__(self, run=None):
        import wandb
        self._wandb = wandb
        self.run = run or wandb.run
        if self.run is None:
            raise RuntimeError("WandbBackend needs an active wandb run")

    @staticmethod
    def _qualify(qualified: str, project: str | None) -> str:
        if ":" not in qualified:
            qualified += ":latest"
        if project and "/" not in qualified:
            qualified = f"{project}/{qualified}"
        return qualified

    def log_artifact(self, name: str, type: str, contents: dict,
                     metadata: dict | None = None,
                     aliases: tuple = ("latest",),
                     project: str | None = None) -> str:
        art = self._wandb.Artifact(name, type=type, metadata=metadata or {})
        for rel, src in contents.items():
            if os.path.isdir(src):
                art.add_dir(src, name=rel)
            else:
                art.add_file(src, name=rel)
        self.run.log_artifact(art, aliases=[a for a in aliases if a])
        return "latest"

    def download(self, qualified: str, project: str | None = None) -> str:
        return self.run.use_artifact(
            self._qualify(qualified, project)).download()

    def metadata(self, qualified: str, project: str | None = None) -> dict:
        return dict(self.run.use_artifact(
            self._qualify(qualified, project)).metadata)


def default_backend(project: str = "mmidet_tpu", wandb_run=None):
    """``WandbBackend`` when wandb and a run are available, else the local
    store."""
    try:
        return WandbBackend(run=wandb_run)
    except Exception:
        return LocalBackend(project=project)


def _labels_dir_for(images_dir: str) -> str | None:
    """The sibling labels dir of an images dir, by ``img2label_path``'s
    mapping (ref img2label_paths, datasets.py:708-735)."""
    from mmidet_tpu_torch.data.datasets import img2label_path
    lab = os.path.dirname(img2label_path(os.path.join(images_dir, "x.jpg")))
    return lab if os.path.isdir(lab) and lab != images_dir else None


def log_dataset_artifact(data: dict, backend, project: str = "mmidet_tpu",
                         out_yaml: str | None = None) -> dict:
    """Upload every image split of ``data`` (with its labels) as a dataset
    artifact and return a data dict whose paths are ``wandb-artifact://``
    references (ref log_dataset_artifact, wandb_utils.py:192-220).  One
    artifact per split key, images under ``data/images``, labels under
    ``data/labels``; ``out_yaml`` gets the rewritten dict."""
    out = dict(data)
    for key in DATA_KEYS:
        src = data.get(key)
        if not isinstance(src, str) or is_artifact_path(src) or \
                not os.path.isdir(src):
            continue
        contents = {"data/images": src}
        lab = _labels_dir_for(src)
        if lab:
            contents["data/labels"] = lab
        backend.log_artifact(key, "dataset", contents,
                             metadata={"nc": data.get("nc"),
                                       "names": data.get("names"),
                                       "source": os.path.abspath(src)},
                             project=project)
        out[key] = f"{WANDB_ARTIFACT_PREFIX}{project}/{key}"
    if out_yaml:
        import yaml
        with open(out_yaml, "w") as fh:
            yaml.safe_dump(dict(out), fh)
    return out


def resolve_data_artifacts(data: dict, backend=None,
                           alias: str = "latest") -> dict:
    """Replace every ``wandb-artifact://`` split path with its downloaded
    ``.../data/images`` dir (ref download_dataset_artifact,
    wandb_utils.py:160-166)."""
    out = dict(data)
    for key in DATA_KEYS:
        p = data.get(key)
        if not is_artifact_path(p):
            continue
        be = backend or default_backend()
        local = be.download(remove_prefix(p) + ":" + alias)
        img_dir = os.path.join(local, "data", "images")
        out[key] = img_dir if os.path.isdir(img_dir) else local
        logger.info("dataset artifact %s -> %s", p, out[key])
    return out


def log_model_artifact(backend, run_id: str, ckpt_dir: str, epoch: int,
                       total_epochs: int, fitness: float,
                       best: bool = False, project: str = "mmidet_tpu",
                       opt: dict | None = None) -> None:
    """Version a checkpoint directory as ``run_<id>_model`` with the
    reference's metadata and aliases (ref log_model,
    wandb_utils.py:181-191).  ``opt`` (the run's config) rides in the
    metadata, so that an artifact resume restores it (the reference keeps
    it in wandb_run.config, wandb_utils.py:103-106)."""
    backend.log_artifact(
        f"run_{run_id}_model", "model", {"ckpt": ckpt_dir},
        metadata={"epochs_trained": epoch + 1,
                  "total_epochs": total_epochs,
                  "fitness_score": float(fitness),
                  "opt": opt or {}},
        aliases=("latest", f"epoch {epoch + 1}", "best" if best else ""),
        project=project)


def resume_from_artifact(resume_path: str, backend=None,
                         alias: str = "latest") -> tuple[str, dict]:
    """``wandb-artifact://<project>/<run_id>`` -> (local checkpoint dir,
    metadata).  Refuses to resume a finished run, as the reference
    (wandb_utils.py:172-177: ``assert epochs_trained < total_epochs``)."""
    run_id, project, art_name = get_run_info(resume_path)
    be = backend or default_backend(project=project)
    qualified = f"{project}/{art_name}:{alias}"
    local = be.download(qualified)
    meta = be.metadata(qualified)
    trained, total = meta.get("epochs_trained"), meta.get("total_epochs")
    if trained is not None and total is not None:
        assert trained < total, (
            f"training to {total} epochs is finished, nothing to resume "
            f"(artifact {qualified} at epoch {trained})")
    ckpt = os.path.join(local, "ckpt")
    return (ckpt if os.path.isdir(ckpt) else local), meta
