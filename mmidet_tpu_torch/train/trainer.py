"""Two-stream training driver on the card.

Counterpart of ``mmidet_tpu/train/trainer.py``; reference
``train.py:476-943``: model build, loaders, optimizer groups + warmup +
cosine, EMA, per-epoch evaluation with fitness-driven best checkpoints,
results logging, resume.  The loop is the JAX package's ``fused_loop=
False`` order: for each loader batch, the augmentation (on the card, from
a seeded ``torch.Generator``), then the train step.  Loss means are summed
on the card and read once an epoch.

The per-epoch evaluation follows the JAX trainer (:437-440, :710-724): a
bf16 copy of the EMA model (when ``dtype="bfloat16"``) with
``kernel_fusion=True``, the JAX package's ``pallas_fusion``: the fused
token transformer (K1) at every fusion level, BN not folded; ``evaluate``
runs its NMS through greedy NMS's large-pool form (K2, ``pre_nms_topk``
30000).  ``best_fitness`` drives ``ckpt_best/``.

The loader and the augmentation are the JAX trainer's choice
(:448-482): with hyp ``mosaic`` > 0 and ``mosaic_prob`` > 0 (the default)
and no ``rect``, ``MosaicLoader`` and the mosaic augmentation; with
``rect``, ``RectLoader``'s aspect-bucketed batches; else ``PairedLoader``;
the last two with the basic augmentation.  Tiles and images reach the
card as uint8 and become floats there.  ``quad`` regroups each augmented
batch by 4 (``quad_batch``), ``multi_scale`` resizes it to a size drawn
from ``multi_scale_sizes`` by ``default_rng(seed + 2)``, and ``remat``
recomputes the train forward in the backward (``train/step.py``).

The per-run options follow the JAX trainer too: ``image_weights``
resamples each next epoch's images by ``labels_to_image_weights`` of the
class weights times ``(1 - maps) ** 2`` (:792-802), ``bbox_interval``
writes annotated val images every N epochs (:719-731), ``use_wandb``
opens the logger's W&B leg when wandb imports (:588-592), the artifact
options version the dataset, the checkpoints and the val predictions in
``utils/artifacts.py``'s store and resume from ``wandb-artifact://``
(:304-340, :382-395, :688-752), and ``bucket`` uploads ``results.txt``
each evaluation (:773-775).

``train(cfg, device="cuda")`` runs on the card; without CUDA it raises
unless ``device="cpu"``.

The mesh follows the JAX trainer (:269-298, ``setup_mesh``): over
``devices`` (every visible card for a bare ``"cuda"``, one device for
an indexed one or the CPU; ``["cpu"] * 4`` or
``["cuda:0"] * 2`` name one device more than once) a ``data`` x ``model``
mesh, one process a rank (``parallel/launch.py``: NCCL when every rank has
a card of its own, gloo otherwise), its data axis clamped to a divisor of
the batch.  Each rank decodes its rows of every global batch, makes the
augmentation's draws for the whole batch and keeps its rows; a ragged
batch runs whole on every rank.  The step's BatchNorm statistics, dropout
masks and losses are the global batch's (``parallel/comm.py``), so the run
gives what one process gives on the same batches up to the order of float
sums.  ``n_model`` > 1 shards the wide layers' out channels
(``tp_min_out``).  Rank 0 alone evaluates, logs, plots and writes
checkpoints, which hold whole tensors: a mesh run resumes on one process
and the other way round.  ``train`` returns rank 0's result, with whole
weights.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from mmidet_tpu_torch.data.augment import (AugmentHyp, make_batch_augment,
                                           quad_batch, quad_draws,
                                           resize_nhwc)
from mmidet_tpu_torch.data.datasets import PairedDataset, load_data_yaml
from mmidet_tpu_torch.data.loader import (MosaicLoader, PairedLoader,
                                          RectLoader)
from mmidet_tpu_torch.eval.evaluator import eval_device, evaluate
from mmidet_tpu_torch.eval.metrics import fitness
from mmidet_tpu_torch.losses.detection import LossHyp
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.spec import is_two_stream, load_yolo_yaml
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.parallel.mesh import (batch_rows, default_devices,
                                            make_mesh, shard_train_state,
                                            unshard_train_state)
from mmidet_tpu_torch.train.checkpoint import (checkpoints,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               strip_for_deploy)
from mmidet_tpu_torch.train.optimizer import build_adam, build_optimizer
from mmidet_tpu_torch.train.schedule import ScheduleConfig
from mmidet_tpu_torch.train.step import init_state, make_train_step
from mmidet_tpu_torch.utils.general import check_img_size, increment_path

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` but ``fused_loop`` (the port runs
    the two-dispatch order)."""
    model: str = "yolov5l_fuse3_fourier"   # zoo name or YAML path
    mesh: str = "auto"   # 'auto'/'on': over the devices; 'off': one
    n_model: int = 1     # tensor parallelism: the mesh's model axis
    tp_min_out: int = 256  # shard layers with this many out channels
    data: str = ""                         # dataset YAML path
    hyp: str | dict = ""                   # hyp YAML path or dict
    epochs: int = 100
    batch_size: int = 8
    img_size: int = 640
    max_labels: int = 120
    workdir: str = "runs/train/exp"
    adam: bool = False
    linear_lr: bool = False
    mosaic_prob: float = 1.0   # > 0 with hyp mosaic > 0: mosaic batches
    use_cem: bool = True
    aux_mode: str = "reference"
    dtype: str = "bfloat16"
    ema_decay: float = 0.9999
    eval_every: int = 1
    seed: int = 0
    resume: str = ""                        # run dir, ckpt dir or "latest"
    optimizer_groups: str = "fixed"         # 'fixed' | 'reference'
    autoanchor: bool = True                 # BPR check + kmeans refit
    use_wandb: bool = False      # W&B leg of the logger when wandb imports
    warmup_floor: int = 1000                # reference's warmup iter floor
    nbs: int = 64            # nominal batch size (ref train.py:564): sets
    #                          gradient accumulation round(nbs / batch)
    #                          and the weight-decay scale
    remat: str = ""          # '' | 'dots' | 'full': the forward recomputed
    #                          in the backward, as the JAX package's; one
    #                          checkpoint over the whole forward, so it
    #                          saves no memory here, only costs time
    #                          (train/step.py)
    weights: str = ""        # pretrained init: a .pt or bundle (tolerant)
    image_weights: bool = False  # resample train images by (1-mAP)^2 class
    #                              weights each epoch (ref --image-weights)
    single_cls: bool = False
    multi_scale: bool = False    # random /gs size in [0.5, 1.5]x a batch
    #                              (ref train.py:778-783)
    multi_scale_buckets: int = 0  # cap the size set to N evenly spaced
    #                               sizes (0: the reference's whole range)
    rect: bool = False           # aspect-bucketed train batches (disables
    #                              mosaic, as the reference does)
    notest: bool = False         # eval only on the final epoch
    nosave: bool = False         # checkpoint only on the final epoch
    save_period: int = -1        # extra checkpoint every N epochs
    exist_ok: bool = False       # reuse workdir without incrementing
    workers: int = 2             # loader prefetch depth (ref --workers)
    freeze: tuple = ()           # parameter-name substrings to freeze
    upload_dataset: bool = False  # version the dataset as an artifact
    #                               (ref --upload_dataset, wandb_utils.py)
    log_artifacts: bool = False  # version checkpoints as model artifacts
    artifact_alias: str = "latest"  # dataset artifact alias to pull
    #                                 (ref --artifact_alias)
    artifact_project: str = "mmidet_tpu"  # the store's (W&B's) project
    label_smoothing: float | None = None  # None = the hyp file's value
    cache_images: bool = False   # RAM-cache decoded images
    quad: bool = False           # groups of 4 -> one 2x-size sample
    #                              (ref --quad / collate_fn4)
    bucket: str = ""             # gsutil bucket for results upload
    #                              (ref --bucket, train.py:860-861)
    entity: str = ""             # W&B entity (ref --entity)
    bbox_interval: int = -1      # every N epochs, annotated val images
    #                              (+W&B media) (ref --bbox_interval)


DEFAULT_HYP = {
    "lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
    "iou_t": 0.20, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
    "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.0,
    "label_smoothing": 0.0,
}


def load_hyp(hyp) -> dict:
    if isinstance(hyp, dict):
        return {**DEFAULT_HYP, **hyp}
    if hyp and os.path.isfile(hyp):
        import yaml
        with open(hyp) as fh:
            return {**DEFAULT_HYP, **yaml.safe_load(fh)}
    return dict(DEFAULT_HYP)


def setup_mesh(cfg: TrainConfig, devices=None) -> tuple[int, int] | None:
    """The ('data', 'model') mesh's shape over ``devices`` (every visible
    card by default), or None for one process: the JAX trainer's rules
    (:269-298).  ``mesh="off"``, or one device with ``n_model == 1``, is no
    mesh; ``n_model`` beyond the devices raises; the data axis is clamped
    to the largest divisor of ``batch_size`` (the reference asserts batch
    % world_size == 0 for DDP, train.py:992-996)."""
    devices = list(default_devices() if devices is None else devices)
    n_model = max(int(cfg.n_model), 1)
    if cfg.mesh == "off" or (len(devices) == 1 and n_model == 1):
        return None
    if n_model > len(devices):
        raise ValueError(f"n_model={n_model} > {len(devices)} devices")
    n_data = len(devices) // n_model
    while cfg.batch_size % n_data:
        n_data -= 1
    if n_data * n_model == 1:
        return None
    if n_data < len(devices) // n_model:
        logger.warning(
            "mesh: data axis clamped to %d (batch %d not divisible by %d)",
            n_data, cfg.batch_size, len(devices) // n_model)
    logger.info("mesh: data=%d x model=%d over %d devices", n_data,
                n_model, len(devices))
    return n_data, n_model


def multi_scale_sizes(img_size: int, gs: int, buckets: int) -> np.ndarray:
    """The /gs image sizes ``--multi-scale`` draws from, across [0.5, 1.5]x
    img_size (ref train.py:778-783); ``buckets`` > 0 caps the set at that
    many evenly spaced sizes."""
    lo, hi = img_size // 2 // gs, img_size * 3 // 2 // gs
    if buckets > 0:
        return np.unique(np.round(
            np.linspace(lo, hi, buckets)).astype(int)) * gs
    return np.arange(lo, hi + 1) * gs


def _spec_from_cfg(cfg: TrainConfig, nc: int):
    if cfg.model.endswith((".yaml", ".yml")):
        return load_yolo_yaml(cfg.model, nc=nc)
    return get_model_spec(cfg.model, nc=nc)


def anchors_grid(spec) -> torch.Tensor:
    """(nl, na, 2) anchors in grid units (``Detect.grid_anchors()``)."""
    a = np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
    s = np.asarray(spec.strides, np.float32)[:, None, None]
    return torch.from_numpy(a / s)


@torch.no_grad()
def transfer_matching(model: torch.nn.Module, loaded: dict
                      ) -> tuple[int, int]:
    """Shape-tolerant transfer, the reference's intersect_dicts +
    strict=False load (train.py:544-547): copy every entry whose name and
    shape match; keep the model's elsewhere.  Returns (n_copied, n_total)
    over the floating-point entries."""
    own = {k: v for k, v in model.state_dict().items()
           if v.is_floating_point()}
    copied = 0
    for k, v in own.items():
        src = loaded.get(k)
        if src is not None and tuple(src.shape) == tuple(v.shape):
            v.copy_(src)
            copied += 1
    return copied, len(own)


def build_sched_and_loss(cfg: TrainConfig, hyp: dict, steps_per_epoch: int):
    sched = ScheduleConfig(
        lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
        warmup_epochs=hyp["warmup_epochs"],
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"], epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, linear_lr=cfg.linear_lr,
        warmup_floor=cfg.warmup_floor)
    loss_hyp = LossHyp(
        box=hyp["box"], cls=hyp["cls"], cls_pw=hyp["cls_pw"],
        obj=hyp["obj"], obj_pw=hyp["obj_pw"], anchor_t=hyp["anchor_t"],
        fl_gamma=hyp["fl_gamma"],
        label_smoothing=hyp.get("label_smoothing", 0.0))
    return sched, loss_hyp


def _resolve_run(cfg: TrainConfig, hyp: dict):
    """The workdir, the checkpoint dir to resume from (or None), and the
    config and hyp after an in-place resume adopted the stored run's
    structure fields (the JAX trainer's rules, trainer.py:304-372)."""
    import yaml

    from mmidet_tpu_torch.utils.general import get_latest_run
    r = cfg.resume if isinstance(cfg.resume, str) else ""
    if r in ("latest", "true", "True") or cfg.resume is True:
        # bare --resume: the newest run under the project dir
        r = get_latest_run(os.path.dirname(cfg.workdir) or ".")
        if not r:
            raise FileNotFoundError(
                f"--resume latest: no previous run with a ckpt/ under "
                f"{os.path.dirname(cfg.workdir) or '.'}")
        cfg = dataclasses.replace(cfg, resume=r)
    if cfg.resume and os.path.isdir(os.path.join(r, "ckpt")):
        # a previous RUN dir continues in place and adopts the fields that
        # shape the train state; the schedule fields stay the caller's, so
        # that --resume --epochs N extends a run
        opt_path = os.path.join(r, "opt.yaml")
        if os.path.isfile(opt_path):
            with open(opt_path) as fh:
                stored = yaml.safe_load(fh) or {}
            keep = {k: stored[k] for k in
                    ("model", "adam", "optimizer_groups", "nbs",
                     "batch_size", "use_cem", "aux_mode", "dtype",
                     "single_cls") if k in stored}
            if isinstance(stored.get("freeze"), list):
                keep["freeze"] = tuple(stored["freeze"])
            cfg = dataclasses.replace(cfg, **keep)
            hyp_path = os.path.join(r, "hyp.yaml")
            if os.path.isfile(hyp_path):
                cfg = dataclasses.replace(cfg, hyp=hyp_path)
            hyp = load_hyp(cfg.hyp)
        return cfg, hyp, r, os.path.join(r, "ckpt")
    if cfg.resume and os.path.isdir(r):  # a bare checkpoint dir
        return cfg, hyp, increment_path(cfg.workdir, cfg.exist_ok), r
    if cfg.resume:
        return cfg, hyp, cfg.workdir, None
    return cfg, hyp, increment_path(cfg.workdir, cfg.exist_ok), None


def _shapes(ds: PairedDataset, n: int) -> list[tuple[int, int]]:
    """(h, w) of the first ``n`` images, read from their headers."""
    from PIL import Image
    out = []
    for f in ds.rgb_files[:n]:
        with Image.open(f) as im:
            out.append((im.size[1], im.size[0]))
    return out


def eval_model_for(spec, use_cem: bool, dtype: str) -> TwoStreamDetector:
    """The per-epoch evaluation model: aux off, the fused token
    transformer at every fusion level (``kernel_fusion``, the JAX
    trainer's ``pallas_fusion``), BN not folded, bf16 when the run is."""
    model = TwoStreamDetector(spec, use_cem=use_cem, kernel_fusion=True)
    return model.to(torch.bfloat16 if dtype == "bfloat16"
                    else torch.float32).eval()


def train(cfg: TrainConfig, device: str | torch.device = "cuda",
          devices=None) -> dict:
    """Run training; returns a summary dict (workdir, best fitness, the
    deploy state dict, the train state, the last results, the mesh).
    ``devices``: the mesh's devices (default: every visible card for a
    bare ``"cuda"``, else ``[device]``); the run is one process when
    ``setup_mesh`` makes no mesh of them."""
    dev = eval_device(device if devices is None else devices[0])
    devices = default_devices(dev) if devices is None else \
        [eval_device(d) for d in devices]
    shape = setup_mesh(cfg, devices)   # its errors before any write
    prep = _prepare(cfg)
    if prep[0].batch_size != cfg.batch_size:   # a resumed run's
        shape = setup_mesh(prep[0], devices)
    if shape is None:
        return _train(*prep, dev=dev)
    return _launch(prep, devices, *shape)


def train_mesh(cfg: TrainConfig, devices, n_data: int,
               n_model: int = 1) -> dict:
    """``train`` on an ``n_data`` x ``n_model`` mesh of ``devices`` as
    given, one rank a device, without ``setup_mesh``'s rules: a mesh of
    one rank (NCCL at world size 1 on a card) included."""
    devices = [eval_device(d) for d in devices]
    return _launch(_prepare(cfg), devices, n_data, n_model)


def _launch(prep: tuple, devices: list, n_data: int, n_model: int) -> dict:
    from mmidet_tpu_torch.parallel.launch import launch
    cfg, hyp, data, workdir, resume_src, art_backend = prep
    devices = devices[:n_data * n_model]
    return launch(_train_rank, (cfg, hyp, data, workdir, resume_src,
                                devices, n_data, n_model),
                  devices, workdir, local_kwargs={"art_backend": art_backend})


def _train_rank(cfg, hyp, data, workdir, resume_src, devices, n_data,
                n_model, art_backend=None) -> dict:
    mesh = make_mesh(n_data, n_model, devices)
    return _train(cfg, hyp, data, workdir, resume_src, art_backend,
                  dev=mesh.device, mesh=mesh)


def _prepare(cfg: TrainConfig) -> tuple:
    """The run's config, hyp, dataset dict, workdir, checkpoint to resume
    from and artifact store, with ``hyp.yaml`` and ``opt.yaml`` written
    (once, before any rank starts)."""
    import yaml
    hyp = load_hyp(cfg.hyp)
    from mmidet_tpu_torch.utils.artifacts import (default_backend,
                                                  is_artifact_path,
                                                  log_dataset_artifact,
                                                  resolve_data_artifacts,
                                                  resume_from_artifact)
    art_backend = None
    if cfg.upload_dataset or cfg.log_artifacts or \
            is_artifact_path(cfg.resume):
        art_backend = default_backend(project=cfg.artifact_project)
    if is_artifact_path(cfg.resume):
        # wandb-artifact://<project>/<run_id> (ref check_wandb_resume +
        # download_model_artifact, wandb_utils.py:42-53,168-177): the
        # artifact's checkpoint seeds a fresh workdir with the stored run
        # config's epochs and hyp
        r, art_meta = resume_from_artifact(cfg.resume, art_backend)
        stored = art_meta.get("opt") or {}
        if stored.get("epochs"):
            cfg = dataclasses.replace(cfg, epochs=int(stored["epochs"]))
        if stored.get("hyp"):
            cfg = dataclasses.replace(cfg, hyp=stored["hyp"])
            hyp = load_hyp(cfg.hyp)
        cfg = dataclasses.replace(cfg, resume=r)
    cfg, hyp, workdir, resume_src = _resolve_run(cfg, hyp)
    if cfg.label_smoothing is not None:  # CLI override
        hyp["label_smoothing"] = float(cfg.label_smoothing)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "hyp.yaml"), "w") as fh:
        yaml.safe_dump(hyp, fh)
    with open(os.path.join(workdir, "opt.yaml"), "w") as fh:
        yaml.safe_dump({**dataclasses.asdict(cfg),
                        "freeze": list(cfg.freeze)}, fh)

    data = load_data_yaml(cfg.data)
    if cfg.upload_dataset:
        # version the dataset and rewrite its paths to artifact references
        # (ref check_and_upload_dataset, wandb_utils.py:116-124)
        data = log_dataset_artifact(
            data, art_backend, project=cfg.artifact_project,
            out_yaml=os.path.join(workdir, "data_wandb.yaml"))
    if any(is_artifact_path(data.get(k)) for k in
           ("train_rgb", "train_ir", "val_rgb", "val_ir")):
        data = resolve_data_artifacts(
            data, art_backend or default_backend(cfg.artifact_project),
            alias=cfg.artifact_alias)
    return cfg, hyp, data, workdir, resume_src, art_backend


def _barrier(mesh) -> None:
    import torch.distributed as dist
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def _from_rank0(mesh, obj):
    """Rank 0's ``obj`` on every rank of the mesh."""
    if mesh is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _train(cfg: TrainConfig, hyp: dict, data: dict, workdir: str,
           resume_src: str | None, art_backend, dev: torch.device,
           mesh=None) -> dict:
    """One process's run: the whole run, or one rank's share of a mesh
    run (``mesh``); rank 0 (``lead``) alone evaluates, logs and saves."""
    lead = mesh is None or mesh.rank == 0
    nc = 1 if cfg.single_cls else int(data["nc"])
    names = ["item"] if cfg.single_cls else \
        data.get("names", [str(i) for i in range(nc)])
    img_size = check_img_size(cfg.img_size)
    spec = _spec_from_cfg(cfg, nc)

    datasets = {}
    if mesh is not None and not lead:
        _barrier(mesh)  # rank 0 writes the label caches first
    for split in ("train", "val"):
        ds = PairedDataset(data[f"{split}_rgb"], data[f"{split}_ir"],
                           nc=None if cfg.single_cls else nc,
                           cache_dir=workdir,
                           cache_images=cfg.cache_images and split == "train")
        if cfg.single_cls:  # ref --single-cls: all labels -> class 0
            for lab in ds.labels:
                if len(lab):
                    lab[:, 0] = 0.0
        datasets[split] = ds
    if mesh is not None and lead:
        _barrier(mesh)
    train_ds, val_ds = datasets["train"], datasets["val"]

    if cfg.autoanchor and lead:  # anchor fit check (train.py:678-679)
        from mmidet_tpu_torch.utils.autoanchor import check_anchors
        shapes = _shapes(train_ds, min(len(train_ds), 512))
        new_anchors = check_anchors(train_ds.labels[:len(shapes)], shapes,
                                    np.asarray(spec.anchors, np.float64),
                                    spec.strides, img_size)
        flat = tuple(tuple(int(round(v)) for v in lvl.reshape(-1))
                     for lvl in new_anchors)
        if flat != spec.anchors:
            logger.info("autoanchor updated anchors: %s", flat)
            spec = dataclasses.replace(spec, anchors=flat)
    spec = _from_rank0(mesh, spec)

    two_stream = is_two_stream(spec)
    # single-stream models carry no CEM and no fusion aux losses
    use_cem = cfg.use_cem and two_stream
    aux_mode = cfg.aux_mode if two_stream else "off"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = TwoStreamDetector(spec, aux_mode=aux_mode, use_cem=use_cem)
    if cfg.weights:  # pretrained init (ref --weights + intersect_dicts)
        from mmidet_tpu_torch.cli.val import load_state_dict_file
        # a reference checkpoint's pickle imports the reference checkout:
        # MMIDET_REFERENCE_REPO, else ~/reference where it exists (JAX
        # trainer.py:180-184)
        ref = os.environ.get("MMIDET_REFERENCE_REPO",
                             os.path.join(os.path.expanduser("~"),
                                          "reference"))
        n_cp, n_tot = transfer_matching(model, load_state_dict_file(
            cfg.weights, reference_repo=ref if os.path.isdir(ref) else None))
        logger.info("transferred %d/%d items from %s", n_cp, n_tot,
                    cfg.weights)
    model = model.to(dev)
    eval_model = eval_model_for(spec, use_cem, cfg.dtype).to(dev) \
        if lead else None

    rows = None if mesh is None else batch_rows(mesh, cfg.batch_size)
    if cfg.quad and (cfg.batch_size if rows is None
                     else rows.stop - rows.start) % 4:
        raise ValueError("--quad needs --batch-size divisible by 4 (on "
                         "each data-parallel rank)")
    # rect disables mosaic, as the reference (datasets.py: mosaic = augment
    # and not rect)
    use_mosaic = (hyp.get("mosaic", 1.0) > 0 and cfg.mosaic_prob > 0
                  and not cfg.rect)
    if use_mosaic:
        loader = MosaicLoader(train_ds, cfg.batch_size, img_size,
                              seed=cfg.seed, prefetch=cfg.workers)
    elif cfg.rect:
        # pad 0.0 (the reference pads 0.5 for evaluation only) and the
        # model's largest stride, so that P6 shapes stay consistent
        loader = RectLoader(train_ds, cfg.batch_size, img_size,
                            cfg.max_labels, stride=int(max(spec.strides)),
                            pad=0.0, scaleup=True)
    else:
        loader = PairedLoader(train_ds, cfg.batch_size, img_size,
                              cfg.max_labels, shuffle=True, seed=cfg.seed,
                              prefetch=cfg.workers)
    loader.rows = rows
    steps_per_epoch = max(len(loader), 1)
    sched, loss_hyp = build_sched_and_loss(cfg, hyp, steps_per_epoch)
    build = build_adam if cfg.adam else build_optimizer
    optimizer, _ = build(model, sched, hyp["weight_decay"],
                         total_batch_size=cfg.batch_size, nbs=cfg.nbs,
                         groups=cfg.optimizer_groups,
                         freeze=tuple(cfg.freeze))
    state = init_state(model, optimizer, cfg.ema_decay)
    step_fn = make_train_step(anchors_grid(spec).to(dev), loss_hyp,
                              two_stream=two_stream, dtype=cfg.dtype,
                              remat=cfg.remat, mesh=mesh)
    aug_hyp = AugmentHyp(**{k: hyp[k] for k in (
        "hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
        "perspective", "flipud", "fliplr", "mosaic")})
    augment = make_batch_augment(img_size, aug_hyp, cfg.max_labels,
                                 mosaic=use_mosaic)
    batch_keys = (("rgb4", "ir4", "labels4", "mask4", "pads4") if use_mosaic
                  else ("rgb", "ir", "targets", "mask"))
    ms_rng = np.random.default_rng(cfg.seed + 2)
    if cfg.multi_scale:
        ms_sizes = multi_scale_sizes(img_size, int(max(spec.strides)),
                                     cfg.multi_scale_buckets)
        logger.info("multi-scale: %d sizes %s", len(ms_sizes),
                    ms_sizes.tolist())

    start_epoch, best_fit = 0, -1.0
    ckpt_dir = os.path.join(workdir, "ckpt")
    if cfg.resume:
        src = resume_src or ckpt_dir
        try:
            state, _, meta = restore_checkpoint(src, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_fit = float(meta.get("best_fitness", -1.0))
            logger.info("resumed from %s at epoch %d", src, start_epoch)
        except FileNotFoundError:
            logger.warning("no checkpoint to resume under %s", src)
    # the augmentation's draws: seeded, on the card, advanced per batch;
    # a resumed run starts its stream again from the seed
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

    from mmidet_tpu_torch.utils.logger import MetricLogger
    results_path = os.path.join(workdir, "results.txt")
    mlog = None
    if lead:
        mlog = MetricLogger(workdir, use_wandb=cfg.use_wandb,
                            run_name=os.path.basename(workdir),
                            config={**dataclasses.asdict(cfg),
                                    "freeze": list(cfg.freeze)},
                            entity=cfg.entity or None)
        try:  # optional: matplotlib may be missing
            from mmidet_tpu_torch.utils.plots import plot_labels
            plot_labels(train_ds.labels, nc, workdir)
        except Exception:
            pass
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s: %.2fM params, %d classes, %d train imgs, "
                "%d epochs x %d steps, accumulate %d", cfg.model,
                n_params / 1e6, nc, len(train_ds), cfg.epochs,
                steps_per_epoch, optimizer.accumulate)
    if mesh is not None:
        # the global batch's dropout masks, the same on every rank
        mesh.gen = torch.Generator(device=dev).manual_seed(cfg.seed + 3)
        shard_train_state(state, mesh, cfg.tp_min_out)

    plotted = 0 if lead else 3
    res = None
    maps = np.zeros(nc)  # per-class mAP of the latest evaluation

    def log_model_art(ep: int, fit_val: float, best: bool) -> None:
        # the checkpoint dir as a model artifact with metadata and aliases
        # (ref log_model, wandb_utils.py:181-191), run id = run dir name
        if not (cfg.log_artifacts and art_backend is not None):
            return
        from mmidet_tpu_torch.utils.artifacts import log_model_artifact
        try:
            log_model_artifact(
                art_backend, os.path.basename(workdir), ckpt_dir, ep,
                cfg.epochs, fit_val, best=best,
                project=cfg.artifact_project,
                opt={"epochs": cfg.epochs, "model": cfg.model, "hyp": hyp,
                     "batch_size": cfg.batch_size,
                     "img_size": cfg.img_size})
        except Exception:
            logger.exception("model artifact logging failed")

    epochs_run = []
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        loader.epoch = epoch  # the shuffle order of this epoch
        loss_sum = torch.zeros(4, dtype=torch.float64, device=dev)
        nb = 0
        for batch in loader:
            jb = {k: torch.from_numpy(batch[k]).to(dev, non_blocking=True)
                  for k in batch_keys}
            for k in ("rgb", "ir", "rgb4", "ir4"):  # uint8 -> [0, 1] here
                if k in jb:
                    jb[k] = jb[k].float() / 255.0
            # a rank's rows of a full batch take their rows of the draws
            # made for the whole of it
            split = batch.get("split", False)
            jb = augment(jb, gen, rows if split else None,
                         cfg.batch_size if split else None)
            if cfg.quad:
                take = quad_draws((cfg.batch_size if split
                                   else jb["rgb"].shape[0]) // 4, gen)
                if split:
                    take = take[rows.start // 4:rows.stop // 4]
                jb = quad_batch(jb["rgb"], jb["ir"], jb["targets"],
                                jb["mask"], take)
            if cfg.multi_scale:
                # labels are normalized: only the images are resized
                sz = int(ms_rng.choice(ms_sizes))
                if sz != jb["rgb"].shape[1]:
                    jb["rgb"] = resize_nhwc(jb["rgb"], sz)
                    jb["ir"] = resize_nhwc(jb["ir"], sz)
            if plotted < 3:  # first train batches (ref train.py:816-817)
                try:
                    from mmidet_tpu_torch.utils.plots import plot_images
                    plot_images(jb["rgb"].cpu().numpy(),
                                jb["targets"].cpu().numpy(),
                                jb["mask"].cpu().numpy(),
                                os.path.join(workdir,
                                             f"train_batch{plotted}.jpg"),
                                names=names)
                except Exception:
                    pass
                plotted += 1
            if mesh is None:
                metrics = step_fn(state, jb)
            else:
                b = jb["rgb"].shape[0]
                metrics = step_fn(state, jb, mesh.split(b, b * mesh.n_data)
                                  if split else None)
            loss_sum += torch.stack([metrics[k] for k in
                                     ("box", "obj", "cls", "aux")]).double()
            nb += 1
        mloss = (loss_sum / max(nb, 1)).cpu().numpy()
        epochs_run.append({"epoch": epoch, "box": float(mloss[0]),
                           "obj": float(mloss[1]), "cls": float(mloss[2]),
                           "aux": float(mloss[3]), "batches": nb,
                           "seconds": time.time() - t0})

        res = None
        saved_this_epoch = False
        final = epoch == cfg.epochs - 1
        do_eval = (((epoch + 1) % cfg.eval_every == 0 or final)
                   and (not cfg.notest or final) and lead)
        if mesh is not None:  # whole tensors for the evaluation and saves
            unshard_train_state(state)
        if do_eval:
            eval_model.load_state_dict(state.ema.state_dict())
            # the val predictions -> a "progress" evaluation artifact (ref
            # log_training_progress, wandb_utils.py:265-306)
            pred_json = os.path.join(workdir, "val_predictions.json") \
                if (cfg.log_artifacts and art_backend is not None) else None
            media_dir = None
            if cfg.bbox_interval > 0 and \
                    ((epoch + 1) % cfg.bbox_interval == 0 or final):
                media_dir = os.path.join(workdir, "media", f"epoch{epoch}")
            res = evaluate(eval_model, PairedLoader(
                val_ds, cfg.batch_size, img_size, cfg.max_labels,
                drop_last=False, prefetch=cfg.workers, scaleup=False),
                nc, names=names, device=dev, devices=[dev],
                save_json=pred_json, media_dir=media_dir)
            if media_dir is not None and os.path.isdir(media_dir):
                import glob
                mlog.log_media_files(
                    epoch, "val/bbox",
                    sorted(glob.glob(os.path.join(media_dir, "*.jpg"))))
            fit = float(fitness(res.fitness_vector())[0])
            is_best = fit > best_fit
            if is_best:
                best_fit = fit
            meta = {"best_fitness": best_fit, "fitness": fit}
            if not cfg.nosave or final:
                save_checkpoint(ckpt_dir, state, epoch, meta)
                saved_this_epoch = True
                log_model_art(epoch, fit, is_best)
            if pred_json and os.path.isfile(pred_json):
                try:
                    art_backend.log_artifact(
                        f"run_{os.path.basename(workdir)}_progress",
                        "evaluation", {"val_predictions.json": pred_json},
                        metadata={"epoch": epoch, "mAP50": res.map50},
                        aliases=("latest", f"epoch {epoch + 1}",
                                 "best" if is_best else ""),
                        project=cfg.artifact_project)
                except Exception:
                    logger.exception("progress artifact logging failed")
            if is_best and not cfg.nosave:
                # the rolling keep=3 would otherwise drop the best epoch
                save_checkpoint(os.path.join(workdir, "ckpt_best"), state,
                                epoch, meta, keep=1)
            # classes that were not evaluated take the MEAN mAP, as the
            # reference (maps = np.zeros(nc) + map, test.py:305)
            maps[:] = res.map
            for i, nm in enumerate(names):
                maps[i] = res.per_class.get(nm, {}).get("ap", res.map)
            with open(results_path, "a") as fh:
                fh.write(
                    f"{epoch}/{cfg.epochs - 1} "
                    f"box {mloss[0]:.4f} obj {mloss[1]:.4f} "
                    f"cls {mloss[2]:.4f} P {res.mp:.4f} R {res.mr:.4f} "
                    f"mAP50 {res.map50:.4f} mAP {res.map:.4f}\n")
            if cfg.bucket:  # per-epoch results upload (ref train.py:860)
                from mmidet_tpu_torch.utils.general import gsutil_upload
                gsutil_upload(cfg.bucket, results_path)
            mlog.log_metrics(epoch, {
                "train/box": mloss[0], "train/obj": mloss[1],
                "train/cls": mloss[2], "train/aux": mloss[3],
                "val/P": res.mp, "val/R": res.mr, "val/mAP50": res.map50,
                "val/mAP": res.map, "fitness": fit})
            epochs_run[-1].update(fitness=fit, mAP50=res.map50,
                                  eval_speed_ms=res.speed_ms[0])
            logger.info(
                "epoch %d/%d loss(box/obj/cls/aux) %.4f/%.4f/%.4f/%.4f "
                "mAP50 %.4f mAP %.4f fit %.4f (%.1fs)", epoch,
                cfg.epochs - 1, *mloss, res.map50, res.map, fit,
                time.time() - t0)
        if cfg.save_period > 0 and (epoch + 1) % cfg.save_period == 0 \
                and not saved_this_epoch and lead:
            # periodic save is independent of eval/nosave (ref save_period)
            save_checkpoint(ckpt_dir, state, epoch,
                            {"best_fitness": best_fit})
            log_model_art(epoch, best_fit, False)
        if cfg.image_weights and not final:
            # every epoch, as the reference (train.py:715-727): the class
            # weights times (1 - maps)^2 of the latest evaluation; the
            # next epoch draws its images by them
            maps = _from_rank0(mesh, maps)
            from mmidet_tpu_torch.utils.general import (
                labels_to_class_weights, labels_to_image_weights)
            cw = labels_to_class_weights(train_ds.labels, nc)
            iw = labels_to_image_weights(train_ds.labels, nc,
                                         cw * (1 - maps) ** 2)
            if hasattr(loader, "set_image_weights") and iw.sum() > 0:
                loader.set_image_weights(iw)
        if mesh is not None:
            _barrier(mesh)
            shard_train_state(state, mesh, cfg.tp_min_out)

    if lead:
        mlog.close()
        try:  # optional: matplotlib may be missing
            from mmidet_tpu_torch.utils.plots import plot_results
            plot_results(results_path)
        except Exception:
            pass
    if mesh is not None:
        unshard_train_state(state)
    # deploy weights come from the BEST checkpoint when one was kept (the
    # reference strips best.pt for distribution, general.py:584-598)
    deploy = strip_for_deploy(state)
    best = checkpoints(os.path.join(workdir, "ckpt_best"))
    if best:
        deploy = torch.load(best[-1], map_location="cpu",
                            weights_only=True)["ema"]
    return {"workdir": workdir, "best_fitness": best_fit, "deploy": deploy,
            "state": state, "last_results": res, "nc": nc, "names": names,
            "spec": spec, "epochs": epochs_run,
            "mesh": None if mesh is None else {
                **mesh.shape, "backend": mesh.backend}}
