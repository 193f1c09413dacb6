"""Experiment metric logging.

Counterpart of ``mmidet_tpu/utils/logger.py``; reference W&B subsystem
(``utils/wandb_logging/wandb_utils.py:80-306``) and the TensorBoard writer
(train.py:1041-1042).  Legs: a JSONL file (always, the record the trainer
keeps beside its ``results.txt``), TensorBoard event files
(``EventWriter``) when the ``tensorboard`` package imports, and W&B when
``use_wandb`` and the ``wandb`` package imports.  A leg whose package is
missing is ``None`` and the logger goes on, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class EventWriter:
    """A TensorBoard event file (``events.out.tfevents.*``) of scalars and
    images, written with tensorboard's own protos and record framing.
    ``torch.utils.tensorboard.SummaryWriter`` writes the same records, but
    opens its file through tensorboard's TF-compat layer, which imports
    TensorFlow wherever it is installed, a large import into every
    process that trains; this writer needs only the ``tensorboard``
    package."""

    def __init__(self, log_dir: str):
        import socket

        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        name = (f"events.out.tfevents.{time.time():.0f}."
                f"{socket.gethostname()}.{os.getpid()}.0")
        self._records = RecordWriter(open(os.path.join(log_dir, name),
                                          "wb"))
        self._write(self._event(wall_time=time.time(),
                                file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())

    def _values(self, step: int, values: list) -> None:
        self._write(self._event(wall_time=time.time(), step=int(step),
                                summary=self._summary(value=values)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._values(step, [self._summary.Value(tag=tag,
                                                simple_value=float(value))])

    def image(self, tag: str, image, step: int) -> None:
        """HW, HWC or NHWC, uint8 or floats in [0, 1]; a batch's images
        as ``tag/<i>``."""
        import io

        from PIL import Image
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).round().astype(np.uint8)
        batch = image if image.ndim == 4 else image[None]
        values = []
        for i, im in enumerate(batch):
            buf = io.BytesIO()
            Image.fromarray(im.squeeze(-1) if im.ndim == 3 and
                            im.shape[-1] == 1 else im).save(buf, "PNG")
            values.append(self._summary.Value(
                tag=tag if image.ndim < 4 else f"{tag}/{i}",
                image=self._summary.Image(
                    height=im.shape[0], width=im.shape[1],
                    colorspace=1 if im.ndim == 2 else im.shape[-1],
                    encoded_image_string=buf.getvalue())))
        self._values(step, values)

    def flush(self) -> None:
        self._records.flush()

    def close(self) -> None:
        self._records.close()


class MetricLogger:
    """Multiplexing logger: ``log_metrics(step, {...})`` fans out to every
    available leg; the JSONL file is the source of truth."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 project: str = "mmidet_tpu", run_name: str | None = None,
                 config: dict | None = None, entity: str | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            self._tb = EventWriter(log_dir)
        except ImportError:  # the tensorboard package is missing
            self._tb = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name,
                                         entity=entity or None,
                                         config=config or {},
                                         dir=log_dir)
            except Exception:
                self._wandb = None

    def log_metrics(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, step: int, tag: str, image) -> None:
        """An image, HW, HWC or NHWC (the JAX writer's layouts)."""
        if self._tb is not None:
            self._tb.image(tag, image, step)

    def log_media_files(self, step: int, tag: str, paths) -> None:
        """Annotated-image files (ref W&B bbox media panels,
        --bbox_interval): a ``wandb.Image`` list when wandb is live; the
        files themselves are the offline record."""
        if self._wandb is not None:
            try:
                import wandb
                self._wandb.log(
                    {tag: [wandb.Image(str(p)) for p in paths]}, step=step)
            except Exception:
                pass

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
