"""Inference input sources: images, videos, webcams, RTSP streams.

A copy of ``mmidet_tpu/data/sources.py``; reference
``utils/datasets.py:477-706``: ``LoadImages`` (image and video iterator +
letterbox), ``LoadWebcam``, ``LoadStreams`` (reader threads, one a source,
each keeping only its newest frame, so that what an iteration yields
depends on timing).  Videos and streams decode through cv2, as the
reference's; still images through PIL.  The port's detect CLI reads its
own paired sources, as the JAX package's does.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from mmidet_tpu_torch.data.datasets import (IMG_FORMATS, discover_images,
                                            letterbox_np)

VID_FORMATS = (".mov", ".avi", ".mp4", ".mpg", ".mpeg", ".m4v", ".wmv",
               ".mkv")


class LoadImages:
    """Iterate images and videos from a path/dir/glob.
    Yields (path, letterboxed HWC RGB uint8, original HWC RGB, ratio_pad).
    Ref: datasets.py:477-541."""

    def __init__(self, path: str, img_size: int = 640):
        self.img_size = img_size
        files = []
        import glob as g
        if os.path.isdir(path):
            files = sorted(g.glob(os.path.join(path, "**", "*.*"),
                                  recursive=True))
        elif os.path.isfile(path):
            files = [path]
        elif "*" in str(path):  # glob pattern (ref datasets.py LoadImages)
            files = sorted(g.glob(path, recursive=True))
            assert files, f"no files match glob {path}"
        else:
            files = discover_images(path)
        self.images = [f for f in files
                       if os.path.splitext(f)[1].lower() in IMG_FORMATS]
        self.videos = [f for f in files
                       if os.path.splitext(f)[1].lower() in VID_FORMATS]
        assert self.images or self.videos, f"no media found in {path}"

    def __len__(self):
        return len(self.images) + len(self.videos)

    def _frames(self):
        from PIL import Image
        for p in self.images:
            im0 = np.asarray(Image.open(p).convert("RGB"))
            yield p, im0
        if self.videos:
            import cv2
            for p in self.videos:
                cap = cv2.VideoCapture(p)
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield p, frame[:, :, ::-1]  # BGR -> RGB
                cap.release()

    def __iter__(self):
        for path, im0 in self._frames():
            lb, r, pad = letterbox_np(im0, (self.img_size, self.img_size))
            yield path, lb, im0, (r, pad)


class LoadWebcam:
    """Single-camera SYNCHRONOUS reader (ref datasets.py:556-613): local
    cameras read-and-mirror each frame (the reference's ``cv2.flip(img0,
    1)``); IP-camera pipes grab continuously and retrieve every 30th frame
    (its stale-frame skip).  Yields the same tuple shape as LoadImages.
    (LoadStreams covers the threaded multi-source case; this class exists
    for the reference's one-cam CLI surface.)"""

    def __init__(self, pipe: str | int = "0", img_size: int = 640):
        import cv2
        self.img_size = img_size
        self.pipe = int(pipe) if str(pipe).isnumeric() else pipe
        self.cap = cv2.VideoCapture(self.pipe)
        self.cap.set(cv2.CAP_PROP_BUFFERSIZE, 3)

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        import cv2
        self.count += 1
        if isinstance(self.pipe, int):  # local camera: mirror like the ref
            ok, img0 = self.cap.read()
            if ok:
                img0 = cv2.flip(img0, 1)
        else:  # IP camera: skip stale frames (ref grabs, retrieves @30)
            n, ok, img0 = 0, False, None
            while n < 3000:
                n += 1
                self.cap.grab()
                if n % 30 == 0:
                    ok, img0 = self.cap.retrieve()
                    if ok:
                        break
        assert ok, f"Camera Error {self.pipe}"
        img0 = img0[:, :, ::-1]  # BGR -> RGB
        lb, ratio, pad = letterbox_np(img0, (self.img_size, self.img_size))
        return f"webcam{self.count}", lb, img0, (ratio, pad)

    def __len__(self):
        return 0  # endless (ref datasets.py:612-613)

    def close(self):
        self.cap.release()


class LoadStreams:
    """Threaded multi-stream reader (webcam index / RTSP / HTTP URLs);
    each thread keeps only the most recent frame. Ref: datasets.py:616-706."""

    def __init__(self, sources, img_size: int = 640):
        import cv2
        self.img_size = img_size
        if isinstance(sources, str):
            if os.path.isfile(sources):
                with open(sources) as fh:
                    sources = [l.strip() for l in fh if l.strip()]
            else:
                sources = [sources]
        self.sources = sources
        self.caps = []
        self.frames: list[np.ndarray | None] = [None] * len(sources)
        self.running = True
        for i, s in enumerate(sources):
            src = int(s) if str(s).isnumeric() else s
            cap = cv2.VideoCapture(src)
            assert cap.isOpened(), f"failed to open stream {s}"
            ok, frame = cap.read()
            assert ok, f"failed to read from stream {s}"
            self.frames[i] = frame[:, :, ::-1]
            self.caps.append(cap)
            t = threading.Thread(target=self._reader, args=(i, cap),
                                 daemon=True)
            t.start()

    def _reader(self, i, cap):
        while self.running and cap.isOpened():
            ok, frame = cap.read()
            if ok:
                self.frames[i] = frame[:, :, ::-1]
            else:
                time.sleep(0.01)

    def __iter__(self):
        while self.running:
            im0s = [f.copy() for f in self.frames]
            batch = [letterbox_np(im0, (self.img_size, self.img_size))
                     for im0 in im0s]
            lbs = np.stack([b[0] for b in batch])
            pads = [(b[1], b[2]) for b in batch]
            yield self.sources, lbs, im0s, pads

    def close(self):
        self.running = False
        for cap in self.caps:
            cap.release()
