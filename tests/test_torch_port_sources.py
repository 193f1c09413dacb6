"""The port's inference sources (``data/sources.py``) against the JAX
package's on the CPU: ``LoadImages`` tuples bit for bit on a dir, a file, a
glob and an MJPG video that cv2 writes here; ``LoadWebcam`` on a fake
capture (mirrored local camera, the IP camera's 30th grab); ``LoadStreams``
on fake captures that return a fixed frame sequence, read once its reader
threads have taken the last frame (what it yields earlier depends on
timing)."""

import sys
import threading
import time
import types

import numpy as np
import pytest
from PIL import Image

from mmidet_tpu.data import sources as jsrc
from mmidet_tpu_torch.data import sources as psrc


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((48, 64), (64, 40), (50, 50))):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            root / f"im{i}.{'jpg' if i % 2 else 'png'}")
    (root / "notes.txt").write_text("not media")
    writer = cv2.VideoWriter(str(root / "clip.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10, (80, 64))
    for i in range(5):
        frame = np.zeros((64, 80, 3), np.uint8)
        frame[:, : 16 * (i + 1)] = (20 * i, 200 - 30 * i, 90)
        writer.write(frame)
    writer.release()
    return root


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3]


@pytest.mark.parametrize("which", ["dir", "file", "glob", "video"])
def test_load_images_against_jax(media, which):
    path = {"dir": str(media), "file": str(media / "im1.jpg"),
            "glob": str(media / "im*.*"), "video": str(media / "clip.avi")
            }[which]
    got, want = psrc.LoadImages(path, 96), jsrc.LoadImages(path, 96)
    assert len(got) == len(want)
    assert (got.images, got.videos) == (want.images, want.videos)
    _same(got, want)
    if which == "dir":  # three stills first, then the video's five frames
        kinds = [p.rsplit(".", 1)[1] for p, *_ in got]
        assert kinds == ["png", "jpg", "png"] + ["avi"] * 5
        assert next(iter(got))[1].shape == (96, 96, 3)


def test_load_images_refuses_empty(tmp_path):
    (tmp_path / "x.txt").write_text("")
    with pytest.raises(AssertionError, match="no media"):
        psrc.LoadImages(str(tmp_path))
    with pytest.raises(AssertionError, match="no files match"):
        psrc.LoadImages(str(tmp_path / "*.png"))


FRAME = np.zeros((48, 64, 3), np.uint8)
FRAME[:, :32] = (10, 20, 30)  # the left half, BGR


def _fake_cv2(frames_by_source=None):
    """A cv2 stand-in: ``VideoCapture(src)`` returns ``FRAME`` for ever, or
    the frames given for ``src`` and then nothing."""

    class Cap:
        def __init__(self, src):
            self.src, self.grabs = src, 0
            self.frames = list((frames_by_source or {}).get(src, []))
            self.done = threading.Event()

        def isOpened(self):  # noqa: N802 (cv2's name)
            return True

        def set(self, *a):
            pass

        def read(self):
            if frames_by_source is None:
                return True, FRAME.copy()
            if self.frames:
                return True, self.frames.pop(0)
            self.done.set()
            return False, None

        def grab(self):
            self.grabs += 1

        def retrieve(self):
            return True, FRAME.copy()

        def release(self):
            pass

    cv2 = types.ModuleType("cv2")
    cv2.VideoCapture = Cap
    cv2.CAP_PROP_BUFFERSIZE = 38
    cv2.flip = lambda img, code: img[:, ::-1] if code == 1 else img
    return cv2


def test_load_webcam_against_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    for pipe in ("0", "rtsp://cam"):
        got, want = psrc.LoadWebcam(pipe, 64), jsrc.LoadWebcam(pipe, 64)
        _same([next(iter(got))], [next(iter(want))])
        assert len(got) == 0
        if pipe == "0":  # mirrored, BGR -> RGB: the marker on the right
            img0 = next(iter(got))[2]
            assert tuple(img0[0, -1]) == (30, 20, 10)
        else:  # the stale-frame skip: retrieved on the 30th grab
            assert got.cap.grabs == want.cap.grabs == 30
        got.close()
        want.close()


def test_load_streams_against_jax(monkeypatch, tmp_path):
    seq = {src: [np.full((40, 56, 3), 10 * k + i, np.uint8) for k in range(4)]
           for i, src in enumerate(("a.avi", "b.avi"))}
    listing = tmp_path / "streams.txt"
    listing.write_text("a.avi\nb.avi\n")
    out = {}
    for mod in (psrc, jsrc):
        monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(seq))
        streams = mod.LoadStreams(str(listing), img_size=64)
        for cap in streams.caps:  # the readers took every frame
            assert cap.done.wait(5)
        time.sleep(0.05)
        out[mod] = next(iter(streams))
        streams.close()
    got, want = out[psrc], out[jsrc]
    assert got[0] == want[0] == ["a.avi", "b.avi"]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].shape == (2, 64, 64, 3)
    for g, w, i in zip(got[2], want[2], (0, 1)):
        np.testing.assert_array_equal(g, w)
        assert int(g[0, 0, 0]) == 30 + i  # the newest frame, the fourth
    assert got[3] == want[3]
