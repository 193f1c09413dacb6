"""Checkpoint and asset download helpers.

A copy of ``mmidet_tpu/utils/downloads.py``; reference
``utils/google_utils.py:13-126`` (``attempt_download`` from GitHub
releases, ``gdrive_download``).  A local path is returned as it is; a URL
is fetched, and where that fails (no network) ``DownloadUnavailable``
says where to put the file by hand.
"""

from __future__ import annotations

import os


class DownloadUnavailable(RuntimeError):
    pass


def attempt_download(path_or_url: str, dest_dir: str = "weights") -> str:
    """Return a local file path; if given a URL (or a missing local file that
    looks like a release asset), attempt an HTTP fetch — raising
    ``DownloadUnavailable`` with instructions in offline environments."""
    if os.path.isfile(path_or_url):
        return path_or_url
    if path_or_url.startswith(("http://", "https://")):
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(path_or_url))
        if os.path.isfile(dest):
            return dest
        try:
            import urllib.request
            urllib.request.urlretrieve(path_or_url, dest)
            return dest
        except Exception as e:
            raise DownloadUnavailable(
                f"cannot download {path_or_url} ({e}); place the file at "
                f"{dest} manually") from e
    raise FileNotFoundError(path_or_url)


def gdrive_download(file_id: str, dest: str) -> str:
    """Google-Drive fetch (ref gdrive_download) — offline-safe."""
    if os.path.isfile(dest):
        return dest
    raise DownloadUnavailable(
        f"Google Drive download of {file_id} is unavailable offline; "
        f"download it on a connected machine and place it at {dest}")
