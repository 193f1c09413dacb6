"""Start one process a rank and run a function on each.

``launch(fn, args, devices, store_dir)``: the caller's process is rank 0;
ranks 1.. are started with ``torch.multiprocessing`` (start method
``spawn``) on ``_rank_main``.  Every rank joins one process group: its
rendezvous is a ``FileStore`` under ``store_dir`` (so that concurrent runs
never race for a port), its backend NCCL when every rank has a card of its
own and gloo otherwise (``mesh.pick_backend``; never a fallback from one to
the other), and it is destroyed on every exit, errors included.  Rank ``r``
runs on ``devices[r]``; ``fn(*args)`` returns rank 0's result.  A rank that
fails ends the others: before the rendezvous rank 0 sees it end, after it
gloo's peers see its connections close; rank 0 raises the error of the
rank that failed first and terminates ranks still running.

The spawned ranks run with the caller's count of intra-op threads and
its TF32 switches (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``), so that every rank rounds alike.
"""

from __future__ import annotations

import datetime
import logging
import os
import time

import torch
import torch.distributed as dist

from mmidet_tpu_torch.parallel.mesh import pick_backend

logger = logging.getLogger(__name__)

# seconds a collective waits for its peers: rank 0 evaluates and writes
# checkpoints while the others wait at a barrier
TIMEOUT = 1800.0


def _await_ranks(store, world: int, ctx) -> None:
    """Rank 0: wait until ranks 1.. reach the store, raising the error of a
    rank that ends before it does (the rendezvous would wait ``TIMEOUT``
    for it)."""
    deadline = time.monotonic() + TIMEOUT
    for r in range(1, world):
        while True:
            try:
                store.wait([f"up{r}"], datetime.timedelta(seconds=1))
                break
            except RuntimeError:   # not there yet
                if ctx.join(0) or time.monotonic() > deadline:
                    raise RuntimeError(f"launch: rank {r} never started")


def _run_rank(rank: int, world: int, backend: str, store_path: str,
              devices: list, fn, args, kwargs, ctx=None):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    if rank:
        store.set(f"up{rank}", "1")
    elif ctx is not None:
        _await_ranks(store, world, ctx)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        return fn(*args, **kwargs)
    finally:
        dist.destroy_process_group()


def _settings() -> dict:
    return {"threads": torch.get_num_threads(),
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}


def _rank_main(i: int, world: int, backend: str, store_path: str,
               devices: list, fn, args, settings: dict) -> None:
    torch.set_num_threads(settings["threads"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    _run_rank(i + 1, world, backend, store_path, devices, fn, args, {})


def launch(fn, args: tuple, devices: list, store_dir: str,
           local_kwargs: dict | None = None):
    """Run ``fn(*args)`` on ``len(devices)`` ranks; rank 0 in this process
    with ``local_kwargs`` added (what need not, or cannot, be pickled).
    Returns rank 0's result."""
    if dist.is_initialized():
        raise RuntimeError("launch: this process is in a process group "
                           "already")
    devices = [str(torch.device(d)) for d in devices]
    world = len(devices)
    backend = pick_backend(devices)
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f".dist_store_{os.getpid()}_"
                              f"{time.time_ns()}")
    logger.info("launch: %d ranks, backend %s, devices %s", world, backend,
                devices)
    ctx = None
    try:
        if world > 1:
            ctx = torch.multiprocessing.start_processes(
                _rank_main, args=(world, backend, store_path, devices, fn,
                                  args, _settings()),
                nprocs=world - 1, join=False, start_method="spawn")
        out = _run_rank(0, world, backend, store_path, devices, fn, args,
                        local_kwargs or {}, ctx)
        if ctx is not None:
            while not ctx.join():
                pass
            ctx = None
        return out
    except Exception as err:
        if ctx is not None and "by peer" in str(err):
            try:  # another rank failed first: its own error
                ctx.join(10)
            except Exception as first:
                raise first from err
        raise
    finally:
        if ctx is not None:   # rank 0 failed: end the others
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(30)
        if os.path.exists(store_path):
            os.remove(store_path)
