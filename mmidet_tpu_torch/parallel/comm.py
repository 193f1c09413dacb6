"""Collectives of the data- and tensor-parallel modes, with their adjoints.

Under the JAX package's GSPMD a mesh changes where values live, never what
they are: a step over ``data = n`` computes the loss, the gradients and the
BatchNorm statistics of the whole global batch.  The port runs one process
a rank, so every term that couples samples sums its parts over the data
group here.  The convention: each rank computes the global loss (the
all-reduced partial sums make it the same number on every rank) and
backpropagates it; every collective's backward is its exact adjoint (an
all-reduce sums the gradients again), so the data group's gradients,
averaged, are the gradient of the global loss.  The model group follows
Megatron's pair: ``copy_to_model`` (identity forward, all-reduce of the
input gradient backward) before a layer that holds an out-channel shard,
``gather_from_model`` (all-gather forward, this rank's slice of the
gradient backward, no reduction: the layers downstream are replicated) after
it.

``DataGroup`` is the data axis of one step: the process group, this rank's
first global row and the global row count, and the generator that draws
the global batch's dropout masks.  ``data_group(g)`` makes it the one that
the train-mode modules (``nn.layers.BatchNorm2d``, ``nn.fusion.Dropout``)
and the detector's aux losses read; outside it they run their one-process
code.  A ``DataGroup`` with ``group=None`` (a ragged batch that every rank
runs whole) reduces over nothing.

gloo reduces host tensors only on some builds; a CUDA tensor under gloo is
staged through host memory.  Low-precision floats are reduced in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataGroup:
    group: object | None          # the data axis' process group, or None
    offset: int                   # this rank's first row of the global batch
    total: int                    # rows of the global batch
    gen: torch.Generator | None = None   # dropout masks of the global batch

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)


_ACTIVE: DataGroup | None = None


def active() -> DataGroup | None:
    """The data group of the step being run, or None (one process)."""
    return _ACTIVE


@contextlib.contextmanager
def data_group(g: DataGroup | None):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, g
    try:
        yield
    finally:
        _ACTIVE = prev


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no autograd); ``group=None``: nothing."""
    if group is None:
        return t
    wide = t.is_floating_point() and t.element_size() < 4
    w = t.float() if wide else t
    if _staged(w, group):
        h = w.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(w, group=group)
        if w is not t:
            t.copy_(w)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order (no autograd)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.is_floating_point() and src.element_size() < 4 and \
            dist.get_backend(group) == "gloo":
        src = src.view(torch.int16)  # gloo gathers the bytes
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim).to(t.device)
    return out.view(t.dtype) if out.dtype != t.dtype else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``: forward and backward all-reduce."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0 (backward: the summed gradient
    of this rank's rows)."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def global_sum(parts: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Partial sums (any shapes) -> their sums over ``group``, in one
    differentiable all-reduce, in f32 (f64 where a part is); ``group=None``:
    as they are."""
    if group is None:
        return parts
    dt = torch.float64 if any(p.dtype == torch.float64 for p in parts) \
        else torch.float32
    flat = all_reduce(torch.cat([p.to(dt).reshape(-1) for p in parts]),
                      group)
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].reshape(p.shape))
        i += p.numel()
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, dim, index, perm):
        ctx.dim, ctx.index = dim, index
        full = all_gather_cat(y, group, dim)
        return full if perm is None else full.index_select(dim, perm)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(ctx.dim, ctx.index), None, None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_from_model(y: torch.Tensor, group, dim: int, index: torch.Tensor,
                      perm: torch.Tensor | None) -> torch.Tensor:
    """This rank's channels ``index`` of a layer's output -> all of them:
    the ranks' shards concatenated along ``dim`` and put in order by
    ``perm`` (None when the shards are contiguous)."""
    return _GatherFromModel.apply(y, group, dim, index, perm)
