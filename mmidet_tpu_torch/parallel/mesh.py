"""The ('data', 'model') mesh of process groups and its sharding rules.

Counterpart of ``mmidet_tpu/parallel/mesh.py``; the reference trains
data-parallel with DDP over NCCL (train.py:683-686, 1019-1028).  The JAX
package runs one controller over a device mesh; the port runs one process
a rank (``parallel/launch.py``) and keeps the JAX rules:

  * ``make_mesh``: rank ``d * n_model + m`` sits at data row ``d`` and
    model column ``m`` (JAX's reshape of the device list); each rank holds
    its model group (its row) and its data group (its column);
  * ``batch_rows``: this rank's contiguous rows of a global batch (JAX's
    ``batch_sharding``, ``P("data")``);
  * ``tp_modules``: the layers whose weight JAX shards over 'model' (a
    leaf named ``kernel``, ndim >= 2, out channels >= ``tp_min_out`` and
    divisible by ``n_model``); torch keeps the out channels on axis 0, and
    the attention's query/key/value kernels (c, heads, head_dim) shard
    head_dim, so their rows are interleaved;
  * ``shard_train_state``: such a layer holds its out-channel shard (as do
    its momentum buffers, its gradient and the EMA's copy) and all-gathers
    its output over the model group (``comm.gather_from_model``); its bias,
    the BatchNorm statistics, the step counts and the EMA's update count
    stay whole.  ``unshard_train_state`` gathers it all back;
  * ``shard_inference``: one replica of a model per device entry, the
    batch split (a ragged one padded) and the predictions gathered.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.parallel import comm


def default_devices(device: str | torch.device = "cuda") -> list:
    """Every visible card for a bare ``"cuda"`` (``jax.devices()``); a
    device with an index, or the CPU, is ``[device]``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def pick_backend(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo (ranks on the
    CPU or sharing a card)."""
    devs = [torch.device(d) for d in devices]
    cards = [(d.index or 0) for d in devs if d.type == "cuda"]
    return "nccl" if len(cards) == len(devs) and \
        len(set(cards)) == len(cards) else "gloo"


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str
    data_group: object
    model_group: object
    gen: torch.Generator | None = None   # the global batch's dropout masks

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def d(self) -> int:
        return self.rank // self.n_model

    @property
    def m(self) -> int:
        return self.rank % self.n_model

    def split(self, rows: int, total: int) -> comm.DataGroup:
        """The data group of a step whose ``total`` global rows are split
        ``rows`` a rank."""
        return comm.DataGroup(self.data_group, self.d * rows, total, self.gen)

    def whole(self, total: int) -> comm.DataGroup:
        """A batch every rank runs whole: nothing reduced."""
        return comm.DataGroup(None, 0, total, self.gen)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """This rank's place on an ``n_data`` x ``n_model`` mesh; the process
    group (``launch``) must be up with ``n_data * n_model`` ranks, and rank
    ``r`` runs on ``devices[r]``."""
    devices = list(default_devices() if devices is None else devices)
    if n_data is None:
        n_data = len(devices) // n_model
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} needs {n_data * n_model}"
                         f" ranks, the process group has {world}")
    data_group = model_group = None
    for d in range(n_data):  # every rank makes every group, in one order
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    return Mesh(n_data, n_model, rank, torch.device(devices[rank]),
                dist.get_backend(), data_group, model_group)


def batch_rows(mesh: Mesh, b: int) -> slice:
    """This rank's rows of a global batch of ``b`` (``P("data")``)."""
    if b % mesh.n_data:
        raise ValueError(f"batch {b} does not split over {mesh.n_data} ranks")
    k = b // mesh.n_data
    return slice(mesh.d * k, (mesh.d + 1) * k)


# ------------------------------------------------------- tensor parallelism

def _jax_out(name: str, mod: nn.Module, parents: dict) -> int | None:
    """The length of the JAX kernel's last axis for ``mod``'s weight, or
    None when that weight is no JAX leaf named ``kernel``."""
    from mmidet_tpu_torch.nn.layers import Focus, VitTransformerLayer
    if not isinstance(mod, (nn.Conv2d, nn.Linear)) or mod.weight.ndim < 2:
        return None
    parent = parents.get(name.rpartition(".")[0])
    grand = parents.get(name.rpartition(".")[0].rpartition(".")[0])
    if isinstance(grand, Focus):       # JAX's conv_kernel_s2d
        return None
    if isinstance(grand, VitTransformerLayer) and parent is grand.ma and \
            name.rpartition(".")[2] in ("query", "key", "value"):
        return mod.weight.shape[0] // grand.num_heads   # (c, heads, hd)
    return mod.weight.shape[0]


def tp_modules(model: nn.Module, n_model: int, tp_min_out: int = 256
               ) -> dict[str, nn.Module]:
    """{module name: module} of the layers whose weight JAX's
    ``param_shardings`` puts on 'model' (``_leaf_spec``)."""
    if n_model <= 1:
        return {}
    parents = dict(model.named_modules())
    out = {}
    for name, mod in parents.items():
        o = _jax_out(name, mod, parents)
        if o is not None and o >= tp_min_out and o % n_model == 0:
            out[name] = mod
    return out


@dataclasses.dataclass
class _Shard:
    cls: type             # the layer's own class, restored on unshard
    group: object         # the model group
    index: torch.Tensor   # this rank's rows of the weight
    perm: torch.Tensor | None   # concatenated shards -> channel order
    in_index: torch.Tensor | None   # a grouped conv's input channels
    groups: int = 1       # a grouped conv's groups on this rank


def _rows(mod: nn.Module, n: int, m: int, heads: int | None):
    """This rank's rows and the order that puts the concatenated shards
    back (None: contiguous)."""
    o = mod.weight.shape[0]
    if heads is None:
        k = o // n
        return torch.arange(m * k, (m + 1) * k), None
    hd = o // heads
    k = hd // n

    def rows_of(r):
        return (torch.arange(heads)[:, None] * hd
                + torch.arange(r * k, (r + 1) * k)[None]).reshape(-1)
    return rows_of(m), torch.argsort(torch.cat([rows_of(r)
                                                for r in range(n)]))


class _TPConv2d(nn.Conv2d):
    def forward(self, x):
        s = self._tp
        x = comm.copy_to_model(x, s.group)
        if s.in_index is not None:
            x = x.index_select(1, s.in_index.to(x.device))
        y = F.conv2d(x, self.weight, None, self.stride, self.padding,
                     self.dilation, s.groups)
        y = comm.gather_from_model(y, s.group, 1, s.index.to(y.device),
                                   None if s.perm is None
                                   else s.perm.to(y.device))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


class _TPLinear(nn.Linear):
    def forward(self, x):
        s = self._tp
        x = comm.copy_to_model(x, s.group)
        y = F.linear(x, self.weight)
        y = comm.gather_from_model(y, s.group, -1, s.index.to(y.device),
                                   None if s.perm is None
                                   else s.perm.to(y.device))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _tp_class(mod: nn.Module) -> type:
    if type(mod) is nn.Conv2d:
        if mod.padding_mode != "zeros":
            raise NotImplementedError(f"tensor parallel {mod}: padding "
                                      f"{mod.padding_mode}")
        return _TPConv2d
    if type(mod) is nn.Linear:
        return _TPLinear
    raise NotImplementedError(f"tensor parallel over {type(mod).__name__}")


def _shard_plan(model: nn.Module, mesh: Mesh, tp_min_out: int) -> dict:
    """{module name: _Shard} for this rank."""
    from mmidet_tpu_torch.nn.layers import VitTransformerLayer
    n = mesh.n_model
    plan = {}
    parents = dict(model.named_modules())
    for name, mod in tp_modules(model, n, tp_min_out).items():
        grand = parents.get(name.rpartition(".")[0].rpartition(".")[0])
        heads = grand.num_heads if isinstance(grand, VitTransformerLayer) \
            and _jax_out(name, mod, parents) != mod.weight.shape[0] else None
        index, perm = _rows(mod, n, mesh.m, heads)
        in_index, groups = None, getattr(mod, "groups", 1)
        if groups > 1:
            if groups % n:
                raise NotImplementedError(
                    f"tensor parallel {name}: {groups} groups over {n}")
            c = mod.in_channels // n
            in_index = torch.arange(mesh.m * c, (mesh.m + 1) * c)
        plan[name] = _Shard(type(mod), mesh.model_group, index, perm,
                            in_index, max(groups // n, 1))
    return plan


def _shard_module(model: nn.Module, plan: dict) -> None:
    for name, s in plan.items():
        mod = model.get_submodule(name)
        w = mod.weight
        w.data = w.data.index_select(0, s.index.to(w.device)).contiguous()
        if w.grad is not None:
            w.grad = w.grad.index_select(0, s.index.to(w.device))
        mod._tp = s
        mod.__class__ = _tp_class(mod)


def _gather(t: torch.Tensor, s: _Shard) -> torch.Tensor:
    full = comm.all_gather_cat(t, s.group, 0)
    return full if s.perm is None else full.index_select(
        0, s.perm.to(full.device))


def _unshard_module(model: nn.Module) -> None:
    """Gathers every sharded layer of ``model`` back."""
    for mod in model.modules():
        s = getattr(mod, "_tp", None)
        if s is None:
            continue
        w = mod.weight
        w.data = _gather(w.data, s)
        if w.grad is not None:
            w.grad = _gather(w.grad, s)
        mod.__class__ = s.cls
        del mod._tp


def _opt_entries(optimizer, model: nn.Module, plan: dict) -> list:
    """(state, key, layer name) of the optimizer entries shaped as a
    sharded layer's weight (momentum buffers, Adam's moments)."""
    state = optimizer.opt.state if hasattr(optimizer, "opt") \
        else optimizer.state
    out = []
    for name in plan:
        p = model.get_submodule(name).weight
        st = state.get(p, {})
        out += [(st, k, name) for k, v in st.items()
                if torch.is_tensor(v) and v.shape == p.shape]
    return out


def shard_train_state(state, mesh: Mesh, tp_min_out: int = 256) -> dict:
    """Shard a whole ``TrainState`` in place (JAX :76-112): the wide layers'
    weights, gradients and optimizer entries of the model, and the EMA's
    copies; everything else stays replicated.  Returns the plan."""
    if mesh.n_model <= 1:
        return {}
    plan = _shard_plan(state.model, mesh, tp_min_out)
    entries = _opt_entries(state.optimizer, state.model, plan)
    _shard_module(state.model, plan)
    _shard_module(state.ema.module, plan)
    for st, k, name in entries:
        st[k] = st[k].index_select(0, plan[name].index.to(st[k].device))
    state.ema._paired = (None,)   # its views of the state dicts are stale
    return plan


def unshard_train_state(state) -> None:
    """Gather a sharded ``TrainState`` back to whole tensors, in place
    (every rank of each model group takes part)."""
    plan = {name: mod._tp for name, mod in state.model.named_modules()
            if getattr(mod, "_tp", None) is not None}
    if not plan:
        return
    entries = _opt_entries(state.optimizer, state.model, plan)
    for st, k, name in entries:
        st[k] = _gather(st[k], plan[name])
    _unshard_module(state.model)
    _unshard_module(state.ema.module)
    state.ema._paired = (None,)


def average_gradients(model: nn.Module, mesh: Mesh) -> None:
    """Mean of the gradients over the data group, in one bucket (each
    rank's gradient is that of the global loss restricted to its rows,
    scaled by the data ranks: ``comm``'s convention)."""
    if mesh.n_data <= 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    comm.all_reduce_(flat, mesh.data_group)
    flat /= mesh.n_data
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


# ------------------------------------------------------------- inference

class ShardedModel(nn.Module):
    """``shard_inference``'s result: one replica of ``model`` per entry of
    ``devices``; a call splits the batch over them (a ragged batch padded
    with zeros to a multiple of their count, as the JAX evaluator pads),
    runs each part on its device and gathers ``pred`` on the first."""

    def __init__(self, model: nn.Module, devices):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.replicas = nn.ModuleList(
            [copy.deepcopy(model).to(d).eval() for d in self.devices])
        self.spec = getattr(model, "spec", None)

    def to(self, *args, **kwargs):  # replicas stay on their devices
        return self

    def forward(self, rgb, ir=None):
        n = len(self.devices)
        b0 = rgb.shape[0]
        pad = (-b0) % n

        def padded(x):
            return x if not pad else torch.cat(
                [x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        rgb = padded(rgb)
        ir = None if ir is None else padded(ir)
        k = rgb.shape[0] // n
        preds = []
        for i, (dev, rep) in enumerate(zip(self.devices, self.replicas)):
            part = rgb[i * k:(i + 1) * k].to(dev)
            part_ir = None if ir is None else ir[i * k:(i + 1) * k].to(dev)
            preds.append(rep(part, part_ir)["pred"])
        pred = torch.cat([p.to(self.devices[0]) for p in preds])
        return {"pred": pred[:b0]}


def shard_inference(model: nn.Module, devices) -> ShardedModel:
    """Data-parallel inference over ``devices`` (JAX :115-143): the batch
    over the replicas, the weights replicated."""
    return ShardedModel(model, devices)
