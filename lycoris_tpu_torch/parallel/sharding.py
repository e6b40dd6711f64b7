"""Mesh and sharding on ``torch.distributed`` (counterpart of
``lycoris_tpu/parallel/sharding.py``).

- :func:`make_mesh` -- a ``(data, model)`` ``DeviceMesh`` over the world,
  everything on ``data`` by default, with a process group per axis;
- :func:`shard_base_params` -- each frozen base leaf of at least
  ``min_size`` elements keeps only this rank's slice along its largest dim
  that divides by the ``model`` axis, and is all-gathered over the
  ``model`` group where its layer runs; smaller leaves stay whole;
- :func:`replicate` -- the adapters (and anything else given) broadcast
  from the first rank of each axis, so every rank starts identical;
- :func:`shard_batch` -- this rank's rows of a global batch.

The collectives are ``all_gather``, ``all_reduce`` and ``broadcast``, which
NCCL and gloo both run on the card's tensors (gloo through the host). Each
is counted in :data:`collectives`, and each gather of a leaf in
:data:`gathers` under the leaf's name.

A process with no process group has no mesh: :func:`make_mesh` returns
None there, and every function here takes None as the ``(1, 1)`` mesh.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")
SHARD_SUFFIX = "_shard"  # a sharded leaf's slice is the parameter "{name}_shard"

collectives: Counter = Counter()  # "all_gather", "all_reduce", "broadcast" calls
gathers: Counter = Counter()  # all-gathers of each sharded leaf, by "{module}.{name}"


def reset_counts() -> None:
    collectives.clear()
    gathers.clear()


# -- the mesh -----------------------------------------------------------------


def make_mesh(devices=None, data: int | None = None, model: int = 1, axis_names=AXES):
    """A ``(data, model)`` ``DeviceMesh`` over ``devices`` (global ranks, all
    of the world by default), rank ``r`` at ``(r // model, r % model)``;
    all devices on the data axis by default. None with no process group
    and one device."""
    initialized = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size() if initialized else 1))
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices do not divide by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, not {n}")
    if not initialized:
        if data * model != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs a process group: call "
                               "init_distributed first")
        return None
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor(list(devices)[: data * model], dtype=torch.int64).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh) -> dict:
    """``{"data": d, "model": m}`` of a mesh (None is (1, 1))."""
    if mesh is None:
        return {"data": 1, "model": 1}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 with no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_main_process() -> bool:
    """Global rank 0, or no process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


# -- counted collectives --------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group``."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast_first(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` set in place to the value of the group's first rank."""
    collectives["broadcast"] += 1
    dist.broadcast(t, group=group, group_src=0)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along ``dim``."""
    collectives["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


# -- replication -------------------------------------------------------------------


def _tensors(obj) -> list:
    if isinstance(obj, nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = obj.values()
    return [t for x in obj for t in _tensors(x)]


@torch.no_grad()
def replicate(module_or_tensors, mesh):
    """Every tensor of a module (parameters and buffers), a tensor, or a
    dict or list of them, set in place to the value on the first rank of
    each mesh axis: one broadcast per axis and dtype. Returns its argument."""
    tensors = _tensors(module_or_tensors)
    for axis in AXES:
        if axis_size(mesh, axis) <= 1:
            continue
        group = mesh.get_group(axis)
        by_kind: dict = {}
        for t in tensors:
            by_kind.setdefault((t.dtype, t.device), []).append(t)
        for ts in by_kind.values():
            flat = broadcast_first(torch.cat([t.reshape(-1) for t in ts]), group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))
    return module_or_tensors


# -- the batch ----------------------------------------------------------------------


def batch_spec(ndim: int) -> tuple:
    """The layout of a batch leaf: dim 0 over ``data``, the rest whole."""
    return ("data",) + (None,) * (ndim - 1)


def shard_batch(batch, mesh):
    """This rank's rows of each leaf of the global ``batch`` (a tensor, or a
    dict, list or tuple of them): dim 0 split over the data axis. Raises
    unless every leaf's dim 0 divides by it."""
    n = axis_size(mesh, "data")
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if batch is None or n == 1:
        return batch
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} does not divide by the data axis {n}")
    i = axis_index(mesh, "data")
    return batch[i * (b // n):(i + 1) * (b // n)]


# -- the sharded base ------------------------------------------------------------------


def base_param_spec(t, mesh, min_size: int = 2**16) -> int | None:
    """The dim of the frozen base leaf ``t`` to shard over the ``model``
    axis, or None to keep it whole: the largest dim that divides by the
    axis (ties to the lower index), for a leaf of at least ``min_size``
    elements. ``t`` needs only a ``shape``."""
    model = axis_size(mesh, "model")
    shape = tuple(t.shape)
    if model <= 1 or not shape or math.prod(shape) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % model == 0 and shape[i] >= model:
            return i
    return None


class _Shards:
    """The sharded leaves of one module: name -> (dim, full shape, qualified
    name), the model group, its size and this rank's index, and the leaves
    the running forward gathered."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index
        self.leaves: dict = {}
        self.live: list = []


def _gather_hook(module, args):
    """Before the layer runs: its sharded leaves gathered in place."""
    sh = module._lycoris_shards
    for name in sh.leaves:
        if module._parameters[name] is None:
            module._parameters[name] = gathered(module, name)
            sh.live.append(name)


def _release_hook(module, args, output):
    """After it ran: the gathered leaves dropped (autograd keeps those it saved)."""
    sh = module._lycoris_shards
    for name in sh.live:
        module._parameters[name] = None
    sh.live.clear()


@torch.no_grad()
def shard_base_params(model: nn.Module, mesh, min_size: int = 2**16) -> dict:
    """Shard the frozen leaves of ``model`` by :func:`base_param_spec`:
    a sharded leaf ``name`` becomes ``None`` in its module's parameters and
    this rank's slice is the parameter ``name + "_shard"``; the module
    gathers it over the ``model`` group before each forward (a layer's
    checkpointed recompute too) and drops it after. Returns ``{qualified
    leaf name: dim or None}`` for every leaf. Build adapters on the whole
    model first: their layer info and initial values read the full weights."""
    specs = {}
    m = axis_size(mesh, "model")
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None or name.endswith(SHARD_SUFFIX):
                continue
            qual = f"{mod_name}.{name}" if mod_name else name
            dim = base_param_spec(p, mesh, min_size)
            specs[qual] = dim
            if dim is None:
                continue
            if p.requires_grad:
                raise ValueError(f"shard_base_params shards frozen leaves only; {qual} "
                                 "requires grad")
            sh = getattr(mod, "_lycoris_shards", None)
            if sh is None:
                sh = mod._lycoris_shards = _Shards(mesh.get_group("model"), m,
                                                   axis_index(mesh, "model"))
                mod.register_forward_pre_hook(_gather_hook)
                mod.register_forward_hook(_release_hook, always_call=True)
            local = p.detach().chunk(m, dim)[sh.index].clone()
            sh.leaves[name] = (dim, tuple(p.shape), qual)
            mod._parameters[name] = None
            mod.register_parameter(name + SHARD_SUFFIX, nn.Parameter(local, requires_grad=False))
    return specs


def is_sharded(module, name: str) -> bool:
    sh = getattr(module, "_lycoris_shards", None)
    return sh is not None and name in sh.leaves


@torch.no_grad()
def gathered(module, name: str) -> torch.Tensor:
    """The whole leaf ``name`` of ``module``, all-gathered from its slices."""
    sh = module._lycoris_shards
    dim, shape, qual = sh.leaves[name]
    gathers[qual] += 1
    return all_gather_cat(module._parameters[name + SHARD_SUFFIX], dim, sh.group, sh.n)


def full_param(module, name: str):
    """The whole leaf ``name``: the module's own, or gathered where sharded
    and not gathered by a running forward."""
    t = module._parameters.get(name) if hasattr(module, "_parameters") else None
    if t is None and is_sharded(module, name):
        return gathered(module, name)
    return getattr(module, name, None) if t is None else t


def stored_param(module, name: str):
    """The tensor that holds leaf ``name``: this rank's slice where sharded."""
    if is_sharded(module, name):
        return module._parameters[name + SHARD_SUFFIX]
    return getattr(module, name, None)


@torch.no_grad()
def write_param(module, name: str, value: torch.Tensor) -> None:
    """Write the whole leaf ``value`` into ``name``: where sharded, this
    rank's slice of it into the slice. Raises if ``value`` is not the
    leaf's whole shape."""
    if not is_sharded(module, name):
        stored_param(module, name).copy_(value)
        return
    sh = module._lycoris_shards
    dim, shape, qual = sh.leaves[name]
    if tuple(value.shape) != shape:
        raise ValueError(f"{qual} is sharded from {shape}; cannot write a {tuple(value.shape)} "
                         "tensor into its slice")
    stored_param(module, name).copy_(value.chunk(sh.n, dim)[sh.index])


def base_bytes(model: nn.Module) -> int:
    """Bytes of ``model``'s parameters and buffers on this rank (slices of sharded leaves)."""
    return sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()])
