"""Device meshes, and the collectives of their data and model axes.

Counterpart of `atomai_tpu/core/mesh.py:1-167`. JAX drives every device
of a mesh from one process; the port runs one process a device, the SPMD
ranks of ``torch.distributed`` (started by
:func:`atomai_tpu_torch.parallel.launch`), and every rank makes the same
call on the same arguments. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of global ranks with the
dimensions ``("data", "model")``:

- ``"data"``: the batch axis. A rank computes its contiguous block of the
  global batch (a ``PartitionSpec("data")`` gives each JAX device its
  contiguous block too); what the JAX program reduces over the batch, the
  port all-reduces over the axis's group: batch sums and means of the
  losses (:func:`batch_sum`, :func:`batch_mean`), BatchNorm's statistics
  (``parallel.sync_bn``) and the gradients (:func:`mean_gradients`).
  Random draws are made for the global batch on every rank, from the same
  generator, and sliced (:func:`draw_rows`), so a rank draws the numbers
  one process draws for its rows;
- ``"model"``: the ensemble-member and independent-output axis. A rank
  trains its contiguous block of members (:func:`block`) and the members
  are then gathered to every rank.

With no process group, or a world of one, nothing resolves to a mesh and
the port runs as one process. ``AOI_AUTO_MESH=0`` turns the automatic
meshes off (explicit meshes and ``mesh=False`` behave as before).

Ranks outside a mesh. An automatic data mesh is sized to the largest
divisor of the batch that the world holds, and an ensemble mesh to the
largest divisor of the member count, so a mesh may leave ranks out (a
world of 4 and a batch of 6: ranks 0-2), or be none at all (a batch of
7 at world 2, or ``AOI_AUTO_MESH=0``). Such a rank computes a replica:
the whole batch, or every member or output, by itself, as with
``mesh=False``; the trainers then give every rank of the world rank 0's
weights, statistics and history at the end of a fit
(:func:`sync_from_rank0`), so that all ranks end with the same model.
Ensemble training is the exception: a rank outside the member mesh
trains no member and takes each one from the rank that trained it. A
caller's explicit ``mesh=False`` is left alone: each rank keeps what it
computed.
"""

import contextlib
import os
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESHES = {}


def world_size() -> int:
    """The ranks of the initialised process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _mesh(ranks: Sequence[int], n_data: int, n_model: int):
    """The (cached) DeviceMesh of ``ranks`` as (n_data, n_model). Building
    one creates process groups, a collective call: every rank builds the
    same meshes in the same order, as every rank makes the same calls."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (id(dist.group.WORLD), device_type, tuple(ranks), n_data, n_model)
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(
            device_type, torch.tensor(list(ranks)).reshape(n_data, n_model),
            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _MESHES[key]


def get_mesh(n_data: Optional[int] = None, n_model: int = 1,
             devices: Optional[Sequence[int]] = None):
    """Builds a (data, model) mesh over ``devices``: global ranks, one a
    device (default: every rank of the world)."""
    if world_size() == 1 and not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(atomai_tpu_torch.parallel.launch starts one)")
    ranks = list(range(world_size())) if devices is None else \
        [int(d) for d in devices]
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model > len(ranks):
        raise ValueError(f"mesh {n_data}x{n_model} needs more than "
                         f"{len(ranks)} devices")
    return _mesh(ranks[:n_data * n_model], n_data, n_model)


def ensemble_mesh(n_models: int, devices: Optional[Sequence[int]] = None):
    """Mesh that spreads ensemble members over the ranks: the model axis is
    the largest divisor of ``n_models`` that fits the rank count, so every
    rank of the axis holds the same number of members."""
    n_dev = world_size() if devices is None else len(devices)
    n_model = 1
    for d in range(min(n_models, n_dev), 0, -1):
        if n_models % d == 0:
            n_model = d
            break
    return get_mesh(n_data=n_dev // n_model, n_model=n_model,
                    devices=devices)


def _auto_mesh_enabled() -> bool:
    """``AOI_AUTO_MESH=0`` (or false, off, no) turns the automatic meshes
    off; explicit meshes are always used."""
    val = os.environ.get("AOI_AUTO_MESH", "1").strip().lower()
    return val not in ("0", "false", "off", "no")


def _given(mesh):
    """A caller's mesh, checked: a ``DeviceMesh`` with the dimensions
    ("data", "model")."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS, MODEL_AXIS):
        raise TypeError("mesh must be None, False or a DeviceMesh with the "
                        f"dimensions ('data', 'model') (core.mesh.get_mesh), "
                        f"not {mesh!r}")
    return mesh


def resolve_data_mesh(mesh=None, batch_size: Optional[int] = None):
    """The data-parallel mesh of a fit or a predictor:

    * ``None``: a pure data mesh when the world has more than one rank,
      sized to the largest rank count that divides ``batch_size`` (when
      given); none where that is 1, or when ``AOI_AUTO_MESH=0``;
    * ``False``: no mesh (every rank computes alone);
    * a ``DeviceMesh`` (of :func:`get_mesh`): used as given; anything
      else raises.
    """
    if mesh is False:
        return None
    if mesh is not None:
        return _given(mesh)
    if not _auto_mesh_enabled():
        return None
    n_dev = world_size()
    if n_dev <= 1:
        return None
    n_data = n_dev
    if batch_size is not None:
        n_data = 1
        for d in range(min(n_dev, batch_size), 0, -1):
            if batch_size % d == 0:
                n_data = d
                break
        if n_data <= 1:
            return None
    return get_mesh(n_data=n_data, n_model=1, devices=range(n_data))


def resolve_model_mesh(mesh, n_models: int):
    """Model-axis counterpart of :func:`resolve_data_mesh`: ``None`` builds
    an :func:`ensemble_mesh` when the members spread over more than one
    rank, ``False`` gives none, a ``DeviceMesh`` is used as given."""
    if mesh is False:
        return None
    if mesh is not None:
        return _given(mesh)
    if not _auto_mesh_enabled() or world_size() <= 1:
        return None
    m = ensemble_mesh(n_models)
    return m if axis_size(m, MODEL_AXIS) > 1 else None


def data_sharding(mesh, ndim: int):
    """The placements of a batch on ``mesh``: the leading axis sharded over
    the data axis, replicated over the model axis (DTensor's form of
    ``PartitionSpec("data")``; ``ndim`` is accepted for the JAX
    signature)."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicate(mesh):
    """The placements of a tensor every rank of ``mesh`` holds whole."""
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


# ------------------------------------------------------------ coordinates
def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(_dim(mesh, axis))


def in_mesh(mesh) -> bool:
    """Whether this rank belongs to ``mesh``."""
    return mesh is not None and mesh.get_coordinate() is not None


def axis_index(mesh, axis: str) -> Optional[int]:
    """This rank's coordinate along ``axis`` (None outside the mesh)."""
    if not in_mesh(mesh):
        return None
    return mesh.get_coordinate()[_dim(mesh, axis)]


def splits(mesh, axis: str) -> bool:
    """Whether this rank computes a block of ``axis`` (it is in a mesh
    whose ``axis`` has more than one rank)."""
    return in_mesh(mesh) and axis_size(mesh, axis) > 1


def block(n: int, mesh, axis: str) -> slice:
    """This rank's contiguous block of ``n`` items split over ``axis``
    (all of them without a mesh or outside it); ``n`` must divide."""
    if not splits(mesh, axis):
        return slice(0, n)
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} items do not split over {k} ranks of "
                         f"the {axis} axis")
    i = axis_index(mesh, axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def block_owner(mesh, axis: str, index: int) -> int:
    """The global rank that owns block ``index`` of ``axis`` (the rank of
    the mesh at coordinate 0 of the other axis)."""
    ranks = mesh.mesh
    return int(ranks[index, 0] if _dim(mesh, axis) == 0 else ranks[0, index])


def group(mesh, axis: str):
    """This rank's process group along ``axis``."""
    return mesh.get_group(_dim(mesh, axis))


def shard_batch(mesh, *arrays):
    """This rank's block of each array's leading (batch) axis over the
    data axis; an array whose batch the data axis does not divide is kept
    whole (replicated), and so is everything without a mesh."""
    out = []
    for a in arrays:
        if splits(mesh, DATA_AXIS) and getattr(a, "ndim", 0) >= 1 and \
                a.shape[0] % axis_size(mesh, DATA_AXIS) == 0:
            a = a[block(a.shape[0], mesh, DATA_AXIS)]
        out.append(a)
    return tuple(out) if len(out) > 1 else out[0]


def shard_member_stacked(tree, mesh):
    """This rank's block of the leading (member) axis of every tensor of
    ``tree`` (dicts, lists and tuples of tensors) over the model axis;
    scalars are kept whole."""
    if isinstance(tree, dict):
        return {k: shard_member_stacked(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_member_stacked(v, mesh) for v in tree)
    if getattr(tree, "ndim", 0) >= 1:
        return tree[block(tree.shape[0], mesh, MODEL_AXIS)]
    return tree


# ------------------------------------------------------------ collectives
class _AllSum(torch.autograd.Function):
    """Sum over a group, differentiable: the backward sums the incoming
    gradients over the group too, so each rank's gradient is the group
    size times its part of the true one, which :func:`mean_gradients`
    divides back."""

    @staticmethod
    def forward(ctx, t, pg):
        ctx.pg = pg
        t = t.clone()
        dist.all_reduce(t, group=pg)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed over this rank's group along ``axis`` (differentiable);
    ``t`` itself where the rank does not split that axis."""
    if not splits(mesh, axis):
        return t
    return _AllSum.apply(t, group(mesh, axis))


def gather_blocks(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's block of ``axis`` concatenated along dim 0 (blocks of
    equal shape); ``t`` itself where the rank does not split that axis."""
    if not splits(mesh, axis):
        return t
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t.contiguous(), group=group(mesh, axis))
    return torch.cat(parts)


def mean_gradients(params: Iterable[torch.nn.Parameter], mesh,
                   axis: str = DATA_AXIS) -> None:
    """Replaces every gradient by its mean over this rank's group along
    ``axis``, in one all-reduce of a flat buffer a dtype."""
    if not splits(mesh, axis):
        return
    grads = [p.grad for p in params if p.grad is not None]
    k = axis_size(mesh, axis)
    pg = group(mesh, axis)
    # in the parameters' order: every rank makes the same calls
    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=pg)
        flat /= k
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int) -> None:
    """Overwrites each tensor, in place, with global rank ``src``'s, over
    the whole world."""
    for t in tensors:
        dist.broadcast(t, src)


def replicas(mesh, pref=None) -> bool:
    """Whether ranks of the world computed replicas that must end equal:
    the world has more than one rank, the caller did not ask for
    ``mesh=False`` (``pref``), and ``mesh`` leaves ranks out or is None
    (no automatic mesh divides the batch, or ``AOI_AUTO_MESH=0``)."""
    if pref is False or world_size() <= 1:
        return False
    return mesh is None or mesh.mesh.numel() < world_size()


def sync_from_rank0(mesh, tensors: Iterable[torch.Tensor],
                    obj: Any = None, pref=None) -> Any:
    """Where ranks computed replicas (:func:`replicas` of ``mesh`` and the
    caller's ``pref``), gives every rank rank 0's ``tensors`` (in place)
    and ``obj`` (picklable); returns the object. Nothing otherwise: on the
    card, replicas drift apart (atomics in the backward), so this is what
    makes every rank end with the same model."""
    if not replicas(mesh, pref):
        return obj
    broadcast_tensors(tensors, 0)
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


# ------------------------------------------------- a step split over data
class _Split:
    def __init__(self, pg, index: int, n: int):
        self.pg, self.index, self.n = pg, index, n


_SPLIT: List[_Split] = []


@contextlib.contextmanager
def split_batch(mesh):
    """Within the block, this rank computes its block of the global batch
    over ``mesh``'s data axis: :func:`draw_rows` draws the global batch's
    numbers and keeps the rank's rows, :func:`batch_sum` and
    :func:`batch_mean` reduce over the global batch. A no-op where the
    rank does not split the data axis."""
    if not splits(mesh, DATA_AXIS):
        yield
        return
    _SPLIT.append(_Split(group(mesh, DATA_AXIS),
                         axis_index(mesh, DATA_AXIS),
                         axis_size(mesh, DATA_AXIS)))
    try:
        yield
    finally:
        _SPLIT.pop()


def active_split() -> Optional[_Split]:
    return _SPLIT[-1] if _SPLIT else None


def draw_rows(sampler, shape, **kwargs) -> torch.Tensor:
    """``sampler(shape, **kwargs)`` (``torch.rand``, ``torch.randn``, ...)
    for the rows of ``shape[0]``; under :func:`split_batch` the global
    batch's draw, sliced to this rank's rows."""
    s = active_split()
    if s is None:
        return sampler(tuple(shape), **kwargs)
    rows = shape[0]
    full = sampler((rows * s.n,) + tuple(shape[1:]), **kwargs)
    return full[s.index * rows:(s.index + 1) * rows]


def split_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of a split step (differentiable); ``t``
    outside a split."""
    s = active_split()
    return t if s is None else _AllSum.apply(t, s.pg)


def split_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a split step of ``t`` (a mean over this
    rank's rows): the global batch's mean where the rows are equal blocks
    (differentiable); ``t`` outside a split."""
    s = active_split()
    return t if s is None else _AllSum.apply(t, s.pg) / s.n


def batch_sum(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` summed over ``dim`` (every axis by default), which holds the
    batch axis: under :func:`split_batch` the global batch's sum
    (differentiable)."""
    return split_sum(t.sum() if dim is None else t.sum(dim))


def batch_mean(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` averaged over ``dim`` (every axis by default), which holds
    the batch axis: under :func:`split_batch` the global batch's mean
    (blocks of equal size; differentiable); ``torch.mean`` outside."""
    s = active_split()
    if s is None:
        return t.mean() if dim is None else t.mean(dim)
    return split_mean(t.mean() if dim is None else t.mean(dim))


__all__ = ["DATA_AXIS", "MODEL_AXIS", "get_mesh", "ensemble_mesh",
           "resolve_data_mesh", "resolve_model_mesh", "data_sharding",
           "replicate", "shard_member_stacked", "shard_batch", "world_size",
           "axis_size", "axis_index", "in_mesh", "splits", "block",
           "block_owner", "group", "all_sum", "gather_blocks",
           "mean_gradients", "broadcast_tensors", "replicas",
           "sync_from_rank0",
           "split_batch", "active_split", "draw_rows", "split_sum",
           "split_mean", "batch_sum", "batch_mean"]
