"""A device mesh over ``torch.distributed``, and the helpers that shard and
replicate over it.

Port of ``tpu3dssf.parallel.mesh``. JAX runs one program over every device
of a ``jax.sharding.Mesh`` and XLA inserts the collectives; the port runs
one process per rank (``torchrun --nproc_per_node N``), each holding its
own shard, and calls the collectives itself:

* :class:`Mesh` holds the axis names and shape, this rank's coordinates,
  one process group per axis and the rank's device. ``with mesh:`` makes
  it the current mesh (:func:`current_mesh`), JAX's ``with mesh:``: the
  sequence-parallel CPE finds its axis there.
* :func:`create_mesh` brings the default process group up from the
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` environment
  that ``torchrun`` sets, unless it is up already, and maps the ranks
  row-major onto the shape.
* :func:`shard_batch` takes this rank's rows, :func:`replicate` broadcasts
  rank 0's parameters, buffers and optimizer state, and
  :func:`vit_tp_shardings` cuts a ViT's block weights to this rank's
  tensor-parallel shard.

The backend follows the layout (:func:`pick_backend`): gloo for CPU ranks;
NCCL where each rank has a card of its own, which moves the tensors card
to card in their own dtype (bf16 included), the counterpart of XLA's
collectives on the TPU's interconnect, and which a CUDA graph can capture;
gloo for ranks that share one card only where the caller asks for it
(``backend="gloo"``), since NCCL refuses two ranks on one card. Gloo stages
CUDA tensors through host memory, as raw bytes where its dtype table lacks
one (:func:`_byte_view`). Nothing falls back: a layout with no backend, or
a failed NCCL init, raises. The autograd-aware collectives
(:func:`gather_batch`, :func:`all_reduce_sum`, :func:`copy_to_axis`) are
written for the layouts their callers use, and say in which sense their
backward is right.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_CURRENT = []   # the meshes entered with ``with mesh:``, innermost last


class Mesh:
    """A mesh of ranks: ``axis_names``, ``shape`` ({axis: size}, as JAX's
    ``Mesh.shape``), ``coords`` ({axis: this rank's index}), ``groups``
    ({axis: the process group of the ranks that differ from this one only
    along that axis}), ``rank`` (in the default group), ``device`` and
    ``backend`` (the process groups' backend)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 coords: Sequence[int], groups=None, rank: int = 0,
                 device="cpu", owns_group: bool = False,
                 backend: str = "gloo"):
        if len(axis_names) != len(shape) or len(coords) != len(shape):
            raise ValueError(f"mesh axes {tuple(axis_names)} do not match "
                             f"shape {tuple(shape)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, shape)))
        self.coords = dict(zip(self.axis_names, map(int, coords)))
        self.groups = dict(groups or {})
        self.rank = rank
        self.device = torch.device(device)
        self.owns_group = owns_group
        self.backend = backend

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}: "
                             f"{self.axis_names}")
        return self.groups[axis]

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.remove(self)
        return False

    def close(self):
        """Destroy the default process group if :func:`create_mesh` brought
        it up."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __repr__(self):
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _CURRENT[-1] if _CURRENT else None


def _mesh_device(device="cuda") -> torch.device:
    """This rank's device: ``"cuda"`` is ``cuda:(LOCAL_RANK % device
    count)``, so ranks may share a card; raises where CUDA is missing (the
    port never drops to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device}: no CUDA device is available (pass "
                "device='cpu' to run the plain PyTorch versions)")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", 0))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def pick_backend(device, local_ranks: int, cards: int,
                 backend: Optional[str] = None) -> str:
    """The backend for ``local_ranks`` ranks of one host on ``device``
    (``cards`` cards there): gloo for CPU ranks; NCCL where each rank has a
    card of its own; gloo where ranks share a card, only when ``backend``
    asks for it (NCCL refuses two ranks on one card). Raises for any other
    choice: a CUDA mesh with one rank per card never takes gloo."""
    kind = torch.device(device).type
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r}: CPU ranks take gloo")
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"no backend for ranks on {device}")
    if local_ranks > cards:
        if backend != "gloo":
            raise ValueError(
                f"{local_ranks} ranks share {cards} card(s): NCCL refuses "
                "two ranks on one card; pass backend='gloo' to run them "
                "over gloo, through host memory")
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(
            f"backend {backend!r}: each of the {local_ranks} ranks has a "
            "card of its own, which takes NCCL")
    return "nccl"


def _local_ranks() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun sets it), else
    the world size (one host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",),
                device="cuda", backend: Optional[str] = None) -> Mesh:
    """A :class:`Mesh` over every rank (default: a 1-D ``data`` axis).

    Brings up the default process group from the environment ``torchrun``
    sets, unless it is up, over the backend of the layout
    (:func:`pick_backend`; ``backend="gloo"`` for ranks that share a card);
    a group already up must have that backend. Under NCCL every group's
    communicator is made here, by one collective each, so that a CUDA
    graph can capture the collectives (a lazy init cannot be captured).
    Raises when the product of ``shape`` is not the world size, as
    ``mesh_utils`` does. Rank r sits at ``np.unravel_index(r, shape)``.
    """
    device = _mesh_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    owns = not dist.is_initialized()
    if owns:
        if "RANK" not in os.environ:
            raise RuntimeError(
                "create_mesh: no process group is up and RANK is not set: "
                "start one process per rank, e.g. torchrun "
                "--nproc_per_node N -m <module> ...")
        backend = pick_backend(device, _local_ranks(), cards, backend)
        dist.init_process_group(
            backend, device_id=device if backend == "nccl" else None)
    else:
        up = dist.get_backend()
        if pick_backend(device, _local_ranks(), cards, backend or up) != up:
            raise ValueError(f"create_mesh: the process group is up over "
                             f"{up}, not {backend}")
        backend = up
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = tuple(int(s) for s in (shape or (world,)))
    if math.prod(shape) != world or len(shape) != len(axis_names):
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"Number of devices {world} must equal the product "
                         f"of mesh_shape {shape} (axes {tuple(axis_names)})")
    grid = np.arange(world).reshape(shape)
    coords = np.unravel_index(rank, shape)
    groups = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        if shape[a] == world:
            groups[name] = dist.group.WORLD
            continue
        # every rank makes every group, in the same order
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    if backend == "nccl":
        for name in axis_names:
            dist.all_reduce(torch.zeros(1, device=device),
                            group=groups[name])
        torch.cuda.synchronize(device)
    return Mesh(axis_names, shape, coords, groups, rank, device, owns,
                backend)


def shard_rows(x, mesh: Mesh, axis: str = "data", microbatches: int = 1):
    """This rank's rows of one array or tensor (see :func:`shard_batch`)."""
    if np.ndim(x) == 0:
        return x
    n, s, r = x.shape[0], mesh.shape[axis], mesh.coords[axis]
    if n % (s * microbatches):
        raise ValueError(f"batch dim {n} is not divisible by the mesh axis "
                         f"{axis!r} of size {s}"
                         + (f" times {microbatches} microbatches"
                            if microbatches > 1 else ""))
    m = n // microbatches     # rows per microbatch
    k = m // s                # of which this rank holds k
    parts = [x[i * m + r * k:i * m + (r + 1) * k]
             for i in range(microbatches)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat(parts) if isinstance(x, torch.Tensor)
            else np.concatenate(parts))


def shard_batch(batch, mesh: Mesh, axis: str = "data",
                microbatches: int = 1):
    """Every leaf of ``batch`` (a dict of arrays or tensors, or one) cut to
    this rank's contiguous 1/S of its leading dim, S the size of ``axis``;
    0-d leaves stay whole. Raises where the dim does not divide, as JAX's
    ``shard_batch`` does.

    ``microbatches=m`` cuts the leading dim into m microbatches first (JAX's
    ``grad_accum`` reshape) and takes this rank's 1/S of each, concatenated:
    the local batch of a data-parallel train step with ``grad_accum = m``.
    """
    if isinstance(batch, dict):
        return {k: shard_rows(v, mesh, axis, microbatches)
                for k, v in batch.items()}
    return shard_rows(batch, mesh, axis, microbatches)


def _state_tensors(obj):
    """The tensors :func:`replicate` broadcasts: a module's parameters and
    buffers, and for a train state (``.model``, ``.optimizer``) also its
    optimizer's state and the chain's device state (its rate, counts and
    plateau)."""
    model = getattr(obj, "model", obj)
    out = [p.data for p in model.parameters()] + list(model.buffers())
    opt = getattr(obj, "optimizer", None)
    if opt is not None:
        for p in model.parameters():
            out += [v for v in opt.inner.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
        out += list(opt.device_state().values())   # the rate among them
    return out


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Broadcast rank 0's parameters, buffers and optimizer state (of a
    module or a train state) to every rank, in place, so every rank holds
    the same bits; one broadcast per dtype and device. Returns ``obj``."""
    tensors = _state_tensors(obj)
    buckets = {}
    for x in tensors:
        buckets.setdefault((x.dtype, x.device), []).append(x)
    for key in sorted(buckets, key=str):
        xs = buckets[key]
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.broadcast(flat, src=0)
        offset = 0
        for x in xs:
            x.copy_(flat[offset:offset + x.numel()].view_as(x))
            offset += x.numel()
    return obj


def _byte_view(x):
    """A contiguous tensor seen as raw bytes (gloo moves any dtype so)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def all_gather_rows(x, group, size):
    """(n, ...) on each of ``size`` ranks → (size·n, ...) in rank order:
    one NCCL ``all_gather_into_tensor`` in ``x``'s own dtype on the card,
    or one gloo ``all_gather`` of the raw bytes."""
    rows = (size * x.shape[0],) + tuple(x.shape[1:])
    if dist.get_backend(group) == "nccl":
        out = torch.empty(rows, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    src = _byte_view(x)
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).view(x.dtype).reshape(rows)


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0; the backward takes this rank's slice of the
    incoming gradient and communicates nothing. That is the gradient where
    every rank computes the same function of the gathered tensor (the
    data-parallel loss): summing the ranks' identical gradients, as a
    reduce-scatter would, counts it once per rank."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.rows, ctx.index = x.shape[0], index
        return all_gather_rows(x, group, size)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def gather_batch(x, mesh: Mesh, axis: str = "data"):
    """The whole batch on every rank from each rank's rows, in rank order
    (see :class:`_GatherBatch` for its gradient)."""
    return _GatherBatch.apply(x, mesh.group(axis), mesh.shape[axis],
                              mesh.coords[axis])


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of an axis (a row-parallel layer's partial
    outputs); the backward passes the gradient through, which is right
    where every rank consumes the sum alike (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """The identity on a replicated input of column-parallel layers; the
    backward sums the ranks' partial gradients (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, mesh: Mesh, axis: str):
    return _AllReduceSum.apply(x, mesh.group(axis))


@torch.no_grad()
def all_reduce_max(x, mesh: Mesh, axis: str):
    """The elementwise max over the ranks of ``axis`` (no gradient: a W8A8
    row-parallel layer's activation scale)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return y


def copy_to_axis(x, mesh: Mesh, axis: str):
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToAxis.apply(x, mesh.group(axis))


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh, axis: str = "data"):
    """Sum the parameters' gradients over ``axis`` in place, one
    ``all_reduce`` per dtype; a missing gradient counts as zeros (and is
    set so, on every rank alike)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    buckets = {}
    for p in params:
        buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for key in sorted(buckets, key=str):
        grads = buckets[key]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group(axis))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def vit_tp_shardings(model, mesh: Mesh, axis: str = "model"):
    """Cut each block of a ViT (``tpu3dssf_torch.models.vit``) to this
    rank's Megatron shard over ``axis``, in place: qkv and ``mlp_in``
    column-parallel (their weight rows and bias split), ``proj`` and
    ``mlp_out`` row-parallel (their weight columns split; the bias stays
    whole and is added once, after the sum). A W8A8 layer's ``kernel_q`` is
    split as a weight; its ``scale`` is split with the bias of a
    column-parallel layer and stays whole in a row-parallel one. Norms,
    embeddings, LayerScale and the RoPE tables stay whole. The blocks must
    have been through
    :func:`tpu3dssf_torch.models.vit.prepare_tp_params`, whose qkv layout
    makes each rank's contiguous rows its packed [q_s|k_s|v_s]. Returns
    ``model``.

    JAX's version returns shardings that ``device_put`` applies; here each
    rank keeps only its shard, which is what a sharding places on a
    device."""
    s, r = mesh.shape[axis], mesh.coords[axis]
    for blk in model.blocks:
        if blk.cfg.tp_axis != axis or blk.cfg.tp_mesh is not mesh:
            raise ValueError("vit_tp_shardings: run prepare_tp_params with "
                             f"this mesh and axis {axis!r} first")
        if blk.qkv.out_features != 3 * blk.cfg.hidden_size:
            raise ValueError("vit_tp_shardings: the model is sharded "
                             "already")
        for name in ("qkv", "mlp_in"):
            _keep(getattr(blk, name), 0, s, r, bias=True)
        for name in ("proj", "mlp_out"):
            _keep(getattr(blk, name), 1, s, r, bias=False)
    return model


@torch.no_grad()
def _keep(dense, dim, shards, index, bias):
    """Keep shard ``index`` of ``dense``'s weight along ``dim`` (0: output
    rows, 1: input columns), and of its bias where ``bias``: a Dense's
    parameters ``weight`` and ``bias``, a W8A8 ``QuantDense``'s buffers
    ``kernel_q``, and ``scale`` and ``bias``."""
    quant = hasattr(dense, "kernel_q")
    n = (dense.out_features if dim == 0 else dense.in_features) // shards
    names = [("kernel_q" if quant else "weight", dim)]
    if bias:
        names += [(name, 0) for name in (("scale", "bias") if quant
                                         else ("bias",))]
    for name, d in names:
        x = getattr(dense, name)
        x = x.narrow(d, index * n, n).clone(
            memory_format=torch.contiguous_format)
        if quant:
            setattr(dense, name, x)   # a registered buffer is replaced
        else:
            setattr(dense, name, torch.nn.Parameter(
                x, requires_grad=getattr(dense, name).requires_grad))
    if dim == 0:
        dense.out_features = n
    else:
        dense.in_features = n
