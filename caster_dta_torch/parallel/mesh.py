"""Process groups for multi-device training (counterpart of
caster_dta_tpu/parallel/mesh.py).

The JAX package has one process own a mesh of devices, shards batches with
``NamedSharding`` and lets GSPMD insert the collectives. Here, as is usual
with PyTorch, there is **one process per device**: ``torch.distributed``
joins the processes, a ``Mesh`` holds the world, this rank, and the ``dp``
and ``gp`` process groups of the ``n_dp x gp`` grid (rank ``r`` sits at
``(r // gp, r % gp)``, JAX's ``reshape(n_dp, n_gp)`` of the device list), and
the collectives are explicit: a batch's rows per rank (``shard_batch``), the
loss's sums and the gradients' all-reduce, parameters broadcast from rank 0.

The backend is chosen up front (``pick_backend``), never after an error:
NCCL where each rank has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device). Gloo takes the card's
tensors itself for every collective used here (``all_reduce``,
``all_gather``, ``all_to_all_single``, ``broadcast``: probed on the H100's
machine by chip_smoke.py's multidevice phase), so no backend needs its
tensors staged by hand.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from caster_dta_torch.device import resolve_device


def _init_method(address: str) -> str:
    """``host:port`` (the JAX package's form) -> ``tcp://host:port``; a URL
    (``tcp://``, ``file://``, ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def pick_backend(device: str | torch.device, local_processes: int = 1) -> str:
    """'nccl' when each of the ``local_processes`` ranks on this host has a
    card of its own, else 'gloo' (the CPU, or ranks sharing a card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_processes <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, device: str | torch.device = "cuda") -> torch.device:
    """The device of ``rank``: ``cuda:(rank mod device_count)`` on the card,
    else the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str | torch.device = "cuda", backend: Optional[str] = None,
                     local_processes: Optional[int] = None,
                     verbose: bool = True) -> torch.device:
    """Join the process group (``init_process_group``) -> this rank's device.

    ``coordinator_address`` is ``host:port`` or a ``tcp://``/``file://`` URL;
    without it the three arguments come from the environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is
    ``pick_backend(device, local_processes)`` unless ``backend`` is given;
    ``local_processes`` (the ranks on this host; default ``LOCAL_WORLD_SIZE``
    or 1) decides whether ranks share a card. The choice is printed."""
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = _init_method(coordinator_address)
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    local = int(local_processes or os.environ.get("LOCAL_WORLD_SIZE", 1))
    dev = rank_device(rank, device)
    chosen = backend or pick_backend(dev, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(chosen, init_method=init_method, world_size=world, rank=rank)
    if verbose:
        why = ("explicit" if backend else "the CPU" if dev.type != "cuda" else
               f"{local} ranks on {torch.cuda.device_count()} card(s)")
        print(f"rank {rank}/{world}: backend {chosen} ({why}) on {dev}", flush=True)
    return dev


@dataclass
class Mesh:
    """This rank's place in the ``n_dp x gp`` grid of the process group,
    with the groups of its row (``gp_group``: the ranks that partition one
    protein) and its column (``dp_group``: the ranks that hold the same shard
    of different pairs)."""

    n_dp: int
    gp: int
    rank: int
    device: torch.device
    backend: str
    world_group: object
    dp_group: object
    gp_group: object

    @property
    def world(self) -> int:
        return self.n_dp * self.gp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.gp

    @property
    def gp_rank(self) -> int:
        return self.rank % self.gp

    def group(self, axis: str):
        """The group of ``axis``: 'world', 'dp' or 'gp'."""
        return {"world": self.world_group, "dp": self.dp_group, "gp": self.gp_group}[axis]

    def size(self, axis: str) -> int:
        return {"world": self.world, "dp": self.n_dp, "gp": self.gp}[axis]

    def index(self, axis: str) -> int:
        """This rank's position in ``axis``'s group."""
        return {"world": self.rank, "dp": self.dp_rank, "gp": self.gp_rank}[axis]

    # ------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """Sum ``t`` over ``axis`` in place (not differentiable) -> t."""
        dist.all_reduce(t, group=self.group(axis))
        return t

    def all_reduce_grads(self, grads: list) -> list:
        """Gradients summed over the world, in one flat all-reduce."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]),
                                                     grads)]

    def gather(self, t: torch.Tensor, axis: str = "world", dim: int = 0) -> torch.Tensor:
        """Every member's ``t`` of ``axis``, concatenated along ``dim`` in
        rank order (not differentiable)."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def gather_grad(self, t: torch.Tensor, axis: str = "gp", dim: int = 1) -> torch.Tensor:
        """``gather`` through autograd: the backward sums every member's
        gradient of this rank's part of the result (a reduce-scatter, as one
        all-to-all and a sum)."""
        return _GatherGrad.apply(t, self, axis, dim)

    def all_to_all_grad(self, t: torch.Tensor, axis: str = "gp") -> torch.Tensor:
        """``t`` [G, ...] split along dim 0: part p goes to member p; the result's
        part h is what member h sent here. Differentiable: the backward is the
        same exchange of the gradient."""
        return _AllToAll.apply(t, self, axis)

    def _all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group(axis))
        return out

    def broadcast_params(self, module: torch.nn.Module) -> None:
        """Every parameter and buffer of ``module`` set to rank 0's."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                buf = t.detach().clone()
                dist.broadcast(buf, src=0, group=self.world_group)
                t.copy_(buf)


class _AllToAll(torch.autograd.Function):
    """Mesh.all_to_all_grad. Written here, not taken from
    ``torch.distributed.nn.functional``, whose gloo backward of ``all_gather``
    names a subgroup's members by their group ranks where ``scatter`` wants
    global ones (a ``dp x gp`` mesh's gp groups hang); both collectives are
    kept alike."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._all_to_all(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_to_all(grad, ctx.axis), None, None


class _GatherGrad(torch.autograd.Function):
    """Mesh.gather_grad: forward the members' parts concatenated along dim;
    backward each member's gradient of this rank's part, summed."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.gather(t, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        parts = torch.stack(grad.chunk(ctx.mesh.size(ctx.axis), dim=ctx.dim))
        return ctx.mesh._all_to_all(parts, ctx.axis).sum(0), None, None, None


def _world_device(device) -> torch.device:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh.init_distributed first")
    return rank_device(dist.get_rank(), device)


def make_2d_mesh(n_dp: int, n_gp: int, device: str | torch.device = "cuda") -> Mesh:
    """The ``n_dp x n_gp`` grid over the whole process group (every rank calls
    it, in the same order as any other group it makes)."""
    dev = _world_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_dp * n_gp != world:
        raise ValueError(f"mesh {n_dp}x{n_gp} needs {n_dp * n_gp} processes, the group has "
                         f"{world}")
    backend = dist.get_backend()
    # every rank creates every group (torch's rule), keeping its own
    dp_groups = [dist.new_group([g + d * n_gp for d in range(n_dp)], backend=backend)
                 for g in range(n_gp)]
    gp_groups = [dist.new_group([d * n_gp + g for g in range(n_gp)], backend=backend)
                 for d in range(n_dp)]
    return Mesh(n_dp, n_gp, rank, dev, backend, dist.group.WORLD, dp_groups[rank % n_gp],
                gp_groups[rank // n_gp])


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp",
              device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh over the whole process group: 'dp' (or 'gp' when
    ``axis_name='gp'``)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if axis_name == "gp":
        return make_2d_mesh(1, n, device)
    if axis_name != "dp":
        raise ValueError(f"axis_name must be 'dp' or 'gp', not {axis_name!r}")
    return make_2d_mesh(n, 1, device)


def replicate_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters on every rank (JAX's replicated placement)."""
    mesh.broadcast_params(module)
    return module


def _rows(mesh: Mesh, axis: str, b: int) -> slice:
    n = mesh.size(axis)
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} ranks of {axis!r}")
    i = mesh.index(axis)
    return slice(i * (b // n), (i + 1) * (b // n))


def _slice(obj, rows: slice, dim: int = 0):
    """Every tensor or array field of a dataclass sliced along ``dim``."""
    idx = (slice(None),) * dim + (rows,)
    return dataclasses.replace(obj, **{
        f.name: (_slice(v, rows, dim) if dataclasses.is_dataclass(v) and not isinstance(v, type)
                 else v[idx] if hasattr(v, "shape") else v)
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})


def shard_batch(batch, mesh: Mesh, axis: str = "world"):
    """This rank's rows of a training-loop batch, for data parallelism over
    ``axis`` ('world', every rank, as the JAX package shards standard buckets
    over all of ``dp x gp``; or 'dp').

    - PairBatch: rows of every field (the leading batch dim).
    - StoreBatch: rows of its row, target, weight and pair arrays; the stores
      are whole on every rank (data/device_cache.py).
    - MegaBatch: the per-step arrays are [k, B]: rows of B (axis 1)."""
    from caster_dta_torch.data.device_cache import MegaBatch, StoreBatch

    if isinstance(batch, MegaBatch):
        rows = _rows(mesh, axis, batch.p_rows.shape[1])
        return dataclasses.replace(batch, **{k: getattr(batch, k)[:, rows] for k in (
            "p_rows", "m_rows", "target", "weight", "pair_idx")})
    if isinstance(batch, StoreBatch):
        rows = _rows(mesh, axis, len(batch.p_rows))
        return dataclasses.replace(batch, **{k: getattr(batch, k)[rows] for k in (
            "p_rows", "m_rows", "target", "weight", "pair_idx")})
    return _slice(batch, _rows(mesh, axis, len(batch.target)))
