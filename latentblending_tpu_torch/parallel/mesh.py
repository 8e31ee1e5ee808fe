"""The ('data', 'model') mesh over torch.distributed ranks, and its
collectives.

Counterpart of latentblending_tpu/parallel/mesh.py. The JAX package's
central strategy is batched-tree data parallelism: the sibling stems of
one injection level are the batch axis of one UNet forward, sharded over
the mesh's 'data' axis, with the parameters replicated over 'data' and
(optionally) Megatron-sharded over 'model' (tp.py). XLA emits the
collectives from sharding annotations; here each rank is one process and
the collectives are explicit, one small helper per kind, counted on the
Mesh (`collectives`).

Ranks are laid out data-major, rank = d * n_model + m, so a model group is
n_model consecutive ranks (one host under torchrun). Under the gloo
backend a CUDA tensor is staged through pinned host memory for each
collective (gloo's CUDA support differs by collective): a transport, not a
fallback; the computation stays on the card.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn


class Mesh:
    """This rank's view of an n_data × n_model mesh: `shape` ({"data",
    "model"}, read as mesh.shape["data"]), the global `rank`, its
    coordinates `data_index`/`model_index`, the process groups along each
    axis (None on the trivial mesh without a process group) and a count of
    the collectives run, by kind. It stands for the jax.sharding.Mesh that
    latentblending_tpu/parallel/mesh.py:20-26 builds over devices."""

    def __init__(self, n_data: int, n_model: int, rank: int = 0, data_group=None, model_group=None,
                 backend: Optional[str] = None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.shape["model"])
        self.data_group = data_group
        self.model_group = model_group
        self.backend = backend
        self.collectives = {"all_gather": 0, "all_reduce": 0, "broadcast": 0, "barrier": 0}

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs over a process group (False only for the
        trivial (1, 1) mesh made without one)."""
        return self.backend is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank}, "
                f"backend={self.backend})")

    # ------------------------------------------------------ collective helpers

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """`x` where the backend moves it: gloo moves host tensors (a CUDA
        tensor is staged through pinned host memory), NCCL CUDA tensors."""
        if self.backend == "gloo" and x.is_cuda:
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
        if self.backend == "nccl" and not x.is_cuda:
            return x.to(torch.device("cuda", torch.cuda.current_device()))
        return x.contiguous()

    def all_gather(self, x: torch.Tensor, group) -> list[torch.Tensor]:
        """The tensors of every rank of `group` (None: the world), in
        group-rank order, on x's device."""
        self.collectives["all_gather"] += 1
        w = self._wire(x)
        out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, w, group=group)
        return [o.to(x.device) for o in out]

    def all_reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        """The sum of `x` over `group` (x itself may be reduced in place)."""
        self.collectives["all_reduce"] += 1
        w = self._wire(x)
        dist.all_reduce(w, group=group)
        return w.to(x.device)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Global rank `src`'s `x` on every rank of the world."""
        self.collectives["broadcast"] += 1
        w = self._wire(x)
        dist.broadcast(w, src)
        return w.to(x.device)

    def barrier(self) -> None:
        """Wait for every rank of the world (no-op without a process group)."""
        if not self.distributed:
            return
        self.collectives["barrier"] += 1
        _world_barrier()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """('data', 'model') mesh over the ranks of the process group
    (latentblending_tpu/parallel/mesh.py:20-26). Needs an initialized group
    of n_data × n_model ranks; make_mesh(1, 1) without one builds the
    trivial mesh (the mesh code path on one device, as the JAX make_mesh
    over one device). Every rank must call it, with the same arguments:
    new_group runs on every rank for every group, in one order."""
    n_model = int(n_model)
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"make_mesh({n_data}, {n_model}) needs an initialized process group "
                             f"(parallel.distributed.init_distributed)")
        return Mesh(1, 1)
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover the process group's {world} ranks")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, rank, data_groups[m], model_groups[d], dist.get_backend())


def auto_mesh(n_model: Optional[int] = None) -> Optional[Mesh]:
    """Mesh over all ranks, or None below 2 ranks; n_model (or LB_MESH_TP)
    carves the tensor-parallel axis out of the rank count
    (latentblending_tpu/parallel/mesh.py:66-79)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < 2:
        return None
    if n_model is None:
        n_model = int(os.environ.get("LB_MESH_TP", "1"))
    return make_mesh(n_data=world // n_model, n_model=n_model)


def pad_to_multiple(n: int, m: int) -> int:
    """Stem batches are padded to a multiple of the data-axis size so the
    shard shapes stay static (recompilation control, SURVEY.md §7 hard part c).
    A copy of latentblending_tpu/parallel/mesh.py:82-85."""
    return ((n + m - 1) // m) * m


def shard_stem_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch padded to a multiple of n_data (the JAX
    shard_stem_batch's local shard, latentblending_tpu/parallel/mesh.py:55-58):
    the data_index-th of n_data equal slices along `dim`."""
    n = mesh.shape["data"]
    if x.shape[dim] % n:
        raise ValueError(f"batch {x.shape[dim]} is not a multiple of the data axis {n}: pad it first")
    b = x.shape[dim] // n
    return x.narrow(dim, mesh.data_index * b, b)


def gather_stem_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every data shard's rows, concatenated along `dim` in shard order:
    the all-gather over the data group. It stands for XLA's implicit gather
    when the JAX holder's global output array is read."""
    if not mesh.distributed:
        return x
    return torch.cat(mesh.all_gather(x, mesh.data_group), dim=dim)


def _checksums(module: nn.Module) -> tuple[list[str], torch.Tensor]:
    names, sums = [], []
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        v = t.detach().double()
        names.append(name)
        sums.append(torch.stack([v.sum(), (v * v).sum()]))
    return names, torch.stack(sums)


def replicate_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """replicate_params of latentblending_tpu/parallel/mesh.py:61-63, as a
    check of its contract (the _put_global docstring, :38-52):
    every rank built identical weights (same seed, same snapshot). One
    all-gather of a vector of per-tensor checksums (the sum and the sum of
    squares of each tensor, in float64) over the world, instead of
    broadcasting the weights tensor by tensor; raises ValueError naming
    the first tensor that differs from rank 0's. Returns the module."""
    if not mesh.distributed:
        return module
    names, local = _checksums(module)
    every = mesh.all_gather(local.cpu(), None)
    for r, other in enumerate(every):
        diff = (other != every[0]).any(dim=1)
        if bool(diff.any()):
            bad = names[int(diff.nonzero()[0, 0])]
            raise ValueError(f"replicate_params: rank {r}'s {bad} differs from rank 0's; every rank must build "
                             f"the same weights (same seed or snapshot)")
    return module


def broadcast_from_rank0(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Global rank 0's value of `x` on every rank (x itself without a
    distributed mesh). The engine broadcasts its gap similarities before
    any placement reads them, so the ranks, each running the whole engine
    (SPMD), cannot place stems differently when floats differ in the last
    bit: one-process-per-card PyTorch's way to keep the JAX package's
    single controller."""
    if mesh is None or not mesh.distributed:
        return x
    return mesh.broadcast(x, 0)


def is_file_writer() -> bool:
    """Whether this process writes the files of an SPMD run: global rank 0
    of the process group, or a process without one. The one rule every
    writer of the port follows (write_on_rank0, run_multi_transition)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def write_on_rank0(write: Callable, *args, **kw):
    """Run `write` (which writes files) on global rank 0 only, then wait
    at a barrier for every rank of the process group, so N ranks never
    write one path; without a process group, just run it. Every rank calls
    this. Returns what `write` returned (None on the other ranks). The JAX
    package has one controller process that writes; this is how SPMD ranks
    keep that."""
    try:
        return write(*args, **kw) if is_file_writer() else None
    finally:
        if dist.is_initialized():
            _world_barrier()


def _world_barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
