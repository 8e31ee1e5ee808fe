"""Multi-process start-up: torch.distributed and the global mesh.

Counterpart of latentblending_tpu/parallel/distributed.py. The JAX package
calls jax.distributed.initialize and lets XLA emit every collective; here
each rank is one process with one card, joined by a torch.distributed
process group, and the collectives are the small helpers of mesh.py.

Launch over N cards of one host with

    torchrun --nproc-per-node N your_script.py

where the script calls init_distributed() and passes global_mesh() (or
mesh.auto_mesh()) to SDXLHolder(mesh=...). torchrun sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK; without them and without
arguments the process stays single, as the JAX package does.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from latentblending_tpu_torch.parallel.mesh import Mesh, make_mesh


def _local_device(device) -> torch.device:
    """This rank's device: `device` if given, else cuda:{LOCAL_RANK} where
    there is a card, else the CPU. A LOCAL_RANK beyond the card count
    raises: two ranks share a card only when the caller names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA device(s); "
                           f"pass device=\"cuda:0\" to share one card")
    return torch.device("cuda", local)


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Start the process group once, from the arguments or torchrun's env
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). Returns True
    when running multi-process (world size > 1). Counterpart of
    latentblending_tpu/parallel/distributed.py:20-43.

    init_method: e.g. "tcp://localhost:29500"; None reads the env
    ("env://"), and with neither the process stays single (returns False,
    as the JAX package at distributed.py:32-35). backend: "nccl" for a CUDA
    device and "gloo" for the CPU by default; "gloo" with a CUDA device is
    how two ranks share one card (NCCL refuses two ranks on one device).
    Nothing switches backend after a failure. device: this rank's device,
    by default cuda:{LOCAL_RANK} (set with torch.cuda.set_device) or the
    CPU without a card. A holder built after it with device="cuda" lands
    on this rank's card."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and "MASTER_ADDR" not in os.environ and world_size is None:
        # single process — nothing to start
        return False
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    return world_size > 1


def global_mesh(n_model: int = 1) -> Mesh:
    """('data', 'model') mesh over all ranks, data-major: a model group is
    n_model consecutive ranks, so under torchrun it stays on one host and
    only the stem gathers cross hosts (the JAX package's host-major rule,
    distributed.py:45-51)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_data=world // n_model, n_model=n_model)
