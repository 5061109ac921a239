"""Data parallelism: one process a rank, ``torch.distributed`` between them
(the JAX package's ``parallel/mesh.py``).

The JAX package lays the batch out over a 1-D ``data`` mesh and lets XLA
insert the gradient all-reduce. Here each rank is a process started by
``torchrun`` (or ``torch.multiprocessing.spawn`` with a store, in the
tests): it loads only its slice of each batch (``data/loader.py``,
``process_index`` / ``process_count``), runs the one-card step on it, and
the step sums the token-weighted gradients of all ranks with one
``all_reduce`` of the flat buffer (``training/steps.py``). Every helper
below is a no-op at world size 1, so the one-process path is the same
code.

The backend follows the layout and is chosen once: ``nccl`` when every
rank of the host has a card of its own, ``gloo`` when ranks share a card
(NCCL refuses two ranks on one device: "Duplicate GPU detected") or run
on the CPU. Nothing retries on another backend after a failure. gloo runs
every collective used here (all_reduce, reduce_scatter_tensor,
all_gather_into_tensor, all_gather_object) on CUDA tensors directly on
the card's PyTorch, so none is staged through the host.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    return rank() == 0


def choose_backend(device: torch.device, local_world: int,
                   n_cards: int) -> str:
    """``nccl`` when each of the host's `local_world` ranks has a card of
    its own, else ``gloo`` (ranks sharing a card, or the CPU)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= n_cards else "gloo"


def rank_device(dev: torch.device) -> torch.device:
    """The device of this process: ``cuda:{LOCAL_RANK % cards}`` for a
    CUDA --device without an index under torchrun, else `dev`."""
    if (dev.type == "cuda" and dev.index is None
            and "LOCAL_RANK" in os.environ and torch.cuda.is_available()):
        n = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % n)
    return dev


def maybe_initialize_distributed(device: torch.device) -> int:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) with the backend of the layout; returns the world size.
    Without that environment, or when a group is already up, nothing is
    done."""
    if active():
        return world_size()
    env = os.environ
    if not ("RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env):
        return 1
    world = int(env["WORLD_SIZE"])
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    name = choose_backend(device, local_world, cards)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if name == "nccl":
            kw["device_id"] = device
    dist.init_process_group(name, init_method="env://",
                            rank=int(env["RANK"]), world_size=world, **kw)
    return world


def describe(device: torch.device) -> str:
    """The group for rank 0's log: its size, backend and layout."""
    if not active():
        return f"process group: none, one rank on {device}"
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return (f"process group: {world_size()} ranks, backend "
            f"{dist.get_backend()} ({local} ranks on this host, {cards} "
            f"cards), rank 0 on {device}")


def join_group(device: torch.device, mesh_data: int, batch_size: int,
               grad_accum: int = 1):
    """--parallel: join torchrun's group and check --mesh-data, the batch
    and --grad-accum against its size. Returns (world size, whether this
    call started the group: the caller then ends it with `shutdown`)."""
    started = not active()
    world = maybe_initialize_distributed(device)
    check_mesh_data(mesh_data, world)
    check_divisible(batch_size, world, grad_accum=grad_accum)
    return world, started and active()


def shutdown() -> None:
    if active():
        dist.barrier()
        dist.destroy_process_group()


def check_mesh_data(mesh_data: int, world: int) -> None:
    """--mesh-data N > 0 names the data-parallel degree: it must be the
    world size (0 takes every rank)."""
    if mesh_data > 0 and mesh_data != world:
        raise ValueError(f"--mesh-data {mesh_data} must equal the number "
                         f"of ranks ({world}): each rank is one device "
                         f"on the data axis")


def check_divisible(batch_size: int, n: int, grad_accum: int = 1) -> None:
    """The JAX package's check, with `n` ranks on the data axis."""
    if batch_size % n != 0:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the number of "
            f"devices on the data axis ({n}) — same constraint as the "
            f"reference's DataParallel (README.md:73)")
    if grad_accum > 1 and (batch_size // n) % grad_accum != 0:
        raise ValueError(
            f"--grad-accum {grad_accum} must divide the per-device "
            f"batch {batch_size}//{n}={batch_size // n} when training "
            f"on a mesh")


# ---------------------------------------------------------------------------
# collectives (no-ops at world size 1)
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it."""
    if world_size() == 1:
        return t
    dist.all_reduce(t)
    return t


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """This rank's 1/N slice of the sum of `t` over the ranks (`t`'s
    length a multiple of N)."""
    n = world_size()
    if n == 1:
        return t
    out = torch.empty(t.numel() // n, dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous())
    return out


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' `t` (1-D, equal lengths) concatenated in rank order."""
    n = world_size()
    if n == 1:
        return t
    out = torch.empty(t.numel() * n, dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous())
    return out


def gather_objects(obj) -> List:
    """Every rank's `obj`, in rank order (on every rank)."""
    if world_size() == 1:
        return [obj]
    out: List[Optional[object]] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
