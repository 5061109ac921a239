"""Data parallelism: one process a rank, ``torch.distributed`` between them
(the JAX package's ``parallel/mesh.py``), and the ``data`` x ``model``
layout of tensor parallelism (its ``parallel/tp.py`` `make_mesh_2d`).

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

With ``--mesh-model M`` (`set_layout`) the ranks form a ``data`` x
``model`` grid with ``model`` innermost, as ``make_mesh_2d`` lays the
devices out: rank = d·M + m. Each data row d (M ranks) is one model
group, which parallel/tp.py's collectives run over; each model column m
(the ranks of one model coordinate) is one data group, which the
data-parallel collectives below run over. Without a layout the data
group is the whole world.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist


class Layout:
    """The data x model grid of the ranks and this rank's groups."""

    def __init__(self, n_data: int, n_model: int):
        self.n_data, self.n_model = n_data, n_model
        r = dist.get_rank()
        self.data_rank, self.model_rank = divmod(r, n_model)
        # every rank creates every group, in the same order
        self.model_group = self.data_group = None
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == self.data_rank:
                self.model_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == self.model_rank:
                self.data_group = g


_LAYOUT: Optional[Layout] = None
_LAYOUTS = {}        # (n_data, n_model) -> Layout: the groups are kept


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_layout(n_model: int, n_data: int, world: int):
    """(n_data, n_model) of the grid: `make_mesh_2d`'s checks, with the
    ranks for devices. n_data 0 takes every rank."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data and n_data > 0:
        need = n_data * n_model
        if world < need:
            raise ValueError(f"mesh {n_data}x{n_model} needs {need} "
                             f"devices, have {world}")
        if world != need:
            raise ValueError(f"--mesh-data {n_data} x --mesh-model "
                             f"{n_model} must equal the number of ranks "
                             f"({world}): each rank is one device")
        return n_data, n_model
    n_data = world // n_model
    if n_data < 1:
        raise ValueError(f"--mesh-model {n_model} exceeds the {world} "
                         f"visible devices")
    if n_data * n_model != world:
        raise ValueError(
            f"--mesh-model {n_model} does not divide the {world} visible "
            f"devices — pass --mesh-data to use a subset explicitly "
            f"instead of silently dropping chips")
    return n_data, n_model


def set_layout(n_model: int, n_data: int = 0) -> None:
    """Lay the group's ranks out as data x model (`make_layout`); n_model
    1 returns to plain data parallelism over every rank. Collective: the
    first call for a grid creates its groups on every rank."""
    global _LAYOUT
    n_data, n_model = make_layout(n_model, n_data, world_size())
    if n_model == 1:
        _LAYOUT = None
        return
    if (n_data, n_model) not in _LAYOUTS:
        _LAYOUTS[n_data, n_model] = Layout(n_data, n_model)
    _LAYOUT = _LAYOUTS[n_data, n_model]


def data_size() -> int:
    """Ranks on the data axis (the world without a layout)."""
    return _LAYOUT.n_data if _LAYOUT else world_size()


def data_rank() -> int:
    return _LAYOUT.data_rank if _LAYOUT else rank()


def model_size() -> int:
    return _LAYOUT.n_model if _LAYOUT else 1


def model_rank() -> int:
    return _LAYOUT.model_rank if _LAYOUT else 0


def data_group():
    return _LAYOUT.data_group if _LAYOUT else None


def model_group():
    return _LAYOUT.model_group if _LAYOUT else None


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
    grid = (f", data x model mesh {data_size()}x{model_size()}"
            if _LAYOUT else "")
    return (f"process group: {world_size()} ranks, backend "
            f"{dist.get_backend()} ({local} ranks on this host, {cards} "
            f"cards), rank 0 on {device}{grid}")


def join_group(device: torch.device, mesh_data: int, batch_size: int,
               grad_accum: int = 1, mesh_model: int = 1):
    """--parallel: join torchrun's group, lay it out as data x model
    (--mesh-model; `set_layout`) and check --mesh-data, the batch and
    --grad-accum against the data axis. Returns (ranks on the data
    axis, whether this call started the group: the caller then ends it
    with `shutdown`)."""
    started = not active()
    world = maybe_initialize_distributed(device)
    if mesh_model > 1:
        set_layout(mesh_model, mesh_data)
    else:
        check_mesh_data(mesh_data, world)
        set_layout(1)
    check_divisible(batch_size, data_size(), grad_accum=grad_accum)
    return data_size(), started and active()


def shutdown() -> None:
    global _LAYOUT
    if active():
        dist.barrier()
        _LAYOUT = None
        _LAYOUTS.clear()
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
# collectives over the data axis (no-ops with one rank on it); the
# model axis's are parallel/tp.py's
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the data axis, in place; returns it."""
    if data_size() == 1:
        return t
    dist.all_reduce(t, group=data_group())
    return t


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """This rank's 1/N slice of the sum of `t` over the N ranks of the
    data axis (`t`'s length a multiple of N)."""
    n = data_size()
    if n == 1:
        return t
    out = torch.empty(t.numel() // n, dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=data_group())
    return out


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The data axis's `t` (1-D, equal lengths) concatenated in rank
    order."""
    n = data_size()
    if n == 1:
        return t
    out = torch.empty(t.numel() * n, dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=data_group())
    return out


def gather_objects(obj) -> List:
    """Every data rank's `obj`, in rank order (on every rank)."""
    if data_size() == 1:
        return [obj]
    out: List[Optional[object]] = [None] * data_size()
    dist.all_gather_object(out, obj, group=data_group())
    return out


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
