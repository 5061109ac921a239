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
all_gather_into_tensor, all_gather_object, broadcast) on CUDA tensors
directly on the card's PyTorch, so none is staged through the host.

With ``--mesh-model T`` and / or ``--mesh-pipe S`` (`set_layout`) the
ranks form a ``data`` x ``pipe`` x ``model`` grid with ``model``
innermost, as ``make_mesh_2d`` and pipeline parallelism's
``make_mesh_pipe`` lay the devices out: rank = (d·S + s)·T + m. The
ranks of one (d, s) are a model group, which parallel/tp.py's
collectives run over; those of one (s, m) a data group, which the
data-parallel collectives below run over; those of one (d, m) a pipe
group, the stages of one pipeline (parallel/pp.py). Without a layout
the data group is the whole world.

The pipeline's hand-offs between neighbouring stages (`TRANSPORT`) are
chosen once, like the backend: ``send`` / ``recv`` of the tensor where
the backend carries the tensor's device (NCCL; gloo on the CPU), and
over gloo on a card a copy through pinned host memory and ``send`` /
``recv`` of that. gloo's point-to-point takes a device tensor's pointer
for host memory and fails ("writev: Bad address"); a broadcast over a
group of the two ranks and the host copy both run, at 2.09 and 2.10 ms
for the encoder's 2.46 MB microbatch and 1.02 and 0.80 ms for the
decoder's 0.29 MB (tools/probe_pipe_transport.py on an NVIDIA H100 80GB
HBM3 at 700 W), and the host copy needs no group for each pair of
stages.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist


class Layout:
    """The data x pipe x model grid of the ranks and this rank's groups."""

    def __init__(self, n_data: int, n_model: int, n_pipe: int = 1):
        self.n_data, self.n_pipe, self.n_model = n_data, n_pipe, n_model
        at = lambda d, s, m: (d * n_pipe + s) * n_model + m
        self.data_rank, rest = divmod(dist.get_rank(), n_pipe * n_model)
        self.pipe_rank, self.model_rank = divmod(rest, n_model)
        d0, s0, m0 = self.data_rank, self.pipe_rank, self.model_rank
        # the global ranks of this rank's pipeline, stage by stage
        self.pipe_ranks = [at(d0, s, m0) for s in range(n_pipe)]
        # every rank creates every group of more than one rank, in the
        # same order (an axis of one rank has no collective to run)
        self.model_group = self.data_group = self.pipe_group = None
        if n_model > 1:
            for d in range(n_data):
                for s in range(n_pipe):
                    g = dist.new_group([at(d, s, m) for m in range(n_model)])
                    if (d, s) == (d0, s0):
                        self.model_group = g
        if n_data > 1:
            for s in range(n_pipe):
                for m in range(n_model):
                    g = dist.new_group([at(d, s, m) for d in range(n_data)])
                    if (s, m) == (s0, m0):
                        self.data_group = g
        if n_pipe > 1:
            for d in range(n_data):
                for m in range(n_model):
                    g = dist.new_group([at(d, s, m) for s in range(n_pipe)])
                    if (d, m) == (d0, m0):
                        self.pipe_group = g


_LAYOUT: Optional[Layout] = None
_LAYOUTS = {}        # (n_data, n_model, n_pipe) -> Layout: groups kept
TRANSPORT: Optional[str] = None    # the pipeline's hand-off (`set_layout`)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_layout(n_model: int, n_data: int, world: int, n_pipe: int = 1):
    """(n_data, n_model, n_pipe) of the grid: the checks of `make_mesh_2d`
    (n_pipe 1) or of `make_mesh_pipe`, with the ranks for devices.
    n_data 0 takes every rank."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_pipe < 1:
        raise ValueError(f"n_pipe must be >= 1, got {n_pipe}")
    per_data = n_pipe * n_model
    if n_data and n_data > 0:
        need = n_data * per_data
        if world < need:
            grid = (f"{n_data}x{n_pipe}x{n_model}" if n_pipe > 1
                    else f"{n_data}x{n_model}")
            raise ValueError(f"mesh {grid} needs {need} devices, have "
                             f"{world}")
        if world != need:
            what = (f"--mesh-pipe {n_pipe} x " if n_pipe > 1 else "") + \
                f"--mesh-model {n_model}"
            raise ValueError(f"--mesh-data {n_data} x {what} must equal "
                             f"the number of ranks ({world}): each rank is "
                             f"one device")
        return n_data, n_model, n_pipe
    n_data = world // per_data
    if n_pipe > 1:
        if n_data < 1:
            raise ValueError(f"--mesh-pipe {n_pipe} x --mesh-model "
                             f"{n_model} exceeds the {world} visible devices")
        if n_data * per_data != world:
            raise ValueError(
                f"--mesh-pipe {n_pipe} x --mesh-model {n_model} does not "
                f"divide the {world} visible devices — pass --mesh-data to "
                f"use a subset explicitly")
        return n_data, n_model, n_pipe
    if n_data < 1:
        raise ValueError(f"--mesh-model {n_model} exceeds the {world} "
                         f"visible devices")
    if n_data * n_model != world:
        raise ValueError(
            f"--mesh-model {n_model} does not divide the {world} visible "
            f"devices — pass --mesh-data to use a subset explicitly "
            f"instead of silently dropping chips")
    return n_data, n_model, n_pipe


def choose_transport(backend: str, device: torch.device) -> str:
    """The pipeline's hand-off: ``p2p`` (send / recv of the tensor) where
    the backend carries the tensor's device, ``host`` (through pinned
    host memory) for gloo on a card."""
    return "host" if backend == "gloo" and device.type == "cuda" else "p2p"


def set_layout(n_model: int, n_data: int = 0, n_pipe: int = 1,
               device: Optional[torch.device] = None) -> None:
    """Lay the group's ranks out as data x pipe x model (`make_layout`);
    n_model 1 and n_pipe 1 return to plain data parallelism over every
    rank. `device` (this rank's) picks the pipeline's hand-off. Collective:
    the first call for a grid creates its groups on every rank."""
    global _LAYOUT, TRANSPORT
    n_data, n_model, n_pipe = make_layout(n_model, n_data, world_size(),
                                          n_pipe)
    if n_model == 1 and n_pipe == 1:
        _LAYOUT = None
        return
    key = (n_data, n_model, n_pipe)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = Layout(n_data, n_model, n_pipe)
    _LAYOUT = _LAYOUTS[key]
    TRANSPORT = choose_transport(dist.get_backend(),
                                 device or torch.device("cpu"))


def data_size() -> int:
    """Ranks on the data axis (the world without a layout)."""
    return _LAYOUT.n_data if _LAYOUT else world_size()


def data_rank() -> int:
    return _LAYOUT.data_rank if _LAYOUT else rank()


def model_size() -> int:
    return _LAYOUT.n_model if _LAYOUT else 1


def model_rank() -> int:
    return _LAYOUT.model_rank if _LAYOUT else 0


def pipe_size() -> int:
    """Stages on the pipe axis (1 without pipeline parallelism)."""
    return _LAYOUT.n_pipe if _LAYOUT else 1


def pipe_rank() -> int:
    return _LAYOUT.pipe_rank if _LAYOUT else 0


def pipe_group():
    return _LAYOUT.pipe_group if _LAYOUT else None


def stage_rank(s: int) -> int:
    """The global rank of stage `s` of this rank's pipeline."""
    return _LAYOUT.pipe_ranks[s]


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
    grid = ""
    if _LAYOUT and pipe_size() > 1:
        grid = (f", data x pipe x model mesh {data_size()}x{pipe_size()}x"
                f"{model_size()}, pipeline hand-off {TRANSPORT}")
    elif _LAYOUT:
        grid = f", data x model mesh {data_size()}x{model_size()}"
    return (f"process group: {world_size()} ranks, backend "
            f"{dist.get_backend()} ({local} ranks on this host, {cards} "
            f"cards), rank 0 on {device}{grid}")


def join_group(device: torch.device, mesh_data: int, batch_size: int,
               grad_accum: int = 1, mesh_model: int = 1, mesh_pipe: int = 1):
    """--parallel: join torchrun's group, lay it out as data x pipe x
    model (--mesh-pipe, --mesh-model; `set_layout`) and check
    --mesh-data, the batch and --grad-accum against the data axis.
    Returns (ranks on the data axis, whether this call started the group:
    the caller then ends it with `shutdown`)."""
    started = not active()
    world = maybe_initialize_distributed(device)
    if mesh_model > 1 or mesh_pipe > 1:
        set_layout(mesh_model, mesh_data, mesh_pipe, device)
    else:
        check_mesh_data(mesh_data, world)
        set_layout(1)
    check_divisible(batch_size, data_size(), grad_accum=grad_accum)
    return data_size(), started and active()


def shutdown() -> None:
    global _LAYOUT, TRANSPORT
    if active():
        dist.barrier()
        _LAYOUT = TRANSPORT = None
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
