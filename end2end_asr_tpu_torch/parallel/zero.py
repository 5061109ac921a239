"""ZeRO-1 (--zero1) and FSDP (--fsdp) on the trainer's flat parameter
buffer (the JAX package's ``parallel/zero.py``).

The train step keeps the trainable parameters, their gradient and the
optimizer moments in flat f32 buffers of n elements
(``training/steps.FlatParams``). Over N ranks the buffer is padded with
zeros to a multiple of N and rank r owns the slice [r·s, (r+1)·s),
s = ceil(n / N):
  * --zero1: the moments (Adam's mu and nu, SGD's momentum) live as the
    slice only. The step reduce-scatters the token-weighted gradient,
    runs the elementwise update on its slice of the parameters and the
    moments, and all-gathers the parameters. The global norm for --clip
    is an all-reduce of the slices' squared sums.
  * --fsdp: as --zero1, and the parameters too live as the slice between
    steps: the step all-gathers them before the forward and drops the
    full copy after the backward.
The update is elementwise, so only the order of the gradient's sum over
the ranks changes against plain data parallelism.

The JAX package keeps the frontend's parameters replicated under FSDP
(``_FSDP_REPLICATED_SUBTREES``): its Pallas kernels' partitioning rules
take replicated weights. Here every kernel runs on the gathered full
buffer, so no kernel ever sees a shard and that rule has nothing to
protect: every element of the buffer shards, and `coverage()` is 1.
"""

from __future__ import annotations

from typing import Dict

import torch

from end2end_asr_tpu_torch.parallel import mesh

# the optimizer entries shaped like the parameters (the trainer's too)
MOMENT_KEYS = ("mu", "nu", "buf")


class ZeroShard:
    """Rank `rank`'s slice of a flat buffer of `n` elements over `world`
    ranks, at ZeRO stage 1 (--zero1) or 3 (--fsdp)."""

    def __init__(self, n: int, world: int, rank: int, stage: int):
        if stage not in (1, 3):
            raise ValueError(f"ZeRO stage must be 1 or 3, got {stage}")
        self.n, self.world, self.rank, self.stage = n, world, rank, stage
        self.per = -(-n // world)
        self.pad = self.per * world - n
        self.lo = rank * self.per

    @classmethod
    def for_config(cls, cfg, n: int) -> "ZeroShard":
        return cls(n, mesh.data_size(), mesh.data_rank(),
                   3 if cfg.fsdp else 1)

    def coverage(self) -> float:
        """Share of the moment elements that shard over the ranks."""
        return 1.0

    def describe(self) -> str:
        return (f"ZeRO-{self.stage} ON: {100 * self.coverage():.0f}% of "
                f"optimizer-moment elements shard over the {self.world}-way "
                f"'data' axis{' (+ params, FSDP)' if self.stage == 3 else ''}"
                f"; the flat buffer of {self.n} elements is padded by "
                f"{self.pad} to {self.n + self.pad}, {self.per} a rank")

    def padded(self, full: torch.Tensor) -> torch.Tensor:
        if not self.pad:
            return full
        return torch.cat([full, full.new_zeros(self.pad)])

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full buffer (a copy)."""
        return self.padded(full)[self.lo:self.lo + self.per].clone()

    def reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the ranks' summed buffer."""
        return mesh.reduce_scatter(self.padded(g))

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The full buffer from the ranks' slices."""
        return mesh.all_gather(part)[:self.n]

    def shard_opt(self, opt: Dict) -> Dict:
        return {k: (self.shard(v) if k in MOMENT_KEYS else v)
                for k, v in opt.items()}

    def gather_opt(self, opt: Dict) -> Dict:
        return {k: (self.gather(v) if k in MOMENT_KEYS else v)
                for k, v in opt.items()}
