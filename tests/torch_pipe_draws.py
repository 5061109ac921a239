"""One pipelined step's random draws on a stage, shared by the CPU test
(tests/test_torch_dispatch.py) and the card's (tests/test_torch_gpu.py).
Imports no JAX."""

import torch


def pipe_step_draws(rng):
    """One step's draws as a pipelined forward makes them on a stage
    (parallel/pp.py `pipeline_apply`): a kernel seed of the step's own
    (a slot of `rng`), then for each stack, microbatch and stage layer its
    stream's kernel seeds (1 a layer in the encoder, 2 in the decoder) and
    5 uint16 bits of its plain dropout. Returns (the seeds' values, the
    bits), int64 tensors on `rng`'s device."""
    rng.begin_step()
    own = rng.kernel_seed()
    seeds, bits = [own.buf[own.slot:own.slot + 1]], []
    for stack, n in (("encoder", 1), ("decoder", 2)):
        for m in range(2):
            for layer in (2, 3):
                r = rng.pipe_stream(stack, layer, m)
                for _ in range(n):
                    s = r.kernel_seed()
                    seeds.append(s.buf[s.slot:s.slot + 1])
                bits.append(r.bits16((5,), rng.device).to(torch.int64))
    rng.end_step()
    return torch.cat(seeds), torch.cat(bits)
