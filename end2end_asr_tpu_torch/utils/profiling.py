"""``--trace-dir``: a torch.profiler trace of a block of the run (the JAX
package's ``utils/profiling.trace``, which takes a jax.profiler trace of
the first training epoch).

The trace is one ``<host>_<pid>.<ms>.pt.trace.json`` file in the given
directory, in the Chrome trace format that TensorBoard's profiler plugin
and chrome://tracing read: host operators, and on a card its kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: torch.device):
    """Profile the block into `log_dir` when it is set; a no-op
    otherwise. On a CUDA device the card's kernels are traced too, and
    the block's work is waited for before the trace is written."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
