"""tools/probe_step.py's tracing, on the CPU: the attention forward's
range and the autograd nodes of the port's attention and pool Functions
are found in a profile, once per call, and the pool's memory formats are
recorded; with the tracing on, the values are those without it. (On the
card the same report lists the kernels under each; chip_smoke.py holds
them to one kernel a call, with no copy.)
"""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from end2end_asr_tpu_torch.models import layers as TL
from end2end_asr_tpu_torch.ops import pool_vjp as PV
from end2end_asr_tpu_torch.tools import probe_step as PS


def _step_inputs():
    r = np.random.RandomState(3)
    B, T, H, D = 2, 6, 2, 8
    dm = H * D
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))
    p = {n: {"w": t(dm, dm) * 0.1, "b": torch.zeros(dm)}
         for n in ("q", "k", "v", "out")}
    p["ln"] = {"scale": torch.ones(dm), "bias": torch.zeros(dm)}
    x = t(B, T, dm)
    mask = torch.from_numpy(r.rand(B, T, T) < 0.3)
    y = t(2, 4, 6, 8).contiguous(memory_format=torch.channels_last)
    return p, x, mask, y, (H, D)


def _run(p, x, mask, y, hd):
    leaves = [x.clone().requires_grad_(), y.clone().requires_grad_()]
    out = TL.mha(p, leaves[0], leaves[0], leaves[0], *hd, hd[1], mask=mask,
                 dtype=torch.float32, dropout_rate=0.1,
                 rng=TL.DropoutRng(1, "cpu"))
    loss = out.sum() + PV.max_pool2(leaves[1]).sum()
    return (loss.detach(), *torch.autograd.grad(loss, leaves))


def test_trace_finds_each_attention_and_pool_call():
    args = _step_inputs()
    want = _run(*args)
    formats = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with PS.traced(formats):
            got = _run(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rep = PS.report(torch, prof, 1.0, formats)
    for key in ("attention_forward", "attention_backward", "pool_backward"):
        assert rep[key]["calls"] == 1, (key, rep[key])
        assert rep[key]["copy_kernels"] == 0
    assert rep["device_ms"] is None and rep["kernel_launches"] == 0
    # y channels-last, as conv4 gives it; g the expanded gradient of a sum
    assert formats == [{"y": "channels_last", "g": "strided",
                        "dy": "channels_last"}]
    assert PS.is_copy("void at::native::direct_copy_kernel_cuda(x)")
    assert not PS.is_copy("CatArrayBatchedCopy<float>")
