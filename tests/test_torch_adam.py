"""The train step's update (training/optimizer.adam_noam_step) on the
CPU: the plain chain of adam_noam_update followed by the step's
`torch.where` picks, bit for bit, and the refusals of the kernel's
wrapper (ops/adam.adam_step). The kernel itself is held to the same chain
on the card (tests/test_torch_gpu.py)."""

import pytest
import torch

from end2end_asr_tpu_torch.ops import adam as A
from end2end_asr_tpu_torch.training import optimizer as TO

NOAM = TO.NoamConfig(model_size=640, factor=1.0, warmup=25, min_lr=1e-6)
N = 1001        # not a multiple of 4
MAX_NORM = 0.5  # below the gradients' norm: the clip binds


def inputs(mdt, seed: int, offset: int = 0):
    """p, g (f32) and a state of step 6 with moments in `mdt`, each a
    slice of a larger buffer starting `offset` elements in (another
    offset for each), and inv."""
    gen = torch.Generator().manual_seed(seed)

    def sliced(x, k):
        o = (offset + k) % 4 if offset else 0
        buf = torch.zeros(N + 4, dtype=x.dtype)
        buf[o:o + N] = x
        return buf[o:o + N]
    p = sliced(torch.randn(N, generator=gen), 0)
    g = sliced(torch.randn(N, generator=gen) * 30.0, 1)
    m = sliced(torch.randn(N, generator=gen).mul(0.1).to(mdt), 2)
    v = sliced(torch.rand(N, generator=gen).mul(1e-2).to(mdt), 3)
    state = {"step": torch.tensor(6, dtype=torch.int32), "mu": m, "nu": v}
    return p, g, state, torch.tensor(1.0) / torch.tensor(7.0)


def plain_step(p, g, inv, finite, state, clip):
    """The step's update before the kernel: adam_noam_update on g * inv,
    then the picks."""
    upd, new, lr = TO.adam_noam_update(p, g * inv, state, NOAM, clip=clip,
                                       max_norm=MAX_NORM)
    pick = lambda a, b: torch.where(finite, a, b)
    return pick(upd, p), TO.tree_map(pick, new, state), lr


def same(a, b) -> bool:
    """Equal dtypes and equal bits."""
    bits = lambda x: x.reshape(-1).view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_update_equals_the_plain_chain_and_picks(mdt, clip, finite, offset):
    p, g, state, inv = inputs(mdt, int(clip) + 2 * int(finite), offset)
    fin = torch.tensor(finite)
    want = plain_step(p, g, inv, fin, state, clip)
    got = TO.adam_noam_step(p, g, inv, fin, state, NOAM, clip=clip,
                            max_norm=MAX_NORM)
    assert same(got[0], want[0])
    for k in ("step", "mu", "nu"):
        assert same(got[1][k], want[1][k]), k
    assert same(got[2], want[2])
    # the update moved the parameters, or returned them unchanged
    assert torch.equal(got[0], p) != finite
    assert int(got[1]["step"]) == (7 if finite else 6)
    if clip:    # the clip bound: its scale is below 1
        scale, _ = TO.clip_scale(g * inv, MAX_NORM)
        assert float(scale) < 1.0


def bad_calls():
    """(what is wrong, kwargs of adam_step, what the refusal says) for
    each refusal; the last: every input right, on the CPU."""
    p, g, state, inv = inputs(torch.float32, seed=0)
    m, v = state["mu"], state["nu"]
    s = torch.tensor(0.5)
    ok = dict(p=p, g=g, m=m, v=v, lr=s, bc1=s, bc2=s, inv=inv,
              finite=torch.tensor(True))
    meta = lambda x: x.to("meta")
    shifted = lambda x: torch.cat([x[:1], x])[1:]   # 4 bytes past a start
    shape, dtype, one = "parameters' shape", "must (both )?be", "must be one"
    return [
        ("gradient shape", dict(ok, g=g[:-1]), shape),
        ("moment shape", dict(ok, v=v[:-1]), shape),
        ("gradient dtype", dict(ok, g=g.double()), dtype),
        ("parameters dtype", dict(ok, p=p.to(torch.bfloat16)), dtype),
        ("moment dtypes differ", dict(ok, v=v.to(torch.bfloat16)), dtype),
        ("moment dtype", dict(ok, m=m.half(), v=v.half()), dtype),
        ("not contiguous", dict(ok, p=torch.stack([p, p], 1)[:, 0]), shape),
        ("moment device", dict(ok, m=meta(m)), "is on meta"),
        ("gradient device", dict(ok, g=meta(g)), "is on meta"),
        ("parameters at an offset", dict(ok, p=shifted(p)), "16-byte"),
        ("moment at an offset", dict(ok, v=shifted(v)), "16-byte"),
        ("lr device", dict(ok, lr=meta(s)), one),
        ("lr dtype", dict(ok, lr=s.double()), one),
        ("bc2 not one value", dict(ok, bc2=torch.ones(2)), one),
        ("clip dtype", dict(ok, clip=torch.tensor(1)), one),
        ("finite dtype", dict(ok, finite=torch.tensor(1.0)), one),
        ("finite device", dict(ok, finite=meta(torch.tensor(True))), one),
        ("on the CPU", ok, "runs on a CUDA device"),
    ]


@pytest.mark.parametrize("case", range(len(bad_calls())),
                         ids=[what for what, _, _ in bad_calls()])
def test_adam_step_refuses_mismatched_inputs(case):
    _, kw, says = bad_calls()[case]
    p, g, m, v = (kw.pop(k) for k in ("p", "g", "m", "v"))
    with pytest.raises(ValueError, match="adam_step: .*" + says):
        A.adam_step(p, g, m, v, beta1=0.9, beta2=0.98, eps=1e-9, **kw)
