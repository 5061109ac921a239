"""Port parity: the streaming probe (end2end_asr_tpu_torch.tools.
probe_stream) against the JAX package's tools/probe_stream.py.

`x + 1` and one Adam step (`_adam_math`) on numpy inputs from a seed go
through the JAX probe's XLA arms and the port's plain versions (the CPU
side of the kernels' wrappers); the probe's own exactness limit, 1e-6, is
the tolerance. The CUDA kernels are held against the plain versions on
the card by chip_smoke.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu_torch.tools import probe_stream as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6   # the probe's own exactness check (tools/probe_stream.py:130)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_stream", os.path.join(REPO, "tools", "probe_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(seed, shape=(96, 128)):
    rng = np.random.RandomState(seed)
    p, m, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    return p, m, np.abs(v), g


def test_constants_match(jax_probe):
    assert (TP.N_ROWS, TP.N_COLS) == (jax_probe.N_ROWS, jax_probe.N_COLS)
    assert (TP.LR, TP.B1, TP.B2, TP.EPS) == (jax_probe.LR, jax_probe.B1,
                                             jax_probe.B2, jax_probe.EPS)


def test_copy_matches_xla_copy(jax_probe):
    p = _arrays(0)[0]
    want = np.asarray(jax_probe.xla_copy(jnp.asarray(p)))
    got = TP.stream_copy(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TP.copy_plain(torch.from_numpy(p)).numpy(),
                                  want)


@pytest.mark.parametrize("t", [1.0, 3.0, 100.0])
def test_adam_matches_xla_adam(jax_probe, t):
    p, m, v, g = _arrays(1)
    want = jax_probe.xla_adam(*(jnp.asarray(a) for a in (p, m, v, g)), t)
    got = TP.adam_plain(*(torch.from_numpy(a) for a in (p, m, v, g)), t)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


def test_stream_adam_updates_in_place():
    p, m, v, g = (torch.from_numpy(a.copy()) for a in _arrays(2))
    want = TP.adam_plain(p.clone(), m.clone(), v.clone(), g, 3.0)
    out = TP.stream_adam(p, m, v, g, 3.0)
    for a, o, b in zip((p, m, v), out, want):
        assert o is a                                   # the same storage
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_probe_runs_on_the_cpu_and_refuses_a_missing_card(monkeypatch,
                                                          capsys):
    arms = TP.run(torch.device("cpu"), rows=8, iters=1)
    assert [a["name"] for a in arms] == ["torch_copy", "cuda_copy",
                                         "torch_adam", "cuda_adam"]
    assert all(np.isfinite(a["ms"]) and a["ms"] > 0 for a in arms)
    assert "adam exactness" in capsys.readouterr().out
    assert TP.copy_launches() == 0 and TP.adam_launches() == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.main([])


def _copy_writes(n, threads, vec):
    """(writes per float4 of the body, writes per float of the tail) as
    stream_copy_kernel's threads make them (csrc/stream.cu): the grid is
    one block a tile of threads·vec float4s (at least one block); thread t
    of block b takes float4s b·threads·vec + u·threads + t (u < vec) below
    n // 4, and thread t of block 0 the float 4·(n // 4) + t of the last
    n % 4."""
    n4, tile = n // 4, threads * vec
    grid = max(1, -(-n4 // tile))
    i = (tile * torch.arange(grid).view(grid, 1, 1)
         + threads * torch.arange(vec).view(1, vec, 1)
         + torch.arange(threads).view(1, 1, threads)).reshape(-1)
    body = torch.bincount(i[i < n4], minlength=n4)
    t = torch.arange(threads)
    tail = torch.bincount(t[t < n - 4 * n4], minlength=n - 4 * n4)
    return body, tail


@pytest.mark.parametrize("n", [4, 1023, 4096 * 33 + 5, 38400 * 1024])
def test_copy_threads_write_every_float_once(n):
    """The kept design's tiles (a block's COPY_VEC float4s a thread, each
    warp on 512 contiguous bytes a load) and its scalar tail write every
    float once, at the source's block size and depth and at others."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_lib
    k = probe_lib.constexprs(os.path.join(cuda_lib.CSRC_DIR, "stream.cu"))
    for threads, vec in {(k["COPY_THREADS"], k["COPY_VEC"]), (128, 2),
                         (512, 8)}:
        body, tail = _copy_writes(n, threads, vec)
        assert bool((body == 1).all()) and bool((tail == 1).all()), (
            threads, vec)


def test_copy_probe_variants_apply_to_the_source():
    """--copy-arms --variants times copies of csrc/stream.cu with one knob
    of stream_copy turned: each edit must still find its text once and
    give a source of its own that keeps the stream_copy entry; the timing
    refuses the CPU."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    with open(os.path.join(cuda_lib.CSRC_DIR, "stream.cu")) as f:
        src = f.read()
    copies = TP.variant_sources(list(TP.COPY_VARIANTS))
    assert src not in copies.values()
    assert len(set(copies.values())) == len(TP.COPY_VARIANTS)
    assert all('extern "C" int stream_copy(' in c for c in copies.values())
    with pytest.raises(RuntimeError, match="the card only"):
        TP.main(["--device", "cpu", "--copy-arms"])


def test_profiled_windows_leave_their_lead_kernels_out():
    """probe_lib.profiled opens each window with two kernels of its own (a
    window can lose its first launch); device_events gives the rest in
    launch order, the probes' and the card tests' kernel names and times
    read it; a window with no lead kernel left is one the profiler lost."""
    from types import SimpleNamespace as NS
    from end2end_asr_tpu_torch.tools import probe_lib
    cuda = torch.autograd.DeviceType.CUDA
    ev = lambda name, t, dev=cuda: NS(name=name, device_type=dev,
                                      time_range=NS(start=t))
    prof = NS(events=lambda: [
        ev("void b_kernel()", 3.0), ev("at::cuda::spin_kernel(long)", 1.0),
        ev("void a_kernel()", 2.0), ev("aten::add", 2.5,
                                       torch.autograd.DeviceType.CPU)])
    assert [e.name for e in probe_lib.device_events(torch, prof)] == [
        "void a_kernel()", "void b_kernel()"]
    assert probe_lib.window_kept(torch, prof)
    assert not probe_lib.window_kept(torch, NS(events=lambda: [
        ev("void a_kernel()", 2.0)]))
