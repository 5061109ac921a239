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
