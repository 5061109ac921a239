"""Port parity: SpecAugment (end2end_asr_tpu_torch.ops.specaugment).

The JAX function draws its bands inside one jitted call, so the test
replays the same `jax.random` calls on the same key, feeds the draws to
the port's pure `time_band` + `mask`, and asks for the exact output of
`apply_spec_augment`. The port's own draw (a torch.Generator) is held to
the band laws: widths in [0, width], frequency starts below
max(F - freq_width, 1), time bands inside the valid frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.ops.specaugment import apply_spec_augment
from end2end_asr_tpu_torch.ops import specaugment as TS


def _replay_jax_draws(key, B, F, nf, fw, nt, tw):
    """The draws of apply_spec_augment (specaugment.py:31-50), in order."""
    keys = jax.random.split(key, 2 * (nf + nt))
    ki, out = 0, {"f_width": [], "f_start": [], "raw": [], "u": []}
    for _ in range(nf):
        out["f_width"].append(jax.random.randint(keys[ki], (B, 1), 0, fw + 1))
        out["f_start"].append(jax.random.randint(keys[ki + 1], (B, 1), 0,
                                                 max(F - fw, 1)))
        ki += 2
    for _ in range(nt):
        out["raw"].append(jax.random.randint(keys[ki], (B, 1), 0, tw + 1))
        out["u"].append(jax.random.uniform(keys[ki + 1], (B, 1)))
        ki += 2
    return {k: torch.from_numpy(np.concatenate([np.asarray(a) for a in v],
                                               axis=1))
            for k, v in out.items()}


@pytest.mark.parametrize("seed,nf,fw,nt,tw", [(0, 2, 27, 2, 100),
                                              (1, 1, 5, 3, 10),
                                              (2, 2, 200, 1, 7)])
def test_mask_is_exact_on_the_jax_draws(seed, nf, fw, nt, tw):
    B, F, T = 5, 40, 64
    rng = np.random.RandomState(seed)
    spect = rng.randn(B, F, T).astype(np.float32)
    n_frames = np.array([64, 50, 9, 1, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(apply_spec_augment(
        key, jnp.asarray(spect), jnp.asarray(n_frames), n_freq_masks=nf,
        freq_width=fw, n_time_masks=nt, time_width=tw))
    d = _replay_jax_draws(key, B, F, nf, fw, nt, tw)
    nfr = torch.from_numpy(n_frames.astype(np.int64))
    t_start, t_width = TS.time_band(d["u"], d["raw"].to(torch.int64), nfr)
    got = TS.mask(torch.from_numpy(spect), nfr, d["f_start"].to(torch.int64),
                  d["f_width"].to(torch.int64), t_start, t_width)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_own_draw_obeys_the_band_laws():
    B, F, T = 64, 161, 800
    gen = torch.Generator().manual_seed(3)
    n_frames = torch.from_numpy(np.random.RandomState(0).randint(
        1, T + 1, size=B).astype(np.int64))
    widths_f, widths_t = [], []
    for _ in range(20):
        f_start, f_width, t_start, t_width = TS.draw(gen, B, F, n_frames)
        assert f_start.shape == f_width.shape == (B, 2)
        assert t_start.shape == t_width.shape == (B, 2)
        assert (f_width >= 0).all() and (f_width <= 27).all()
        assert (f_start >= 0).all() and (f_start < F - 27).all()
        assert (t_width >= 0).all()
        assert (t_width <= torch.clamp(n_frames, max=100)[:, None]).all()
        assert (t_start >= 0).all()
        assert (t_start + t_width <= n_frames[:, None]).all()
        widths_f.append(f_width)
        widths_t.append(t_width)
    wf = torch.cat(widths_f).float()
    assert {int(wf.min()), int(wf.max())} == {0, 27}
    assert abs(wf.mean().item() - 13.5) < 1.0      # uniform on [0, 27]
    assert torch.cat(widths_t).max() == 100


def test_apply_masks_only_bands_and_leaves_the_generator_apart():
    B, F, T = 4, 32, 48
    spect = torch.from_numpy(np.random.RandomState(1).randn(B, F, T).astype(
        np.float32)) + 10.0
    n_frames = torch.tensor([48, 30, 20, 10])
    gen = torch.Generator().manual_seed(7)
    other = torch.Generator().manual_seed(8)
    before = other.get_state().clone()
    out = TS.apply_spec_augment(gen, spect, n_frames, freq_width=8,
                                time_width=12)
    kept = out != 0
    assert torch.equal(out[kept], spect[kept]) and (~kept).any()
    # masked cells form whole rows (frequency bands) or whole columns
    masked = ~kept
    rows = masked.all(dim=2, keepdim=True)
    cols = masked.all(dim=1, keepdim=True)
    assert torch.equal(masked, rows | cols)
    assert torch.equal(other.get_state(), before)
    again = TS.apply_spec_augment(torch.Generator().manual_seed(7), spect,
                                  n_frames, freq_width=8, time_width=12)
    assert torch.equal(out, again)
