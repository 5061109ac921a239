"""Port parity: the weight bridge and the encoder.

A JAX checkpoint (init_transformer → save_checkpoint) read by the port's
loader gives identical arrays, bfloat16 leaves included; a checkpoint
written by the port loads in the JAX package; and the same params give
the same `encode` output (front end + encoder) at f32.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from end2end_asr_tpu.models.transformer import dims_from_config, encode
from end2end_asr_tpu.training.checkpoint import (flatten_tree,
                                                 load_checkpoint,
                                                 save_checkpoint)
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.training import checkpoint as TC

from port_parity import jax_params, small_config, to_port, torch_config

VOCAB = 12
# f32 end to end through convs, 2 encoder layers and LayerNorms: sums in
# another order, ~1e-6 relative per op
ENC_TOL = 2e-4


def _vocab():
    id2label = {i: chr(ord("a") + i) for i in range(VOCAB)}
    return {v: k for k, v in id2label.items()}, id2label


@pytest.mark.parametrize("rank", [0, 8])
def test_jax_checkpoint_loads_identically(tmp_path, rank):
    cfg = small_config(rank=rank)
    params = jax_params(cfg, VOCAB)
    # one bfloat16 leaf: stored as uint16 bit patterns + bf16_keys
    params["decoder"]["embedding"] = params["decoder"]["embedding"].astype(
        jnp.bfloat16)
    label2id, id2label = _vocab()
    base = str(tmp_path / "ck")
    save_checkpoint(base, cfg, 3, params, None, {}, label2id, id2label)

    (tcfg, epoch, tparams, _, _, t_l2i, t_i2l, _) = TC.load_checkpoint(base)
    assert epoch == 3 and t_l2i == label2id and t_i2l == id2label
    assert tcfg.to_dict() == torch_config(cfg).to_dict()
    want = flatten_tree(params)
    got = TC.flatten_params(tparams)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        t = got[k]
        if v.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                t.to(torch.float32).numpy(), np.asarray(v, np.float32))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(v), k)

    # and back: the port's writer → the JAX loader
    base2 = str(tmp_path / "ck2")
    TC.save_checkpoint(base2, tcfg, 3, tparams, t_l2i, t_i2l)
    back = load_checkpoint(base2)[2]
    for k, v in flatten_tree(back).items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("rank", [0, 8])
def test_encode_matches_jax_f32(rank):
    cfg = small_config(rank=rank)
    params = jax_params(cfg, VOCAB, seed=1)
    rng = np.random.RandomState(0)
    B, F, T = 2, cfg.n_freq, 37  # odd T: the VALID pools crop
    spect = rng.randn(B, F, T).astype(np.float32)
    lengths = np.array([T, 30], np.int32)
    dims = dims_from_config(cfg)
    jax_enc = jax.jit(functools.partial(
        lambda p, s, l, d: encode(p, {}, s, l, d)[0], d=dims))
    want = np.asarray(jax_enc(params, jnp.asarray(spect),
                              jnp.asarray(lengths)))

    tcfg = torch_config(cfg)
    got, lens = TT.encode(to_port(params), torch.from_numpy(spect),
                          torch.from_numpy(lengths.astype(np.int64)),
                          TT.dims_from_config(tcfg))
    assert got.shape == want.shape == (B, T // 4, cfg.dim_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=ENC_TOL,
                               atol=ENC_TOL)
    np.testing.assert_array_equal(lens.numpy(), lengths)


def test_init_params_match_jax_structure():
    """The port's seeded random init builds the JAX pytree's keys and
    shapes (so its checkpoints load in the JAX package)."""
    cfg = small_config()
    want = {k: v.shape for k, v in flatten_tree(
        jax_params(cfg, VOCAB)).items()}
    got = {k: tuple(v.shape) for k, v in TC.flatten_params(TT.init_params(
        torch_config(cfg), VOCAB, torch.Generator().manual_seed(0))).items()}
    assert got == want
