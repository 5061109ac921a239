"""Port parity: the KV-cached decode step, greedy and beam decoding.

Same JAX-initialised weights (through the weight bridge) and the same
encoder output on both sides, at f32. Greedy ids must be EQUAL to the
JAX package's `greedy_decode_progressive`; beam n-best strings equal,
with scores within tolerance, to `BeamDecoder.decode_nbest`
(tests/test_decode_parity.py and tests/test_progressive_decode.py hold
the JAX side against the reference and against itself).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from end2end_asr_tpu.decoding.beam import BeamDecoder
from end2end_asr_tpu.decoding.greedy import greedy_decode_progressive
from end2end_asr_tpu.models import decoder as D
from end2end_asr_tpu.models.transformer import dims_from_config
from end2end_asr_tpu_torch.decoding import beam as TB
from end2end_asr_tpu_torch.decoding import greedy as TG
from end2end_asr_tpu_torch.models import decoder as TD
from end2end_asr_tpu_torch.models import transformer as TT

from port_parity import jax_params, small_config, to_port, torch_config

# f32 logits through 2 decoder layers: sums in another order
LOGIT_TOL = 1e-4
# cumulative log-probs over <= 12 steps of log_softmax over f32 logits
SCORE_TOL = 1e-4
# > 256 ids: the JAX beam gathers ids with one-hot products, which need
# full precision to keep ids above 2^8 exact (ROADMAP hazards); the
# port gathers by index
BIG_VOCAB = 600


def _setup(rank, vocab, seed, eos_boost=0.0):
    cfg = small_config(rank=rank, beam_width=4, tgt_max_len=13)
    params = jax_params(cfg, vocab, seed=seed, eos_boost=eos_boost)
    enc = np.random.RandomState(seed).randn(3, 9, cfg.dim_model).astype(
        np.float32)
    tcfg = torch_config(cfg)
    return (cfg, params, dims_from_config(cfg), enc, tcfg, to_port(params),
            TT.dims_from_config(tcfg))


@pytest.mark.parametrize("rank", [0, 8])
def test_decode_step_logits_match(rank):
    cfg, params, dims, enc, _, tparams, tdims = _setup(rank, 20, seed=0)
    dec, tdec = params["decoder"], tparams["decoder"]
    L = 5
    cache = D.init_cache(dec, jnp.asarray(enc), L, cfg.num_heads,
                         cfg.dim_key, cfg.dim_value, dtype=jnp.float32)
    tcache = TD.init_cache(tdec, torch.from_numpy(enc), L, cfg.num_heads,
                           cfg.dim_key, cfg.dim_value, dtype=torch.float32)
    tokens = np.random.RandomState(1).randint(0, 20, size=(L, 3))
    for t in range(L):
        want, cache = D.decode_step(
            dec, cache, jnp.asarray(tokens[t], jnp.int32), jnp.int32(t),
            cfg.num_heads, cfg.dim_key, cfg.dim_value, cfg.dim_model,
            dtype=jnp.float32)
        got = TD.decode_step(tdec, tcache, torch.from_numpy(tokens[t]), t,
                             cfg.num_heads, cfg.dim_key, cfg.dim_value,
                             cfg.dim_model, dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


# (eos_boost picked so that some rows end before max_len and some not,
# which takes progressive decoding's re-run path at stage 4)
@pytest.mark.parametrize("rank,stage,boost", [(0, 4, 1.0), (0, 64, 1.0),
                                              (8, 4, 1.8)])
def test_greedy_ids_equal(rank, stage, boost):
    cfg, params, dims, enc, _, tparams, tdims = _setup(
        rank, 300, seed=2, eos_boost=boost)
    want = np.asarray(greedy_decode_progressive(
        params, jnp.asarray(enc), dims, max_len=12, stage_len=stage))
    got = TG.greedy_decode_progressive(tparams, torch.from_numpy(enc),
                                       tdims, max_len=12, stage_len=stage)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 2).any() and (want != 2).any()


# (eos_boost picked so that some hypotheses end by themselves and some
# get the forced EOS at step enc_T - 1)
@pytest.mark.parametrize("rank,stage,boost", [(0, 0, 1.0), (0, 3, 1.0),
                                              (8, 0, 1.2)])
def test_beam_nbest_equal(rank, stage, boost):
    cfg, params, dims, enc, tcfg, tparams, tdims = _setup(
        rank, BIG_VOCAB, seed=3, eos_boost=boost)
    id2label = {i: chr(0x4e00 + i) for i in range(BIG_VOCAB)}
    want = BeamDecoder(cfg, dims, id2label, stage_len=stage).decode_nbest(
        params, jnp.asarray(enc), nbest=3)
    got = TB.BeamDecoder(tcfg, tdims, id2label,
                         stage_len=stage).decode_nbest(
        tparams, torch.from_numpy(enc), nbest=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert [h.text for h in g] == [h.text for h in w]
        assert [h.ids for h in g] == [h.ids for h in w]
        np.testing.assert_allclose([h.raw for h in g], [h.raw for h in w],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
        np.testing.assert_allclose([h.final for h in g],
                                   [h.final for h in w],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    lens = {len(h.ids) for utt in got for h in utt}
    assert max(lens) == enc.shape[1] + 2 and min(lens) < max(lens)
    assert any(max(h.ids) > 256 for utt in got for h in utt)


def test_beam_top_k_breaks_ties_to_lower_index():
    """The pool and expansion top-k must order equal scores by index, as
    jax.lax.top_k does (torch.topk leaves ties unspecified)."""
    x = torch.tensor([[0.0, 1.0, 1.0, -1.0, 1.0]])
    vals, idx = TB._top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[1.0] * 3]
