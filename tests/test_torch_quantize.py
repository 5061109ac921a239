"""Port parity: weight-only int8 serving (models/quantize.py).

The same JAX-initialised weights (through the weight bridge) go through
the JAX package's quantize_for_inference and the port's:
  * q8 and scale are bit-equal (round half to even, a zero column);
  * the whole param tree: every 2-D dense weight quantised, a tied head
    materialised, low-rank leaves and everything else untouched;
  * layers.dense, decoder.output_logits and decoder.fused_qkv_weights
    dispatch on "q8" (the fused projection stays int8);
  * full-model logits at f32, greedy ids and beam n-best of the
    quantised model equal the JAX package's;
  * prepare_params keeps q8 int8 after the bf16 cast;
  * the test / transcribe entry points with --quantize-int8 give root
    test.py's and transcribe.py's CER line, hypotheses and lines.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.decoding.beam import BeamDecoder
from end2end_asr_tpu.decoding.greedy import greedy_decode_progressive
from end2end_asr_tpu.models import decoder as JD
from end2end_asr_tpu.models import layers as JLay
from end2end_asr_tpu.models.quantize import (quantize_dense,
                                             quantize_for_inference)
from end2end_asr_tpu.models.transformer import dims_from_config, forward
from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import transcribe as port_transcribe
from end2end_asr_tpu_torch.decoding import beam as TB
from end2end_asr_tpu_torch.decoding import greedy as TG
from end2end_asr_tpu_torch.evaluation import prepare_params
from end2end_asr_tpu_torch.models import decoder as TD
from end2end_asr_tpu_torch.models import layers as TLay
from end2end_asr_tpu_torch.models import quantize as TQ
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.training.checkpoint import flatten_params

from port_parity import (corpus_checkpoint, jax_params, root_cli,
                         small_config, to_port, torch_config)

# f32 products of int8-valued weights, the scale in f32: sums in another
# order
DENSE_TOL = 1e-5
# f32 logits (O(1)) through the vgg front end and 2 encoder + 2 decoder
# layers; atol for the logits near 0
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5
# cumulative beam log-probs over <= 12 steps
SCORE_TOL = 1e-4
V = 30


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def test_quantize_dense_bit_equal():
    """q8 and scale bit for bit, with per-column magnitudes over three
    decades, a zero column and exact halves (round half to even)."""
    rs = np.random.RandomState(0)
    w = rs.randn(96, 48).astype(np.float32) * rs.uniform(0.01, 3.0, 48)
    w[:, 5] = 0.0
    w[:4, 7] = [0.5, 1.5, 2.5, -2.5]   # scale 1: ties at x.5
    w[4:, 7] = 0.0
    w[95, 7] = 127.0
    b = rs.randn(48).astype(np.float32)
    want = quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = TQ.quantize_dense({"w": torch.from_numpy(w),
                             "b": torch.from_numpy(b)})
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["scale"].numpy().view(np.uint32),
                                  np.asarray(want["scale"]).view(np.uint32))
    assert got["q8"][:4, 7].tolist() == [0, 2, 2, -2]
    assert got["scale"][5] == 1.0 and not got["q8"][:, 5].any()
    np.testing.assert_array_equal(got["b"].numpy(), b)


VARIANTS = {"plain": {}, "tied": {"emb_trg_sharing": True},
            "lowrank": {"rank": 8}}


def _setup(variant, seed=0, eos_boost=0.0, **kw):
    """(cfg, JAX params, JAX int8 params). quantize_for_inference runs
    eagerly, as root test.py runs it: under jit XLA turns the division
    by 127 into a product with its reciprocal, which moves ~5% of the
    scales by one f32 ulp."""
    cfg = small_config(**{**VARIANTS[variant], **kw})
    params = jax_params(cfg, V, seed=seed, eos_boost=eos_boost)
    return cfg, params, quantize_for_inference(params)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_quantize_for_inference_matches_jax(variant):
    cfg, params, qparams = _setup(variant)
    got = flatten_params(TQ.quantize_for_inference(to_port(params)))
    want = _flat(qparams)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    q = "encoder::layers::0::self_attn::q::"
    if variant == "lowrank":
        assert q + "u" in got and not any(k.endswith("q8") and "layers"
                                          in k for k in got)
    else:
        assert got[q + "q8"].dtype == torch.int8 and q + "w" not in got
        assert "decoder::output_linear::q8" in got
        assert got["decoder::embedding"].dtype == torch.float32
    if variant == "tied":
        assert "output_linear" not in to_port(params)["decoder"]


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_dense_dispatches_q8(dtype):
    rs = np.random.RandomState(1)
    w = rs.randn(32, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    x = rs.randn(4, 32).astype(np.float32)
    jq = quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    want = JLay.dense(jq, jnp.asarray(x),
                      dtype=None if dtype is None else jnp.float32)
    tq = TQ.quantize_dense({"w": torch.from_numpy(w),
                            "b": torch.from_numpy(b)})
    got = TLay.dense(tq, torch.from_numpy(x),
                     None if dtype is None else torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DENSE_TOL, atol=DENSE_TOL)


@pytest.mark.parametrize("variant", ["plain", "tied"])
def test_full_model_logits_match_jax(variant):
    cfg, params, qparams = _setup(variant)
    rs = np.random.RandomState(0)
    B, T = 2, 64
    spect = rs.randn(B, cfg.dim_input, T).astype(np.float32)
    nf = np.array([T, T - 9], np.int32)
    tg = np.zeros((B, 8), np.int32)
    tg[:, 0] = 1
    tg[:, 1:4] = rs.randint(3, V, size=(B, 3))
    tg[:, 4] = 2
    dims = dims_from_config(cfg)
    want, _, _ = jax.jit(lambda p, s, n, t: forward(
        p, {}, s, n, t, dims, train=False))(qparams, spect, nf, tg)
    tcfg = torch_config(cfg)
    tparams = TQ.quantize_for_inference(to_port(params))
    got, _ = TT.forward(tparams, torch.from_numpy(spect),
                        torch.from_numpy(nf).long(),
                        torch.from_numpy(tg).long(),
                        TT.dims_from_config(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    # the tied head: output_logits on the materialised int8 projection
    h = rs.randn(3, cfg.dim_model).astype(np.float32)
    np.testing.assert_allclose(
        TD.output_logits(tparams["decoder"], torch.from_numpy(h),
                         torch.float32).numpy(),
        np.asarray(JD.output_logits(qparams["decoder"], jnp.asarray(h),
                                    jnp.float32)),
        rtol=DENSE_TOL, atol=DENSE_TOL)


def test_fused_qkv_stays_int8():
    _, params, qparams = _setup("plain")
    got = TD.fused_qkv_weights(
        TQ.quantize_for_inference(to_port(params))["decoder"])
    want = JD.fused_qkv_weights(qparams["decoder"])
    for g, w in zip(got, want):
        assert g["q8"].dtype == torch.int8
        for k in ("q8", "scale", "b"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_prepare_params_keeps_int8():
    """The bf16 cast of prepare_params leaves q8 int8 and scale f32:
    quantise first, from the f32 weights, then cast (evaluation.py)."""
    cfg, params, qparams = _setup("plain", dtype="bfloat16")
    tcfg = torch_config(cfg)
    prepared = prepare_params(TQ.quantize_for_inference(to_port(params)),
                              TT.dims_from_config(tcfg),
                              torch.device("cpu"))
    flat = flatten_params(prepared)
    want = _flat(qparams)
    for k, v in flat.items():
        if k.endswith(("q8", "scale")):
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        if k.endswith("::w") and "frontend" not in k:
            assert v.dtype == torch.bfloat16, k
    assert any(k.endswith("::q8") for k in flat)


@pytest.mark.parametrize("variant", ["plain", "lowrank"])
def test_quantized_decoding_matches_jax(variant):
    """Greedy (progressive, both stages) ids and the beam n-best of the
    quantised model equal the JAX package's."""
    cfg, params, qparams = _setup(variant, seed=2, eos_boost=1.0,
                                  beam_width=4, tgt_max_len=13)
    dims = dims_from_config(cfg)
    tdims = TT.dims_from_config(torch_config(cfg))
    tparams = TQ.quantize_for_inference(to_port(params))
    enc = np.random.RandomState(2).randn(3, 9, cfg.dim_model).astype(
        np.float32)
    for stage in (4, 64):
        want = np.asarray(greedy_decode_progressive(
            qparams, jnp.asarray(enc), dims, max_len=12, stage_len=stage))
        got = TG.greedy_decode_progressive(tparams, torch.from_numpy(enc),
                                           tdims, max_len=12,
                                           stage_len=stage)
        np.testing.assert_array_equal(got.numpy(), want)
    id2label = {i: chr(ord("a") + i) for i in range(V)}
    want = BeamDecoder(cfg, dims, id2label).decode_nbest(
        qparams, jnp.asarray(enc), nbest=4)
    got = TB.BeamDecoder(torch_config(cfg), tdims, id2label).decode_nbest(
        tparams, torch.from_numpy(enc), nbest=4)
    for g_utt, w_utt in zip(got, want):
        assert [h.ids for h in g_utt] == [h.ids for h in w_utt]
        np.testing.assert_allclose([h.final for h in g_utt],
                                   [h.final for h in w_utt], rtol=0,
                                   atol=SCORE_TOL)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return corpus_checkpoint(str(tmp_path_factory.mktemp("q8_serve")))


def _hyps(caplog, logger):
    return [r.getMessage().split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for r in caplog.records
            if r.name == logger and r.getMessage().startswith("HYP: ")]


@pytest.mark.parametrize("extra", [[], ["--beam-search", "--beam-width",
                                        "3"]], ids=["greedy", "beam"])
def test_entry_points_quantize_match_root(served, caplog, capsys, extra):
    manifest, base = served
    argv = ["--continue-from", base, "--test-manifest-list", manifest,
            "--batch-size", "2", "--verbose", "--quantize-int8", *extra]
    caplog.set_level(logging.INFO)
    root_cli("test").main(argv)
    want_out = capsys.readouterr().out
    want_hyps = _hyps(caplog, "end2end_asr_tpu")
    port_test.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert _hyps(caplog, "end2end_asr_tpu_torch") == want_hyps
    assert len(want_hyps) == 4 and any(want_hyps)
    line = [ln for ln in want_out.splitlines() if ln.startswith("TEST CER")]
    assert line and line[-1] in got_out.splitlines()

    with open(manifest) as f:
        wavs = [ln.split(",")[0] for ln in f if ln.strip()]
    targv = ["--continue-from", base, "--quantize-int8", *extra, *wavs]
    root_cli("transcribe").main(targv)
    want_lines = capsys.readouterr().out.splitlines()
    assert port_transcribe.main(targv + ["--device", "cpu"]) == want_lines
    assert len(want_lines) == 4
