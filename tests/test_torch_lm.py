"""Port parity: the LSTM LM, its trainer and LM-rescored beam search.

The same weights (made from a seed with numpy, carried in the JAX
package's .npz layout or a reference-layout .pt) and the same inputs go
through the JAX package's function and the port's:
  * LSTM logits against lstm_forward / lstm_forward_batch (f32);
  * LM.evaluate on strings with OOV, uppercase and 1-word inputs;
  * .npz round trips both ways, tied and untied, and the .pt layout;
  * calculate_lm_score's string handling, exactly; lm_loader's outputs;
  * 3 steps of lm_train (root lm_train.py's jitted step against the
    port's train_step) from the same init on the same BPTT batches;
  * LM-rescored beam n-best (scores and order) with --beam-search and
    with --lm-greedy-as-beam; the test / transcribe entry points with
    --lm-rescoring against root test.py / transcribe.py.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.data import lm_loader as JL
from end2end_asr_tpu.decoding.beam import BeamDecoder
from end2end_asr_tpu.decoding.lm_rescoring import \
    calculate_lm_score as jax_lm_score
from end2end_asr_tpu.models import lm as JLM
from end2end_asr_tpu.models.transformer import dims_from_config
from end2end_asr_tpu.training.optimizer import adam_update, init_adam_state
from end2end_asr_tpu_torch import lm_train as port_lm_train
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch import transcribe as port_transcribe
from end2end_asr_tpu_torch.data import lm_loader as PL
from end2end_asr_tpu_torch.decoding import lm_rescoring as PR
from end2end_asr_tpu_torch.evaluation import make_beam
from end2end_asr_tpu_torch.models import lm as PLM
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.training.optimizer import \
    init_adam_state as port_init_adam

from port_parity import (corpus_checkpoint, jax_params, root_cli,
                         small_config, to_port, torch_config)

# f32 LSTM logits: the same products summed in another order
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# summed CE over <= 10 words of f32 log-softmax
CE_TOL = 1e-4
# params after 3 Adam steps at LR: each step moves a parameter by up to
# ~LR, and where a moment sums gradients of opposite signs (m = 0.09 g1 +
# 0.1 g2) the gradients' f32 differences (the LSTM backward summed in
# another order) grow in the ratio m / sqrt(v); held to 1e-3 of each
# step's size, 3e-3 LR over 3 steps
LR = 1e-3
STEP_RTOL, STEP_ATOL = 1e-5, 3e-3 * LR

WORDS = ["<eos>", "<oov>", "hello", "world", "good", "morning", "你", "好",
         "世", "界", "abba", "cab"]
WORD2IDX = {w: i for i, w in enumerate(WORDS)}
NINP = NHID = 32


def np_lm_params(seed, tied, ntoken=len(WORDS), ninp=NINP, nhid=NHID,
                 nlayers=2):
    """JAX-layout LM params from numpy: uniform weights, a nonzero
    decoder bias; no decoder_w leaf when tied."""
    rs = np.random.RandomState(seed)

    def u(shape, b):
        return rs.uniform(-b, b, shape).astype(np.float32)
    b = 1.0 / np.sqrt(nhid)
    return {"embedding": u((ntoken, ninp), 0.5),
            "decoder_w": None if tied else u((ntoken, nhid), 0.5),
            "decoder_b": u((ntoken,), 0.1),
            "layers": [{"w_ih": u((4 * nhid, ninp if i == 0 else nhid), b),
                        "w_hh": u((4 * nhid, nhid), b),
                        "b_ih": u((4 * nhid,), b),
                        "b_hh": u((4 * nhid,), b)}
                       for i in range(nlayers)]}


def _jnp(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def lm_npz(request, tmp_path_factory):
    """(path, JAX-layout numpy params, tied) of an LM the JAX package
    saved."""
    tied = request.param
    params = np_lm_params(1 + tied, tied)
    path = str(tmp_path_factory.mktemp("lm") / "lm.npz")
    JLM.save_npz_lm(path, params, WORD2IDX)
    return path, params, tied


def test_lstm_forward_matches_jax(lm_npz):
    path, params, tied = lm_npz
    model, word2idx = PLM._load_npz_lm(path)
    assert word2idx == WORD2IDX and model.tied == tied
    tokens = np.random.RandomState(0).randint(0, len(WORDS), size=(3, 9))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jax.jit(JLM.lstm_forward_batch)(
        _jnp(params), jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    want0 = np.asarray(jax.jit(JLM.lstm_forward)(
        _jnp(params), jnp.asarray(tokens[0], jnp.int32)))
    np.testing.assert_allclose(got[0], want0, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


SEQS = ["hello world", "HELLO World good", "你 好 hello 世 界",
        "hello", "zzz qqq morning", "", "CAB abba xyz 好"]


def test_evaluate_matches_jax(lm_npz):
    path = lm_npz[0]
    want_lm, got_lm = JLM.LM(path), PLM.LM(path, "cpu")
    for seq in SEQS:
        want, got = want_lm.evaluate(seq), got_lm.evaluate(seq)
        assert got[1] == want[1], seq
        assert abs(got[0] - want[0]) <= CE_TOL, (seq, got, want)
        np.testing.assert_array_equal(got_lm.seq_to_ids(seq)[0],
                                      want_lm.seq_to_ids(seq)[0])
    assert got_lm.evaluate("") == (0.0, 0)  # <eos> alone: < 2 ids
    assert got_lm.evaluate("Hello")[1] == 0  # the lowercase fallback
    assert got_lm.evaluate("zzz")[1] == 1


@pytest.mark.parametrize("tied", [False, True])
def test_port_save_loads_in_jax(tmp_path, tied):
    """The port's save_npz_lm → the JAX LM: the same leaves (no
    decoder_w when tied) and the same scores."""
    model = PLM.init_lm(len(WORDS), NINP, NHID, 2, tied,
                        torch.Generator().manual_seed(5))
    path = str(tmp_path / "lm.npz")
    PLM.save_npz_lm(path, model, WORD2IDX)
    want = JLM.LM(path)
    assert (want.params["decoder_w"] is None) == tied
    np.testing.assert_array_equal(np.asarray(want.params["embedding"]),
                                  model.encoder.weight.detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(want.params["layers"][1]["w_hh"]),
        model.rnn.weight_hh_l1.detach().numpy())
    assert not model.decoder.bias.detach().any()  # the init's zero bias
    got = PLM.LM(path, "cpu")
    assert got.model.tied == tied
    for seq in SEQS:
        assert abs(got.evaluate(seq)[0] - want.evaluate(seq)[0]) <= CE_TOL


def test_reference_pt_layout(tmp_path, lm_npz):
    """A reference torch LM checkpoint (lstm_utils.py:52-64 layout) gives
    the .npz's scores through both packages' loaders."""
    path, params, tied = lm_npz
    sd = {"encoder.weight": params["embedding"],
          "decoder.weight": (params["embedding"] if tied
                             else params["decoder_w"]),
          "decoder.bias": params["decoder_b"]}
    for i, layer in enumerate(params["layers"]):
        for k, name in PLM.LSTM_KEYS:
            sd["rnn." + name.format(i)] = layer[k]
    pt = str(tmp_path / "lm.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                "word2idx": WORD2IDX, "nlayers": 2}, pt)
    npz_lm, want_lm, got_lm = (PLM.LM(path, "cpu"), JLM.LM(pt),
                               PLM.LM(pt, "cpu"))
    for seq in SEQS:
        ref = npz_lm.evaluate(seq)[0]
        assert abs(got_lm.evaluate(seq)[0] - ref) <= CE_TOL
        assert abs(want_lm.evaluate(seq)[0] - ref) <= CE_TOL


class _Recorder:
    """An LM stand-in: records the strings it scores and returns a score
    computed from the string, so both packages' string handling compare
    exactly."""

    def __init__(self):
        self.seen = []

    def evaluate(self, seq):
        self.seen.append(seq)
        return 0.37 * len(seq) + 0.01 * seq.count("a"), seq.count("x")


def test_calculate_lm_score_matches_jax():
    chars = ["¶", "§", "¤", " ", "a", "B", "x", "你", "好", "世"]
    id2label = dict(enumerate(chars))
    cases = [[1, 7, 8, 3, 4, 5, 6, 3, 9, 2],      # 你好 aBx 世
             [1, 4, 3, 3, 5, 7, 3, 3, 6, 2, 0],   # a  B你  x, PAD
             [1, 7, 8, 9, 2],                      # Chinese only
             [1, 3, 4, 4, 4, 3, 2],                # spaces around aaa
             [1, 2], [1, 3, 3, 2], [0, 0]]         # empty after strips
    for ids in cases:
        want_rec, got_rec = _Recorder(), _Recorder()
        want = jax_lm_score(ids, want_rec, id2label)
        got = PR.calculate_lm_score(ids, got_rec, id2label)
        assert got == want and got_rec.seen == want_rec.seen, ids
    assert PR.calculate_lm_score([1, 2], _Recorder(), id2label) == \
        (-999.0, 0, 0)


def _transcripts(tmp_path, texts):
    rows = []
    for i, text in enumerate(texts):
        p = tmp_path / f"t{i}.txt"
        p.write_text(text, encoding="utf-8")
        rows.append(f"dummy{i}.wav,{p}")
    manifest = tmp_path / "m.csv"
    manifest.write_text("\n".join(rows) + "\n")
    return str(manifest)


TEXTS = ["Hello World", "good  morning 你好", "你好世界 hello", "",
         "CAB abba cab", "hello 世界 World good"]


def test_lm_loader_matches_jax(tmp_path):
    for text in TEXTS + ["  MiXeD 中文 text  with 空 格 "]:
        assert PL.words_from_text(text) == JL.words_from_text(text)
    manifest = _transcripts(tmp_path, TEXTS)
    sents = PL.corpus_from_manifests([manifest, manifest])
    assert sents == JL.corpus_from_manifests([manifest, manifest])
    for min_count in (1, 2):
        assert (PL.build_word_vocab(sents, min_count)
                == JL.build_word_vocab(sents, min_count))
    vocab = PL.build_word_vocab(sents, 2)
    for bs in (2, 3):
        stream = PL.batchify(sents, vocab, bs)
        np.testing.assert_array_equal(stream,
                                      JL.batchify(sents, vocab, bs))
        got = list(PL.bptt_batches(stream, 4))
        want = list(JL.bptt_batches(stream, 4))
        assert len(got) == len(want) > 1
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
    with open(manifest, "a") as f:
        f.write("only-a-wav.wav\n")
    with pytest.raises(ValueError, match="malformed manifest line"):
        PL.corpus_from_manifests([manifest])


def _jax_lm_step(lr):
    """The step of root lm_train.py: mean CE of lstm_forward_batch, then
    adam_update at a fixed lr."""
    @jax.jit
    def step(params, opt, inputs, targets):
        def loss_fn(p):
            logits = JLM.lstm_forward_batch(p, inputs)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)
            return -jnp.mean(ll)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_opt = adam_update(params, grads, opt, lr)
        return new_params, new_opt, loss
    return step


@pytest.mark.parametrize("tied", [False, True])
def test_lm_train_steps_match_jax(tmp_path, tied):
    """3 steps from the same init on the same BPTT batches: the port's
    params equal JAX's within STEP_RTOL; a tied model stays tied."""
    manifest = _transcripts(tmp_path, TEXTS * 3)
    sents = PL.corpus_from_manifests([manifest])
    vocab = PL.build_word_vocab(sents)
    batches = [b for b in PL.bptt_batches(PL.batchify(sents, vocab, 2), 6)
               if b[0].shape[1] >= 2][:3]
    assert len(batches) == 3
    params = np_lm_params(7, tied, ntoken=len(vocab))
    path = str(tmp_path / "init.npz")
    JLM.save_npz_lm(path, params, vocab)
    model, _ = PLM._load_npz_lm(path)

    lr = LR
    step = _jax_lm_step(lr)
    jp = _jnp(params)
    jopt = init_adam_state(jp)
    popt = port_init_adam({k: p.detach()
                           for k, p in model.named_parameters()})
    for inputs, targets in batches:
        jp, jopt, jloss = step(jp, jopt, jnp.asarray(inputs),
                               jnp.asarray(targets))
        popt, ploss = port_lm_train.train_step(
            model, popt, torch.from_numpy(inputs).long(),
            torch.from_numpy(targets).long(), lr)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
    assert int(popt["step"]) == 3 and model.tied == tied
    out = str(tmp_path / "after.npz")
    PLM.save_npz_lm(out, model, vocab)
    got = np.load(out, allow_pickle=True)
    want = {"embedding": jp["embedding"], "decoder_b": jp["decoder_b"],
            **{f"l{i}_{k}": v for i, layer in enumerate(jp["layers"])
               for k, v in layer.items()}}
    if not tied:
        want["decoder_w"] = jp["decoder_w"]
    assert sorted(want) == sorted(k for k in got.files if k != "meta")
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=k)
        assert not np.array_equal(got[k], np.load(path)[k]), k  # moved


def test_lm_train_entry_point(tmp_path):
    """`lm_train --device cpu` learns the corpus (its loss falls and a
    memorised bigram scores better), and its file scores the same in the
    JAX package's LM; a corpus with no 2-column batch raises."""
    manifest = _transcripts(tmp_path, ["hello world"] * 6
                            + ["good morning"] * 6)
    lm_path = str(tmp_path / "lm.npz")
    res = port_lm_train.main(
        ["--train-manifest-list", manifest, "--lm-path", lm_path,
         "--ninp", "16", "--nhid", "16", "--nlayers", "1",
         "--batch-size", "2", "--bptt", "8", "--epochs", "30",
         "--lr", "0.01", "--device", "cpu"])
    assert res["vocab"] == 6 and res["stream"] == [2, 18]
    assert len(res["losses"]) == 30 and res["losses"][-1] < \
        0.5 * res["losses"][0]
    assert len(res["step_ms"]) == 30 * 2  # the third batch has 1 column
    got, want = PLM.LM(lm_path, "cpu"), JLM.LM(lm_path)
    in_domain, oov = got.evaluate("hello world")
    assert oov == 0 and in_domain < got.evaluate("world hello")[0]
    for seq in ("hello world", "world hello", "good morning foo"):
        assert abs(got.evaluate(seq)[0] - want.evaluate(seq)[0]) <= CE_TOL
    with pytest.raises(ValueError, match="corpus too small"):
        port_lm_train.main(["--train-manifest-list", manifest,
                            "--lm-path", lm_path, "--batch-size", "64",
                            "--epochs", "1", "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_lm_train.main(["--train-manifest-list", manifest,
                            "--tie-weights", "--ninp", "8", "--nhid", "16",
                            "--device", "cpu"])


# the decoder's labels: specials, a space, letters and Chinese characters
LABELS = ["¶", "§", "¤", " ", "h", "e", "l", "o", "w", "r", "d", "a", "b",
          "c", "你", "好", "世", "界", "早", "上"]


@pytest.mark.parametrize("mode", ["beam_search", "greedy_as_beam"])
def test_lm_rescored_beam_matches_jax(lm_npz, mode):
    """The LM-rescored n-best (ids, final scores and their order) equal
    the JAX package's BeamDecoder(lm=...), built as its evaluate() builds
    it for --beam-search and for --lm-rescoring --lm-greedy-as-beam."""
    path = lm_npz[0]
    id2label = dict(enumerate(LABELS))
    cfg = small_config(beam_width=4, tgt_max_len=13, lm_rescoring=True,
                       lm_weight=0.7, c_weight=0.3,
                       beam_search=mode == "beam_search",
                       lm_greedy_as_beam=mode == "greedy_as_beam")
    params = jax_params(cfg, len(LABELS), seed=4, eos_boost=1.0)
    enc = np.random.RandomState(4).randn(3, 9, cfg.dim_model).astype(
        np.float32)
    want = BeamDecoder(cfg, dims_from_config(cfg), id2label,
                       lm=JLM.LM(path)).decode_nbest(
        params, jnp.asarray(enc), nbest=4)
    tcfg = torch_config(cfg)
    beam = make_beam(tcfg, TT.dims_from_config(tcfg), id2label,
                     PLM.LM(path, "cpu"))
    assert beam is not None
    got = beam.decode_nbest(to_port(params), torch.from_numpy(enc), nbest=4)
    plain = make_beam(tcfg.replace(lm_rescoring=False, beam_search=True),
                      TT.dims_from_config(tcfg), id2label).decode_nbest(
        to_port(params), torch.from_numpy(enc), nbest=4)
    assert [len(u) for u in got] == [len(u) for u in want] == [4, 4, 4]
    for g_utt, w_utt in zip(got, want):
        assert [h.ids for h in g_utt] == [h.ids for h in w_utt]
        assert [h.text for h in g_utt] == [h.text for h in w_utt]
        np.testing.assert_allclose([h.final for h in g_utt],
                                   [h.final for h in w_utt], rtol=0,
                                   atol=CE_TOL)
        np.testing.assert_allclose([h.raw for h in g_utt],
                                   [h.raw for h in w_utt], rtol=0,
                                   atol=CE_TOL)
    # the LM moved the final scores off the plain beam's
    assert {(tuple(h.ids), h.final) for u in got for h in u} != \
        {(tuple(h.ids), h.final) for u in plain for h in u}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A corpus, a checkpoint and an LM over the corpus' words."""
    root = tmp_path_factory.mktemp("lm_serve")
    manifest, base = corpus_checkpoint(str(root))
    vocab = PL.build_word_vocab(PL.corpus_from_manifests([manifest]))
    lm_path = str(root / "lm.npz")
    JLM.save_npz_lm(lm_path, np_lm_params(9, False, ntoken=len(vocab)),
                    vocab)
    return manifest, base, lm_path


def _hyps(caplog, logger):
    return [r.getMessage().split("HYP: ", 1)[1].split(" || GOLD: ")[0]
            for r in caplog.records
            if r.name == logger and r.getMessage().startswith("HYP: ")]


@pytest.mark.parametrize("extra", [
    ["--beam-search", "--beam-width", "3"],
    ["--lm-greedy-as-beam", "--beam-width", "3"],
    []], ids=["beam_search", "greedy_as_beam", "lm_unused"])
def test_entry_points_lm_rescoring_match_root(served, caplog, capsys,
                                              extra):
    """`test` and `transcribe` with --lm-rescoring give root test.py's
    and transcribe.py's CER line, hypotheses and lines; without a beam
    the LM is unused, with the same warning."""
    manifest, base, lm_path = served
    argv = ["--continue-from", base, "--test-manifest-list", manifest,
            "--batch-size", "2", "--verbose", "--lm-rescoring",
            "--lm-path", lm_path, "--lm-weight", "0.5", *extra]
    caplog.set_level(logging.INFO)
    root_cli("test").main(argv)
    want_out = capsys.readouterr().out
    want_hyps = _hyps(caplog, "end2end_asr_tpu")
    port_test.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert _hyps(caplog, "end2end_asr_tpu_torch") == want_hyps
    assert len(want_hyps) == 4
    line = [ln for ln in want_out.splitlines() if ln.startswith("TEST CER")]
    assert line and line[-1] in got_out.splitlines()
    warned = [r.name for r in caplog.records
              if "the LM is unused" in r.getMessage()]
    assert warned == ([] if extra else ["end2end_asr_tpu",
                                        "end2end_asr_tpu_torch"])

    with open(manifest) as f:
        wavs = [ln.split(",")[0] for ln in f if ln.strip()]
    targv = ["--continue-from", base, "--lm-rescoring", "--lm-path",
             lm_path, "--lm-weight", "0.5", *extra, *wavs]
    root_cli("transcribe").main(targv)
    want_lines = capsys.readouterr().out.splitlines()
    assert port_transcribe.main(targv + ["--device", "cpu"]) == want_lines
    assert len(want_lines) == 4
