"""Port parity: StreamingTranscriber (streaming.py).

The same JAX-initialised weights (through the weight bridge) and the same
PCM chunks go through the JAX package's StreamingTranscriber and the
port's: the partials and flush() are equal, greedy and beam. Chunked
feeding equals one-shot feeding and the port's `transcribe` on the whole
file; the throttle, reset and the default device behave as specified.
"""

import numpy as np
import pytest
import torch

from end2end_asr_tpu.decoding.beam import BeamDecoder
from end2end_asr_tpu.models.transformer import dims_from_config
from end2end_asr_tpu.streaming import StreamingTranscriber as JaxStream
from end2end_asr_tpu.training.checkpoint import save_checkpoint
from end2end_asr_tpu_torch import transcribe as port_transcribe
from end2end_asr_tpu_torch.data.audio import load_audio, save_wav
from end2end_asr_tpu_torch.decoding import beam as TB
from end2end_asr_tpu_torch.models import transformer as TT
from end2end_asr_tpu_torch.streaming import StreamingTranscriber

from port_parity import jax_params, small_config, to_port, torch_config

V = 12
ID2LABEL = {i: c for i, c in enumerate("¶§¤ abcdefgh")}
SR = 8000
# 8 kHz, n_fft 160, hop 80: 4400 samples are 56 frames, so the partials
# take the buckets 16, 32 and 64 (= src_max_len)
CFG = small_config(sample_rate=SR, dim_input=81, src_max_len=64,
                   tgt_max_len=16, src_buckets=(16, 32, 64), beam_width=3)


@pytest.fixture(scope="module")
def model():
    params = jax_params(CFG, V, seed=6, eos_boost=1.0)
    pcm = (np.random.RandomState(0).randn(4400) * 0.1).astype(np.float32)
    return params, pcm


def _chunks(pcm, n=7):
    return np.array_split(pcm, n)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_partials_and_flush_match_jax(model, decode):
    params, pcm = model
    jbeam = tbeam = None
    tcfg = torch_config(CFG)
    if decode == "beam":
        jbeam = BeamDecoder(CFG, dims_from_config(CFG), ID2LABEL)
        tbeam = TB.BeamDecoder(tcfg, TT.dims_from_config(tcfg), ID2LABEL)
    want = JaxStream(params, {}, CFG, ID2LABEL, beam=jbeam)
    got = StreamingTranscriber(to_port(params), {}, tcfg, ID2LABEL,
                               beam=tbeam, device="cpu")
    want_parts = [want.feed(c) for c in _chunks(pcm)]
    got_parts = [got.feed(c) for c in _chunks(pcm)]
    assert got_parts == want_parts
    assert len(set(got_parts)) > 1  # the partials change as audio arrives
    assert got.flush() == want.flush()


def test_chunked_equals_oneshot_and_transcribe(model, tmp_path):
    """flush() after chunks = after one feed = `transcribe` on the file
    (the same 16-bit samples)."""
    params, pcm = model
    wav = str(tmp_path / "u.wav")
    save_wav(wav, pcm, SR)
    y = load_audio(wav)
    base = str(tmp_path / "ck")
    save_checkpoint(base, CFG, 1, params, None, {},
                    {c: i for i, c in ID2LABEL.items()}, ID2LABEL)
    tcfg = torch_config(CFG)
    tparams = to_port(params)
    one = StreamingTranscriber(tparams, {}, tcfg, ID2LABEL, device="cpu")
    one.feed(y)
    ref = one.flush()
    st = StreamingTranscriber(tparams, {}, tcfg, ID2LABEL, device="cpu")
    for c in _chunks(y, 5):
        st.feed(c)
    assert st.flush() == ref
    line = port_transcribe.main(["--continue-from", base, wav,
                                 "--device", "cpu"])
    assert line == [f"{wav}\t{ref}"] and ref


def test_throttle_and_reset(model):
    params, pcm = model
    st = StreamingTranscriber(to_port(params), {}, torch_config(CFG),
                              ID2LABEL, min_new_frames=10 ** 9,
                              device="cpu")
    assert st.feed(np.zeros(0, np.float32)) == ""
    assert st.feed(pcm[:400]) == "" and st.feed(pcm[400:800]) == ""
    assert st._decoded_frames == 0  # below the throttle: no decode yet
    text = st.flush()
    assert st._decoded_frames == 1 + 800 // 80
    assert st.flush() == text  # nothing new: the cached transcript
    st.reset()
    assert st.flush() == "" and st._n_samples == 0


def test_runs_on_the_card_by_default(model, monkeypatch):
    params, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTranscriber(to_port(params), {}, torch_config(CFG),
                             ID2LABEL)
