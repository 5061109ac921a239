"""Chunked / streaming transcription.

Port of the JAX package's ``streaming.py`` (the reference has no
streaming surface: transcription there is a whole-file batch affair). PCM
arrives in chunks of any size, and each ``feed()`` returns the current
partial transcript.

The encoder is bidirectional (every frame attends to the whole
utterance), so exact streaming re-encodes all the audio received so far:
there is no causal encoder cache to reuse. Each re-encode snaps to the
bucket ladder and takes the same path as ``transcribe`` on a file of
that length (``evaluation.encode_utterance``: the STFT kernel, the front
end's kernels, the encoder), and the decoder re-decodes from scratch,
greedy (progressive) or with the given beam. So the partials are what
the batch pipeline gives for the same prefix of audio, and ``flush()``
equals ``transcribe`` on the whole file.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from end2end_asr_tpu_torch.config import Config
from end2end_asr_tpu_torch.data.features import num_frames
from end2end_asr_tpu_torch.evaluation import (decode_strings,
                                              encode_utterance,
                                              prepare_params, resolve_device,
                                              strip_specials)
from end2end_asr_tpu_torch.models.transformer import dims_from_config


class StreamingTranscriber:
    """Incremental transcription over a growing PCM buffer.

        st = StreamingTranscriber(params, model_state, cfg, id2label)
        for chunk in microphone():      # float32 PCM at cfg.sample_rate
            partial = st.feed(chunk)    # current best transcript
        final = st.flush()

    `params` are a checkpoint's (f32, or int8 from
    models.quantize.quantize_for_inference); they are prepared for
    `device` here (the card unless told otherwise; it raises without one,
    and TF32 goes off: evaluation.resolve_device). `beam` is an optional
    decoding.beam.BeamDecoder for beam partials. `min_new_frames`
    throttles recomputation: feed() returns the cached partial until at
    least that many new spectrogram frames arrived (default 10 = 100 ms
    at the reference's 10 ms hop).
    """

    def __init__(self, params, model_state, cfg: Config,
                 id2label: Dict[int, str], beam=None,
                 min_new_frames: int = 10, device="cuda"):
        self.device = resolve_device(str(device))
        self.cfg = cfg
        self.id2label = id2label
        self.dims = dims_from_config(cfg)
        self.params = prepare_params(params, self.dims, self.device,
                                     model_state)
        self.beam = beam
        self.min_new_frames = min_new_frames
        self._pcm: List[np.ndarray] = []
        self._n_samples = 0
        self._decoded_frames = 0
        self._partial = ""

    def _frames(self, n_samples: int) -> int:
        # transcribe's frame count (librosa center=True: 1 + n // hop)
        return max(num_frames(n_samples, self.cfg.n_fft,
                              self.cfg.hop_length), 1)

    def feed(self, pcm_chunk) -> str:
        """Append PCM (1-D float array) and return the current partial
        transcript (cached unless enough new audio arrived)."""
        pcm_chunk = np.asarray(pcm_chunk, np.float32).reshape(-1)
        if pcm_chunk.size:
            self._pcm.append(pcm_chunk)
            self._n_samples += pcm_chunk.size
        if self._n_samples == 0:
            return self._partial
        frames = self._frames(self._n_samples)
        if frames - self._decoded_frames < self.min_new_frames:
            return self._partial
        return self._decode()

    def flush(self) -> str:
        """Final transcript over all audio received so far."""
        if self._n_samples == 0:
            return ""
        if self._frames(self._n_samples) == self._decoded_frames:
            # the last feed() decoded every frame already
            return self._partial
        return self._decode()

    def reset(self) -> None:
        self._pcm.clear()
        self._n_samples = 0
        self._decoded_frames = 0
        self._partial = ""

    def _decode(self) -> str:
        y = np.concatenate(self._pcm) if len(self._pcm) > 1 else self._pcm[0]
        self._pcm = [y]
        enc_out = encode_utterance(self.params, self.cfg, self.dims, y,
                                   self.device)
        text = decode_strings(self.params, self.cfg, self.dims, enc_out,
                              self.beam, self.id2label)[0]
        self._decoded_frames = self._frames(y.size)
        self._partial = strip_specials(text).strip()
        return self._partial
