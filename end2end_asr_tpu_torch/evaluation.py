"""Batch evaluation (the reference's test.py:19-62 evaluate()).

Port of the JAX package's ``evaluation.py``: per batch, int16 PCM →
features (the STFT kernel, ops/stft.py) → encode (vgg front end with the
fused block-1 kernel, then the encoder) → greedy or beam decode; strip
special chars and accumulate CER / WER / CER_EN / CER_ZH totals.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import (Config, EOS_CHAR, PAD_CHAR,
                                          PAD_TOKEN, SOS_CHAR)
from end2end_asr_tpu_torch.decoding.greedy import (greedy_decode_progressive,
                                                   ids_to_strings)
from end2end_asr_tpu_torch.models.transformer import (ModelDims,
                                                      cast_dense_weights,
                                                      dims_from_config,
                                                      encode, to_device)
from end2end_asr_tpu_torch.ops.stft import batched_features
from end2end_asr_tpu_torch.utils.metrics import (calculate_cer,
                                                 calculate_cer_en_zh,
                                                 calculate_wer)

logger = logging.getLogger("end2end_asr_tpu_torch")


def strip_specials(s: str) -> str:
    return (s.replace(EOS_CHAR, "").replace(SOS_CHAR, "")
            .replace(PAD_CHAR, ""))


def ids_to_string_until_pad(ids, id2label: Dict[int, str]) -> str:
    """Token ids → string, stopping at the first PAD (trainer.py:62-75)."""
    s = ""
    for x in ids:
        if int(x) == PAD_TOKEN:
            break
        s += id2label.get(int(x), "")
    return s


def resolve_device(name: str) -> torch.device:
    """The torch device for --device; a CUDA device without a usable
    GPU is an error, never a silent fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "run on the CPU")
    return dev


def prepare_params(params, dims: ModelDims, device: torch.device):
    """Params on `device` with dense weights stored in the compute dtype."""
    return to_device(cast_dense_weights(params, dims.dtype), device)


def encode_pcm(params, cfg: Config, dims: ModelDims, pcm: torch.Tensor,
               n_frames: torch.Tensor, spect_T: int):
    """(B, N) reflect-padded PCM (int16 wire or f32) on the device →
    (enc_out (B, T', H), enc_lengths)."""
    spect = batched_features(pcm, n_frames, cfg.n_fft, cfg.hop_length,
                             cfg.window, T_out=spect_T, normalize=True)
    return encode(params, spect, n_frames, dims)


def make_beam(cfg: Config, dims: ModelDims, id2label: Dict[int, str]):
    """The BeamDecoder for --beam-search, else None (greedy)."""
    if cfg.lm_rescoring:
        raise NotImplementedError("LM rescoring is not ported yet")
    if not cfg.beam_search:
        return None
    from end2end_asr_tpu_torch.decoding.beam import BeamDecoder
    return BeamDecoder(cfg, dims, id2label, stage_len=cfg.decode_stage_len)


def decode_strings(params, cfg: Config, dims: ModelDims, enc_out, beam,
                   id2label: Dict[int, str]) -> List[str]:
    if beam is not None:
        return beam.decode(params, enc_out)
    max_len = min(cfg.decode_max_len, cfg.tgt_max_len)
    ids = greedy_decode_progressive(params, enc_out, dims, max_len=max_len,
                                    stage_len=cfg.decode_stage_len
                                    or max_len)
    return ids_to_strings(ids, id2label)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(params, cfg: Config, test_loader, id2label: Dict[int, str],
             device: torch.device, verbose: bool = False,
             timings: Optional[list] = None) -> Dict[str, float]:
    """Decode every batch and score it. `params` are prepared for
    `device` (prepare_params). With `timings` (a list), one dict per
    batch is appended: encode_ms and decode_ms on the host clock, each
    ending in a device synchronize."""
    dims = dims_from_config(cfg)
    beam = make_beam(cfg, dims, id2label)
    totals = dict(word=0, char=0, cer=0, wer=0,
                  en_cer=0, zh_cer=0, en_char=0, zh_char=0)

    for batch in test_loader:
        t0 = time.perf_counter()
        pcm = torch.from_numpy(batch.pcm).to(device)
        n_frames = torch.from_numpy(
            np.asarray(batch.n_frames, np.int64)).to(device)
        enc_out, _ = encode_pcm(params, cfg, dims, pcm, n_frames,
                                batch.src_bucket)
        if timings is not None:
            _sync(device)
        t1 = time.perf_counter()
        hyps = decode_strings(params, cfg, dims, enc_out, beam, id2label)
        t2 = time.perf_counter()
        if timings is not None:
            timings.append({"encode_ms": (t1 - t0) * 1e3,
                            "decode_ms": (t2 - t1) * 1e3,
                            "batch": len(hyps)})
        golds = [ids_to_string_until_pad(row, id2label)
                 for row in batch.targets]
        if batch.real_rows > 0:
            hyps, golds = hyps[:batch.real_rows], golds[:batch.real_rows]

        for hyp_raw, gold_raw in zip(hyps, golds):
            hyp, gold = strip_specials(hyp_raw), strip_specials(gold_raw)
            if verbose:
                logger.info("HYP: %s || GOLD: %s", hyp, gold)
            totals["wer"] += calculate_wer(hyp, gold)
            totals["cer"] += calculate_cer(hyp.strip(), gold.strip())
            en_cer, zh_cer, n_en, n_zh = calculate_cer_en_zh(hyp, gold)
            totals["en_cer"] += en_cer
            totals["zh_cer"] += zh_cer
            totals["en_char"] += n_en
            totals["zh_char"] += n_zh
            totals["word"] += len(gold.split(" "))
            totals["char"] += len(gold)

        logger.info(
            "TEST CER:%.2f%% WER:%.2f%% CER_EN:%.2f%% CER_ZH:%.2f%%",
            totals["cer"] * 100 / max(1, totals["char"]),
            totals["wer"] * 100 / max(1, totals["word"]),
            totals["en_cer"] * 100 / max(1, totals["en_char"]),
            totals["zh_cer"] * 100 / max(1, totals["zh_char"]))

    return {
        "cer": totals["cer"] * 100 / max(1, totals["char"]),
        "wer": totals["wer"] * 100 / max(1, totals["word"]),
        "cer_en": totals["en_cer"] * 100 / max(1, totals["en_char"]),
        "cer_zh": totals["zh_cer"] * 100 / max(1, totals["zh_char"]),
    }
