"""Batch evaluation (the reference's test.py:19-62 evaluate()).

Port of the JAX package's ``evaluation.py``: per batch, int16 PCM →
features (the STFT kernel, ops/stft.py) → encode (the front end — vgg
with its fused kernels, or emb_cnn with the checkpoint's batch-norm
statistics — then the encoder) → greedy or beam decode; strip
special chars and accumulate CER / WER / CER_EN / CER_ZH totals.

Data parallelism (``test --parallel``): each rank encodes and decodes its
slice of every batch; the hypotheses and golds are gathered to every rank
in row order (``all_gather_object``), cut to the bin's real rows, and
rank 0 alone scores and logs them, so the strings and the CER are the
one-process run's.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from end2end_asr_tpu_torch.config import (Config, EOS_CHAR, PAD_CHAR,
                                          PAD_TOKEN, SOS_CHAR)
from end2end_asr_tpu_torch.data.features import num_frames
from end2end_asr_tpu_torch.data.loader import pick_bucket
from end2end_asr_tpu_torch.decoding.greedy import (greedy_decode_progressive,
                                                   ids_to_strings)
from end2end_asr_tpu_torch.models.transformer import (ModelDims,
                                                      cast_dense_weights,
                                                      dims_from_config,
                                                      encode, to_device,
                                                      with_state)
from end2end_asr_tpu_torch.ops.features import reflect_pad_pcm
from end2end_asr_tpu_torch.ops.stft import batched_features
from end2end_asr_tpu_torch.parallel import mesh
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


def no_tf32() -> None:
    """Full f32 on the card: PyTorch lets cuDNN's convolutions run in TF32
    (about three decimal digits) unless told otherwise, which puts an f32
    model ~3e-3 off the CPU and the JAX package; both flags go off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """The torch device for --device; a CUDA device without a usable
    GPU is an error, never a silent fall back to the CPU. Every entry
    point (train, test, transcribe) starts here, so TF32 goes off here."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "run on the CPU")
    no_tf32()
    return dev


def prepare_params(params, dims: ModelDims, device: torch.device,
                   model_state=None):
    """Params on `device` with dense weights stored in the compute dtype,
    and the model state (a checkpoint's ``state`` group: the emb_cnn
    batch norms' running statistics) under "state" for `encode`. int8
    params (models/quantize.py) are quantised before this, from the f32
    weights; their "q8" leaves stay int8."""
    return to_device(with_state(cast_dense_weights(params, dims.dtype),
                                model_state), device)


def encode_pcm(params, cfg: Config, dims: ModelDims, pcm: torch.Tensor,
               n_frames: torch.Tensor, spect_T: int):
    """(B, N) reflect-padded PCM (int16 wire or f32) on the device →
    (enc_out (B, T', H), enc_lengths). ``--no-pallas-features`` takes the
    plain STFT in place of the kernel."""
    spect = batched_features(pcm, n_frames, cfg.n_fft, cfg.hop_length,
                             cfg.window, T_out=spect_T, normalize=True,
                             use_kernel=cfg.use_pallas_features)
    return encode(params, spect, n_frames, dims)


def encode_utterance(params, cfg: Config, dims: ModelDims, y: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """One utterance's f32 PCM → enc_out (1, T', H) with the batch
    loader's frame geometry: the bucket of its frame count, both capped
    at src_max_len, and reflect-padded PCM of (T_b − 1)·hop samples; so a
    file alone encodes as it does in a batch of its bucket."""
    frames = min(num_frames(len(y), cfg.n_fft, cfg.hop_length),
                 cfg.src_max_len)
    T_b = min(pick_bucket(frames, cfg.src_buckets), cfg.src_max_len)
    n_pcm = (T_b - 1) * cfg.hop_length
    pcm = reflect_pad_pcm(y[:n_pcm], cfg.n_fft, n_pcm)[None, :]
    enc_out, _ = encode_pcm(
        params, cfg, dims, torch.from_numpy(pcm).to(device),
        torch.tensor([min(frames, T_b)], dtype=torch.long, device=device),
        T_b)
    return enc_out


def make_beam(cfg: Config, dims: ModelDims, id2label: Dict[int, str],
              lm=None):
    """The BeamDecoder (LM-rescored where `lm` is given and
    --lm-rescoring is set) for --beam-search, or for --lm-rescoring with
    --lm-greedy-as-beam and an LM; else None (greedy).

    --lm-rescoring without --beam-search leaves the LM unused, the
    reference's reachable behaviour: its evaluate() always calls
    greedy_search with defaults (transformer.py:117-118), and the per-step
    LM branch it never reaches is broken (:357-373). --lm-greedy-as-beam
    takes a width-k LM-rescored beam instead, as the JAX package does."""
    if cfg.beam_search or (cfg.lm_rescoring and cfg.lm_greedy_as_beam
                           and lm is not None):
        from end2end_asr_tpu_torch.decoding.beam import BeamDecoder
        return BeamDecoder(cfg, dims, id2label, lm=lm,
                           stage_len=cfg.decode_stage_len)
    if cfg.lm_rescoring:
        logger.warning(
            "--lm-rescoring without --beam-search: the LM is unused, "
            "matching the reference's reachable behavior "
            "(transformer.py:117-118); pass --lm-greedy-as-beam for a "
            "width-%d LM-rescored beam instead", cfg.beam_width)
    return None


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
             timings: Optional[list] = None, lm=None) -> Dict[str, float]:
    """Decode every batch and score it. `params` are prepared for
    `device` (prepare_params); `lm` is the rescoring LM (make_beam).
    With `timings` (a list), one dict per batch is appended: encode_ms
    and decode_ms on the host clock, each ending in a device
    synchronize. Under data parallelism only rank 0 scores: the other
    ranks return {}."""
    dims = dims_from_config(cfg)
    beam = make_beam(cfg, dims, id2label, lm)
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
        if mesh.data_size() > 1:
            # the ranks' slices in rank order: the bin's rows, then its
            # cycled duplicates
            parts = mesh.gather_objects((hyps, golds))
            hyps = [h for p in parts for h in p[0]][:batch.bin_rows]
            golds = [g for p in parts for g in p[1]][:batch.bin_rows]
            if not mesh.is_main():
                continue
        elif batch.real_rows > 0:
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

    if not mesh.is_main():
        return {}
    return {
        "cer": totals["cer"] * 100 / max(1, totals["char"]),
        "wer": totals["wer"] * 100 / max(1, totals["word"]),
        "cer_en": totals["en_cer"] * 100 / max(1, totals["en_char"]),
        "cer_zh": totals["zh_cer"] * 100 / max(1, totals["zh_char"]),
    }
