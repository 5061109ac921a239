"""Single-command transcription with the port: WAV file(s) in, text out.

    python -m end2end_asr_tpu_torch.transcribe --continue-from models/run/best_model \
        a.wav b.wav [--beam-search --beam-width 8] [--device cpu]

The flags of root ``transcribe.py`` plus ``--device`` (default ``cuda``;
without a GPU it raises unless --device cpu is given). Prints one line
per file:  <path>\\t<transcript>
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="Transcribe WAV files")
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--continue-from", required=True)
    ap.add_argument("--beam-search", action="store_true")
    ap.add_argument("--beam-width", type=int, default=8)
    ap.add_argument("--lm-rescoring", action="store_true")
    ap.add_argument("--lm-path", default="lm.npz")
    ap.add_argument("--lm-weight", type=float, default=0.1)
    ap.add_argument("--c-weight", type=float, default=0.1)
    ap.add_argument("--lm-greedy-as-beam", action="store_true")
    ap.add_argument("--quantize-int8", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, name in ((args.lm_rescoring, "--lm-rescoring"),
                       (args.quantize_int8, "--quantize-int8")):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet")

    from end2end_asr_tpu_torch.data.audio import load_audio
    from end2end_asr_tpu_torch.data.features import num_frames
    from end2end_asr_tpu_torch.data.loader import pick_bucket
    from end2end_asr_tpu_torch.evaluation import (decode_strings,
                                                  encode_pcm, make_beam,
                                                  prepare_params,
                                                  resolve_device,
                                                  strip_specials)
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.ops.features import reflect_pad_pcm
    from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    cfg, _, params, _, model_state, _, id2label, _ = load_checkpoint(
        args.continue_from)
    cfg = cfg.replace(beam_search=args.beam_search,
                      beam_width=args.beam_width,
                      c_weight=args.c_weight)
    dims = dims_from_config(cfg)
    params = prepare_params(params, dims, device, model_state)
    beam = make_beam(cfg, dims, id2label)

    n_fft, hop = cfg.n_fft, cfg.hop_length
    lines = []
    for path in args.wavs:
        y = load_audio(path)
        frames = min(num_frames(len(y), n_fft, hop), cfg.src_max_len)
        T_b = min(pick_bucket(frames, cfg.src_buckets), cfg.src_max_len)
        frames = min(frames, T_b)
        n_pcm = (T_b - 1) * hop
        pcm = reflect_pad_pcm(y[:n_pcm], n_fft, n_pcm)[None, :]
        enc_out, _ = encode_pcm(
            params, cfg, dims, torch.from_numpy(pcm).to(device),
            torch.tensor([frames], dtype=torch.long, device=device), T_b)
        text = decode_strings(params, cfg, dims, enc_out, beam, id2label)[0]
        line = f"{path}\t{strip_specials(text).strip()}"
        print(line)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
