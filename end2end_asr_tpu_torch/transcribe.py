"""Single-command transcription with the port: WAV file(s) in, text out.

    python -m end2end_asr_tpu_torch.transcribe --continue-from models/run/best_model \
        a.wav b.wav [--beam-search --beam-width 8] \
        [--lm-rescoring --lm-path lm.npz [--lm-greedy-as-beam]] \
        [--quantize-int8] [--device cpu]

The flags of root ``transcribe.py`` plus ``--device`` (default ``cuda``;
without a GPU it raises unless --device cpu is given). --quantize-int8
quantises the dense weights to int8 on load (models/quantize.py);
--lm-rescoring rescores the beam's hypotheses with the LSTM LM of
--lm-path (models/lm.py), and is unused without --beam-search unless
--lm-greedy-as-beam is given (evaluation.make_beam). Prints one line per
file:  <path>\\t<transcript>
"""

from __future__ import annotations

import argparse


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
    ap.add_argument("--lm-greedy-as-beam", action="store_true",
                    help="upgrade greedy --lm-rescoring to a width-k "
                         "LM-rescored beam (evaluation.make_beam)")
    ap.add_argument("--quantize-int8", action="store_true",
                    help="weight-only int8 quantisation of the "
                         "encoder/decoder dense weights on load "
                         "(models/quantize.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from end2end_asr_tpu_torch.data.audio import load_audio
    from end2end_asr_tpu_torch.evaluation import (decode_strings,
                                                  encode_utterance,
                                                  make_beam, prepare_params,
                                                  resolve_device,
                                                  strip_specials)
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    cfg, _, params, _, model_state, _, id2label, _ = load_checkpoint(
        args.continue_from)
    cfg = cfg.replace(beam_search=args.beam_search,
                      beam_width=args.beam_width,
                      lm_rescoring=args.lm_rescoring,
                      lm_path=args.lm_path, lm_weight=args.lm_weight,
                      c_weight=args.c_weight,
                      lm_greedy_as_beam=args.lm_greedy_as_beam)
    if args.quantize_int8:
        from end2end_asr_tpu_torch.models.quantize import \
            quantize_for_inference
        params = quantize_for_inference(params)
    dims = dims_from_config(cfg)
    params = prepare_params(params, dims, device, model_state)
    lm = None
    if cfg.lm_rescoring:
        from end2end_asr_tpu_torch.models.lm import LM
        lm = LM(cfg.lm_path, device)
    beam = make_beam(cfg, dims, id2label, lm)

    lines = []
    for path in args.wavs:
        enc_out = encode_utterance(params, cfg, dims, load_audio(path),
                                   device)
        text = decode_strings(params, cfg, dims, enc_out, beam, id2label)[0]
        line = f"{path}\t{strip_specials(text).strip()}"
        print(line)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
