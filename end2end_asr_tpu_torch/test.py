"""Evaluation CLI of the port — the flags of root ``test.py`` plus
``--device`` (default ``cuda``).

    python -m end2end_asr_tpu_torch.test --continue-from models/run/best_model \
        --test-manifest-list test.csv [--beam-search --beam-width 8] \
        [--device cpu]

Loads a checkpoint in the JAX package's format (training/checkpoint.py),
takes the feature and model config FROM THE CHECKPOINT (reference
test.py:78-84) and the decode/search flags, the manifests and any other
explicitly typed flag from the command line, builds the test loader and
runs batch evaluation (greedy or --beam-search). Without a GPU it raises
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from end2end_asr_tpu_torch.config import (ARCH_FIELDS, config_from_args,
                                          explicit_cli_overrides)


def split_device_arg(argv: Optional[List[str]]):
    """(device, remaining argv): --device is the port's own flag."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(argv)
    return ns.device, rest


def main(argv=None, timings: Optional[list] = None):
    """Runs the evaluation and returns the metrics dict; `timings`
    collects per-batch encode/decode times (evaluation.evaluate)."""
    if argv is None:
        argv = sys.argv[1:]
    device_name, argv = split_device_arg(argv)
    cli = config_from_args(argv)
    if not cli.continue_from:
        print("need --continue-from checkpoint")
        sys.exit(1)
    for flag, name in ((cli.quantize_int8, "--quantize-int8"),
                       (cli.lm_rescoring, "--lm-rescoring"),
                       (cli.parallel, "--parallel")):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet")

    from end2end_asr_tpu_torch.data.dataset import ManifestDataset
    from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                                   BucketingSampler)
    from end2end_asr_tpu_torch.evaluation import (evaluate, prepare_params,
                                                  resolve_device)
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.training.checkpoint import load_checkpoint

    device = resolve_device(device_name)
    logging.basicConfig(stream=sys.stdout,
                        format="%(asctime)s - %(message)s",
                        level=logging.INFO)

    cfg, _, params, _, label2id, id2label, _ = load_checkpoint(
        cli.continue_from)
    overrides = {k: getattr(cli, k)
                 for k in explicit_cli_overrides(argv)
                 if k not in ARCH_FIELDS}
    overrides.update(
        test_manifest_list=cli.test_manifest_list,
        batch_size=cli.batch_size, beam_search=cli.beam_search,
        beam_width=cli.beam_width, beam_nbest=cli.beam_nbest,
        lm_rescoring=cli.lm_rescoring, lm_path=cli.lm_path,
        lm_weight=cli.lm_weight, c_weight=cli.c_weight,
        lm_greedy_as_beam=cli.lm_greedy_as_beam,
        decode_max_len=cli.decode_max_len,
        decode_stage_len=cli.decode_stage_len,
        verbose=cli.verbose, continue_from=cli.continue_from)
    cfg = cfg.replace(**overrides)

    test_data = ManifestDataset(list(cfg.test_manifest_list), label2id,
                                sample_rate=cfg.sample_rate)
    test_loader = AudioBatchLoader(
        test_data, cfg,
        sampler=BucketingSampler(len(test_data), cfg.batch_size,
                                 seed=cfg.seed))
    params = prepare_params(params, dims_from_config(cfg), device)
    results = evaluate(params, cfg, test_loader, id2label, device,
                       verbose=cfg.verbose, timings=timings)
    print("TEST CER:{:.2f}% WER:{:.2f}% CER_EN:{:.2f}% CER_ZH:{:.2f}%".format(
        results["cer"], results["wer"], results["cer_en"],
        results["cer_zh"]))
    return results


if __name__ == "__main__":
    main()
