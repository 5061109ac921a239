"""The plain reference against the program at a tiny size on the CPU,
through the benchmark's own runs."""

import pytest
import torch

from asr_bench import weights
from asr_bench.reference import model as ref
import tiny


@pytest.mark.parametrize("model,rank", [("TRFS", 0), ("LRTRFS", 8)])
def test_reference_follows_an_f32_program(model, rank):
    # with the program in f32 the two differ by the order of sums alone,
    # dropout masks and all
    out, checks, run = tiny.run(tiny.TRAIN, dtype="float32", model=model,
                                rank=rank)
    r = run.check_detail
    assert r["loss_rel"] < 1e-5
    assert r["mu_gap"] < 1e-3
    assert r["update_gap"] < 1e-2
    assert out["correct"]


def test_bf16_program_is_correct_and_near():
    out, checks, run = tiny.run(tiny.TRAIN)
    assert run.check_detail["loss_rel"] < 1e-3
    assert out["correct"], out["checks"]


def test_weights_have_the_program_layout():
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.models.transformer import init_params
    from end2end_asr_tpu_torch.training.checkpoint import flatten_params
    _, (_, config, _, _) = tiny.files(tiny.TRAIN)
    for rank in (0, 8):
        cfg = dict(config, rank=rank)
        kw = {k: cfg[k] for k in ("feat_extractor", "num_layers",
                                  "num_heads", "dim_model", "dim_key",
                                  "dim_value", "dim_inner", "dim_emb",
                                  "sample_rate", "src_max_len",
                                  "tgt_max_len", "rank")}
        want = flatten_params(init_params(Config(**kw), 50,
                                          torch.Generator().manual_seed(0)))
        got = weights.make_flat(cfg, 50, 0, "cpu")
        assert sorted(got) == sorted(want)
        assert all(tuple(got[k].shape) == tuple(want[k].shape)
                   for k in want)


def test_philox_and_features_match_the_program():
    from end2end_asr_tpu_torch.ops import attention_fused as AF
    from end2end_asr_tpu_torch.ops.features import batched_features
    keep = ref.attention_keep(2 ** 62 + 12345, 2, 3, 5, 7, 58982, "cpu")
    assert torch.equal(keep, AF.keep_mask(2 ** 62 + 12345, 2, 3, 5, 7,
                                          58982))
    g = torch.Generator().manual_seed(1)
    y = [(torch.rand(n, generator=g) * 2e4 - 1e4).to(torch.int16).numpy()
         for n in (3000, 3900)]
    pcm = ref.padded_pcm(y, 50, 320, 80)
    n = torch.tensor([38, 49])
    want = batched_features(pcm, n, 320, 80, "hamming", T_out=50)
    got = ref.features(pcm, n, 320, 80, 50)
    assert torch.allclose(got, want, atol=1e-4)
