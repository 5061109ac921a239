"""Data parallelism's single-process pieces: the loader's per-rank slices
against the JAX package's `AudioBatchLoader(process_index, process_count)`
bit for bit, the divisibility and --mesh-data checks, the backend and
device choice, ZeRO's slice arithmetic over the flat buffer, and the
options the port still refuses. No process group is needed."""

import os

import numpy as np
import pytest
import torch

from end2end_asr_tpu.config import Config, load_vocab
from end2end_asr_tpu.data import audio as JA
from end2end_asr_tpu.data import dataset as JD
from end2end_asr_tpu.data import loader as JL
from end2end_asr_tpu.parallel import mesh as JM
from end2end_asr_tpu_torch import train as port_train
from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch.config import Config as TorchConfig
from end2end_asr_tpu_torch.config import config_from_args
from end2end_asr_tpu_torch.data import audio as PA
from end2end_asr_tpu_torch.data import dataset as PD
from end2end_asr_tpu_torch.data import loader as PL
from end2end_asr_tpu_torch.parallel import mesh as PM
from end2end_asr_tpu_torch.parallel.zero import ZeroShard
from end2end_asr_tpu_torch.training import optimizer as TO

from synth import make_corpus

SR = 16000


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Six utterances (batch 4: bins of 4 and 2, one ragged) and a second
    manifest of four, for joint training."""
    root = str(tmp_path_factory.mktemp("slices"))
    a, labels = make_corpus(os.path.join(root, "a"), seed=1,
                            texts=["abba", "cab", "back", "cabba", "bab",
                                   "ca"])
    b, _ = make_corpus(os.path.join(root, "b"), seed=2,
                       texts=["bab", "abc", "cc", "acab"])
    return [a, b], load_vocab(labels)[0]


@pytest.mark.parametrize("n,pad_to_full,augment", [
    (2, True, False), (3, False, False), (3, True, True)])
def test_loader_slices_equal_jax(corpora, n, pad_to_full, augment):
    """Every rank r of n, two epochs: pcm, targets, n_frames, the bucket
    (from the headers of the whole bin; with --augment the 1/0.85 margin,
    on both packages' C++ WSOLA, over two manifests) and real_rows equal
    the JAX loader's at process_index r."""
    manifests, label2id = corpora
    if augment:
        if not JA._native.available():
            pytest.skip("the JAX package's native library is unavailable")
        assert PA.audio_host.active() == "native"
    else:
        manifests = manifests[:1]
    # a fine bucket ladder, so that the tempo margin moves a bucket
    cfg = Config(batch_size=4, num_workers=0,
                 src_buckets=tuple(range(24, 72, 4)) + (200,))
    pcfg = TorchConfig.from_dict(cfg.to_dict())
    for r in range(n):
        loaders = []
        for D, L, c in ((JD, JL, cfg), (PD, PL, pcfg)):
            data = D.ManifestDataset(manifests, label2id, augment=augment)
            loader = L.AudioBatchLoader(
                data, c, sampler=L.BucketingSampler(len(data), 4, seed=7),
                process_index=r, process_count=n)
            loader.pad_to_full = pad_to_full
            loaders.append(loader)
        jl, pl = loaders
        for _ in range(2):
            got_all = list(pl)
            want_all = list(jl)
            assert len(got_all) == len(want_all) == 2
            for want, got in zip(want_all, got_all):
                assert got.real_rows == want.real_rows == -1
                assert got.pcm.shape[0] == (want.pcm.shape[0])
                assert np.array_equal(got.pcm, want.pcm)
                assert np.array_equal(got.targets, want.targets)
                assert np.array_equal(got.n_frames, want.n_frames)
                assert got.src_bucket == want.src_bucket
            # the ragged bin: 2 real rows, each rank a share of the cycle
            assert got_all[-1].bin_rows == 2 or got_all[0].bin_rows == 2
            jl.shuffle(0)
            pl.shuffle(0)
    if augment:
        plain = PL.AudioBatchLoader(PD.ManifestDataset(manifests, label2id),
                                    pcfg, process_count=n)
        ids = list(range(6))
        assert plain._global_buckets(ids)[0] < pl._global_buckets(ids)[0]


def test_check_divisible_and_mesh_data_messages():
    for n, batch, accum in ((2, 5, 1), (2, 4, 4), (3, 4, 1)):
        mesh = JM.make_mesh(n)
        with pytest.raises(ValueError) as want:
            JM.check_divisible(batch, mesh, grad_accum=accum)
        with pytest.raises(ValueError) as got:
            PM.check_divisible(batch, n, grad_accum=accum)
        assert str(got.value) == str(want.value)
    PM.check_divisible(8, 2, grad_accum=2)
    PM.check_mesh_data(0, 3)
    PM.check_mesh_data(3, 3)
    with pytest.raises(ValueError, match="--mesh-data 2 must equal"):
        PM.check_mesh_data(2, 3)


def test_backend_and_rank_device(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert PM.choose_backend(cpu, 2, 0) == "gloo"
    assert PM.choose_backend(cuda, 1, 1) == "nccl"
    assert PM.choose_backend(cuda, 4, 4) == "nccl"
    assert PM.choose_backend(cuda, 2, 1) == "gloo"    # two ranks, one card
    assert PM.world_size() == 1 and PM.rank() == 0 and not PM.active()
    # without a group every collective is the identity
    t = torch.arange(5.0)
    assert PM.all_reduce_(t) is t and PM.all_gather(t) is t
    assert PM.reduce_scatter(t) is t and PM.gather_objects(3) == [3]
    assert PM.maybe_initialize_distributed(cpu) == 1
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert PM.rank_device(cuda) == torch.device("cuda", 1)
    assert PM.rank_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert PM.rank_device(cpu) == cpu


def test_zero_slices_cover_the_buffer_and_update_elementwise():
    """n = 10 over 3 ranks: slices of 4, the buffer padded by 2; Adam-Noam
    and annealing SGD on each slice give the slices of the whole update,
    bit for bit, and the clip's norm from the slices' squared sums is the
    whole buffer's."""
    g = torch.Generator().manual_seed(0)
    n, world = 10, 3
    p, grad = torch.randn(n, generator=g), torch.randn(n, generator=g) * 3
    shards = [ZeroShard(n, world, r, 1) for r in range(world)]
    assert [s.per for s in shards] == [4] * 3 and shards[0].pad == 2
    assert shards[0].coverage() == 1.0
    assert "padded by 2 to 12" in shards[0].describe()
    whole = torch.cat([s.shard(p) for s in shards])
    assert torch.equal(whole[:n], p) and not whole[n:].any()
    sq = [torch.sum(torch.square(s.shard(grad))) for s in shards]
    reduce_sq = lambda _: sum(sq)
    c = TO.NoamConfig(model_size=64, factor=1.0, warmup=10, min_lr=1e-6)
    for clip in (False, True):
        full, fstate, _ = TO.adam_noam_update(
            p, grad, TO.init_adam_state(p), c, clip=clip, max_norm=1.0)
        sfull, sstate, _ = TO.sgd_annealing_update(
            p, grad, TO.init_sgd_state(p, 0.1), 0.9, 1.1, clip=clip,
            max_norm=1.0)
        for s in shards:
            part = s.shard(p)
            new, st, _ = TO.adam_noam_update(
                part, s.shard(grad), TO.init_adam_state(part), c, clip=clip,
                max_norm=1.0, reduce_sq=reduce_sq)
            new_s, st_s, _ = TO.sgd_annealing_update(
                part, s.shard(grad), TO.init_sgd_state(part, 0.1), 0.9, 1.1,
                clip=clip, max_norm=1.0, reduce_sq=reduce_sq)
            lo, hi = s.lo, min(s.lo + s.per, n)
            if clip:   # the norm summed in another order
                torch.testing.assert_close(new[:hi - lo], full[lo:hi],
                                           rtol=1e-6, atol=1e-7)
                torch.testing.assert_close(new_s[:hi - lo], sfull[lo:hi],
                                           rtol=1e-6, atol=1e-7)
            else:
                assert torch.equal(new[:hi - lo], full[lo:hi])
                assert torch.equal(st["nu"][:hi - lo], fstate["nu"][lo:hi])
                assert torch.equal(new_s[:hi - lo], sfull[lo:hi])
                assert torch.equal(st_s["buf"][:hi - lo],
                                   sstate["buf"][lo:hi])
    with pytest.raises(ValueError, match="stage must be 1 or 3"):
        ZeroShard(n, world, 0, 2)


@pytest.mark.parametrize("flags,exc,match", [
    # tensor parallelism is ported: the JAX package's check of the heads
    (["--parallel", "--mesh-model", "2"], ValueError,
     r"--num-heads 5 must be divisible by --mesh-model 2 \(whole"),
    # pipeline parallelism is ported: the JAX package's check of the
    # layers (3 by default)
    (["--parallel", "--mesh-pipe", "2"], ValueError,
     r"--num-layers 3 must be divisible by --mesh-pipe 2 \(equal"),
    (["--mesh-pipe", "2"], SystemExit, "--mesh-pipe requires --parallel"),
    (["--parallel", "--seq-parallel"], SystemExit,
     r"--seq-parallel requires --parallel --mesh-model N \(N > 1\)"),
    # low-rank layers under TP are ported, as the JAX package runs them:
    # accepted (exc None)
    (["--parallel", "--mesh-model", "2", "--num-heads", "4", "--model",
      "LRTRFS", "--rank", "8"], None, None),
    (["--zero1"], SystemExit, "require --parallel"),
    (["--fsdp"], SystemExit, "require --parallel")])
def test_train_refuses_what_is_not_ported(flags, exc, match):
    """refuse_unported raises where root train.py or the JAX package's
    checks do, with their words, and accepts the mixes they run."""
    if exc is None:
        assert port_train.refuse_unported(config_from_args(flags)) is None
        return
    with pytest.raises(exc, match=match):
        port_train.refuse_unported(config_from_args(flags))


def test_test_refuses_tensor_parallel_inference():
    """Tensor-parallel inference is ported
    (tests/test_torch_tp.py runs it on two ranks): one process without
    torchrun's group has one rank, too few for the model axis, and says
    so as the JAX package's make_mesh_2d does."""
    with pytest.raises(ValueError, match="--mesh-model 2 exceeds the 1 "
                                         "visible devices"):
        port_test.main(["--continue-from", "x", "--parallel",
                        "--mesh-model", "2", "--device", "cpu"])
