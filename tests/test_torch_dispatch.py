"""--steps-per-dispatch K and the Prefetcher of the port, on the CPU.

  * the port's trainer at --steps-per-dispatch 3 against 1 over two
    epochs of 4 batches (a group of 3 and a single step an epoch), with
    dropout: losses, parameters and optimizer state bit-equal, by default
    and with --grad-accum 2 (on the CPU a group runs its K steps one
    after another, so the grouping, the seeds and the metrics are what is
    held here; the card's CUDA graph is held against the eager steps by
    chip_smoke.py);
  * one group of 3 through the port's make_multi_train_step against the
    JAX package's make_multi_train_step (its lax.scan) on the same
    weights and batches, f32 at dropout 0;
  * an infinite-loss batch inside a group skips its own step only;
  * the Prefetcher yields the loader's batches, bit-equal and in order,
    plain and with --augment, --noise-dir and --num-workers;
  * the kernels' device-seed entries against their by-value entries (on
    the plain versions here), and the host stream of kernel seeds that
    DropoutRng draws a step or a group at a time against one draw a call;
    the pipeline's streams' seeds and bits in a group against single
    steps (tests/test_torch_gpu.py holds them under a CUDA graph), and
    `remat`'s recompute of a pipeline stream's draws under capture.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_asr_tpu.models.transformer import \
    dims_from_config as jax_dims
from end2end_asr_tpu.training import optimizer as JO
from end2end_asr_tpu.training.checkpoint import flatten_tree
from end2end_asr_tpu.training.steps import \
    make_multi_train_step as jax_multi_step
from end2end_asr_tpu_torch.config import Config, load_vocab
from end2end_asr_tpu_torch.data.dataset import ManifestDataset, NoiseInjector
from end2end_asr_tpu_torch.data.loader import (AudioBatchLoader,
                                               BucketingSampler, Prefetcher)
from end2end_asr_tpu_torch.models import layers as L
from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                      init_params)
from end2end_asr_tpu_torch.ops import attention_fused as AF
from end2end_asr_tpu_torch.training import checkpoint as TC
from end2end_asr_tpu_torch.training import optimizer as TO
from end2end_asr_tpu_torch.training import steps as TS
from end2end_asr_tpu_torch.training import trainer as TR

from port_parity import jax_params, to_port, torch_config
from synth import make_corpus
from test_torch_train import (LOSS_TOL, T_FRAMES, VOCAB, _batch, _cfg,
                              _ctc_batch, _params_close, _port_batch)

K = 3
# 8 utterances of one length: 4 batches of 2 an epoch, all in one bucket
TEXTS = ["ab", "ba", "abba", "baab", "aabb", "bbaa", "abab", "baba"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the models are tiny, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dispatch"))
    return make_corpus(os.path.join(root, "c"), texts=TEXTS,
                       exact_samples=63 * 160)


def _train(corpus, k, monkeypatch, **kw):
    """Two epochs of the port's Trainer at --steps-per-dispatch k: (the
    result, the K-step dispatches made)."""
    manifest, labels = corpus
    cfg = Config(feat_extractor="vgg_cnn", num_layers=2, num_heads=2,
                 dim_model=64, dim_key=32, dim_value=32, dim_inner=128,
                 dim_emb=64, batch_size=2, dropout=0.1, src_max_len=64,
                 tgt_max_len=8, src_buckets=(64,), tgt_buckets=(8,),
                 dtype="float32", epochs=2, save_every=100, seed=3,
                 save_folder=os.path.join(os.path.dirname(manifest), "m"),
                 name="d", steps_per_dispatch=k, **kw)
    label2id, id2label = load_vocab(labels)
    calls = []
    grouped = TS.EagerSteps.__call__
    monkeypatch.setattr(TS.EagerSteps, "__call__",
                        lambda *a, **k_: calls.append(1) or grouped(*a, **k_))
    ds = ManifestDataset([manifest], label2id)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(cfg.seed))
    trainer = TR.Trainer(cfg, label2id, id2label, torch.device("cpu"))
    res = trainer.train(params, None, AudioBatchLoader(ds, cfg),
                        [AudioBatchLoader(ds, cfg)], num_epochs=2)
    return res, len(calls)


@pytest.mark.parametrize("extra", [{}, {"grad_accum": 2}],
                         ids=["default", "grad_accum_2"])
def test_steps_per_dispatch_3_equals_1_bit_for_bit(corpus, monkeypatch,
                                                   extra):
    (one, n1), (grouped, nk) = (_train(corpus, k, monkeypatch, **extra)
                                for k in (1, K))
    assert (n1, nk) == (0, 2)          # a group of 3 an epoch
    assert grouped["opt_step"] == one["opt_step"] == 8
    h1, hk = one["metrics"]["history"], grouped["metrics"]["history"]
    assert [h["train_loss"] for h in hk] == [h["train_loss"] for h in h1]
    assert [h["valid_loss"] for h in hk] == [h["valid_loss"] for h in h1]
    assert [h["train_cer"] for h in hk] == [h["train_cer"] for h in h1]
    for a, b in ((one["params"], grouped["params"]),
                 (one["opt_state"], grouped["opt_state"])):
        fa, fb = TC.flatten_params(a), TC.flatten_params(b)
        assert set(fa) == set(fb)
        for key in fa:
            assert torch.equal(fa[key], fb[key]), key


@functools.lru_cache(maxsize=None)
def _model():
    cfg = _cfg()
    return cfg, jax_params(cfg, VOCAB, seed=4)


def test_grouped_steps_match_the_jax_multi_train_step():
    """One group of 3 at dropout 0, f32: the port's K steps against the
    JAX package's scanned K-step program on the same weights and
    batches: the losses within LOSS_TOL, the token counts equal, the
    parameters by tests/test_torch_train.py's rule."""
    cfg, params = _model()
    port = to_port(params)
    params = jax.tree_util.tree_map(jnp.array, params)   # donated below
    batches = [_batch(s) for s in (0, 1, 2)]
    multi = jax_multi_step(cfg, jax_dims(cfg), from_pcm=True)
    stack = lambda c: jnp.stack([jnp.asarray(b[c]) for b in batches])
    jp, jo, _, jms, _, jgolds = multi(
        params, JO.init_opt_state(cfg, params), {},
        jnp.stack([jax.random.PRNGKey(i) for i in range(K)]),
        stack(0), stack(1), stack(2), stack(3), spect_T=T_FRAMES)

    tcfg = torch_config(cfg)
    fp = TS.FlatParams(port, torch.device("cpu"))
    step = TS.make_train_step_impl(tcfg, dims_from_config(tcfg))
    pmulti = TS.make_multi_train_step(tcfg, step, K, torch.device("cpu"))
    data, opt, _, ms, _, golds = pmulti(
        fp, fp.data, TO.init_opt_state(tcfg, fp.data), None,
        [_port_batch(b) for b in batches], T_FRAMES)
    np.testing.assert_allclose(ms["loss"].numpy(),
                               np.asarray(jms["loss"]), rtol=LOSS_TOL)
    np.testing.assert_array_equal(ms["num_token"].numpy(),
                                  np.asarray(jms["num_token"]))
    np.testing.assert_array_equal(golds.numpy(), np.asarray(jgolds))
    assert int(opt["step"]) == int(jo["step"]) == K
    want = flatten_tree(jp)
    got = fp.views(data)
    _params_close(torch.cat([v.reshape(-1) for v in got.values()]).numpy(),
                  np.concatenate([want[k].reshape(-1) for k in got]),
                  ms["lr"].tolist())


def test_an_infinite_batch_inside_a_group_skips_its_step_only():
    """CTC, the middle batch of a group infeasible (4 frames): its step
    leaves parameters, moments and the step count as they were, the
    others update; the group equals the three single steps bit for bit
    (the JAX package's test_multi_step_inf_skip_inside_group)."""
    cfg, params = _model()
    tcfg = torch_config(cfg.replace(loss="ctc", label_smoothing=0.0))
    bad = list(_ctc_batch(1, [4, 3, 5, 4]))
    bad[1] = np.full_like(bad[1], 4)
    batches = [_port_batch(b) for b in (_ctc_batch(0, [4, 3, 5, 4]),
                                         tuple(bad),
                                         _ctc_batch(2, [3, 5, 4, 4]))]
    step = TS.make_train_step_impl(tcfg, dims_from_config(tcfg))

    def fresh():
        fp = TS.FlatParams(to_port(params), torch.device("cpu"))
        return fp, fp.data, TO.init_opt_state(tcfg, fp.data)

    fp, data, opt = fresh()
    finite = []
    for b in batches:
        data, opt, _, m, _, _ = step(fp, data, opt, None, *b, T_FRAMES)
        finite.append(bool(m["finite"]))
    assert finite == [True, False, True] and int(opt["step"]) == 2
    fpk, datak, optk = fresh()
    multi = TS.make_multi_train_step(tcfg, step, K, torch.device("cpu"))
    datak, optk, _, ms, _, _ = multi(fpk, datak, optk, None, batches,
                                     T_FRAMES)
    assert ms["finite"].tolist() == finite
    assert ms["loss"][1].item() == 0.0 and int(optk["step"]) == 2
    assert torch.equal(datak, data)
    for key in opt:
        assert torch.equal(optk[key], opt[key]), key


@pytest.mark.parametrize("augment", [False, True],
                         ids=["plain", "augment_noise_workers_4"])
def test_prefetcher_yields_the_loader_batches(corpus, tmp_path, augment):
    """Two epochs (the bins shuffled between them) through the Prefetcher
    and through the loader alone, each from a fresh loader of the same
    seed: the same batches in the same order, bit for bit, and the
    tensors those of `batch_tensors`."""
    manifest, labels = corpus
    label2id, _ = load_vocab(labels)
    noise = None
    if augment:
        d = tmp_path / "noise"
        d.mkdir()
        wav = os.path.join(os.path.dirname(manifest), "wav")
        shutil.copy(os.path.join(wav, sorted(os.listdir(wav))[0]), d)
    cfg = Config(batch_size=3, num_workers=4 if augment else 0)

    def loader():
        if augment:
            noise_inj = NoiseInjector(str(tmp_path / "noise"))
        ds = ManifestDataset([manifest, manifest], label2id, augment=augment,
                             noise_injector=noise_inj if augment else noise,
                             noise_prob=0.5)
        return AudioBatchLoader(ds, cfg, sampler=BucketingSampler(
            len(ds), 3, seed=7))

    plain, pre = loader(), loader()
    for epoch in range(2):
        got = list(Prefetcher(pre))
        want = list(plain)
        assert len(got) == len(want) == 3
        for (b, tensors), w in zip(got, want):
            for f in ("pcm", "n_frames", "targets", "tgt_lengths"):
                assert np.array_equal(getattr(b, f), getattr(w, f)), f
            assert b.src_bucket == w.src_bucket
            assert b.real_rows == w.real_rows
            assert tensors[0].dtype == torch.int16
            for x, y in zip(tensors, TR.batch_tensors(w, "cpu")):
                assert torch.equal(x, y)
        plain.shuffle(epoch)
        pre.shuffle(epoch)


def test_prefetcher_raises_the_producer_error():
    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            raise OSError("no such file")
            yield

    with pytest.raises(OSError, match="no such file"):
        list(Prefetcher(Broken()))


def test_prefetcher_takes_the_current_card_for_cuda_without_an_index(
        monkeypatch):
    """`train --device cuda` (the default) names no card; the producer
    thread sets its card with torch.cuda.set_device, which takes an index
    only (it raised "Expected a torch.device with a specified index" on
    the card): the Prefetcher takes the caller's current card."""
    from torch.cuda._utils import _get_device_index
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    for name, want in (("cuda", 3), ("cuda:1", 1)):
        pf = Prefetcher([], device=name)
        assert pf.device == torch.device("cuda", want)
        assert _get_device_index(pf.device) == want    # set_device's read
    assert Prefetcher([]).device == torch.device("cpu")


def test_device_seed_entries_equal_the_by_value_entries():
    """The seed read from a slot of a seed buffer (DeviceSeed) against
    the same seed by value: the attention forward and its gradients and
    the dropout bits, on the plain versions."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 9, 64, generator=g) for _ in range(3))
    bias = torch.zeros(2, 9, 9)
    bias[1, :, 7:] = AF.MASK_BIAS
    buf = torch.tensor([5, 2 ** 63 - 7, 77], dtype=torch.int64)
    for slot in range(3):
        seed = AF.DeviceSeed(buf, slot)
        assert seed.value() == int(buf[slot])
        outs = []
        for s in (seed, int(buf[slot])):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            out = AF.flash_mha_train(*qkv, bias, s, 0.25)
            outs.append((out, *torch.autograd.grad(out.sum(), qkv)))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        assert torch.equal(AF.dropout_bits(seed, 2, 2, 9, 9),
                           AF.dropout_bits(int(buf[slot]), 2, 2, 9, 9))
    assert not torch.equal(AF.dropout_bits(AF.DeviceSeed(buf, 0), 1, 1, 4, 8),
                           AF.dropout_bits(AF.DeviceSeed(buf, 2), 1, 1, 4, 8))


def test_kernel_seeds_keep_the_host_stream():
    """DropoutRng draws a step's seeds up front (the first step as it
    goes), and a group's at once: the seeds the kernels get, slot by
    slot, are one draw a call from the run's host generator, in order;
    a step that leaves a drawn seed unused raises."""
    host = torch.Generator().manual_seed(11)
    want = [int(torch.randint(0, 2 ** 63 - 1, (), generator=host))
            for _ in range(5 * 4)]
    rng = L.DropoutRng(11, "cpu")
    got = []
    for _ in range(2):                 # two single steps of 4 seeds
        rng.begin_step()
        got += [rng.kernel_seed().value() for _ in range(4)]
        rng.end_step()
    assert rng.per_step == 4
    with rng.group(3):                 # a group of 3 steps
        for _ in range(3):
            rng.begin_step()           # inside a group: no draw
            got += [rng.kernel_seed().value() for _ in range(4)]
            rng.end_step()
    assert got == want
    assert rng.values[:12] == want[8:]
    rng.begin_step()
    rng.kernel_seed()
    with pytest.raises(RuntimeError, match="used 1 of the 4"):
        rng.end_step()


def test_pipeline_stream_draws_of_a_group_equal_single_steps():
    """The pipeline's (stack, layer, microbatch) streams: their kernel
    seeds and their plain dropout's bits, drawn on the device from each
    stream's generator, are a group's as K single steps'; the group draws
    only the run's own seeds up front, and every seed differs from stream
    to stream and from step to step."""
    from torch_pipe_draws import pipe_step_draws
    single = L.DropoutRng(7, "cpu")
    want = [pipe_step_draws(single) for _ in range(4)]
    rng = L.DropoutRng(7, "cpu")
    got = [pipe_step_draws(rng)]
    with rng.group(3):
        got += [pipe_step_draws(rng) for _ in range(3)]
    for (gs, gb), (ws, wb) in zip(got, want):
        assert torch.equal(gs, ws) and torch.equal(gb, wb)
    assert rng.per_step == 1
    seeds = torch.cat([s for s, _ in want])
    assert seeds.unique().numel() == seeds.numel() == 4 * (1 + 2 * 2 * 3)


def test_remat_under_capture_keeps_a_pipeline_streams_draws(monkeypatch):
    """`remat` of a layer that draws from a pipeline stream (a kernel
    seed, then bits), as under CUDA-graph capture, where no generator can
    be set back: the recompute gets the first run's seed and bits from
    the tape, so the gradient is the one without remat, and the stream
    advances once."""
    def layer(r, x):
        seed = r.kernel_seed().value() % 65536
        return x * (r.bits16(x.shape, x.device) + seed).to(x.dtype)

    x0 = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64)
    grads, after = [], []
    for capture in (False, True):
        r = L.DropoutRng(5, "cpu").pipe_stream("encoder", 0, 1)
        monkeypatch.setattr(L, "_capturing", lambda device: capture)
        x = x0.clone().requires_grad_()
        L.remat(lambda a: layer(r, a), r, x).sum().backward()
        monkeypatch.undo()
        grads.append(x.grad)
        after.append(r.dev.get_state())
    r = L.DropoutRng(5, "cpu").pipe_stream("encoder", 0, 1)
    x = x0.clone().requires_grad_()
    layer(r, x).sum().backward()
    for g, st in zip(grads, after):
        assert torch.equal(g, x.grad)
        assert torch.equal(st, r.dev.get_state())
