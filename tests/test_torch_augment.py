"""Tempo/gain augmentation, noise injection and the loader's per-row
generators: the port against the JAX package, bit for bit, on the same
files and the same seeded RandomStates. Most cases run both packages'
pure-Python paths (the JAX C++ library switched off through
`_native.available`, the port's through `audio_host._load`); the
`native_on` cases run both C++ WSOLAs, the JAX package's default path.

The loader case is the `--num-workers` fault: with num_workers > 1 the
JAX loader gives each row its own RandomState seeded from the epoch's
generator, so with two manifests (joint training) a loader that draws
every row from the shared generator picks other rows."""

import os

import numpy as np
import pytest

from end2end_asr_tpu.config import Config, load_vocab
from end2end_asr_tpu.data import audio as JA
from end2end_asr_tpu.data import dataset as JD
from end2end_asr_tpu.data import loader as JL
from end2end_asr_tpu_torch.config import Config as TorchConfig
from end2end_asr_tpu_torch.data import audio as PA
from end2end_asr_tpu_torch.data import dataset as PD
from end2end_asr_tpu_torch.data import loader as PL

from synth import make_corpus

SR = 16000


@pytest.fixture(autouse=True)
def no_native(request, monkeypatch):
    """Both packages' Python fallbacks, unless the case asks for
    `native_on`."""
    if "native_on" in request.fixturenames:
        return
    monkeypatch.setattr(JA._native, "available", lambda: False)
    monkeypatch.setattr(PA.audio_host, "_load", lambda: None)
    assert PA.audio_host.active() == "python"


@pytest.fixture
def native_on():
    """Both C++ libraries loaded; skipped only where the JAX package's
    own library is unavailable (no g++)."""
    if not JA._native.available():
        pytest.skip("the JAX package's native library is unavailable")
    assert PA.audio_host.active() == "native", PA.audio_host.build_error()


def write_au(path, y, sr, encoding, channels=1):
    """A Sun .au file: μ-law (1) or big-endian int16 (3) samples."""
    y = np.asarray(y, np.float64)
    if encoding == 1:
        # G.711 μ-law encode (the inverse of the decoder under test)
        x = np.clip(np.round(y * 32768), -32768, 32767).astype(np.int64)
        sign = np.where(x < 0, 0x80, 0)
        mag = np.minimum(np.abs(x), 32635) + 0x84
        exp = np.floor(np.log2(mag)).astype(np.int64) - 7
        mant = (mag >> (exp + 3)) & 0x0F
        raw = (~(sign | (exp << 4) | mant) & 0xFF).astype(np.uint8)
        data = raw.tobytes()
    else:
        data = np.clip(y * 32768, -32768, 32767).astype(">i2").tobytes()
    hdr = np.array([0x2E736E64, 24, len(data), encoding, sr, channels],
                   ">u4").tobytes()
    with open(path, "wb") as f:
        f.write(hdr + data)


def tone(n, seed, f0=220.0, sr=SR):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    """A long WAV, a short WAV (shorter than the utterances: padded), a
    μ-law AU file and files that are not audio, in a tree."""
    d = str(tmp_path_factory.mktemp("noise"))
    os.makedirs(os.path.join(d, "sub"))
    JA.save_wav(os.path.join(d, "long.wav"), tone(SR, 1, 90), SR)
    JA.save_wav(os.path.join(d, "sub", "short.WAV"), tone(SR // 20, 2, 500),
                SR)
    write_au(os.path.join(d, "hum.au"), tone(SR // 2, 3, 60) * 2, SR, 1)
    for junk in ("notes.txt", "noext", os.path.join("sub", "x.wav.bak")):
        with open(os.path.join(d, junk), "w") as f:
            f.write("x")
    return d


@pytest.mark.parametrize("tempo", [0.85, 0.9, 1.0, 1.1, 1.15, "short"])
def test_wsola_equals_jax(tempo):
    if tempo == "short":   # under 2 windows: the linear-resample branch
        y, tempo = tone(700, 4), 0.9
    else:
        y = tone(SR // 2, 5)
    want = JA._wsola_py(y, tempo, SR)
    got = PA._wsola_py(y, tempo, SR)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("tempo", [0.85, 1.0, 1.15])
@pytest.mark.parametrize("seconds", [7.99, "short"])
def test_native_wsola_equals_jax(native_on, tempo, seconds):
    """The port's C++ WSOLA against the JAX package's, on 7.99 s and on a
    signal shorter than two windows (their `resample_linear` branch),
    and `apply_tempo` (which skips tempo 1.0) on both sides."""
    y = tone(700 if seconds == "short" else int(seconds * SR), 10)
    want = JA._native.tempo_wsola(y, tempo, SR)
    got = PA.audio_host.tempo_wsola(y, tempo, SR)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(PA.apply_tempo(y, tempo, SR),
                          JA.apply_tempo(y, tempo, SR))
    if tempo != 1.0:
        assert np.array_equal(PA.apply_tempo(y, tempo, SR), want)
        if seconds != "short":
            # the Python WSOLA is another function
            assert not np.array_equal(PA._wsola_py(y, tempo, SR), want)


@pytest.mark.parametrize("sr_in", [8000, 44100])
def test_resample_equals_jax_native(native_on, sr_in):
    """The port's NumPy resampler against the JAX package's C++ one (its
    default path): bit-equal."""
    y = tone(sr_in // 2 + 37, 11, sr=sr_in)
    want = JA._native.resample(y, sr_in, SR)
    assert np.array_equal(PA.resample(y, sr_in, SR), want)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_randomly_augmented_audio_equals_jax(tmp_path, sr):
    """At 8 kHz the source is resampled to 16 kHz before the tempo."""
    path = str(tmp_path / "u.wav")
    JA.save_wav(path, tone(sr // 3, 6, sr=sr), sr)
    for seed in range(3):
        want = JA.load_randomly_augmented_audio(
            path, SR, rng=np.random.RandomState(seed))
        got = PA.load_randomly_augmented_audio(
            path, SR, rng=np.random.RandomState(seed))
        assert np.array_equal(got, want)


def test_find_audio_files_and_decode_equal_jax(noise_dir, tmp_path):
    files = PA.find_audio_files(noise_dir)
    assert files == JA.find_audio_files(noise_dir)
    assert [os.path.basename(f) for f in files] == ["hum.au", "long.wav",
                                                    "short.WAV"]
    stereo = str(tmp_path / "st.au")
    write_au(stereo, np.stack([tone(801, 7), tone(801, 8)], 1).ravel(),
             8000, 3, channels=2)
    for path in files + [stereo]:
        (y, sr), (w, wsr) = PA.decode_audio(path), JA.decode_audio(path)
        assert sr == wsr and y.dtype == np.float32 and np.array_equal(y, w)
        assert PA.get_audio_length(path) == JA.get_audio_length(path)
        if path.lower().endswith(".wav"):
            assert PA.get_num_samples(path) == JA.get_num_samples(path)
    assert PA.decode_audio(stereo)[1] == 8000


@pytest.mark.parametrize("case", ["mixed", "short", "au", "level0"])
def test_inject_noise_equals_jax(noise_dir, tmp_path, case):
    """`short`: a noise file shorter than the utterance (zero-padded);
    `au`: the μ-law AU file; `level0`: level 0 returns the data."""
    d = noise_dir
    if case in ("short", "au"):
        d = str(tmp_path / case)
        os.makedirs(d)
        src = ("sub/short.WAV" if case == "short" else "hum.au")
        with open(os.path.join(noise_dir, src), "rb") as f, \
                open(os.path.join(d, os.path.basename(src)), "wb") as g:
            g.write(f.read())
    levels = (0.0, 0.0) if case == "level0" else (0.0, 0.5)
    jinj = JD.NoiseInjector(d, SR, levels)
    pinj = PD.NoiseInjector(d, SR, levels)
    data = tone(SR // 4, 9, 330)
    for seed in range(4):
        want = jinj.inject_noise(data, np.random.RandomState(seed))
        got = pinj.inject_noise(data, np.random.RandomState(seed))
        assert np.array_equal(got, want)
        if case == "level0":
            assert np.array_equal(got, data)
        else:
            assert not np.array_equal(got, data)
    with pytest.raises(IOError, match="Directory doesn't exist"):
        PD.NoiseInjector(str(tmp_path / "missing"))


@pytest.fixture(scope="module")
def two_corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joint"))
    a, labels = make_corpus(os.path.join(root, "a"), seed=1)
    b, _ = make_corpus(os.path.join(root, "b"), texts=["bab", "abc", "cc",
                                                       "acab"], seed=2)
    return [a, b], load_vocab(labels)[0]


def test_get_item_with_augment_and_noise_equals_jax(two_corpora, noise_dir):
    manifests, label2id = two_corpora
    kw = dict(sample_rate=SR, augment=True, noise_prob=0.4)
    jd = JD.ManifestDataset(manifests, label2id,
                            noise_injector=JD.NoiseInjector(noise_dir, SR),
                            **kw)
    pd = PD.ManifestDataset(manifests, label2id,
                            noise_injector=PD.NoiseInjector(noise_dir, SR),
                            **kw)
    for seed in range(8):
        (wy, wt), (gy, gt) = (d.get_item(seed % 4,
                                         np.random.RandomState(seed))
                              for d in (jd, pd))
        assert gt == wt and np.array_equal(gy, wy)


def _loaders_equal(two_corpora, noise_dir, num_workers, augment):
    manifests, label2id = two_corpora
    cfg = Config(batch_size=4, num_workers=num_workers)
    pcfg = TorchConfig.from_dict(cfg.to_dict())
    loaders = []
    for D, L, c in ((JD, JL, cfg), (PD, PL, pcfg)):
        noise = D.NoiseInjector(noise_dir, SR) if augment else None
        data = D.ManifestDataset(manifests, label2id, augment=augment,
                                 noise_injector=noise)
        loaders.append(L.AudioBatchLoader(
            data, c, sampler=L.BucketingSampler(len(data), 4, seed=7)))
    jl, pl = loaders
    assert pl.num_workers == num_workers
    for _ in range(2):
        for want, got in zip(jl, pl):
            assert got.pcm.dtype == np.int16
            assert np.array_equal(got.pcm, want.pcm)
            assert np.array_equal(got.targets, want.targets)
            assert np.array_equal(got.n_frames, want.n_frames)
            assert got.src_bucket == want.src_bucket


@pytest.mark.parametrize("num_workers,augment", [(0, False), (4, False),
                                                 (4, True)])
def test_loader_batches_equal_jax(two_corpora, noise_dir, num_workers,
                                  augment):
    """Two manifests, batch 4, sampler seed 7, two epochs: pcm (int16 on
    the wire), targets, n_frames and the bucket equal the JAX loader's."""
    _loaders_equal(two_corpora, noise_dir, num_workers, augment)


@pytest.mark.parametrize("num_workers", [0, 4])
def test_loader_batches_with_native_equal_jax(native_on, two_corpora,
                                              noise_dir, num_workers):
    """As above with --augment on the JAX package's default path: both
    C++ WSOLAs."""
    _loaders_equal(two_corpora, noise_dir, num_workers, True)
