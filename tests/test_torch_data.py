"""The port's own copies of the numpy data path (``data/codec.py``,
``data/audio_dataset.py``) against the JAX package's, on seed-made ``.npy``
and ``.wav`` files: the same split and batch order, and the same arrays, bit
for bit from ``.npy`` files (the code is the same numpy arithmetic). ``.wav``
files are held to 2e-5 absolute: the JAX package decodes them through its
native library where that is built, the port through scipy, and the two
scale integers and interpolate in another order of operations."""

from types import SimpleNamespace

import numpy as np
import pytest
from scipy.io import wavfile

from ddim_audio_tpu.data import audio_dataset as jds
from ddim_audio_tpu.data import codec as jcodec
from ddim_audio_tpu.ops.stft import STFTConfig as JSTFTConfig
from ddim_audio_tpu_torch.data import audio_dataset as ds
from ddim_audio_tpu_torch.data import codec

F_SIZE, T_SIZE, SR = 16, 8, 16000
WINDOW = T_SIZE * (F_SIZE - 1)
WAV_ATOL = 2e-5


def _same(got, ref, path, msg=""):
    if path.endswith(".npy"):
        np.testing.assert_array_equal(got, ref, err_msg=msg)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=WAV_ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """11 files: .npy of one, two and a half windows, .wav in int16 / float32,
    mono / stereo, at the target rate and at another one."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    for i, n in enumerate((WINDOW, 2 * WINDOW + 7, WINDOW // 2, 3 * WINDOW,
                           WINDOW, WINDOW + 1)):
        np.save(root / f"n{i}.npy", (0.3 * rng.standard_normal(n)).astype(np.float32))
    (root / "sub").mkdir()
    wavfile.write(root / "sub" / "a.wav", SR,
                  (3000 * rng.standard_normal(2 * WINDOW)).astype(np.int16))
    wavfile.write(root / "sub" / "b.wav", SR,
                  (0.2 * rng.standard_normal((WINDOW, 2))).astype(np.float32))
    wavfile.write(root / "c.wav", 8000,
                  (3000 * rng.standard_normal(WINDOW)).astype(np.int16))
    wavfile.write(root / "d.wav", SR,
                  (3000 * rng.standard_normal((WINDOW, 2))).astype(np.int16))
    wavfile.write(root / "e.wav", 22050,
                  (0.2 * rng.standard_normal(100)).astype(np.float32))
    return str(root)


def _datasets(folder):
    kw = dict(f_size=F_SIZE, t_size=T_SIZE, virtual_samplerate=SR, axis="CTF",
              HPI=False)
    return ds.AudioDataset(folder, **kw), jds.AudioDataset(folder, **kw)


def test_wav2pfft_and_round_trip():
    rng = np.random.default_rng(1)
    wave = (0.5 * rng.standard_normal(WINDOW)).astype(np.float32)
    cfg, jcfg = codec.STFTConfig(f_size=F_SIZE), JSTFTConfig(f_size=F_SIZE)
    assert codec.num_samples(cfg, T_SIZE) == WINDOW
    got, ref = codec.wav2pfft(wave, cfg, T_SIZE), jcodec.wav2pfft(wave, jcfg, T_SIZE)
    assert got.shape == (2, T_SIZE, F_SIZE) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(codec.pfft_to_wave(got, cfg), wave, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of hop"):
        codec.wav2pfft(wave[:-1], cfg)
    with pytest.raises(ValueError, match="expected"):
        codec.wav2pfft(wave, cfg, T_SIZE + 1)


def test_read_audio_and_audio_length(folder):
    import os

    for root, _, names in os.walk(folder):
        for name in sorted(names):
            path = os.path.join(root, name)
            got, ref = codec.read_audio(path, SR), jcodec.read_audio(path, SR)
            assert got.dtype == np.float32 and got.ndim == 1
            _same(got, ref, path, name)
            assert ds.audio_length(path, SR) == jds.audio_length(path, SR)
            # header-only length is the decoded length (resampling rounds)
            assert abs(ds.audio_length(path, SR) - len(got)) <= 1, name
    assert ds.audio_length(os.path.join(folder, "missing.wav"), SR) is None


def test_dataset_windows_and_padding(folder):
    got, ref = _datasets(folder)
    # windows: c.wav 2, d.wav 1, e.wav 1 (short: padded), n0-n5 1 2 1 3 1 1,
    # sub/a.wav 2, sub/b.wav 1
    assert len(got) == len(ref) == 16
    assert got._items == ref._items
    for i in range(len(ref)):
        (a, la), (b, lb) = got[i], ref[i]
        assert a.shape == (2, T_SIZE, F_SIZE) and la == lb == 0
        _same(a, b, got._items[i][0], str(i))
    short = [i for i, (path, _) in enumerate(got._items)
             if path.endswith("n2.npy")]
    wave = codec.pfft_to_wave(got[short[0]][0], got.cfg)
    assert wave.shape == (WINDOW,)
    assert np.abs(wave[:WINDOW // 2]).max() > 0.1
    assert np.abs(wave[WINDOW // 2:]).max() < 1e-5  # the zero-padded tail
    with pytest.raises(NotImplementedError):
        ds.AudioDataset(folder, axis="TFC")
    with pytest.raises(FileNotFoundError):
        ds.AudioDataset(folder + "/sub/..//sub/nothing_here")


def test_split_indices_and_rng_state(folder):
    config = SimpleNamespace(data=SimpleNamespace(
        dataset="AUDIO", path=folder, dataset_kwargs=SimpleNamespace(
            f_size=F_SIZE, t_size=T_SIZE, virtual_samplerate=SR, axis="CTF",
            HPI=False)))
    np.random.seed(77)
    before = np.random.get_state()[1].copy()
    train, test = ds.get_dataset(None, config)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
    jtrain, jtest = jds.get_dataset(None, config)
    assert train.indices == jtrain.indices and test.indices == jtest.indices
    assert len(train) == 14 and len(test) == 2
    assert sorted(train.indices + test.indices) == list(range(16))
    np.testing.assert_allclose(test[0][0], jtest[0][0], rtol=0, atol=WAV_ATOL)
    for bad, error in (("/no/such/dir", NotADirectoryError), (None, Exception)):
        config.data.path = bad
        with pytest.raises(error):
            ds.get_dataset(None, config)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_iterator_order(folder, num_workers, shuffle):
    got, ref = _datasets(folder)
    kw = dict(shuffle=shuffle, seed=5)
    batches = list(ds.batch_iterator(got, 5, num_workers=num_workers, **kw))
    want = list(jds.batch_iterator(ref, 5, num_workers=0, **kw))
    assert [b[0].shape[0] for b in batches] == [5, 5, 5, 1]
    for (x, y), (rx, ry) in zip(batches, want):
        np.testing.assert_allclose(x, rx, rtol=0, atol=WAV_ATOL)
        assert y.dtype == np.int32 and not y.any() and y.shape == ry.shape
    dropped = list(ds.batch_iterator(got, 5, drop_last=True,
                                     num_workers=num_workers, **kw))
    assert len(dropped) == 3
    if shuffle:
        other = list(ds.batch_iterator(got, 5, shuffle=True, seed=6))
        assert not np.array_equal(other[0][0], batches[0][0])
