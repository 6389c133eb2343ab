"""The port's on-device STFT codec (``ops/stft.py``) and its native WAV
decoder (``data/native_io.py``) against the JAX package's:

- ``stft_pfft`` / ``istft_pfft`` against JAX's ``ops/stft.py`` within 2e-5
  absolute (tests/test_codec_data.py's tolerance), one clip and a batch of
  three, and the exact inverse;
- the port's binding of ``native/audio_io.cpp`` (built into the port's own
  ``build/``) against the JAX package's binding on 8-, 16- and 32-bit
  PCM, stereo and float WAVs, at the file's rate and resampled: bit for bit
  (the same C++ code);
- ``read_audio`` on ``.wav`` bit for bit against JAX's ``read_audio``.

The native cases skip where the library cannot be built (no C++ compiler),
as the JAX package's own tests do."""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from ddim_audio_tpu.data import codec as jcodec
from ddim_audio_tpu.data import native_io as jnative
from ddim_audio_tpu.ops import stft as jstft
from ddim_audio_tpu_torch.data import codec, native_io
from ddim_audio_tpu_torch.ops import stft

CFG = stft.STFTConfig(f_size=64)
JCFG = jstft.STFTConfig(f_size=64)
ATOL = 2e-5

@pytest.fixture(scope="module")
def native():
    """Both packages' native libraries, built at first use; the native
    cases skip where they cannot be built (decided here, not at import)."""
    if not (native_io.available() and jnative.available()):
        pytest.skip("the native audio library cannot be built here")


def _waves(batch, frames, seed=0):
    rng = np.random.default_rng(seed)
    n = stft.num_samples(CFG, frames)
    t = np.arange(n) / 16000.0
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    return (tone + 0.1 * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.mark.parametrize("shape", [(), (3,)], ids=["one", "batch3"])
def test_stft_matches_jax(shape):
    waves = _waves(int(np.prod(shape)) if shape else 1, 16).reshape(
        shape + (-1,))
    got = stft.stft_pfft(torch.from_numpy(waves), CFG, 16)
    ref = np.asarray(jstft.stft_pfft(jnp.asarray(waves), JCFG, 16))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == shape + (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(), (3,)], ids=["one", "batch3"])
def test_istft_matches_jax_and_inverts(shape):
    waves = _waves(int(np.prod(shape)) if shape else 1, 8, seed=1).reshape(
        shape + (-1,))
    p = codec.wav2pfft(waves, CFG) if not shape else np.stack(
        [codec.wav2pfft(w, CFG) for w in waves])
    got = stft.istft_pfft(torch.from_numpy(p), CFG).numpy()
    ref = np.asarray(jstft.istft_pfft(jnp.asarray(p), JCFG))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, waves, rtol=0, atol=1e-4)  # exact codec


def test_stft_refuses_ragged_audio():
    with pytest.raises(ValueError, match="multiple of hop"):
        stft.stft_pfft(torch.zeros(100), CFG)
    with pytest.raises(ValueError, match="expected 4 frames"):
        stft.stft_pfft(torch.zeros(stft.num_samples(CFG, 8)), CFG, 4)


def _pcm(kind, wave):
    if kind == "u8":
        return np.clip(wave * 127 + 128, 0, 255).astype(np.uint8)
    if kind == "i16":
        return (wave * 32767).astype(np.int16)
    if kind == "i32":
        return (wave * 2147483000).astype(np.int32)
    if kind == "f32":
        return wave.astype(np.float32)
    if kind == "stereo":
        return (np.stack([wave, 0.5 * wave], axis=1) * 32767).astype(np.int16)
    raise ValueError(kind)


KINDS = ["u8", "i16", "i32", "f32", "stereo"]


def _write(tmp_path, kind, sr=22050):
    wave = _waves(1, 50, seed=2)[0] * 0.9
    path = str(tmp_path / f"{kind}.wav")
    wavfile.write(path, sr, _pcm(kind, wave))
    return path


@pytest.mark.parametrize("target", [22050, 16000], ids=["same", "resample"])
@pytest.mark.parametrize("kind", KINDS)
def test_native_load_wav_matches_jax(native, tmp_path, kind, target):
    path = _write(tmp_path, kind)
    got = native_io.load_wav(path, target)
    ref = jnative.load_wav(path, target)
    assert got.dtype == ref.dtype == np.float32 and len(got) == len(ref)
    np.testing.assert_array_equal(got, ref)


def test_native_library_is_the_ports_own(native):
    """Built into the port's git-ignored build/ folder from the JAX
    package's C++ source, named by the source's hash."""
    lib = native_io._build()
    assert lib.parent == native_io.BUILD_DIR
    assert lib.name.startswith("libaudio_io_") and lib.suffix == ".so"
    assert native_io.SOURCE.name == "audio_io.cpp"


def test_native_corrupt_file_raises(native, tmp_path):
    path = _write(tmp_path, "i16")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(open(path, "rb").read()[:10])
    with pytest.raises(ValueError, match="native WAV decode failed"):
        native_io.load_wav(str(bad), 16000)


@pytest.mark.parametrize("kind", KINDS)
def test_read_audio_wav_bit_equal_to_jax(native, tmp_path, kind):
    path = _write(tmp_path, kind)
    for target in (22050, 16000):
        got = codec.read_audio(path, target)
        ref = jcodec.read_audio(path, target)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_read_audio_falls_back_to_scipy(tmp_path, monkeypatch):
    """Without the library, .wav decodes through scipy (within 1e-4 of the
    native decode at the same rate, the JAX package's own test)."""
    path = _write(tmp_path, "i16")
    monkeypatch.setattr(native_io, "available", lambda: False)
    got = codec.read_audio(path, 22050)
    ref = jcodec.read_audio(path, 22050)
    assert got.dtype == np.float32 and len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
