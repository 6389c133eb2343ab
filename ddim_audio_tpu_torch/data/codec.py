"""Host-side pfft codec for dataset loading and the final export (numpy;
port of ``ddim_audio_tpu/data/codec.py`` with ``STFTConfig``/``_hann``/
``num_samples`` from ``ddim_audio_tpu/ops/stft.py``).

- ``wav2pfft(wave [N], cfg, t_size) → pfft [2, T, f_size]`` — the encoder
- ``read_audio(path, samplerate)`` — ``.npy`` waveforms, ``.wav`` through
  scipy, linearly resampled
- ``pfft2img(img [F, T, C]) → uint8 [F, T]`` — PNG-able spectrogram render
- ``limit_length_img(img)`` — caps the rendered width
- ``pfft2wav(img [F, T, C], samplerate, dtype=np.int32, HPI=False) → int PCM``

The axis order at these call sites is [F, T, C] (the runner permutes
[N, C, T, F] → [N, F, T, C] before export). The codec: n_fft = 2·(f_size − 1),
hop = n_fft / 2, periodic Hann window at 50% overlap with wrap padding,
channels (Re, Im) / (n_fft / 4) — exactly invertible.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    f_size: int = 256
    virtual_samplerate: int = 48000
    # HPI flag kept for config-surface parity (configs/audio.yml:7,73); this
    # codec stores the full complex STFT so inversion never needs phase
    # reconstruction — both HPI settings decode identically.
    HPI: bool = False

    @property
    def n_fft(self) -> int:
        return 2 * (self.f_size - 1)

    @property
    def hop(self) -> int:
        return self.f_size - 1

    @property
    def scale(self) -> float:
        return self.n_fft / 4.0


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int) -> np.ndarray:
    # periodic Hann
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(
        np.float32
    )


def num_samples(cfg: STFTConfig, t_size: int) -> int:
    """Audio samples consumed/produced for t_size frames."""
    return t_size * cfg.hop


def wav2pfft(wave: np.ndarray, cfg: STFTConfig,
             t_size: int | None = None) -> np.ndarray:
    """wave [N] float in [-1, 1] → pfft [2, T, f_size] float32 ("CTF")."""
    w = np.asarray(wave, np.float32)
    n_fft, hop = cfg.n_fft, cfg.hop
    n = w.shape[-1]
    if n % hop != 0:
        raise ValueError(f"audio length {n} must be a multiple of hop {hop}")
    t = n // hop
    if t_size is not None and t != t_size:
        raise ValueError(f"expected {t_size} frames, audio gives {t}")
    wp = np.concatenate([w[..., -hop:], w], axis=-1)
    segs = wp.reshape(wp.shape[:-1] + (t + 1, hop))
    frames = np.concatenate([segs[..., :t, :], segs[..., 1:, :]], axis=-1)
    frames = frames * _hann(n_fft)
    spec = np.fft.rfft(frames, axis=-1) / cfg.scale  # exactly f_size bins
    return np.stack([spec.real, spec.imag], axis=-3).astype(np.float32)


def pfft_to_wave(pfft: np.ndarray, cfg: STFTConfig) -> np.ndarray:
    """pfft [..., 2, T, f_size] ("CTF") → wave [..., T·hop] float32."""
    p = np.asarray(pfft, np.float32)
    n_fft, hop = cfg.n_fft, cfg.hop
    t = p.shape[-2]
    spec = (p[..., 0, :, :] + 1j * p[..., 1, :, :]) * cfg.scale
    frames = np.fft.irfft(spec, n=n_fft, axis=-1)
    win = _hann(n_fft)
    frames = frames * win

    lead = frames.shape[:-2]
    left = frames[..., :hop].reshape(lead + (t * hop,))
    right = frames[..., hop:].reshape(lead + (t * hop,))
    out = np.concatenate(
        [right[..., : (t - 1) * hop] + left[..., hop:],
         right[..., (t - 1) * hop :] + left[..., :hop]],
        axis=-1,
    )
    wl, wr = win[:hop], win[hop:]
    den = np.tile(wl * wl + wr * wr, t)
    return (out / den).astype(np.float32)


def pfft2wav(
    img: np.ndarray,
    samplerate: int | None = None,
    dtype=np.int32,
    HPI: bool = False,
) -> np.ndarray:
    """pfft [F, T, C] → integer PCM (reference call:
    runners/diffusion.py:410-415). Float wave is clipped to [-1, 1] then
    scaled to the integer range."""
    img = np.asarray(img)
    f, t, c = img.shape
    cfg = STFTConfig(f_size=f, HPI=HPI)
    p = np.transpose(img, (2, 1, 0))  # [C, T, F]
    wave = pfft_to_wave(p, cfg)
    info = np.iinfo(dtype)
    # float64 + clip to the integer range: float32·int32.max rounds past the
    # representable max and overflows the cast
    scaled = np.clip(wave.astype(np.float64), -1.0, 1.0) * info.max
    return np.clip(scaled, info.min, info.max).astype(dtype)


def pfft2img(img: np.ndarray, *, db_floor: float = -80.0) -> np.ndarray:
    """pfft [F, T, C] → uint8 [F, T] spectrogram render (log magnitude,
    low frequencies at the bottom row like the usual spectrogram view)."""
    img = np.asarray(img, np.float32)
    mag = np.sqrt(np.sum(np.square(img), axis=-1))  # [F, T]
    db = 20.0 * np.log10(np.maximum(mag, 1e-8))
    top = max(float(db.max()), db_floor + 1.0)
    db = np.clip(db, top + db_floor, top)
    u8 = ((db - (top + db_floor)) / (-db_floor) * 255.0).astype(np.uint8)
    return u8[::-1]  # flip so low frequencies render at the bottom


def limit_length_img(img: np.ndarray, max_len: int = 4096) -> np.ndarray:
    """Cap the time-axis width of a rendered spectrogram (reference call:
    runners/diffusion.py:409)."""
    if img.shape[1] > max_len:
        return img[:, :max_len]
    return img


def read_audio(path: str, target_samplerate: int) -> np.ndarray:
    """Load .wav or .npy (raw float waveform) → float32 [-1, 1] mono,
    linearly resampled to target_samplerate. WAVs decode through scipy."""
    if path.endswith(".npy"):
        wave = np.asarray(np.load(path), np.float32)
        sr = target_samplerate
    else:
        from scipy.io import wavfile

        sr, wave = wavfile.read(path)
        if wave.dtype.kind == "i":
            wave = wave.astype(np.float32) / np.iinfo(wave.dtype).max
        elif wave.dtype.kind == "u":
            info = np.iinfo(wave.dtype)
            wave = (wave.astype(np.float32) - info.max / 2) / (info.max / 2)
        else:
            wave = wave.astype(np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=1)
    if sr != target_samplerate:
        n_out = int(round(len(wave) * target_samplerate / sr))
        x_old = np.linspace(0.0, 1.0, len(wave), endpoint=False)
        x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
        wave = np.interp(x_new, x_old, wave).astype(np.float32)
    return wave
