"""On-device "pfft" spectrogram codec (port of ``ddim_audio_tpu/ops/stft.py``).

audio ⇄ a 2-channel complex-STFT tensor ``[..., 2, T, f_size]`` ("CTF" axis
order) with ``torch.fft`` on the tensor's own device. The codec is the one of
``data/codec.py`` (which holds ``STFTConfig``, the window and the numpy
twin): n_fft = 2·(f_size − 1), hop = n_fft / 2, so rfft yields exactly
f_size bins; a periodic Hann window at 50% overlap with the clip treated as
periodic (wrap padding by one hop), so every sample is covered by exactly two
windows and the overlap-add inverse is exact; channels (Re, Im) / (n_fft / 4).
"""

from __future__ import annotations

import torch

from ..data.codec import STFTConfig, _hann, num_samples

__all__ = ["STFTConfig", "num_samples", "stft_pfft", "istft_pfft"]


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.from_numpy(_hann(n_fft)).to(device)


def stft_pfft(wave: torch.Tensor, cfg: STFTConfig,
              t_size: int | None = None) -> torch.Tensor:
    """wave [..., N] float in [-1, 1] → pfft [..., 2, T, f_size] fp32.

    N must be a multiple of hop; T = N / hop. Frame k is centred at sample
    k·hop, with a periodic boundary (frame 0's left half wraps to the clip's
    tail)."""
    w = torch.as_tensor(wave).float()
    n_fft, hop = cfg.n_fft, cfg.hop
    n = w.shape[-1]
    if n % hop != 0:
        raise ValueError(f"audio length {n} must be a multiple of hop {hop}")
    t = n // hop
    if t_size is not None and t != t_size:
        raise ValueError(f"expected {t_size} frames, audio gives {t}")
    # n_fft = 2·hop: after wrap-padding one hop on the left, the frames are
    # two reshapes (frame k = segments k and k + 1), no gather
    wp = torch.cat([w[..., -hop:], w], dim=-1)
    segs = wp.reshape(wp.shape[:-1] + (t + 1, hop))
    frames = torch.cat([segs[..., :t, :], segs[..., 1:, :]], dim=-1)
    frames = frames * _window(n_fft, w.device)
    spec = torch.fft.rfft(frames, dim=-1) / cfg.scale  # exactly f_size bins
    return torch.stack([spec.real, spec.imag], dim=-3).float()


def istft_pfft(pfft: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """pfft [..., 2, T, f_size] → wave [..., T·hop] fp32: the exact inverse
    of ``stft_pfft``."""
    p = torch.as_tensor(pfft).float()
    n_fft, hop = cfg.n_fft, cfg.hop
    t = p.shape[-2]
    spec = torch.complex(p[..., 0, :, :], p[..., 1, :, :]) * cfg.scale
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    win = _window(n_fft, p.device)
    frames = frames * win  # synthesis window

    # overlap-add by reshapes: frame k's left hop lands at [(k−1)·hop, k·hop)
    # (frame 0's wraps to the clip's tail), its right hop at [k·hop, (k+1)·hop)
    lead = frames.shape[:-2]
    left = frames[..., :hop].reshape(lead + (t * hop,))
    right = frames[..., hop:].reshape(lead + (t * hop,))
    out = torch.cat([right[..., : (t - 1) * hop] + left[..., hop:],
                     right[..., (t - 1) * hop:] + left[..., :hop]], dim=-1)
    wl, wr = win[:hop], win[hop:]
    return out / (wl * wl + wr * wr).repeat(t)
