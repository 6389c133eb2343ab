"""FNet transformer bottleneck (port of ``ddim_audio_tpu/models/fnet.py``).

Each layer: ``f = LN(x + Re(FFT2(x)))``, ``y = LN(f + W_out(gelu_new(W_in f)))``
(HF FNetEncoder; with ``train=True`` and a generator, dropout acts on each
layer's feed-forward output and after the embedding projection, the two
sites of the JAX package). ``Re(FFT2)`` has both of
the JAX package's implementations: ``dft_matmul`` (real matmuls against
float64-built cos/sin matrices, run in full fp32 — TF32 would lose the
Fourier mixing's precision) and ``fft`` (``torch.fft.fft2``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .layers import (
    dropout,
    gelu_new,
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
    sinusoid_on,
)


@functools.lru_cache(maxsize=32)
def _dft_cos_sin(n: int):
    """Real/imag parts of the DFT matrix F[k,m] = exp(−2πi·k·m/n), built in
    float64 on the host, stored as float32."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    theta = 2.0 * np.pi * (k * m % n) / n
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


def fourier_real_fft2(x):
    """Re(FFT over (seq, hidden)). x: [B, S, H] real."""
    return torch.fft.fft2(x.float(), dim=(1, 2)).real.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _dft_on(n: int, device: torch.device, dtype: torch.dtype):
    """The cos/sin DFT matrices as tensors on device, made once: a host →
    device copy per call would stall the host on every FNet layer."""
    return tuple(torch.from_numpy(a).to(device, dtype) for a in _dft_cos_sin(n))


def fourier_real_dft_matmul(x):
    """Re(F_s · x · F_h) = (C_s·x)·C_h − (S_s·x)·S_h as fp32 matmuls."""
    _, s, h = x.shape
    cs, ss = _dft_on(s, x.device, x.dtype)
    ch, sh = _dft_on(h, x.device, x.dtype)
    return torch.matmul(torch.matmul(cs, x), ch) - torch.matmul(torch.matmul(ss, x), sh)


_FOURIER_IMPLS = {
    "fft": fourier_real_fft2,
    "dft_matmul": fourier_real_dft_matmul,
}


def fnet_layer_init(gen, hidden: int, intermediate: int, device):
    return {
        "ln_fourier": layer_norm_init(hidden, device),
        "dense_in": linear_init(gen, hidden, intermediate, device=device),
        "dense_out": linear_init(gen, intermediate, hidden, device=device),
        "ln_out": layer_norm_init(hidden, device),
    }


def fnet_layer_apply(p, x, *, eps, fourier, drop_rate=0.0, train=False,
                     generator=None):
    f = layer_norm_apply(p["ln_fourier"], x + fourier(x), eps=eps)
    y = linear_apply(p["dense_out"], gelu_new(linear_apply(p["dense_in"], f)))
    y = dropout(generator, y, drop_rate, train=train)
    return layer_norm_apply(p["ln_out"], f + y, eps=eps)


def fnet_encoder_init(gen, tcfg, device):
    kw = tcfg.kwargs
    return {"layers": [fnet_layer_init(gen, kw.hidden_size, kw.intermediate_size,
                                       device=device)
                       for _ in range(kw.num_hidden_layers)]}


def fnet_encoder_apply(p, x, *, tcfg, train=False, generator=None):
    fourier = _FOURIER_IMPLS[getattr(tcfg, "fourier_impl", "dft_matmul")]
    for layer in p["layers"]:
        x = fnet_layer_apply(layer, x, eps=tcfg.kwargs.layer_norm_eps,
                             fourier=fourier,
                             drop_rate=tcfg.kwargs.hidden_dropout_prob,
                             train=train, generator=generator)
    return x


ENCODER_REGISTRY = {
    "fnet": (fnet_encoder_init, fnet_encoder_apply),
    "FNetEncoder": (fnet_encoder_init, fnet_encoder_apply),
}


def transformer_module_init(gen, io_channels: int, tcfg, device):
    enc_init, _ = ENCODER_REGISTRY[tcfg.module]
    return {
        "embedding": {
            "ln": layer_norm_init(io_channels, device),
            "projection": linear_init(gen, io_channels, tcfg.channels,
                                      device=device),
        },
        "encoder": enc_init(gen, tcfg, device=device),
        "compute_out": linear_init(gen, tcfg.channels, io_channels,
                                   device=device),
    }


def transformer_module_apply(p, x, *, tcfg, train=False, generator=None):
    """x: [B, S, io_channels] → same shape. Positional table sized to the
    next power of two of S (as the JAX package). Dropout (``train`` with a
    generator) follows the embedding projection and each layer's
    feed-forward."""
    _, s, c = x.shape
    pow2 = 1 << max(0, (s - 1).bit_length())
    te = sinusoid_on(pow2, c, x.device, x.dtype)[:s]
    x = layer_norm_apply(p["embedding"]["ln"], x + te,
                         eps=tcfg.kwargs.layer_norm_eps)
    x = linear_apply(p["embedding"]["projection"], x)
    x = dropout(generator, x, tcfg.kwargs.hidden_dropout_prob, train=train)
    _, enc_apply = ENCODER_REGISTRY[tcfg.module]
    x = enc_apply(p["encoder"], x, tcfg=tcfg, train=train,
                  generator=generator)
    return linear_apply(p["compute_out"], x)
