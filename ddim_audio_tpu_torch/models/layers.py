"""Primitive layers over param dicts (port of ``ddim_audio_tpu/models/layers.py``).

Activations are channels-last [B, T, F, C] as in the JAX package. Weights keep
the JAX package's storage:

- conv:            HWIO ``[kh, kw, in, out]``
- conv_transpose:  HWIO of the *equivalent forward conv on the dilated
                   input* — spatially flipped and in/out-swapped relative to
                   torch's ``[in, out, kh, kw]`` ConvTranspose2d weight
- linear:          ``[in, out]``

Initializers draw from the same bounds as the JAX package (torch's
kaiming-uniform with a = sqrt(5)) from an explicit ``torch.Generator``; the
numbers differ from JAX's, the shapes and bounds do not.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv_strided import up_weight_to_torch


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


def conv_init(gen, kh, kw, cin, cout, *, bias=True, device):
    bound = 1.0 / math.sqrt(cin * kh * kw)
    p = {"w": _uniform(gen, (kh, kw, cin, cout), bound, device)}
    if bias:
        p["b"] = _uniform(gen, (cout,), bound, device)
    return p


def conv_transpose_init(gen, kh, kw, cin, cout, *, bias=True, device):
    # torch ConvTranspose2d fan_in (of its [in,out,kh,kw] weight) = out·kh·kw
    bound = 1.0 / math.sqrt(cout * kh * kw)
    p = {"w": _uniform(gen, (kh, kw, cin, cout), bound, device)}
    if bias:
        p["b"] = _uniform(gen, (cout,), bound, device)
    return p


def linear_init(gen, cin, cout, *, bias=True, device):
    bound = 1.0 / math.sqrt(cin)
    p = {"w": _uniform(gen, (cin, cout), bound, device)}
    if bias:
        p["b"] = _uniform(gen, (cout,), bound, device)
    return p


def group_norm_init(channels, *, bias=True, zero_weight=False, device):
    fill = torch.zeros if zero_weight else torch.ones
    p = {"g": fill(channels, device=device)}
    if bias:
        p["b"] = torch.zeros(channels, device=device)
    return p


def layer_norm_init(channels, device):
    return {"g": torch.ones(channels, device=device),
            "b": torch.zeros(channels, device=device)}


def _nchw(x):
    # contiguous: oneDNN's fp32 conv sums less accurately on channels-last
    # views (see ops/conv_flat.py::_nchw)
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv_apply(p, x, *, stride=1, padding=1):
    """2-D conv over NHWC x with an HWIO weight; symmetric int padding."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1).contiguous()
    out = _nhwc(F.conv2d(_nchw(x), w, stride=stride, padding=padding))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def conv_transpose_apply(p, x, *, stride=2, padding=1):
    """torch ConvTranspose2d(k, s, p) semantics, out = (in−1)·s − 2p + k, from
    the stored equivalent-forward kernel (flipped back to torch's layout)."""
    w = up_weight_to_torch(p["w"].to(x.dtype)).contiguous()
    out = _nhwc(F.conv_transpose2d(_nchw(x), w, stride=stride,
                                   padding=padding))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def linear_apply(p, x):
    out = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def group_norm_apply(p, x, *, num_groups=8, eps=1e-6):
    """GroupNorm over NHWC: stats per (sample, group) over (T, F, C/G), as
    torch.nn.GroupNorm(num_groups, C, eps=1e-6)."""
    b, t, f, c = x.shape
    xg = x.reshape(b, t, f, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, f, c)
    x = x * p["g"].to(x.dtype)
    if "b" in p:
        x = x + p["b"].to(x.dtype)
    return x


def layer_norm_apply(p, x, *, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return x * p["g"].to(x.dtype) + p["b"].to(x.dtype)


def gelu_new(x):
    """HF "gelu_new": tanh-approximate GELU."""
    return F.gelu(x, approximate="tanh")


def dropout(generator, x, rate: float, *, train: bool):
    """Inverted dropout: keep with probability 1 − rate, scale by 1 / keep.
    The identity unless ``train`` with a generator and a non-zero rate. The
    mask is drawn on the generator's device."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def sinusoid_table(length: int, channels: int, dtype=np.float32) -> np.ndarray:
    """Interleaved sin/cos table: table[p, 2k] = sin(p·exp(−2k·ln(1e4)/C)),
    table[p, 2k+1] = cos(same). Host numpy, computed in the target dtype as
    the JAX package does."""
    position = np.arange(length, dtype=dtype)[:, None]
    div_term = np.exp(
        np.arange(0, channels, 2, dtype=dtype) * dtype(-math.log(10000.0) / channels)
    )
    x = position * div_term
    table = np.zeros((length, channels), dtype=dtype)
    table[:, 0::2] = np.sin(x)
    table[:, 1::2] = np.cos(x)
    return table


@functools.lru_cache(maxsize=32)
def sinusoid_on(length: int, channels: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """``sinusoid_table`` as a tensor on device, made once per (shape,
    device, dtype) so the forward does no host → device copy."""
    return torch.from_numpy(sinusoid_table(length, channels)).to(device, dtype)
