"""Strided stage transitions over the flat channels-last state.

- ``conv_down_flat``: k4 s2 p1 conv, C_in → C_out, (T, F) → (T/2, F/2),
  + bias, optional per-channel (sum, sum²) of the fp32 output. Port of the
  TPU kernel ``ddim_audio_tpu/ops/pallas/conv_strided.py::_down_kernel``
  (wrapper ``conv_down_flat``), float taps.
- ``conv_up_flat``: transposed k4 s2 p1 conv (torch ConvTranspose2d
  semantics), C_in → C_out, (T, F) → (2T, 2F), + bias, + the fused skip
  ``residual``, statistics of the SUMMED output. Port of
  ``conv_strided.py::_up_kernel`` (wrapper ``conv_up_flat``), float taps.
  Its weight is the stored equivalent-forward kernel (spatially flipped
  HWIO, ``models/layers.py``).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/conv_strided.cu``); on a CPU tensor it runs its plain PyTorch twin
(``*_plain``). No fallback from one to the other. bf16 transitions at the
audio.yml widths run their taps on the tensor cores (WMMA); fp32 and the
narrowest bf16 geometries run on CUDA cores (what bounds each: the note at
the top of ``csrc/conv_strided.cu``). Statistics come from per-block partials
finished by ``torch.sum`` (deterministic).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cuda import (
    check,
    check_operand,
    kernels,
    ptr,
    require_cuda_dtype,
    stream_ptr,
    twin_result,
    use_twin,
)
from .conv_flat import _finish, _nchw, wide_dtype


def _bias(bias, c_out: int, device, dtype=torch.float32) -> torch.Tensor:
    bias = torch.as_tensor(bias, dtype=dtype, device=device)
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must be [{c_out}], got {tuple(bias.shape)}")
    return bias.contiguous()


def up_weight_to_torch(w: torch.Tensor) -> torch.Tensor:
    """Stored equivalent-forward HWIO [4, 4, C_in, C_out] → torch
    ConvTranspose2d weight [C_in, C_out, 4, 4] (flip back)."""
    return w.permute(2, 3, 0, 1).flip(2, 3)


def conv_down_flat_plain(x, w, bias, *, c_in: int, c_out: int,
                         want_stats: bool = False):
    """Plain twin of ``conv_down_flat``: ``F.conv2d`` (stride 2, pad 1) in
    fp32 on the stored operands."""
    out = F.conv2d(_nchw(x, c_in),
                   w.to(wide_dtype(x)).permute(3, 2, 0, 1).contiguous(),
                   stride=2, padding=1).permute(0, 2, 3, 1)
    out = out + _bias(bias, c_out, x.device, out.dtype)
    return _finish(out, x.dtype, want_stats)


def conv_up_flat_plain(x, w, bias, *, c_in: int, c_out: int, residual=None,
                       want_stats: bool = False):
    """Plain twin of ``conv_up_flat``: ``F.conv_transpose2d`` (stride 2,
    pad 1) in fp32, + bias, + residual, statistics of the sum."""
    out = F.conv_transpose2d(_nchw(x, c_in),
                             up_weight_to_torch(
                                 w.to(wide_dtype(x))).contiguous(),
                             stride=2, padding=1).permute(0, 2, 3, 1)
    out = out + _bias(bias, c_out, x.device, out.dtype)
    if residual is not None:
        b, t2, f2, _ = out.shape
        out = out + residual.float().view(b, t2, f2, c_out)
    return _finish(out, x.dtype, want_stats)


def _geometry(x, c_in: int, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c_in or c_in % 8:
        raise ValueError(f"{name} kernel: needs F·C_in % C_in == 0 and "
                         f"C_in % 8 == 0, got F·C_in={fc}, C_in={c_in}")
    return b, t, fc // c_in


def conv_down_flat(x, w, bias, *, c_in: int, c_out: int,
                   want_stats: bool = False):
    """x: [B, T, F·C_in] → [B, T/2, (F/2)·C_out]; w: [4, 4, C_in, C_out] HWIO
    in x's dtype; bias: [C_out] fp32. Returns out, or (out, sum [B, C_out],
    sum² [B, C_out]) when want_stats."""
    if use_twin(x):
        kw = dict(c_in=c_in, c_out=c_out, want_stats=want_stats)
        return twin_result("conv_down_flat",
                           conv_down_flat_plain(x, w, bias, **kw), x,
                           lambda: conv_down_flat(x, w, bias, **kw))
    b, t, f = _geometry(x, c_in, "conv_down_flat")
    if t % 2 or f % 2:
        raise ValueError(f"conv_down_flat: T={t} and F={f} must be even")
    bf16 = require_cuda_dtype(x, "conv_down_flat")
    dev = x.device
    check_operand(x, "x", device=dev)
    check_operand(w, "w", device=dev, dtype=x.dtype,
                  shape=(4, 4, c_in, c_out))
    bias = _bias(bias, c_out, dev)
    out = torch.empty((b, t // 2, (f // 2) * c_out), dtype=x.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        lib = kernels()
        stats = None
        if want_stats:
            tiles = lib.ddim_conv_down_tiles(t, f, c_in, c_out, bf16)
            stats = torch.empty((b, tiles, 2, c_out), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv_down(
            ptr(x), ptr(w), ptr(bias), ptr(out), ptr(stats), b, t, f, c_in,
            c_out, bf16, stream_ptr(x))
    check(err, "conv_down_flat")
    conv_down_flat.launches += 1
    if not want_stats:
        return out
    tot = stats.sum(dim=1)
    return out, tot[:, 0], tot[:, 1]


def conv_up_flat(x, w, bias, *, c_in: int, c_out: int, residual=None,
                 want_stats: bool = False):
    """x: [B, T, F·C_in] → [B, 2T, (2F)·C_out]; w: [4, 4, C_in, C_out]
    equivalent-forward HWIO in x's dtype; bias: [C_out] fp32; residual:
    optional [B, 2T, 2F·C_out] skip in x's dtype added in the epilogue.
    Returns out, or (out, sum, sum²) of the summed fp32 output."""
    if use_twin(x):
        kw = dict(c_in=c_in, c_out=c_out, residual=residual,
                  want_stats=want_stats)
        return twin_result("conv_up_flat",
                           conv_up_flat_plain(x, w, bias, **kw), x,
                           lambda: conv_up_flat(x, w, bias, **kw))
    b, t, f = _geometry(x, c_in, "conv_up_flat")
    bf16 = require_cuda_dtype(x, "conv_up_flat")
    dev = x.device
    out_shape = (b, 2 * t, 2 * f * c_out)
    check_operand(x, "x", device=dev)
    check_operand(w, "w", device=dev, dtype=x.dtype,
                  shape=(4, 4, c_in, c_out))
    check_operand(residual, "residual", device=dev, dtype=x.dtype,
                  shape=out_shape)
    bias = _bias(bias, c_out, dev)
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        lib = kernels()
        stats = None
        if want_stats:
            tiles = lib.ddim_conv_up_tiles(t, f, c_in, c_out, bf16)
            stats = torch.empty((b, tiles, 2, c_out), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv_up(
            ptr(x), ptr(w), ptr(bias), ptr(residual), ptr(out), ptr(stats),
            b, t, f, c_in, c_out, bf16, stream_ptr(x))
    check(err, "conv_up_flat")
    conv_up_flat.launches += 1
    if not want_stats:
        return out
    tot = stats.sum(dim=1)
    return out, tot[:, 0], tot[:, 1]


conv_down_flat.launches = 0
conv_up_flat.launches = 0
