"""Fused 3×3 SAME conv over the flat channels-last state [B, T, F·C].

``conv3x3_flat`` is the port of the TPU kernel
``ddim_audio_tpu/ops/pallas/conv_flat.py::_conv_kernel`` (its wrapper
``conv3x3_flat``), float taps. On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/conv3x3.cu``; on a CPU tensor it runs the plain PyTorch
twin ``conv3x3_flat_plain``, which computes the same function. There is no
fallback from one to the other.

The contract both follow (the TPU kernel's docstring, minus its lane layout):

- prologue: ``x (+ residual)`` → per-channel affine (GroupNorm folded to
  (scale, shift) from precomputed statistics) → optional SiLU → rounded to
  x's dtype; padded positions are zero AFTER the prologue;
- taps: fp32 accumulation of the 3×3 conv with HWIO weights [3, 3, C, C];
- epilogue: + ``add`` (bias [C] or per-sample timestep embedding [B, C],
  fp32) → optional SiLU → optional per-channel (sum, sum²) of the fp32
  output → store in x's dtype.

Statistics are per (sample, channel) [B, C] sums; the TPU kernel's per-lane
sums fold to these (its GroupNorm folds lanes by lane % C only).

On the card, bf16 convs at F >= 16 run their taps on the tensor cores (WMMA
bf16, fp32 accumulation); fp32 convs and the F = 8 stage run on CUDA cores.
What bounds each, and why the design, is noted at the top of
``csrc/conv3x3.cu``. Both write per-block statistics partials that
``torch.sum`` finishes, so runs are deterministic.
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
)


def per_sample(v, b: int, c: int, device) -> torch.Tensor | None:
    """[C] or [B, C] → contiguous fp32 [B, C] on device (None stays None)."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.ndim == 1:
        v = v.expand(b, v.shape[0])
    if tuple(v.shape) != (b, c):
        raise ValueError(f"expected a [{c}] or [{b}, {c}] vector, got "
                         f"{tuple(v.shape)}")
    return v.contiguous()


def _nchw(x: torch.Tensor, c: int) -> torch.Tensor:
    """Flat [B, T, F·C] → contiguous fp32 NCHW. Contiguous on purpose: the
    CPU (oneDNN) fp32 conv on a channels-last view sums ~5× less accurately
    than on NCHW (2.8e-5 vs 5.8e-6 absolute at outputs of magnitude ~17)."""
    b, t, fc = x.shape
    return x.view(b, t, fc // c, c).permute(0, 3, 1, 2).float().contiguous()


def _finish(out32: torch.Tensor, dtype, want_stats: bool):
    """out32 [B, T, F, C] fp32 → flat out in dtype (+ per-channel sums)."""
    b, t, f, c = out32.shape
    out = out32.to(dtype).reshape(b, t, f * c)
    if not want_stats:
        return out
    return out, out32.sum(dim=(1, 2)), (out32 * out32).sum(dim=(1, 2))


def conv3x3_flat_plain(x, w, *, c: int, add=None, residual=None, pre=None,
                       pre_silu: bool = False, post_silu: bool = False,
                       want_stats: bool = False):
    """Plain PyTorch twin of ``conv3x3_flat`` (same arguments, same result):
    the prologue in torch, ``F.conv2d`` in fp32 on the dtype-rounded
    operands, the epilogue in torch."""
    b, t, fc = x.shape
    f = fc // c
    v = x if residual is None else x + residual
    if pre is not None or pre_silu:
        v32 = v.float().view(b, t, f, c)
        if pre is not None:
            scale = per_sample(pre[0], b, c, x.device)
            shift = per_sample(pre[1], b, c, x.device)
            v32 = v32 * scale[:, None, None, :] + shift[:, None, None, :]
        if pre_silu:
            v32 = F.silu(v32)
        v = v32.to(x.dtype).reshape(b, t, fc)
    out = F.conv2d(_nchw(v, c), w.float().permute(3, 2, 0, 1).contiguous(),
                   padding=1).permute(0, 2, 3, 1)
    if add is not None:
        out = out + per_sample(add, b, c, x.device)[:, None, None, :]
    if post_silu:
        out = F.silu(out)
    return _finish(out, x.dtype, want_stats)


def conv3x3_flat(x, w, *, c: int, add=None, residual=None, pre=None,
                 pre_silu: bool = False, post_silu: bool = False,
                 want_stats: bool = False):
    """Fused flat 3×3 conv (module docstring).

    x: [B, T, F·C] fp32 or bf16; w: [3, 3, C, C] HWIO in x's dtype;
    residual: [B, T, F·C] in x's dtype, summed into the input; pre:
    (scale, shift), each [C] or [B, C] fp32; add: [C] or [B, C] fp32.
    Returns out [B, T, F·C], or (out, sum [B, C], sum² [B, C]) when
    want_stats."""
    if x.device.type == "cpu":
        return conv3x3_flat_plain(
            x, w, c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
            post_silu=post_silu, want_stats=want_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_flat: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c or c % 16:
        raise ValueError(f"conv3x3_flat kernel: needs F·C % C == 0 and "
                         f"C % 16 == 0, got F·C={fc}, C={c}")
    f = fc // c
    bf16 = require_cuda_dtype(x, "conv3x3_flat")
    dev = x.device
    check_operand(x, "x", device=dev)
    check_operand(w, "w", device=dev, dtype=x.dtype, shape=(3, 3, c, c))
    check_operand(residual, "residual", device=dev, dtype=x.dtype,
                  shape=x.shape)
    add_b = per_sample(add, b, c, dev)
    pre_s = pre_h = None
    if pre is not None:
        pre_s = per_sample(pre[0], b, c, dev)
        pre_h = per_sample(pre[1], b, c, dev)
        check_operand(pre_s, "pre scale", device=dev)  # read 16 bytes at a time
        check_operand(pre_h, "pre shift", device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        lib = kernels()
        stats = None
        if want_stats:
            tiles = lib.ddim_conv3x3_tiles(t, f, c, bf16)
            stats = torch.empty((b, tiles, 2, c), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv3x3(
            ptr(x), ptr(residual), ptr(pre_s), ptr(pre_h), ptr(w), ptr(add_b),
            ptr(out), ptr(stats), b, t, f, c, int(pre_silu), int(post_silu),
            bf16, stream_ptr(x))
    check(err, "conv3x3_flat")
    conv3x3_flat.launches += 1
    if not want_stats:
        return out
    tot = stats.sum(dim=1)
    return out, tot[:, 0], tot[:, 1]


conv3x3_flat.launches = 0
