"""Fused 3×3 SAME conv over the flat channels-last state [B, T, F·C].

``conv3x3_flat`` is the port of the TPU kernel
``ddim_audio_tpu/ops/pallas/conv_flat.py::_conv_kernel`` (its wrapper
``conv3x3_flat``): float taps, and int8 taps (``conv3x3_flat_int8``, the TPU
kernel's ``mxu_int8`` mode). On a CUDA tensor it launches the hand-written
Hopper kernel (``csrc/conv3x3.cu``, ``csrc/conv3x3_int8.cu``); on a CPU tensor
it runs the plain PyTorch twin (``conv3x3_flat_plain``,
``conv3x3_flat_int8_plain``), which computes the same function. There is no
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

import functools

import torch
import torch.nn.functional as F

from ._cuda import (
    check,
    check_operand,
    kernels,
    ptr,
    require_cuda_dtype,
    stream_ptr,
    twin_int8_group,
    twin_result,
    use_twin,
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


def _prologue(x, c: int, residual, pre, pre_silu: bool, stage_dtype):
    """x (+ residual, summed in x's dtype) → affine → SiLU, rounded to
    stage_dtype: the flat operand of the taps."""
    b, t, fc = x.shape
    v = x if residual is None else x + residual
    if pre is not None or pre_silu:
        v32 = v.float().view(b, t, fc // c, c)
        if pre is not None:
            scale = per_sample(pre[0], b, c, x.device)
            shift = per_sample(pre[1], b, c, x.device)
            v32 = v32 * scale[:, None, None, :] + shift[:, None, None, :]
        if pre_silu:
            v32 = F.silu(v32)
        v = v32.reshape(b, t, fc)
    return v.to(stage_dtype)


def _epilogue(out32, add, post_silu: bool, dtype, want_stats: bool):
    """out32 [B, T, F, C] fp32 → + add → SiLU → ``_finish``."""
    b, _, _, c = out32.shape
    if add is not None:
        out32 = out32 + per_sample(add, b, c, out32.device)[:, None, None, :]
    if post_silu:
        out32 = F.silu(out32)
    return _finish(out32, dtype, want_stats)


def conv3x3_flat_plain(x, w, *, c: int, add=None, residual=None, pre=None,
                       pre_silu: bool = False, post_silu: bool = False,
                       want_stats: bool = False):
    """Plain PyTorch twin of ``conv3x3_flat`` (same arguments, same result):
    the prologue in torch, ``F.conv2d`` in fp32 on the dtype-rounded
    operands, the epilogue in torch."""
    v = _prologue(x, c, residual, pre, pre_silu, x.dtype)
    out = F.conv2d(_nchw(v, c), w.float().permute(3, 2, 0, 1).contiguous(),
                   padding=1).permute(0, 2, 3, 1)
    return _epilogue(out, add, post_silu, x.dtype, want_stats)


# ------------------------------------------------------------ int8 taps --

# The quantisation group of the CUDA kernel (csrc/conv3x3_int8.cu): a block's
# output tile (rows, columns) and the halo (rows, columns) staged around it.
INT8_KERNEL_TILE = (8, 16)
INT8_KERNEL_HALO = (1, 1)
INT8_WIDTHS = (32, 64, 96)  # C of the kernel; also where int8 accumulates exactly


def quantize_conv_weights_int8(w):
    """w [3, 3, C, C] HWIO → (wq int8 [3, 3, C, C], s_w fp32 [C]): symmetric
    per-output-channel quantisation from the fp32 weights,
    ``s_w = max(max|w| over (kh, kw, ci), 1e-30) / 127`` and
    ``wq = clip(round(w / s_w), -127, 127)`` (round half to even). The
    values of the JAX package's ``pack_conv_weights_int8`` without its lane
    packing."""
    w32 = w.float()
    amax = w32.abs().amax(dim=(0, 1, 2)).clamp_min(1e-30)
    # tensor / tensor: torch divides by a Python scalar as a multiplication
    # by its rounded reciprocal, which is not the same number
    s_w = amax / torch.full_like(amax, 127.0)
    wq = torch.round(w32 / s_w).clamp_(-127.0, 127.0).to(torch.int8)
    return wq.contiguous(), s_w.contiguous()


def _int8_taps(v, wq, w_scale, q_tile, q_halo):
    """The requant, the exact integer taps and the dequant of the int8 mode.
    v [B, T, F, C] fp32 (bf16-rounded values, the prologue result) → out32
    [B, T, F, C] fp32. Groups are a batch dimension: every group's tile is
    cut out with its 1-position conv halo and quantised with the group's own
    scale, so each output position uses the scale of the group that owns it."""
    b, t, f, c = v.shape
    rows, cols = q_tile[0] or t, q_tile[1] or f
    hr, hc = q_halo
    n_r, n_c = -(-t // rows), -(-f // cols)
    tp, fp = n_r * rows, n_c * cols
    # one amax per group over its staged region (tile + halo, clipped: the
    # zero padding adds nothing to a max of magnitudes)
    mag = F.pad(v.abs().amax(dim=3), (hc, fp - f + hc, hr, tp - t + hr))
    amax = F.max_pool2d(mag[:, None], (rows + 2 * hr, cols + 2 * hc),
                        stride=(rows, cols)).clamp_min(1e-30)
    amax = amax.reshape(b * n_r * n_c, 1, 1, 1)
    # a true division (``127.0 / amax`` would run as reciprocal(amax)·127)
    inv, s_q = torch.full_like(amax, 127.0) / amax, amax * (1.0 / 127.0)
    tiles = F.pad(v.permute(0, 3, 1, 2), (1, fp - f + 1, 1, tp - t + 1))
    tiles = tiles.unfold(2, rows + 2, rows).unfold(3, cols + 2, cols)
    tiles = tiles.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, rows + 2, cols + 2)
    q = torch.round(tiles * inv).clamp_(-127.0, 127.0)
    # fp64 holds every partial sum of int8 products exactly
    acc = F.conv2d(q.double(), wq.double().permute(3, 2, 0, 1).contiguous())
    out = acc.float() * (s_q * w_scale.float().view(1, c, 1, 1))
    out = out.view(b, n_r, n_c, c, rows, cols).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(b, tp, fp, c)[:, :t, :f]


def conv3x3_flat_int8_plain(x, wq, w_scale, *, c: int, add=None,
                            residual=None, pre=None, pre_silu: bool = False,
                            post_silu: bool = False, want_stats: bool = False,
                            q_tile=INT8_KERNEL_TILE, q_halo=INT8_KERNEL_HALO):
    """Plain PyTorch twin of ``conv3x3_flat_int8``. q_tile = (rows, columns)
    of a quantisation group's output tile and q_halo = (rows, columns)
    staged around it (``None`` = the whole axis); the defaults are the CUDA
    kernel's group, ``((tile_t, None), (2, 0))`` the TPU kernel's."""
    b, t, fc = x.shape
    v = _prologue(x, c, residual, pre, pre_silu, torch.bfloat16)
    out = _int8_taps(v.float().view(b, t, fc // c, c), wq, w_scale, q_tile,
                     q_halo)
    return _epilogue(out, add, post_silu, x.dtype, want_stats)


@functools.lru_cache(maxsize=1)
def _int8_lib():
    """The kernel library, once checked to quantise over the group that
    INT8_KERNEL_TILE / INT8_KERNEL_HALO tell the twin."""
    lib = kernels()
    group = tuple(lib.ddim_conv3x3_int8_geometry(i) for i in range(4))
    if group != INT8_KERNEL_TILE + INT8_KERNEL_HALO:
        raise RuntimeError(f"the built kernel's quantisation group {group} "
                           "differs from INT8_KERNEL_TILE/HALO")
    return lib


def conv3x3_flat_int8(x, wq, w_scale, *, c: int, add=None, residual=None,
                      pre=None, pre_silu: bool = False,
                      post_silu: bool = False, want_stats: bool = False):
    """``conv3x3_flat`` with int8 × int8 → int32 taps: the port of the
    ``mxu_i8`` branch of the TPU kernel. The prologue result is rounded to
    bf16 and requantised with one scale per quantisation group
    (``amax = max(max|v|, 1e-30)`` over the group's staged values, halo
    included; ``q = clip(rint(v · (127 / amax)), -127, 127)``), the taps
    accumulate in int32, and ``out32 = float(acc) · ((amax / 127) ·
    w_scale[co])`` enters the float epilogue.

    x: [B, T, F·C] fp32 or bf16; wq, w_scale: ``quantize_conv_weights_int8``;
    the other arguments as ``conv3x3_flat``. On a CUDA tensor this launches
    ``csrc/conv3x3_int8.cu`` (C in 32, 64, 96; its group is
    INT8_KERNEL_TILE / INT8_KERNEL_HALO); on a CPU tensor the twin runs with
    the same group, or with the one set by ``ops.twin_route``."""
    if use_twin(x):
        q_tile, q_halo = twin_int8_group() or (INT8_KERNEL_TILE,
                                               INT8_KERNEL_HALO)
        kw = dict(c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
                  post_silu=post_silu, want_stats=want_stats)
        ref = conv3x3_flat_int8_plain(x, wq, w_scale, q_tile=q_tile,
                                      q_halo=q_halo, **kw)
        return twin_result("conv3x3_flat_int8", ref, x,
                           lambda: conv3x3_flat_int8(x, wq, w_scale, **kw))
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_flat_int8: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c or c not in INT8_WIDTHS:
        raise ValueError(f"conv3x3_flat_int8 kernel: needs C in {INT8_WIDTHS} "
                         f"and F·C % C == 0, got F·C={fc}, C={c}")
    f = fc // c
    bf16 = require_cuda_dtype(x, "conv3x3_flat_int8")
    dev = x.device
    check_operand(x, "x", device=dev)
    check_operand(wq, "wq", device=dev, dtype=torch.int8, shape=(3, 3, c, c))
    check_operand(w_scale, "w_scale", device=dev, dtype=torch.float32,
                  shape=(c,))
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
        lib = _int8_lib()
        stats = None
        if want_stats:
            tiles = lib.ddim_conv3x3_int8_tiles(t, f)
            stats = torch.empty((b, tiles, 2, c), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv3x3_int8(
            ptr(x), ptr(residual), ptr(pre_s), ptr(pre_h), ptr(wq),
            ptr(w_scale), ptr(add_b), ptr(out), ptr(stats), b, t, f, c,
            int(pre_silu), int(post_silu), bf16, stream_ptr(x))
    check(err, "conv3x3_flat_int8")
    conv3x3_flat_int8.launches += 1
    if not want_stats:
        return out
    tot = stats.sum(dim=1)
    return out, tot[:, 0], tot[:, 1]


def conv3x3_flat(x, w, *, c: int, add=None, residual=None, pre=None,
                 pre_silu: bool = False, post_silu: bool = False,
                 want_stats: bool = False, w_scale=None):
    """Fused flat 3×3 conv (module docstring).

    x: [B, T, F·C] fp32 or bf16; w: [3, 3, C, C] HWIO in x's dtype;
    residual: [B, T, F·C] in x's dtype, summed into the input; pre:
    (scale, shift), each [C] or [B, C] fp32; add: [C] or [B, C] fp32.
    Returns out [B, T, F·C], or (out, sum [B, C], sum² [B, C]) when
    want_stats. With w_scale (and w the int8 weights, both from
    ``quantize_conv_weights_int8``) the taps run in int8:
    ``conv3x3_flat_int8``."""
    if w_scale is not None:
        return conv3x3_flat_int8(
            x, w, w_scale, c=c, add=add, residual=residual, pre=pre,
            pre_silu=pre_silu, post_silu=post_silu, want_stats=want_stats)
    if use_twin(x):
        kw = dict(c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
                  post_silu=post_silu, want_stats=want_stats)
        return twin_result("conv3x3_flat", conv3x3_flat_plain(x, w, **kw), x,
                           lambda: conv3x3_flat(x, w, **kw))
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
conv3x3_flat_int8.launches = 0
