"""Fused 3×3 SAME conv over the flat channels-last state [B, T, F·C].

``conv3x3_flat`` is the port of the TPU kernel
``ddim_audio_tpu/ops/pallas/conv_flat.py::_conv_kernel`` (its wrapper
``conv3x3_flat``): float taps, int8 taps (``conv3x3_flat_int8``, the TPU
kernel's ``mxu_int8`` mode) and int8 activation storage (``conv3x3_flat_store``,
its ``in_scales`` / ``res_scales`` / ``quant_out`` modes). On a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/conv3x3.cu``,
``csrc/conv3x3_int8.cu``, ``csrc/conv3x3_store.cu``); on a CPU tensor it runs
the plain PyTorch twin (``conv3x3_flat_plain``, ``conv3x3_flat_int8_plain``),
which computes the same function. There is no fallback from one to the
other.

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

int8 activation storage: an int8 tensor [B, T, F·C] carries fp32 scales
[B, n_T, n_F, C], one per storage group of ``rows`` time rows × ``cols``
frequency columns × one channel (``STORE_GROUP``, the CUDA kernels' group;
``cols = "lane"`` is the TPU kernels' group, whose frequency index is
f mod lcm(C, 128)/C). A consumer dequantises every value, halo included,
with the scale of the group that owns it.

On the card, float-tap convs with C % 32 == 0 (every audio.yml stage,
F = 8 included) run their taps on the tensor cores: bf16 with mma.sync bf16
(fp32 accumulation; all C output channels per staging pass of the
prologue), fp32 in split TF32 (each operand a TF32 hi + lo pair, three
TF32 products a tap, fp32 accuracy; training's path and the fp32 float-tap
sampling route); other channel counts run on CUDA cores.
``tile_plan.conv3x3_plan`` says which, and how the grid is cut; what bounds
each variant, and why the design, is noted at the top of
``csrc/conv3x3.cu``. All write per-block statistics partials that
``torch.sum`` finishes, so runs are deterministic.
"""

from __future__ import annotations

import functools
import math

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
from .sums import partials_sum
from .tile_plan import (
    INT8_GROUP,
    STORE_GROUP,
    VARIANT_NONE,
    conv3x3_int8_plan,
    conv3x3_plan,
    conv3x3_store_plan,
)


def wide_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a twin accumulates in: fp32, or fp64 for fp64 operands (so
    ``torch.autograd.gradcheck`` can difference the twins)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def per_sample(v, b: int, c: int, device,
               dtype=torch.float32) -> torch.Tensor | None:
    """[C] or [B, C] → contiguous fp32 [B, C] on device (None stays None)."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=dtype, device=device)
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
    return (x.view(b, t, fc // c, c).permute(0, 3, 1, 2).to(wide_dtype(x))
            .contiguous())


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


def _post(out32, add, post_silu: bool):
    """out32 [B, T, F, C] fp32 → + add → SiLU."""
    b, _, _, c = out32.shape
    if add is not None:
        out32 = out32 + per_sample(add, b, c, out32.device,
                                   out32.dtype)[:, None, None, :]
    return F.silu(out32) if post_silu else out32


def _epilogue(out32, add, post_silu: bool, dtype, want_stats: bool):
    """out32 [B, T, F, C] fp32 → ``_post`` → ``_finish``."""
    return _finish(_post(out32, add, post_silu), dtype, want_stats)


# ------------------------------------------------------ int8 storage --
# STORE_GROUP (ops/tile_plan.py) is the CUDA kernels' storage group
# (csrc/conv3x3_store.cu, csrc/residual_affine.cu): time rows × frequency
# columns, per channel.


def _store_index(t: int, f: int, c: int, group, device):
    """(time index [T], frequency index [F], n_T, n_F) of the storage
    groups: contiguous tiles, or ``cols = "lane"`` for the TPU lane fold."""
    rows, cols = group
    rows = rows or t
    tidx = torch.arange(t, device=device) // rows
    if cols == "lane":
        n_f = math.lcm(c, 128) // c
        fidx = torch.arange(f, device=device) % n_f
    else:
        cols = cols or f
        n_f = -(-f // cols)
        fidx = torch.arange(f, device=device) // cols
    return tidx, fidx, -(-t // rows), n_f


def quantize_store(v32: torch.Tensor, group=STORE_GROUP):
    """v32 [B, T, F, C] fp32 → (q int8 [B, T·F·C] flat as [B, T, F·C],
    scales fp32 [B, n_T, n_F, C]): per storage group
    ``amax = max(max|v|, 1e-30)``, scale ``amax · (1/127)`` and
    ``q = clip(rint(v · (127 / amax)), -127, 127)`` (a true division, round
    half to even)."""
    b, t, f, c = v32.shape
    tidx, fidx, n_t, n_f = _store_index(t, f, c, group, v32.device)
    gid = (tidx[:, None] * n_f + fidx[None, :]).reshape(1, t * f, 1)
    amax = torch.zeros((b, n_t * n_f, c), dtype=torch.float32,
                       device=v32.device)
    amax.scatter_reduce_(1, gid.expand(b, t * f, c),
                         v32.abs().reshape(b, t * f, c), "amax")
    amax = amax.clamp_min(1e-30).view(b, n_t, n_f, c)
    inv = torch.full_like(amax, 127.0) / amax  # not 127.0 / amax (reciprocal)
    q = torch.round(v32 * inv[:, tidx][:, :, fidx]).clamp_(-127.0, 127.0)
    return (q.to(torch.int8).reshape(b, t, f * c).contiguous(),
            (amax * (1.0 / 127.0)).contiguous())


def dequantize_store(q: torch.Tensor, scales: torch.Tensor, c: int,
                     group=STORE_GROUP) -> torch.Tensor:
    """int8 [B, T, F·C] + scales [B, n_T, n_F, C] → fp32 [B, T, F, C]."""
    b, t, fc = q.shape
    f = fc // c
    tidx, fidx, n_t, n_f = _store_index(t, f, c, group, q.device)
    if tuple(scales.shape) != (b, n_t, n_f, c):
        raise ValueError(f"scales {tuple(scales.shape)} do not match the "
                         f"storage group {group} of [{b}, {t}, {f}, {c}]: "
                         f"expected {(b, n_t, n_f, c)}")
    return q.view(b, t, f, c).float() * scales.float()[:, tidx][:, :, fidx]


def _store_prologue(x, c, in_scales, residual, res_scales, pre, pre_silu,
                    stage_dtype, group):
    """The prologue of the storage modes (the TPU kernel's ``prep`` with
    in_q / res_q): int8 operands dequantised to fp32 with their groups'
    scales, a float residual cast to the staging dtype, the sum in fp32 when
    either is int8 (else in the staging dtype), then affine and SiLU in
    fp32, rounded to the staging dtype."""
    b, t, fc = x.shape
    v = (dequantize_store(x, in_scales, c, group) if in_scales is not None
         else x.view(b, t, fc // c, c))
    if residual is not None:
        r = (dequantize_store(residual, res_scales, c, group)
             if res_scales is not None
             else residual.view(b, t, fc // c, c).to(stage_dtype))
        v = v + r
    if pre is not None or pre_silu:
        v = v.float()
        if pre is not None:
            scale = per_sample(pre[0], b, c, x.device)
            shift = per_sample(pre[1], b, c, x.device)
            v = v * scale[:, None, None, :] + shift[:, None, None, :]
        if pre_silu:
            v = F.silu(v)
    return v.to(stage_dtype).reshape(b, t, fc)


def conv3x3_flat_plain(x, w, *, c: int, add=None, residual=None, pre=None,
                       pre_silu: bool = False, post_silu: bool = False,
                       want_stats: bool = False, in_scales=None,
                       res_scales=None, quant_out: bool = False,
                       store_group=STORE_GROUP):
    """Plain PyTorch twin of ``conv3x3_flat`` (same arguments, same result):
    the prologue in torch, ``F.conv2d`` in fp32 on the dtype-rounded
    operands, the epilogue in torch. The storage modes (int8 x with
    ``in_scales``, int8 residual with ``res_scales``, ``quant_out``) stage in
    w's dtype and quantise over ``store_group`` (default: the CUDA kernel's
    ``STORE_GROUP``; ``(tile_t, "lane")`` is the TPU kernel's)."""
    if in_scales is None and res_scales is None and not quant_out:
        v = _prologue(x, c, residual, pre, pre_silu, x.dtype)
    else:
        v = _store_prologue(x, c, in_scales, residual, res_scales, pre,
                            pre_silu, w.dtype, store_group)
    out = F.conv2d(_nchw(v, c),
                   w.to(wide_dtype(v)).permute(3, 2, 0, 1).contiguous(),
                   padding=1).permute(0, 2, 3, 1)
    if not quant_out:
        return _epilogue(out, add, post_silu, v.dtype, want_stats)
    out = _post(out, add, post_silu)
    q, scales = quantize_store(out, store_group)
    if not want_stats:
        return q, scales
    return q, scales, out.sum(dim=(1, 2)), (out * out).sum(dim=(1, 2))


# ------------------------------------------------------------ int8 taps --

# The quantisation group of the CUDA kernel (csrc/conv3x3_int8.cu): an
# output tile (rows, columns) and the halo (rows, columns) staged around it.
INT8_KERNEL_TILE = INT8_GROUP
INT8_KERNEL_HALO = (1, 1)
INT8_WIDTHS = (32, 64, 96)  # C of the kernel; also where int8 accumulates exactly


def quantize_conv_weights_int8(w):
    """w [kh, kw, C_in, C_out] HWIO → (wq int8 of w's shape, s_w fp32
    [C_out]): symmetric per-output-channel quantisation from the fp32
    weights, ``s_w = max(max|w| over (kh, kw, ci), 1e-30) / 127`` and
    ``wq = clip(round(w / s_w), -127, 127)`` (round half to even). For the
    3×3 conv the values of the JAX package's ``pack_conv_weights_int8``
    without its lane packing."""
    w32 = w.float()
    amax = w32.abs().amax(dim=(0, 1, 2)).clamp_min(1e-30)
    # tensor / tensor: torch divides by a Python scalar as a multiplication
    # by its rounded reciprocal, which is not the same number
    s_w = amax / torch.full_like(amax, 127.0)
    wq = torch.round(w32 / s_w).clamp_(-127.0, 127.0).to(torch.int8)
    return wq.contiguous(), s_w.contiguous()


def int8_weights_co_ci(wq):
    """The int8 conv weights [kh, kw, C_in, C_out] (HWIO, as the twins take
    them: the 3 × 3 conv's, or the 4 × 4 up conv's equivalent-forward
    kernel) laid out [kh, kw, C_out, C_in] for the CUDA kernels: the input
    channels contiguous, as the B operand of their int8 MMAs wants them."""
    return wq.permute(0, 1, 3, 2).contiguous()


def quantize_tiles(v, q_tile, q_halo):
    """The requant of the int8 taps, per quantisation group. v [B, T, F, C]
    fp32 → (q [N, C, rows + 2, cols + 2] fp32 integers, s_q [N, 1, 1, 1],
    (n_r, n_c)): N = B·n_r·n_c groups, each a tile of q_tile = (rows, cols)
    positions (``None`` = the whole axis) cut out with the 1-position conv
    halo and quantised with one scale, ``amax = max(max|v|, 1e-30)`` over the
    tile and the q_halo = (rows, columns) staged around it (the zero padding
    adds nothing to a max of magnitudes), ``q = clip(rint(v · (127 /
    amax)), -127, 127)``, ``s_q = amax · (1/127)``."""
    b, t, f, c = v.shape
    rows, cols = q_tile[0] or t, q_tile[1] or f
    hr, hc = q_halo
    n_r, n_c = -(-t // rows), -(-f // cols)
    tp, fp = n_r * rows, n_c * cols
    mag = F.pad(v.abs().amax(dim=3), (hc, fp - f + hc, hr, tp - t + hr))
    amax = F.max_pool2d(mag[:, None], (rows + 2 * hr, cols + 2 * hc),
                        stride=(rows, cols)).clamp_min(1e-30)
    amax = amax.reshape(b * n_r * n_c, 1, 1, 1)
    # a true division (``127.0 / amax`` would run as reciprocal(amax)·127)
    inv, s_q = torch.full_like(amax, 127.0) / amax, amax * (1.0 / 127.0)
    tiles = F.pad(v.permute(0, 3, 1, 2), (1, fp - f + 1, 1, tp - t + 1))
    tiles = tiles.unfold(2, rows + 2, rows).unfold(3, cols + 2, cols)
    tiles = tiles.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, rows + 2, cols + 2)
    return torch.round(tiles * inv).clamp_(-127.0, 127.0), s_q, (n_r, n_c)


def untile(out, b: int, n_r: int, n_c: int, t: int, f: int):
    """Per-group outputs [N, C, rows, cols] → [B, T, F, C] (cropped)."""
    _, c, rows, cols = out.shape
    out = out.view(b, n_r, n_c, c, rows, cols).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(b, n_r * rows, n_c * cols, c)[:, :t, :f]


def _int8_taps(v, wq, w_scale, q_tile, q_halo):
    """The requant, the exact integer taps and the dequant of the int8 mode.
    v [B, T, F, C] fp32 (bf16-rounded values, the prologue result) → out32
    [B, T, F, C] fp32. Groups are a batch dimension: every group's tile is
    cut out with its 1-position conv halo and quantised with the group's own
    scale, so each output position uses the scale of the group that owns it."""
    b, t, f, c = v.shape
    q, s_q, (n_r, n_c) = quantize_tiles(v, q_tile, q_halo)
    # fp64 holds every partial sum of int8 products exactly
    acc = F.conv2d(q.double(), wq.double().permute(3, 2, 0, 1).contiguous())
    out = acc.float() * (s_q * w_scale.float().view(1, c, 1, 1))
    return untile(out, b, n_r, n_c, t, f)


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
                      post_silu: bool = False, want_stats: bool = False,
                      wq_t=None):
    """``conv3x3_flat`` with int8 × int8 → int32 taps: the port of the
    ``mxu_i8`` branch of the TPU kernel. The prologue result is rounded to
    bf16 and requantised with one scale per quantisation group
    (``amax = max(max|v|, 1e-30)`` over the group's staged values, halo
    included; ``q = clip(rint(v · (127 / amax)), -127, 127)``), the taps
    accumulate in int32, and ``out32 = float(acc) · ((amax / 127) ·
    w_scale[co])`` enters the float epilogue.

    x: [B, T, F·C] fp32 or bf16; wq, w_scale: ``quantize_conv_weights_int8``;
    wq_t: ``int8_weights_co_ci(wq)``, the layout the kernel reads (made here
    when not given; ``models.unet.prepare_params`` makes it once); the other
    arguments as ``conv3x3_flat``. On a CUDA tensor this launches
    ``csrc/conv3x3_int8.cu`` (C in 32, 64, 96; its group is
    INT8_KERNEL_TILE / INT8_KERNEL_HALO); on a CPU tensor the twin runs with
    the same group, or with the one set by ``ops.twin_route``."""
    if use_twin(x):
        q_tile, q_halo = twin_int8_group("taps") or (INT8_KERNEL_TILE,
                                                     INT8_KERNEL_HALO)
        kw = dict(c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
                  post_silu=post_silu, want_stats=want_stats)
        ref = conv3x3_flat_int8_plain(x, wq, w_scale, q_tile=q_tile,
                                      q_halo=q_halo, **kw)
        return twin_result("conv3x3_flat_int8", ref, x,
                           lambda: conv3x3_flat_int8(x, wq, w_scale, wq_t=wq_t,
                                                     **kw))
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
    if wq_t is None:
        wq_t = int8_weights_co_ci(wq)
    check_operand(wq_t, "wq_t", device=dev, dtype=torch.int8,
                  shape=(3, 3, c, c))
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
            tiles = conv3x3_int8_plan(t, f, c, bf16, b).tiles
            stats = torch.empty((b, tiles, 2, c), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv3x3_int8(
            ptr(x), ptr(residual), ptr(pre_s), ptr(pre_h), ptr(wq_t),
            ptr(w_scale), ptr(add_b), ptr(out), ptr(stats), b, t, f, c,
            int(pre_silu), int(post_silu), bf16, stream_ptr(x))
    check(err, "conv3x3_flat_int8")
    conv3x3_flat_int8.launches += 1
    if not want_stats:
        return out
    return (out, *partials_sum(stats))


@functools.lru_cache(maxsize=1)
def _store_lib():
    """The kernel library, once checked to quantise storage over the group
    that STORE_GROUP tells the twins."""
    lib = kernels()
    group = tuple(lib.ddim_store_geometry(i) for i in range(2))
    if group != STORE_GROUP:
        raise RuntimeError(f"the built kernels' storage group {group} "
                           "differs from STORE_GROUP")
    return lib


def _scales_operand(scales, b, t, f, c, name, dev):
    n_t, n_f = -(-t // STORE_GROUP[0]), -(-f // STORE_GROUP[1])
    check_operand(scales, name, device=dev, dtype=torch.float32,
                  shape=(b, n_t, n_f, c))


def conv3x3_flat_store(x, w, *, c: int, add=None, residual=None, pre=None,
                       pre_silu: bool = False, post_silu: bool = False,
                       want_stats: bool = False, in_scales=None,
                       res_scales=None, quant_out: bool = False):
    """``conv3x3_flat`` with int8 activation storage: the port of the TPU
    kernel's ``in_q`` / ``res_q`` / ``quant_out`` modes (float taps).

    x: [B, T, F·C] int8 with ``in_scales`` [B, n_T, n_F, C] fp32, or float in
    w's dtype; residual likewise with ``res_scales``; w: [3, 3, C, C] HWIO in
    the compute dtype (fp32 or bf16), which is also the staging dtype of the
    prologue and the output dtype without ``quant_out``. With quant_out the
    fp32 output is quantised per storage group and the result is (int8 out,
    scales[, sum, sum²]); the statistics are those of the fp32 output before
    quantisation. On a CUDA tensor this launches ``csrc/conv3x3_store.cu``
    (C % 32 == 0; its group is STORE_GROUP; bf16 on the tensor cores, fp32
    on CUDA cores: ``tile_plan.conv3x3_store_plan``); on a CPU tensor the
    twin ``conv3x3_flat_plain`` runs with the same group, or with the one
    set by ``ops.twin_route``."""
    kw = dict(c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
              post_silu=post_silu, want_stats=want_stats, in_scales=in_scales,
              res_scales=res_scales, quant_out=quant_out)
    if use_twin(x):
        ref = conv3x3_flat_plain(
            x, w, store_group=twin_int8_group("store") or STORE_GROUP, **kw)
        return twin_result("conv3x3_flat_store", ref, x,
                           lambda: conv3x3_flat_store(x, w, **kw))
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_flat_store: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c or c % 32:
        raise ValueError(f"conv3x3_flat_store kernel: needs C % 32 == 0 and "
                         f"F·C % C == 0, got F·C={fc}, C={c}")
    f = fc // c
    bf16 = require_cuda_dtype(w, "conv3x3_flat_store")
    dev = x.device
    x_q = x.dtype == torch.int8
    res_q = residual is not None and residual.dtype == torch.int8
    if x_q != (in_scales is not None) or res_q != (res_scales is not None):
        raise ValueError("conv3x3_flat_store: an int8 operand needs its "
                         "scales, a float one takes none")
    check_operand(x, "x", device=dev, dtype=torch.int8 if x_q else w.dtype)
    check_operand(w, "w", device=dev, shape=(3, 3, c, c))
    check_operand(residual, "residual", device=dev,
                  dtype=torch.int8 if res_q else w.dtype, shape=x.shape)
    if x_q:
        _scales_operand(in_scales, b, t, f, c, "in_scales", dev)
    if res_q:
        _scales_operand(res_scales, b, t, f, c, "res_scales", dev)
    add_b = per_sample(add, b, c, dev)
    pre_s = pre_h = None
    if pre is not None:
        pre_s = per_sample(pre[0], b, c, dev)
        pre_h = per_sample(pre[1], b, c, dev)
        check_operand(pre_s, "pre scale", device=dev)
        check_operand(pre_h, "pre shift", device=dev)
    out = torch.empty((b, t, fc), dtype=torch.int8 if quant_out else w.dtype,
                      device=dev)
    out_scales = None
    if quant_out:
        out_scales = torch.empty((b, -(-t // STORE_GROUP[0]),
                                  -(-f // STORE_GROUP[1]), c),
                                 dtype=torch.float32, device=dev)
    plan = conv3x3_store_plan(t, f, c, bool(bf16), b, int(x_q) + int(res_q))
    if plan.variant == VARIANT_NONE:
        raise ValueError(f"conv3x3_flat_store kernel: no variant takes "
                         f"C={c} in {w.dtype} (its halo does not fit)")
    with torch.cuda.device(dev):
        lib = _store_lib()
        stats = None
        if want_stats:
            stats = torch.empty((b, plan.tiles, 2, c), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_conv3x3_store(
            ptr(x), ptr(in_scales), ptr(residual), ptr(res_scales),
            ptr(pre_s), ptr(pre_h), ptr(w), ptr(add_b), ptr(out),
            ptr(out_scales), ptr(stats), b, t, f, c, int(x_q), int(res_q),
            int(pre_silu), int(post_silu), bf16, stream_ptr(x))
    check(err, "conv3x3_flat_store")
    conv3x3_flat_store.launches += 1
    result = (out, out_scales) if quant_out else (out,)
    if want_stats:
        result += partials_sum(stats)
    return result if len(result) > 1 else out


def conv3x3_flat(x, w, *, c: int, add=None, residual=None, pre=None,
                 pre_silu: bool = False, post_silu: bool = False,
                 want_stats: bool = False, w_scale=None, wq_t=None,
                 in_scales=None, res_scales=None, quant_out: bool = False):
    """Fused flat 3×3 conv (module docstring).

    x: [B, T, F·C] fp32 or bf16; w: [3, 3, C, C] HWIO in x's dtype;
    residual: [B, T, F·C] in x's dtype, summed into the input; pre:
    (scale, shift), each [C] or [B, C] fp32; add: [C] or [B, C] fp32.
    Returns out [B, T, F·C], or (out, sum [B, C], sum² [B, C]) when
    want_stats. With w_scale (and w the int8 weights, both from
    ``quantize_conv_weights_int8``; wq_t their kernel layout, optional) the
    taps run in int8: ``conv3x3_flat_int8``. With int8 storage (an int8 x with in_scales, an
    int8 residual with res_scales, or quant_out): ``conv3x3_flat_store``."""
    if in_scales is not None or res_scales is not None or quant_out:
        if w_scale is not None:
            raise ValueError("conv3x3_flat: int8 storage runs float taps "
                             "(as the TPU kernel's resblock_flat_int8 does)")
        return conv3x3_flat_store(
            x, w, c=c, add=add, residual=residual, pre=pre, pre_silu=pre_silu,
            post_silu=post_silu, want_stats=want_stats, in_scales=in_scales,
            res_scales=res_scales, quant_out=quant_out)
    if w_scale is not None:
        return conv3x3_flat_int8(
            x, w, w_scale, c=c, add=add, residual=residual, pre=pre,
            pre_silu=pre_silu, post_silu=post_silu, want_stats=want_stats,
            wq_t=wq_t)
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
            tiles = conv3x3_plan(t, f, c, bf16, b).tiles
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
    return (out, *partials_sum(stats))


conv3x3_flat.launches = 0
conv3x3_flat_int8.launches = 0
conv3x3_flat_store.launches = 0
