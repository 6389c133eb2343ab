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

With ``w_scale`` (int8 weights from ``quantize_strided_weights_int8``) both
run int8 × int8 → int32 taps (``conv_down_flat_int8``, ``conv_up_flat_int8``:
the TPU kernels' ``mxu_i8`` branches, ``sampling.strided_int8``): the input
is requantised with one scale per quantisation group (an 8 × 16 output
tile's input tile, halo included; for the down conv both time-parity
streams of the TPU kernel share it), and ``out32 = float(acc) · (s_q ·
w_scale[co]) + bias`` enters the float epilogue. The up kernel reads its
weights laid out [4, 4, C_out, C_in] (``wq_t``: ``prepare_params`` makes
it once, else the wrapper per call).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/conv_strided.cu``, ``csrc/conv_strided_int8.cu``); on a CPU tensor it
runs its plain PyTorch twin (``*_plain``). No fallback from one to the
other. bf16 transitions at the audio.yml widths run their taps on the
tensor cores with mma.sync (down: one staged input halo a tile for all its
output channels, ``tile_plan.conv_down_plan``; up: the sub-pixel form, all
four output parity classes from one staged input tile,
``tile_plan.conv_up_plan``); the fp32 down and up convs (training's) run
them in split TF32 (three TF32 products a tap, fp32 accuracy); the
geometries those do not take run on CUDA cores (what bounds each: the note
at the top of ``csrc/conv_strided.cu``). The int8-tap up conv is a
persistent kernel (``tile_plan.conv_up_int8_plan``). Statistics come from
per-block partials finished by ``torch.sum`` (deterministic).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import functools

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
from .conv_flat import (
    _finish,
    _nchw,
    int8_weights_co_ci,
    quantize_conv_weights_int8,
    quantize_tiles,
    untile,
    wide_dtype,
)
from .tile_plan import (
    VARIANT_MMA,
    conv_down_plan,
    conv_up_int8_plan,
    conv_up_plan,
)

# The quantisation group of the int8 strided kernels
# (csrc/conv_strided_int8.cu): a block's output tile (rows, columns) and the
# halo (input rows, columns) staged around the input positions of that tile.
# In input positions the group is 16 × 32 for the down conv and 4 × 8 for
# the up conv.
STRIDED_INT8_TILE = (8, 16)
STRIDED_INT8_HALO = (1, 1)


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


def quantize_strided_weights_int8(w):
    """w [4, 4, C_in, C_out] (HWIO; for the up conv the stored
    equivalent-forward kernel) → (wq int8 [4, 4, C_in, C_out], s_w fp32
    [C_out]): symmetric per-output-channel quantisation from the fp32
    weights, the values of the JAX package's ``pack_down_weights_int8`` /
    ``pack_up_weights_int8`` without their lane packing."""
    return quantize_conv_weights_int8(w)


def _in_tile(out_tile, up: bool):
    """Input extents of a group: the down conv reads twice its output tile,
    the up conv half of it (``None`` = the whole axis)."""
    def one(n):
        if n is None:
            return None
        if up and n % 2:
            raise ValueError(f"an up-conv group's output tile {out_tile} "
                             "must be even")
        return n // 2 if up else 2 * n
    return tuple(one(n) for n in out_tile)


def _dequant(acc, s_q, w_scale, c_out: int):
    return acc.float() * (s_q * w_scale.float().view(1, c_out, 1, 1))


def conv_down_flat_int8_plain(x, wq, w_scale, bias, *, c_in: int, c_out: int,
                              want_stats: bool = False,
                              q_tile=STRIDED_INT8_TILE,
                              q_halo=STRIDED_INT8_HALO):
    """Plain twin of ``conv_down_flat_int8``. q_tile = the (rows, columns)
    of a quantisation group's output tile and q_halo the (rows, columns) of
    input staged around its input tile (``None`` = the whole axis); the
    defaults are the CUDA kernel's group, ``((tile_t, None), (2, 0))`` the
    TPU kernel's."""
    b, t, fc = x.shape
    f = fc // c_in
    q, s_q, (n_r, n_c) = quantize_tiles(x.float().view(b, t, f, c_in),
                                        _in_tile(q_tile, False), q_halo)
    # fp64 holds every partial sum of int8 products exactly
    acc = F.conv2d(q.double(), wq.double().permute(3, 2, 0, 1).contiguous(),
                   stride=2)
    out = untile(_dequant(acc, s_q, w_scale, c_out), b, n_r, n_c, t // 2,
                 f // 2)
    out = out + _bias(bias, c_out, x.device)
    return _finish(out, x.dtype, want_stats)


def conv_up_flat_int8_plain(x, wq, w_scale, bias, *, c_in: int, c_out: int,
                            residual=None, want_stats: bool = False,
                            q_tile=STRIDED_INT8_TILE,
                            q_halo=STRIDED_INT8_HALO):
    """Plain twin of ``conv_up_flat_int8`` (groups as
    ``conv_down_flat_int8_plain``'s; the output tile's rows and columns must
    be even)."""
    b, t, fc = x.shape
    f = fc // c_in
    q, s_q, (n_r, n_c) = quantize_tiles(x.float().view(b, t, f, c_in),
                                        _in_tile(q_tile, True), q_halo)
    acc = F.conv_transpose2d(q.double(),
                             up_weight_to_torch(wq.double()).contiguous(),
                             stride=2, padding=1)[:, :, 2:-2, 2:-2]
    out = untile(_dequant(acc, s_q, w_scale, c_out), b, n_r, n_c, 2 * t,
                 2 * f)
    out = out + _bias(bias, c_out, x.device)
    if residual is not None:
        out = out + residual.float().view(b, 2 * t, 2 * f, c_out)
    return _finish(out, x.dtype, want_stats)


@functools.lru_cache(maxsize=1)
def _int8_lib():
    """The kernel library, once checked to quantise over the group that
    STRIDED_INT8_TILE / STRIDED_INT8_HALO tell the twins."""
    lib = kernels()
    group = tuple(lib.ddim_strided_int8_geometry(i) for i in range(4))
    if group != STRIDED_INT8_TILE + STRIDED_INT8_HALO:
        raise RuntimeError(f"the built kernel's quantisation group {group} "
                           "differs from STRIDED_INT8_TILE/HALO")
    return lib


def _strided_int8(x, wq, w_scale, bias, residual, *, c_in, c_out, up,
                  want_stats, name, wq_t=None):
    """Checks, allocation and launch of csrc/conv_strided_int8.cu (up: wq_t
    the [4, 4, C_out, C_in] weights, made here when not given)."""
    b, t, f = _geometry(x, c_in, name)
    if c_in % 32 or c_out % 32:
        raise ValueError(f"{name} kernel: needs C_in and C_out % 32 == 0, "
                         f"got {c_in}, {c_out}")
    if not up and (t % 2 or f % 2):
        raise ValueError(f"{name}: T={t} and F={f} must be even")
    bf16 = require_cuda_dtype(x, name)
    dev = x.device
    t_out, f_out = (2 * t, 2 * f) if up else (t // 2, f // 2)
    out_shape = (b, t_out, f_out * c_out)
    check_operand(x, "x", device=dev)
    check_operand(wq, "wq", device=dev, dtype=torch.int8,
                  shape=(4, 4, c_in, c_out))
    check_operand(w_scale, "w_scale", device=dev, dtype=torch.float32,
                  shape=(c_out,))
    check_operand(residual, "residual", device=dev, dtype=x.dtype,
                  shape=out_shape)
    if up:
        plan = conv_up_int8_plan(t, f, c_in, c_out, bool(bf16), b)
        if plan.variant != VARIANT_MMA:
            raise ValueError(f"{name} kernel: no kernel takes C_in={c_in}, "
                             f"C_out={c_out} (C_in <= 256)")
        if wq_t is None:
            wq_t = int8_weights_co_ci(wq)
        check_operand(wq_t, "wq_t", device=dev, dtype=torch.int8,
                      shape=(4, 4, c_out, c_in))
    bias = _bias(bias, c_out, dev)
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        lib = _int8_lib()
        stats = None
        if want_stats:
            tiles = (plan.tiles if up
                     else lib.ddim_strided_int8_tiles(t_out, f_out))
            stats = torch.empty((b, tiles, 2, c_out), dtype=torch.float32,
                                device=dev)
        if up:
            err = lib.ddim_conv_up_int8(
                ptr(x), ptr(wq_t), ptr(w_scale), ptr(bias), ptr(residual),
                ptr(out), ptr(stats), b, t, f, c_in, c_out, bf16,
                stream_ptr(x))
        else:
            err = lib.ddim_conv_down_int8(
                ptr(x), ptr(wq), ptr(w_scale), ptr(bias), ptr(out),
                ptr(stats), b, t, f, c_in, c_out, bf16, stream_ptr(x))
    check(err, name)
    if not want_stats:
        return out
    tot = stats.sum(dim=1)
    return out, tot[:, 0], tot[:, 1]


def conv_down_flat_int8(x, wq, w_scale, bias, *, c_in: int, c_out: int,
                        want_stats: bool = False):
    """``conv_down_flat`` with int8 × int8 → int32 taps (module docstring).
    wq, w_scale: ``quantize_strided_weights_int8``. On a CUDA tensor this
    launches ``csrc/conv_strided_int8.cu`` (C_in, C_out % 32 == 0); on a CPU
    tensor the twin runs with the kernel's group, or with the one set by
    ``ops.twin_route``."""
    kw = dict(c_in=c_in, c_out=c_out, want_stats=want_stats)
    if use_twin(x):
        q_tile, q_halo = twin_int8_group("strided") or (STRIDED_INT8_TILE,
                                                        STRIDED_INT8_HALO)
        ref = conv_down_flat_int8_plain(x, wq, w_scale, bias, q_tile=q_tile,
                                        q_halo=q_halo, **kw)
        return twin_result("conv_down_flat_int8", ref, x,
                           lambda: conv_down_flat_int8(x, wq, w_scale, bias,
                                                       **kw))
    res = _strided_int8(x, wq, w_scale, bias, None, up=False,
                        name="conv_down_flat_int8", **kw)
    conv_down_flat_int8.launches += 1
    return res


def conv_up_flat_int8(x, wq, w_scale, bias, *, c_in: int, c_out: int,
                      residual=None, want_stats: bool = False, wq_t=None):
    """``conv_up_flat`` with int8 × int8 → int32 taps (module docstring);
    the skip add and the statistics of the sum as ``conv_up_flat``. wq_t:
    ``int8_weights_co_ci(wq)``, the [4, 4, C_out, C_in] layout the kernel
    reads (made here when not given; ``models.unet.prepare_params`` makes it
    once); the twin reads HWIO ``wq``. On a CUDA tensor this launches the
    persistent kernel of ``csrc/conv_strided_int8.cu`` (C_in, C_out % 32 ==
    0, C_in <= 256)."""
    kw = dict(c_in=c_in, c_out=c_out, residual=residual,
              want_stats=want_stats)
    if use_twin(x):
        q_tile, q_halo = twin_int8_group("strided") or (STRIDED_INT8_TILE,
                                                        STRIDED_INT8_HALO)
        ref = conv_up_flat_int8_plain(x, wq, w_scale, bias, q_tile=q_tile,
                                      q_halo=q_halo, **kw)
        return twin_result("conv_up_flat_int8", ref, x,
                           lambda: conv_up_flat_int8(x, wq, w_scale, bias,
                                                     wq_t=wq_t, **kw))
    res = _strided_int8(x, wq, w_scale, bias, residual, c_in=c_in,
                        c_out=c_out, up=True, want_stats=want_stats,
                        name="conv_up_flat_int8", wq_t=wq_t)
    conv_up_flat_int8.launches += 1
    return res


def _geometry(x, c_in: int, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c_in or c_in % 8:
        raise ValueError(f"{name} kernel: needs F·C_in % C_in == 0 and "
                         f"C_in % 8 == 0, got F·C_in={fc}, C_in={c_in}")
    return b, t, fc // c_in


def conv_down_flat(x, w, bias, *, c_in: int, c_out: int,
                   want_stats: bool = False, w_scale=None):
    """x: [B, T, F·C_in] → [B, T/2, (F/2)·C_out]; w: [4, 4, C_in, C_out] HWIO
    in x's dtype; bias: [C_out] fp32. Returns out, or (out, sum [B, C_out],
    sum² [B, C_out]) when want_stats. With w_scale (w then the int8 weights)
    the taps run in int8: ``conv_down_flat_int8``."""
    if w_scale is not None:
        return conv_down_flat_int8(x, w, w_scale, bias, c_in=c_in,
                                   c_out=c_out, want_stats=want_stats)
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
            tiles = conv_down_plan(t, f, c_in, c_out, bf16, b).tiles
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
                 want_stats: bool = False, w_scale=None, wq_t=None):
    """x: [B, T, F·C_in] → [B, 2T, (2F)·C_out]; w: [4, 4, C_in, C_out]
    equivalent-forward HWIO in x's dtype; bias: [C_out] fp32; residual:
    optional [B, 2T, 2F·C_out] skip in x's dtype added in the epilogue.
    Returns out, or (out, sum, sum²) of the summed fp32 output. With
    w_scale (w then the int8 weights, wq_t optionally their kernel layout)
    the taps run in int8: ``conv_up_flat_int8``."""
    if w_scale is not None:
        return conv_up_flat_int8(x, w, w_scale, bias, c_in=c_in, c_out=c_out,
                                 residual=residual, want_stats=want_stats,
                                 wq_t=wq_t)
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
            tiles = conv_up_plan(t, f, c_in, c_out, bf16, b).tiles
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
conv_down_flat_int8.launches = 0
conv_up_flat_int8.launches = 0
