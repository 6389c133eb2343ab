"""The fused resblock tail: port of the TPU kernel
``ddim_audio_tpu/ops/pallas/conv_flat.py::_res_affine_kernel`` (wrapper
``residual_affine_flat``) of int8 activation storage, and the float block's
tail ``ops.flat_resblock.resblock_tail``, an XLA fusion in the JAX package.

    out = deq(x) + deq(s) · scale[b, c] + shift[b, c]

over the flat channels-last state [B, T, F·C], where each of x and s is int8
with its storage scales [B, n_T, n_F, C] (``conv_flat.STORE_GROUP``) or a
float tensor; (scale, shift) is GN3 folded to a per-channel affine. With
``quant_out`` the fp32 result is quantised per storage group (int8 out +
scales, for the next block's conv); ``want_stats`` adds its per-channel
(sum, sum²) taken on the fp32 values before quantisation (the next
GroupNorm's statistics). With x and s both float (the float tail) the
product is fused into the sum as torch's ``addcmul`` fuses it, and, unless
quantised, the statistics read the output as stored.

On a CUDA tensor ``residual_affine_flat`` launches the hand-written Hopper
kernel (``csrc/residual_affine.cu``: persistent blocks that walk storage
groups with the next ones' operands in flight, one statistics partial a
block, its plan ``tile_plan.residual_affine_plan``); on a CPU tensor it runs
the plain twin ``residual_affine_flat_plain``. No fallback from one to the
other.
"""

from __future__ import annotations

import torch

from ._cuda import (
    check,
    check_operand,
    ptr,
    stream_ptr,
    twin_int8_group,
    twin_result,
    use_twin,
)
from .sums import batch_sums, partials_sum
from .conv_flat import (
    STORE_GROUP,
    _scales_operand,
    _store_lib,
    dequantize_store,
    per_sample,
    quantize_store,
)
from .tile_plan import residual_affine_plan


def _out_dtype(x, s, out_dtype):
    """The TPU wrapper's default: s's dtype if float, else x's, else bf16."""
    if out_dtype is not None:
        return out_dtype
    if s.dtype != torch.int8:
        return s.dtype
    return x.dtype if x.dtype != torch.int8 else torch.bfloat16


def residual_affine_flat_plain(x, s, affine=None, *, c: int, x_scales=None,
                               s_scales=None, quant_out: bool = False,
                               want_stats: bool = False, out_dtype=None,
                               store_group=STORE_GROUP):
    """Plain PyTorch twin of ``residual_affine_flat`` (same arguments, same
    result), quantising over ``store_group`` (default: the CUDA kernel's
    STORE_GROUP; ``(tile_t, "lane")`` is the TPU kernel's).

    x and s both float with an affine is the float resblock tail in the JAX
    package's order: ``addcmul`` (x + s·scale, promoted to fp32 at least,
    the product fused into the sum), then + shift in place, rounded once.
    With x and s both float and no quant_out the statistics are
    ``batch_sums`` of the output as stored."""
    b, t, fc = x.shape
    f = fc // c
    float_kinds = x.dtype != torch.int8 and s.dtype != torch.int8
    if float_kinds and affine is not None:
        out = torch.addcmul(
            x.view(b, t, f, c), s.view(b, t, f, c),
            per_sample(affine[0], b, c, x.device)[:, None, None, :])
        out.add_(per_sample(affine[1], b, c, x.device)[:, None, None, :])
    else:
        v = (dequantize_store(x, x_scales, c, store_group)
             if x.dtype == torch.int8 else x.float().view(b, t, f, c))
        sv = (dequantize_store(s, s_scales, c, store_group)
              if s.dtype == torch.int8 else s.float().view(b, t, f, c))
        if affine is not None:
            scale = per_sample(affine[0], b, c, x.device)[:, None, None, :]
            shift = per_sample(affine[1], b, c, x.device)[:, None, None, :]
            out = v + sv * scale + shift
        else:
            out = v + sv
    if quant_out:
        result = quantize_store(out, store_group)
    else:
        result = (out.to(_out_dtype(x, s, out_dtype)).reshape(b, t, fc),)
    if want_stats and float_kinds and not quant_out:
        sums = batch_sums(result[0].view(b, t * f, c), squares=True)
        result += (sums[:, 0], sums[:, 1])
    elif want_stats:
        result += (out.sum(dim=(1, 2)), (out * out).sum(dim=(1, 2)))
    return result if len(result) > 1 else result[0]


def residual_affine_flat(x, s, affine=None, *, c: int, x_scales=None,
                         s_scales=None, quant_out: bool = False,
                         want_stats: bool = False, out_dtype=None):
    """x, s: [B, T, F·C], each int8 with its scales (x_scales, s_scales:
    [B, n_T, n_F, C] fp32) or fp32 / bf16; affine: (scale, shift), each [C]
    or [B, C] fp32, or None for ``deq(x) + deq(s)``. Returns out in
    out_dtype (default: s's dtype if float, else x's, else bf16), or with
    quant_out (int8 out, scales); want_stats appends (sum [B, C],
    sum² [B, C]) of the fp32 result (of the stored result where x and s
    are float and quant_out is off: the float tail). On a CUDA tensor this
    launches ``csrc/residual_affine.cu`` (C % 32 == 0; x, s and their
    scales contiguous and 16-byte aligned)."""
    kw = dict(c=c, x_scales=x_scales, s_scales=s_scales, quant_out=quant_out,
              want_stats=want_stats, out_dtype=out_dtype)
    if use_twin(x):
        ref = residual_affine_flat_plain(
            x, s, affine, store_group=twin_int8_group("store") or STORE_GROUP,
            **kw)
        return twin_result("residual_affine_flat", ref, x,
                           lambda: residual_affine_flat(x, s, affine, **kw))
    b, t, fc = x.shape
    if fc % c or c % 32:
        raise ValueError(f"residual_affine_flat kernel: needs C % 32 == 0 and "
                         f"F·C % C == 0, got F·C={fc}, C={c}")
    if x.device.type != "cuda":
        raise ValueError(f"residual_affine_flat: unsupported device {x.device}")
    f = fc // c
    dev = x.device
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    for name, v, sc in (("x", x, x_scales), ("s", s, s_scales)):
        if v.dtype not in kinds:
            raise TypeError(f"residual_affine_flat: {name} is {v.dtype}")
        if (v.dtype == torch.int8) != (sc is not None):
            raise ValueError(f"residual_affine_flat: an int8 {name} needs its "
                             "scales, a float one takes none")
        check_operand(v, name, device=dev, shape=x.shape)
        if sc is not None:
            _scales_operand(sc, b, t, f, c, f"{name}_scales", dev)
        if any(u is not None and u.data_ptr() % 16 for u in (v, sc)):
            raise ValueError(f"residual_affine_flat kernel: {name} and its "
                             "scales must be 16-byte aligned")
    odt = torch.int8 if quant_out else _out_dtype(x, s, out_dtype)
    if odt not in kinds:
        raise TypeError(f"residual_affine_flat: out dtype {odt}")
    scale = shift = None
    if affine is not None:
        scale = per_sample(affine[0], b, c, dev)
        shift = per_sample(affine[1], b, c, dev)
    out = torch.empty((b, t, fc), dtype=odt, device=dev)
    out_scales = None
    if quant_out:
        out_scales = torch.empty((b, -(-t // STORE_GROUP[0]),
                                  -(-f // STORE_GROUP[1]), c),
                                 dtype=torch.float32, device=dev)
    plan = residual_affine_plan(t, f, c, kinds[x.dtype], kinds[s.dtype], b)
    with torch.cuda.device(dev):
        lib = _store_lib()
        stats = None
        if want_stats:  # one partial a persistent block
            stats = torch.empty((b, plan.tiles, 2, c), dtype=torch.float32,
                                device=dev)
        err = lib.ddim_residual_affine(
            ptr(x), ptr(x_scales), ptr(s), ptr(s_scales), ptr(scale),
            ptr(shift), ptr(out), ptr(out_scales), ptr(stats), b, t, f, c,
            kinds[x.dtype], kinds[s.dtype], kinds[odt], stream_ptr(x))
    check(err, "residual_affine_flat")
    residual_affine_flat.launches += 1
    result = (out, out_scales) if quant_out else (out,)
    if want_stats:
        result += partials_sum(stats)
    return result if len(result) > 1 else out


residual_affine_flat.launches = 0
