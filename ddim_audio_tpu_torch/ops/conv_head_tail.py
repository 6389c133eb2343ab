"""The U-Net's channel-asymmetric head and tail convs over the unpadded flat
state.

- ``conv_head_flat``: 3×3 SAME conv C_in → C0 (2 → 32 at audio.yml) + bias,
  read straight from the flat state [B, T, F·C_in], with the per-channel
  (sum, sum²) of the fp32 output (the first GroupNorm's statistics). Port of
  the TPU kernel ``ddim_audio_tpu/ops/pallas/conv_head_tail.py::_head_kernel``
  (wrapper ``conv_head_flat``).
- ``conv_tail_flat``: 3×3 SAME conv C0 → C_out + bias that emits the flat
  ε-prediction [B, T, F·C_out]; the head-skip ``residual`` is added to the
  input, the sum taken in fp32 and rounded to the storage dtype. Port of
  ``conv_head_tail.py::_tail_kernel`` (wrapper ``conv_tail_flat``).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/conv_head_tail.cu``); on a CPU tensor it runs its plain PyTorch twin
(``*_plain``). No fallback from one to the other. Both are bound by bytes.
bf16 takes the tensor-core kernels wherever their plan
(``ops/tile_plan.py`` ``conv_head_plan`` / ``conv_tail_plan``, the model of
``csrc/conv_plan.h``) does, which is every shape of audio.yml: the head's
576 FMAs an output position would hold CUDA cores at 85% of its byte bound
(1.2 G FMA a sample at 8192 × 256), so its products run as an im2col MMA
(K = 9·C_in, N = C0 = 32), and the tail moves its three column taps into N
(K = 3·C0, N = 3·C_out). The fp32 head at C0 = 32 runs the same persistent
block in split TF32 (hi + lo TF32 a value, three products: fp32 accuracy)
wherever its rows fit, audio.yml's among them; the fp32 tail keeps the
CUDA-core kernel. The head's statistics are per-(sample, channel) [B, C0]
sums of per-block partials (one a persistent block on the tensor cores, one
a 64-position tile on CUDA cores) finished by ``torch.sum``
(deterministic); the TPU kernel's per-lane sums fold to the same thing.
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
from .sums import partials_sum
from .conv_flat import _finish, _nchw
from .conv_strided import _bias
from .tile_plan import VARIANT_NONE, conv_head_plan, conv_tail_plan


def _conv3x3_plain(v_flat, w, bias, c_in: int):
    """fp32 3×3 SAME conv of the flat [B, T, F·c_in] operand + bias →
    [B, T, F, c_out] fp32."""
    out = F.conv2d(_nchw(v_flat, c_in),
                   w.float().permute(3, 2, 0, 1).contiguous(), padding=1)
    return out.permute(0, 2, 3, 1) + _bias(bias, w.shape[3], v_flat.device)


def conv_head_flat_plain(x, w, bias, *, c_in: int, c0: int,
                         want_stats: bool = False):
    """Plain twin of ``conv_head_flat``: ``F.conv2d`` in fp32 on the stored
    operands."""
    return _finish(_conv3x3_plain(x, w, bias, c_in), x.dtype, want_stats)


def conv_tail_flat_plain(h, w, bias, *, c0: int, c_out: int, residual=None):
    """Plain twin of ``conv_tail_flat``: the residual sum in fp32 rounded to
    the storage dtype, then ``F.conv2d`` in fp32."""
    v = h if residual is None else (h.float() + residual.float()).to(h.dtype)
    return _finish(_conv3x3_plain(v, w, bias, c0), h.dtype, False)


def _flat_geometry(x, c: int, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c:
        raise ValueError(f"{name}: F·C={fc} is not a multiple of C={c}")
    return b, t, fc // c


def _require_kernel(plan, name: str, shape: str) -> None:
    """A shape no kernel takes raises, among them a bf16 one too wide for
    the tensor-core kernel: the CUDA-core kernel never runs in its place."""
    if plan.variant == VARIANT_NONE:
        raise ValueError(f"{name} kernel: no variant takes {shape} (plan "
                         f"{plan})")


def conv_head_flat(x, w, bias, *, c_in: int, c0: int,
                   want_stats: bool = False):
    """x: [B, T, F·C_in] fp32 or bf16 → [B, T, F·C0]; w: [3, 3, C_in, C0]
    HWIO in x's dtype; bias: [C0] fp32. Returns out, or (out, sum [B, C0],
    sum² [B, C0]) when want_stats."""
    if use_twin(x):
        kw = dict(c_in=c_in, c0=c0, want_stats=want_stats)
        return twin_result("conv_head_flat",
                           conv_head_flat_plain(x, w, bias, **kw), x,
                           lambda: conv_head_flat(x, w, bias, **kw))
    b, t, f = _flat_geometry(x, c_in, "conv_head_flat")
    if not 1 <= c_in <= 4:
        raise ValueError(f"conv_head_flat kernel: needs 1 <= C_in <= 4, got "
                         f"{c_in}")
    bf16 = require_cuda_dtype(x, "conv_head_flat")
    plan = conv_head_plan(t, f, c_in, c0, bool(bf16), b)
    _require_kernel(plan, "conv_head_flat",
                    f"T={t} F={f} C_in={c_in} C0={c0} {x.dtype}")
    dev = x.device
    check_operand(x, "x", device=dev)
    check_operand(w, "w", device=dev, dtype=x.dtype, shape=(3, 3, c_in, c0))
    bias = _bias(bias, c0, dev)
    out = torch.empty((b, t, f * c0), dtype=x.dtype, device=dev)
    stats = None
    if want_stats:  # one partial a block (or CUDA-core tile): the plan's
        stats = torch.empty((b, plan.tiles, 2, c0), dtype=torch.float32,
                            device=dev)
    with torch.cuda.device(dev):
        err = kernels().ddim_conv_head(ptr(x), ptr(w), ptr(bias), ptr(out),
                                       ptr(stats), b, t, f, c_in, c0, bf16,
                                       stream_ptr(x))
    check(err, "conv_head_flat")
    conv_head_flat.launches += 1
    if not want_stats:
        return out
    return (out, *partials_sum(stats))


def conv_tail_flat(h, w, bias, *, c0: int, c_out: int, residual=None):
    """h: [B, T, F·C0] fp32 or bf16 → [B, T, F·C_out]; w: [3, 3, C0, C_out]
    HWIO in h's dtype; bias: [C_out] fp32; residual: optional [B, T, F·C0]
    in h's dtype, summed into the input."""
    if use_twin(h):
        kw = dict(c0=c0, c_out=c_out, residual=residual)
        return twin_result("conv_tail_flat",
                           conv_tail_flat_plain(h, w, bias, **kw), h,
                           lambda: conv_tail_flat(h, w, bias, **kw))
    b, t, f = _flat_geometry(h, c0, "conv_tail_flat")
    if c0 % 32 or c_out not in (1, 2, 4):
        raise ValueError(f"conv_tail_flat kernel: needs C0 % 32 == 0 and "
                         f"C_out in (1, 2, 4), got C0={c0}, C_out={c_out}")
    bf16 = require_cuda_dtype(h, "conv_tail_flat")
    _require_kernel(conv_tail_plan(t, f, c0, c_out, bool(bf16), b),
                    "conv_tail_flat", f"T={t} F={f} C0={c0} {h.dtype}")
    dev = h.device
    check_operand(h, "h", device=dev)
    check_operand(w, "w", device=dev, dtype=h.dtype, shape=(3, 3, c0, c_out))
    check_operand(residual, "residual", device=dev, dtype=h.dtype,
                  shape=h.shape)
    bias = _bias(bias, c_out, dev)
    out = torch.empty((b, t, f * c_out), dtype=h.dtype, device=dev)
    with torch.cuda.device(dev):
        err = kernels().ddim_conv_tail(
            ptr(h), ptr(residual), ptr(w), ptr(bias), ptr(out), b, t, f, c0,
            c_out, bf16, stream_ptr(h))
    check(err, "conv_tail_flat")
    conv_tail_flat.launches += 1
    return out


conv_head_flat.launches = 0
conv_tail_flat.launches = 0
