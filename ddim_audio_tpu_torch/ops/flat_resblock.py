"""Fused residual block over the flat state [B, T, F·C] (port of
``ddim_audio_tpu/ops/flat_resblock.py::resblock_flat``, float or int8 taps).

    x → GN1 → SiLU → conv1 (+temb) → SiLU → GN2 → conv2 (+b) → SiLU → GN3 → +x

runs as two fused ``conv3x3_flat`` calls plus plain torch glue:

1. conv1 with GN1 as its prologue affine (from precomputed statistics) +
   SiLU, the per-sample temb add + SiLU in the epilogue, and GN2's
   statistics from the epilogue;
2. conv2 with GN2 as its prologue, bias + SiLU epilogue, GN3's statistics;
3. the tail ``x + GN3(s)`` in torch (an XLA fusion in the JAX package, not a
   Pallas kernel), and the next block's statistics from the storage-dtype
   result, as the JAX package takes them.

GroupNorm statistics are per-(sample, channel) sums [B, C]; the groups fold
from them exactly (8 groups, eps 1e-6).
"""

from __future__ import annotations

import torch

from .conv_flat import conv3x3_flat, quantize_conv_weights_int8

GROUPS = 8
EPS = 1e-6


def channel_sums(x_flat: torch.Tensor, c: int):
    """Per-(sample, channel) (sum, sum²) over T and F, accumulated in fp32
    from x's own values: ([B, C], [B, C]). Two read passes; no fp32 copy of
    x is made (sum² is the squared fp32 2-norm)."""
    b, t, fc = x_flat.shape
    xv = x_flat.view(b, t * (fc // c), c)
    s1 = xv.sum(dim=1, dtype=torch.float32)
    s2 = torch.linalg.vector_norm(xv, dim=1, dtype=torch.float32).square()
    return s1, s2


def gn_affine_from_sums(s1, s2, n: int, norm_params, c: int):
    """GroupNorm folded to per-channel (scale, shift) [B, C] fp32 from
    per-channel sums (n = elements per (sample, group)): GN(x) = x·scale + shift."""
    b = s1.shape[0]
    cpg = c // GROUPS
    # [B, G, 1] group moments, broadcast back over the group's channels
    mean = s1.view(b, GROUPS, cpg).sum(dim=2, keepdim=True) / n
    var = s2.view(b, GROUPS, cpg).sum(dim=2, keepdim=True) / n - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + EPS)
    scale = rstd * norm_params["g"].float().view(GROUPS, cpg)
    shift = -mean * scale
    if "b" in norm_params:
        shift = shift + norm_params["b"].float().view(GROUPS, cpg)
    return scale.view(b, c), shift.view(b, c)


def _taps(conv, dtype, tap_int8: bool):
    """(w, w_scale) of a resblock conv for ``conv3x3_flat``: the float weight
    in the compute dtype, or the int8 weight and its scales from
    ``models.unet.prepare_params``'s copy (``wq``, ``w_scale``). A tree that
    was not prepared is quantised here only while it still holds the fp32
    weights, which gives the same integers; quantising a weight that was
    already cast would not, so that raises."""
    if not tap_int8:
        return conv["w"].to(dtype), None
    if "wq" in conv:
        return conv["wq"], conv["w_scale"]
    if conv["w"].dtype != torch.float32:
        raise ValueError(
            f"tap_int8: the conv weight is {conv['w'].dtype} and has no "
            "'wq'/'w_scale': int8 weights are quantised from the fp32 "
            "weights (models.unet.prepare_params), not from a cast copy")
    return quantize_conv_weights_int8(conv["w"])


def resblock_flat(p, x_flat, temb, *, f: int, c: int, in_stats=None,
                  want_out_stats: bool = False, tap_int8: bool = False):
    """p: resblock params; x_flat [B, T, F·C] in the compute dtype; temb
    [B, C] fp32. in_stats: optional per-channel (sum, sum²) of x_flat from
    the producer (previous block or a transition kernel); computed here when
    absent. tap_int8: both convs run their taps in int8
    (``conv3x3_flat_int8``); the tail ``x + GN3(s)`` is unchanged. Returns
    out, or (out, out_stats) when want_out_stats."""
    dtype = x_flat.dtype
    b, t, fc = x_flat.shape
    n = t * f * (c // GROUPS)
    if in_stats is None:
        in_stats = channel_sums(x_flat, c)
    w1, ws1 = _taps(p["conv1"], dtype, tap_int8)
    w2, ws2 = _taps(p["conv2"], dtype, tap_int8)
    h, h1, h2 = conv3x3_flat(
        x_flat, w1, c=c, pre=gn_affine_from_sums(*in_stats, n, p["norm1"], c),
        pre_silu=True, add=temb, post_silu=True, want_stats=True, w_scale=ws1)
    s, s1, s2 = conv3x3_flat(
        h, w2, c=c, pre=gn_affine_from_sums(h1, h2, n, p["norm2"], c),
        add=p["conv2"]["b"], post_silu=True, want_stats=True, w_scale=ws2)
    scale3, shift3 = gn_affine_from_sums(s1, s2, n, p["norm3"], c)
    # x + GN3(s) in fp32 in three passes (add promotes x to fp32, addcmul_
    # runs in place), rounded once to the storage dtype
    out = torch.add(x_flat.view(b, t, f, c), shift3[:, None, None, :])
    out.addcmul_(s.view(b, t, f, c), scale3[:, None, None, :])
    out = out.to(dtype).view(b, t, fc)
    if want_out_stats:
        return out, channel_sums(out, c)
    return out
