"""The comparisons that decide a run's ``correct``, on the reference of this
folder in float32 with TF32 off (or, for the control, in a lower
precision). They take the benchmark's own inputs and the program's
outputs, and nothing else the program made."""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from .model import Geometry, Model, Ops
from .sampler import alphas_cumprod, ddim_chain, wiener_2d
from .train import Optimizer, leaves, loss_and_grads, rebuild


@contextlib.contextmanager
def float32_math(tf32: bool = False):
    """Matmuls and convs in true float32 (TF32 off), or in TF32; cuDNN picks
    its fastest algorithm a shape (the reference runs many steps a shape)."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.benchmark = True
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = old


def fp8(x):
    """x rounded to float8 e4m3, scaled per tensor to its range."""
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def int4(x, dims):
    """x rounded to int4 (−7 … 7) with one scale for each slice over
    ``dims`` (the slice's largest magnitude maps to 7)."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / 7.0
    return torch.round(x / scale).clamp(-7, 7) * scale


def int4_groups(x):
    """An activation [B, C, T, F] in int4 with a scale a group of 8 frames ×
    16 bins of a channel (the program's int8 group, at int4)."""
    b, c, t, f = x.shape
    gt, gf = min(8, t), min(16, f)
    g = x.reshape(b, c, t // gt, gt, f // gf, gf)
    return int4(g, (3, 5)).reshape(b, c, t, f)


class ControlOps(Ops):
    """The control: the reference one precision step below what the
    configuration states (``declared``: its YAML's sampling precisions, and
    the widths they apply to). Convs it states in bf16 take float8 e4m3
    operands; where it states int8 taps (resblocks up to
    ``int8_taps_max_width``; with ``strided_int8`` the listed strided
    transitions) both operands are int4, where it states int8 activation
    storage (resblocks up to ``act_store_max_width``) the activations are
    int4 and the weights float8. Products stay float32."""

    def __init__(self, declared: dict):
        self.d = declared

    def _operands(self, x, w, strided: bool):
        """(x, w) rounded; w is [C_out, C_in, kh, kw]."""
        d = self.d
        c_out, c_in = w.shape[0], w.shape[1]
        if strided:
            key = [min(c_in, c_out), max(c_in, c_out)]
            taps = d["strided_int8"] and any(
                sorted(t[:2]) == key for t in d["strided_int8_transitions"])
            store = False
        else:
            resblock = c_in == c_out
            taps = resblock and d["tap_int8"] and \
                c_in <= d["int8_taps_max_width"]
            store = resblock and d["act_store"] == "int8" and \
                c_in <= d["act_store_max_width"]
        if store:
            return int4_groups(x), fp8(w)
        if taps:
            return int4_groups(x), int4(w, (1, 2, 3))
        return fp8(x), fp8(w)

    def conv(self, x, w_hwio, bias=None, *, stride=1, padding=1):
        w = w_hwio.permute(3, 2, 0, 1)
        x, w = self._operands(x, w, stride != 1)
        out = F.conv2d(x, w, stride=stride, padding=padding)
        return out if bias is None else out + bias[:, None, None]

    def conv_up(self, x, w_hwio, bias):
        w = w_hwio.permute(2, 3, 0, 1).flip(2, 3)  # [C_in, C_out, kh, kw]
        x, wt = self._operands(x, w.transpose(0, 1), True)
        out = F.conv_transpose2d(x, wt.transpose(0, 1), stride=2, padding=1)
        return out + bias[:, None, None]


SPANS = 32


def rel_err(got, ref) -> float:
    """‖got − ref‖ / ‖ref‖ over a whole clip [C, T, F]."""
    got = torch.as_tensor(np.asarray(got)).double()
    ref = ref.detach().cpu().double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-300))


def span_errs(got, ref) -> list:
    """Each of ``SPANS`` spans of frames (T) of a clip [C, T, F]: the span's
    relative RMS error."""
    got = torch.as_tensor(np.asarray(got)).double()
    ref = ref.detach().cpu().double()
    n = min(SPANS, ref.shape[1])
    return [float(torch.linalg.vector_norm(g - r)
                  / torch.linalg.vector_norm(r).clamp_min(1e-300))
            for g, r in zip(torch.tensor_split(got, n, dim=1),
                            torch.tensor_split(ref, n, dim=1))]


def clip_errors(got, ref) -> tuple:
    """(compared, logged) numbers of a program's clips ``got`` against the
    reference's ``ref`` [N, C, T, F]. Compared: ``span_err_median``, the
    worst clip's median span error. Logged: ``clip_err``, the worst clip's
    whole error, and ``span_err_max``, the worst span's. With seed-made
    weights a DDIM walk in any lower precision departs from the reference
    in a few spans of some clips, so these two swing from seed to seed and
    are not compared (PERF.md §2)."""
    n = ref.shape[0]
    spans = [span_errs(got[i], ref[i]) for i in range(n)]
    compared = {"span_err_median": max(statistics.median(s) for s in spans)}
    logged = {"clip_err": max(rel_err(got[i], ref[i]) for i in range(n)),
              "span_err_max": max(max(s) for s in spans)}
    return compared, logged


def sample_clips(config: dict, params, x, timesteps: int, ops=None,
                 tf32: bool = False):
    """The reference's clips from start noise x [N, C, T, F]: the DDIM walk
    and the filter (``sampling.denoise``)."""
    geom = Geometry.from_config(config)
    model = Model(geom, x.device, ops)
    abar = alphas_cumprod(config["diffusion"])
    with float32_math(tf32):
        out = ddim_chain(model, params, x.float(), abar, timesteps)
        if config["sampling"].get("denoise"):
            out = wiener_2d(out)
    return out


def sample_error(config: dict, params, x, got, timesteps: int):
    """``clip_errors`` of the program's clips ``got`` against the
    reference's from the same start noise."""
    return clip_errors(got, sample_clips(config, params, x, timesteps).cpu())


def train_reference(config: dict, params, batches, masks, *, chunk: int,
                    tf32: bool = False, ops=None):
    """The reference's first steps from ``params``: for each batch (x0, t,
    e) the loss, and after the first step the clipped gradient each leaf
    got; the parameters and their float32 moving average (``model.ema_rate``,
    from the parameters) after the last. Returns (losses, first gradient,
    last parameters, last average), the last three {path: tensor}."""
    geom = Geometry.from_config(config)
    device = batches[0][0].device
    model = Model(geom, device, ops)
    abar = alphas_cumprod(config["diffusion"])
    flat = {k: v.detach().clone() for k, v in leaves(params).items()}
    ema = {k: v.clone() for k, v in flat.items()}
    mu = float(config["model"]["ema_rate"])
    opt = Optimizer(config["optimization"], flat)
    losses, first = [], None
    with float32_math(tf32):
        for (x0, t, e), m in zip(batches, masks):
            loss, grads = loss_and_grads(model, rebuild(params, flat), x0, t,
                                         e, abar, m, chunk)
            flat = opt.step(flat, grads)
            ema = {k: (1.0 - mu) * flat[k] + mu * v for k, v in ema.items()}
            losses.append(loss)
            if first is None:
                first = opt.last_grad
    return losses, first, flat, ema


def leaf_gaps(got: dict, ref: dict, ref_grad: dict) -> dict:
    """{leaf: the gap between the norms of ``got`` and ``ref`` over the
    larger of the leaf's reference norm and the median leaf's}, leaving out
    the leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone)."""
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_grad.items()}
    gmed = statistics.median(gnorm.values())
    keys = [k for k in ref if gnorm[k] >= 1e-3 * gmed]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(rn.values())
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - rn[k])
            / max(rn[k], med, 1e-300) for k in keys}


def norm_gaps(got: dict, ref: dict, ref_grad: dict) -> tuple:
    """(worst gap, its leaf, leaves compared) of ``leaf_gaps``."""
    gaps = leaf_gaps(got, ref, ref_grad)
    where = max(gaps, key=gaps.get)
    return gaps[where], where, len(gaps)


def median_gap(got: dict, ref: dict, ref_grad: dict) -> tuple:
    """(the median leaf's gap, the worst gap, its leaf) of ``leaf_gaps``."""
    gaps = leaf_gaps(got, ref, ref_grad)
    where = max(gaps, key=gaps.get)
    return statistics.median(gaps.values()), gaps[where], where


def ulp_flips(got: dict, ref: dict) -> tuple:
    """(values that differ, the largest difference in float32 steps) between
    two trees of float32 tensors of one sign a value."""
    n, worst = 0, 0
    for k, r in ref.items():
        d = (got[k].contiguous().view(torch.int32).long()
             - r.contiguous().view(torch.int32).long()).abs()
        n += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    return n, worst
