"""The denoiser: conv U-Net with an FNet bottleneck (port of
``ddim_audio_tpu/models/unet.py``).

Two forwards, as in the JAX package:

- ``apply_model``: the plain forward (the JAX package's XLA branch), [B, C, T, F]
  in and out, layer by layer in PyTorch. It is the reference the kernel route
  is held against on the card.
- ``apply_model_flat_io``: the sampling forward over the unpadded flat state
  [B, T, F·channels]. Every resblock runs as two fused ``conv3x3_flat`` calls
  (``ops/flat_resblock.py``), the stage transitions as ``conv_down_flat`` /
  ``conv_up_flat`` with GroupNorm statistics from their epilogues and the
  up path's skip add fused, and the head/tail as the channel-padded square
  ``conv3x3_flat`` (the JAX package's own route where its asymmetric
  head/tail kernels do not apply; those kernels are ROADMAP item B4). On CUDA
  tensors these are the hand-written kernels, on CPU tensors their twins.

Parameters are nested dicts of torch tensors with the JAX package's
structure and storage (``init_model``); master weights are fp32 and are cast
to the compute dtype at apply time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from ..ops.conv_flat import conv3x3_flat
from ..ops.conv_strided import conv_down_flat, conv_up_flat
from ..ops.flat_resblock import resblock_flat
from .embeddings import beta_embedding_apply, beta_embedding_init
from .fnet import transformer_module_apply, transformer_module_init
from .layers import (
    conv_apply,
    conv_init,
    conv_transpose_apply,
    conv_transpose_init,
    group_norm_apply,
    group_norm_init,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    channels: int = 2
    f_size: int = 256
    ch: Sequence[int] = (32, 64, 96, 128, 192, 256)
    krn: Sequence[int] = (3, 3, 3, 3, 3, 3)
    res: Sequence[int] = (2, 2, 3, 3, 3, 3)
    num_timesteps: int = 1000
    dtype: torch.dtype = torch.float32  # compute dtype; params stay fp32
    transformers: Any = None  # namespace: module/kwargs/channels/fourier_impl

    @classmethod
    def from_config(cls, config):
        """Build from a loaded YAML namespace (config.model/.diffusion).
        Options the port does not have yet raise (config.reject_unported)."""
        from ..config import reject_unported, resolve_dtype

        m = config.model
        reject_unported(m, "model")
        return cls(
            channels=m.channels,
            f_size=m.f_size,
            ch=tuple(m.ch),
            krn=tuple(m.krn),
            res=tuple(m.res),
            num_timesteps=config.diffusion.num_diffusion_timesteps,
            dtype=resolve_dtype(getattr(m, "dtype", None)),
            transformers=m.transformers,
        )

    @property
    def embedding_sizes(self) -> tuple:
        down = [c for c, r in zip(self.ch, self.res) for _ in range(r)]
        return tuple(down + down[::-1])

    @property
    def bottleneck_io(self) -> int:
        return self.ch[-1] * (self.f_size // (2 ** (len(self.ch) - 1)))

    @property
    def transformer_dtype(self) -> torch.dtype:
        from ..config import resolve_dtype

        return resolve_dtype(getattr(self.transformers, "dtype", None))


def _resblock_init(gen, channels: int, kernel_size: int, device):
    return {
        "norm1": group_norm_init(channels, device=device),
        "conv1": conv_init(gen, kernel_size, kernel_size, channels, channels,
                           bias=False, device=device),
        "norm2": group_norm_init(channels, device=device),
        "conv2": conv_init(gen, kernel_size, kernel_size, channels, channels,
                           bias=True, device=device),
        "norm3": group_norm_init(channels, bias=False, zero_weight=True,
                                 device=device),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cpu"):
    """The parameter tree (fp32), drawn from ``gen``: same structure, shapes
    and init bounds as ``ddim_audio_tpu.models.unet.init_model``
    (47,155,266 params at audio.yml). Note the zero-init GN3 weights make
    every resblock the identity at init."""
    params = {"temb": beta_embedding_init(gen, cfg.num_timesteps,
                                          sum(cfg.embedding_sizes),
                                          device=device)}
    down = {"head": conv_init(gen, 3, 3, cfg.channels, cfg.ch[0], device=device)}
    up = {"tail": conv_init(gen, 3, 3, cfg.ch[0], cfg.channels, device=device)}
    down_stages, up_stages = [], []
    prev = -1
    for ch, krn, res in zip(cfg.ch, cfg.krn, cfg.res):
        dstage, ustage = {}, {}
        if prev != -1:
            dstage["down"] = conv_init(gen, 4, 4, prev, ch, device=device)
            ustage["up"] = conv_transpose_init(gen, 4, 4, ch, prev,
                                               device=device)
        dstage["blocks"] = [_resblock_init(gen, ch, krn, device)
                            for _ in range(res)]
        ustage["blocks"] = [_resblock_init(gen, ch, krn, device)
                            for _ in range(res)]
        down_stages.append(dstage)
        up_stages.append(ustage)
        prev = ch
    down["stages"] = down_stages
    up["stages"] = up_stages
    params["down_modules"] = down
    params["up_modules"] = up
    params["transformer"] = transformer_module_init(
        gen, cfg.bottleneck_io, cfg.transformers, device=device)
    return params


def _cast_conv_weights(params, dtype: torch.dtype):
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.ndim == 4 else params
    if isinstance(params, dict):
        return {k: _cast_conv_weights(v, dtype) for k, v in params.items()}
    return [_cast_conv_weights(v, dtype) for v in params]


def prepare_params(params, dtype: torch.dtype):
    """The tree a sampler loop passes on every step, made once per run: the
    conv weights (the 4-D leaves) cast to the compute dtype, and the head and
    tail also stored as the padded square conv the flat forward runs
    (``"square"``, see ``_padded_square``). The forwards then cast and pad
    nothing per call; ``apply_model`` ignores the extra entries."""
    p = _cast_conv_weights(params, dtype)
    c0 = p["down_modules"]["head"]["w"].shape[3]
    for conv in (p["down_modules"]["head"], p["up_modules"]["tail"]):
        conv["square"] = _padded_square(conv, c0, dtype)
    return p


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)


def _temb_chunks(params, t, cfg: ModelConfig):
    temb = beta_embedding_apply(params["temb"], t,
                                num_timesteps=cfg.num_timesteps)
    return list(torch.split(temb, list(cfg.embedding_sizes), dim=-1))


def _check_time(t_len: int, cfg: ModelConfig) -> None:
    stride_total = 2 ** (len(cfg.ch) - 1)
    if t_len % stride_total:
        raise ValueError(f"T={t_len} must be divisible by the total stride "
                         f"{stride_total}")


def _resblock_apply(p, x, temb, *, kernel_size: int):
    """x: [B, T, F, C]; temb: [B, C]. Identity at init (zero-weight GN3)."""
    pad = kernel_size // 2
    h = F.silu(group_norm_apply(p["norm1"], x))
    h = conv_apply(p["conv1"], h, padding=pad) + temb[:, None, None, :].to(x.dtype)
    h = group_norm_apply(p["norm2"], F.silu(h))
    h = F.silu(conv_apply(p["conv2"], h, padding=pad))
    return x + group_norm_apply(p["norm3"], h)


def _bottleneck(params, h, cfg: ModelConfig):
    """[B, T', F', C] → tokens [B, T', C·F'] ((C, F) flatten order) → FNet →
    back, in the transformer's dtype."""
    b, tt, ff, cc = h.shape
    z = h.permute(0, 1, 3, 2).reshape(b, tt, cc * ff).to(cfg.transformer_dtype)
    z = transformer_module_apply(params["transformer"], z,
                                 tcfg=cfg.transformers)
    return z.reshape(b, tt, cc, ff).permute(0, 1, 3, 2).to(h.dtype)


def apply_model(params, x, t, cfg: ModelConfig):
    """Plain denoiser forward (eval): x [B, C, T, F], t int [B] →
    ε-prediction [B, C, T, F] fp32."""
    if x.ndim != 4 or x.shape[1] != cfg.channels or x.shape[3] != cfg.f_size:
        raise ValueError(f"expected x of shape [B, {cfg.channels}, T, "
                         f"{cfg.f_size}], got {tuple(x.shape)}")
    _check_time(x.shape[2], cfg)
    h = x.permute(0, 2, 3, 1).to(cfg.dtype)
    temb_iter = iter(_temb_chunks(params, t, cfg))

    hidden = [conv_apply(params["down_modules"]["head"], h, padding=1)]
    h = hidden[0]
    for stage, krn in zip(params["down_modules"]["stages"], cfg.krn):
        if "down" in stage:
            h = conv_apply(stage["down"], h, stride=2, padding=1)
        for block in stage["blocks"]:
            h = _resblock_apply(block, h, next(temb_iter), kernel_size=krn)
        hidden.append(h)
    h = _bottleneck(params, h, cfg)
    for stage, krn in zip(reversed(params["up_modules"]["stages"]),
                          reversed(cfg.krn)):
        h = h + hidden.pop()
        for block in stage["blocks"]:
            h = _resblock_apply(block, h, next(temb_iter), kernel_size=krn)
        if "up" in stage:
            h = conv_transpose_apply(stage["up"], h, stride=2, padding=1)
    h = h + hidden.pop()
    h = conv_apply(params["up_modules"]["tail"], h, padding=1)
    return h.permute(0, 3, 1, 2).float()


def apply_model_flat_io(params, xf, t, cfg: ModelConfig):
    """Flat-io denoiser for sampler loops: xf [B, T, F·channels] unpadded
    flat (row-major (f, c) lanes); returns the ε-prediction in the same
    layout, in the compute dtype."""
    if xf.ndim != 3 or xf.shape[2] != cfg.f_size * cfg.channels:
        raise ValueError(f"expected flat x [B, T, {cfg.f_size * cfg.channels}]"
                         f", got {tuple(xf.shape)}")
    _check_time(xf.shape[1], cfg)
    return _apply_model_flat_core(params, xf.to(cfg.dtype),
                                  _temb_chunks(params, t, cfg), cfg)


def flat_io_adapters(cfg: ModelConfig):
    """(to_flat, from_flat) for the flat sampling state — the one definition
    of the carried-layout contract: [B, C, T, F] fp32 ↔ unpadded flat
    [B, T, F·C]."""
    cin, f = cfg.channels, cfg.f_size

    def to_flat(xn):
        b, _, t, ff = xn.shape
        return xn.permute(0, 2, 3, 1).reshape(b, t, ff * cin)

    def from_flat(xf):
        b, t, _ = xf.shape
        return xf.reshape(b, t, f, cin).permute(0, 3, 1, 2).float()

    return to_flat, from_flat


def _padded_square(conv, c0: int, dtype: torch.dtype):
    """(w, b): a 3×3 head (cin → c0) or tail (c0 → cout) conv zero-padded
    to the square [3, 3, c0, c0] conv, weight in the compute dtype and fp32
    bias (the JAX package's route where its asymmetric head/tail kernels do
    not apply, unet.py:577-594, :690-698). Taken from ``prepare_params``'s
    copy when there is one."""
    if "square" in conv:
        w, b = conv["square"]
        return w.to(dtype), b
    w, b = conv["w"], conv["b"]
    return (F.pad(w.to(dtype), (0, c0 - w.shape[3], 0, c0 - w.shape[2])),
            F.pad(b.float(), (0, c0 - b.shape[0])))


def _apply_model_flat_core(params, xf, temb_chunks, cfg: ModelConfig):
    """Flat-layout forward: xf [B, T, F·channels] in the compute dtype."""
    dtype = cfg.dtype
    temb_iter = iter(temb_chunks)
    bsz, t, _ = xf.shape
    c0, f, cin = cfg.ch[0], cfg.f_size, cfg.channels

    def run_blocks(stage, hf, f, c, stats):
        blocks = stage["blocks"]
        for k, block in enumerate(blocks):
            last = k == len(blocks) - 1
            res = resblock_flat(block, hf, next(temb_iter), f=f, c=c,
                                in_stats=stats, want_out_stats=not last)
            hf, stats = res if not last else (res, None)
        return hf

    # Head: channel-pad the state to ch0 and run the square kernel; its
    # epilogue seeds stage 0's GroupNorm statistics.
    w_head, b_head = _padded_square(params["down_modules"]["head"], c0, dtype)
    xp = F.pad(xf.view(bsz, t, f, cin), (0, c0 - cin)).reshape(bsz, t, f * c0)
    hf, hs1, hs2 = conv3x3_flat(xp, w_head, c=c0, add=b_head,
                                want_stats=True)

    hidden = [hf]
    stats = (hs1, hs2)
    prev = None
    for i, (stage, c) in enumerate(zip(params["down_modules"]["stages"],
                                       cfg.ch)):
        if i > 0 and "down" not in stage:
            raise NotImplementedError(
                "flat path: a stage > 0 without a 'down' transition has no "
                "fused GroupNorm-statistics source")
        if "down" in stage:
            hf, s1, s2 = conv_down_flat(
                hf, stage["down"]["w"].to(dtype), stage["down"]["b"],
                c_in=prev, c_out=c, want_stats=True)
            stats = (s1, s2)
            t //= 2
            f //= 2
        hf = run_blocks(stage, hf, f, c, stats)
        hidden.append(hf)
        prev = c

    cc = cfg.ch[-1]
    hf = _bottleneck(params, hf.view(bsz, t, f, cc), cfg).reshape(bsz, t, f * cc)

    # Up path: the skip add and the next statistics fuse into the transposed
    # conv's epilogue; only the bottleneck-scale add is a separate op.
    up_stages = params["up_modules"]["stages"]
    chs = list(cfg.ch)
    stats = None
    for idx in range(len(up_stages) - 1, -1, -1):
        stage, c = up_stages[idx], chs[idx]
        if idx == len(up_stages) - 1:
            hf = hf + hidden.pop()
        hf = run_blocks(stage, hf, f, c, stats)
        if "up" in stage:
            hf, s1, s2 = conv_up_flat(
                hf, stage["up"]["w"].to(dtype), stage["up"]["b"], c_in=c,
                c_out=chs[idx - 1], residual=hidden.pop(), want_stats=True)
            stats = (s1, s2)
            t *= 2
            f *= 2

    # Tail: the square kernel with the head skip fused into its input; keep
    # the real output channels.
    tail = params["up_modules"]["tail"]
    cout = tail["w"].shape[3]
    w_tail, b_tail = _padded_square(tail, c0, dtype)
    of = conv3x3_flat(hf, w_tail, c=c0, add=b_tail,
                      residual=hidden.pop())
    return of.view(bsz, t, f, c0)[..., :cout].reshape(bsz, t, f * cout)
