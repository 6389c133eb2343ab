"""The denoiser: conv U-Net with an FNet bottleneck (port of
``ddim_audio_tpu/models/unet.py``).

Three forwards, as in the JAX package:

- ``apply_model``: the plain forward (the JAX package's XLA branch), [B, C, T, F]
  in and out, layer by layer in PyTorch. It is the reference the kernel routes
  are held against on the card.
- ``apply_model(..., train=True)``: the training forward. Unless
  ``cfg.conv_impl`` is ``"xla"`` every conv runs through the differentiable
  flat ops of ``ops/flat_grad.py`` (forward, dx and dW on the flat kernels),
  the head and tail as channel-padded square convs at ``ch[0]``, each
  resblock rematerialised in the backward pass (``cfg.remat``); dropout acts
  in the FNet bottleneck only, drawn from the caller's generator.
- ``apply_model_flat_io``: the sampling forward over the unpadded flat state
  [B, T, F·channels]. Every resblock runs as two fused ``conv3x3_flat`` calls
  (``ops/flat_resblock.py``), the stage transitions as ``conv_down_flat`` /
  ``conv_up_flat`` with GroupNorm statistics from their epilogues and the
  up path's skip add fused, and the head and tail as ``conv_head_flat`` /
  ``conv_tail_flat`` in the state's own unpadded layout. With
  ``cfg.tap_int8`` the resblock convs of the stages up to 96 channels run
  int8 taps; with ``cfg.act_store == "int8"`` the stages up to 128 channels
  keep their activations as int8 + scales between kernels
  (``resblock_flat_int8``, which runs float taps); with ``cfg.strided_int8``
  the transitions of ``strided_int8_transition`` run int8 taps. On CUDA
  tensors these are the hand-written kernels, on CPU tensors their twins.

Parameters are nested dicts of torch tensors with the JAX package's
structure and storage (``init_model``); master weights are fp32 and are cast
to the compute dtype at apply time.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv_flat import (
    INT8_WIDTHS,
    int8_weights_co_ci,
    quantize_conv_weights_int8,
)
from ..ops.conv_head_tail import conv_head_flat, conv_tail_flat
from ..ops.conv_strided import (
    conv_down_flat,
    conv_up_flat,
    quantize_strided_weights_int8,
)
from ..ops.flat_grad import (
    conv3x3_flat_t,
    conv_down_flat_t,
    conv_up_flat_t,
    resblock_flat_train,
)
from ..ops.flat_resblock import (conv3x3_taps, conv_taps, resblock_flat,
                                  resblock_flat_int8)
from ..utils.device import resolve_device
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
    # int8 × int8 → int32 taps in the resblock convs of the flat sampling
    # forward, at the stages where ``tap_int8_stage`` holds
    tap_int8: bool = False
    # "int8": int8 activation storage through the resblocks of the stages
    # where ``act_store_int8_stage`` holds (flat sampling forward)
    act_store: str | None = None
    # int8 taps in the transitions where ``strided_int8_transition`` holds
    strided_int8: bool = False
    # Rematerialise each resblock in the backward pass of the training
    # forward (activation memory for one more forward of the convs).
    remat: bool = True
    # Conv implementation of the training forward: "auto" runs the flat
    # kernels through their autograd Functions, "xla" the plain layers under
    # torch autograd (the reference route).
    conv_impl: str = "auto"

    @classmethod
    def from_config(cls, config):
        """Build from a loaded YAML namespace (config.model/.diffusion)."""
        from ..config import resolve_dtype

        m = config.model
        return cls(
            channels=m.channels,
            f_size=m.f_size,
            ch=tuple(m.ch),
            krn=tuple(m.krn),
            res=tuple(m.res),
            num_timesteps=config.diffusion.num_diffusion_timesteps,
            dtype=resolve_dtype(getattr(m, "dtype", None)),
            transformers=m.transformers,
            tap_int8=bool(getattr(m, "tap_int8", False)),
            act_store=getattr(m, "act_store", None),
            strided_int8=bool(getattr(m, "strided_int8", False)),
            conv_impl=getattr(m, "conv_impl", "auto"),
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


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """The parameter tree (fp32) on device, drawn from ``gen``: same
    structure, shapes and init bounds as
    ``ddim_audio_tpu.models.unet.init_model`` (47,155,266 params at
    audio.yml). Note the zero-init GN3 weights make every resblock the
    identity at init."""
    device = resolve_device(device)
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


def tap_int8_stage(cfg: ModelConfig, c: int) -> bool:
    """Whether a stage of width c runs int8 taps: the widths of the JAX
    package's ``tap_int8_profitable`` (C <= 96), where int32 accumulation of
    the 9·C int8 products is also exact in the fp32-based twin."""
    return cfg.tap_int8 and c <= max(INT8_WIDTHS)


def act_store_int8_stage(cfg: ModelConfig, c: int) -> bool:
    """Whether a stage of width c keeps int8 activation storage: the stages
    where the JAX package's ``supports_flat_int8`` holds on the TPU (C <= 128
    at audio.yml; the two deepest stages carry <2% of the forward's bytes
    and stay float)."""
    return cfg.act_store == "int8" and c <= 128


def strided_int8_transition(cfg: ModelConfig, c_in: int, c_out: int,
                            up: bool = False) -> bool:
    """Whether a transition C_in → C_out runs int8 taps: the JAX package's
    ``strided_int8_profitable``, the transitions whose TPU tap blocks are at
    most half dense (one C_in band of 128-lane slices covers a whole tap
    block). At audio.yml: down 32→64, up 64→32 and up 256→192."""
    if not cfg.strided_int8:
        return False
    period = math.lcm(c_in, 128)  # the flat layout's lane period of C_in
    if up:
        q = period
        while (2 * q * c_out) % (c_in * 128):
            q += period
        lanes = q
    else:
        p = base = math.lcm(c_out, 128)
        while (2 * c_in * p) % (c_out * 128):
            p += base
        lanes = 2 * c_in * p // c_out
    return -(-c_in // 128) * 128 >= lanes


def prepare_params(params, cfg: ModelConfig):
    """The tree a sampler loop passes on every step, made once per run: the
    conv weights (the 4-D leaves) cast to the compute dtype and, with
    ``cfg.tap_int8``, the resblock convs of the int8-tap stages, with
    ``cfg.strided_int8`` the int8 transitions, also quantised FROM THE FP32
    WEIGHTS (``wq``, ``w_scale`` beside ``w``; the resblock convs and the
    int8 up transitions also ``wq_t``, ``wq`` laid out [kh, kw, C_out, C_in]
    as their int8-tap kernels read it). The forwards then cast, quantise and
    lay out nothing per call; ``apply_model`` ignores the extra entries."""
    p = _cast_conv_weights(params, cfg.dtype)
    prev = None
    for c, src, dst in zip(cfg.ch, params["down_modules"]["stages"],
                           p["down_modules"]["stages"]):
        if "down" in src and strided_int8_transition(cfg, prev, c):
            wq, w_scale = quantize_strided_weights_int8(src["down"]["w"])
            dst["down"].update(wq=wq, w_scale=w_scale)
        prev = c
    for i, (c, src, dst) in enumerate(zip(cfg.ch, params["up_modules"]["stages"],
                                          p["up_modules"]["stages"])):
        if "up" in src and strided_int8_transition(cfg, c, cfg.ch[i - 1],
                                                   up=True):
            wq, w_scale = quantize_strided_weights_int8(src["up"]["w"])
            dst["up"].update(wq=wq, w_scale=w_scale,
                             wq_t=int8_weights_co_ci(wq))
    for mod in ("down_modules", "up_modules"):
        for c, src, dst in zip(cfg.ch, params[mod]["stages"],
                               p[mod]["stages"]):
            if not tap_int8_stage(cfg, c) or act_store_int8_stage(cfg, c):
                continue
            for bsrc, bdst in zip(src["blocks"], dst["blocks"]):
                for name in ("conv1", "conv2"):
                    wq, w_scale = quantize_conv_weights_int8(bsrc[name]["w"])
                    bdst[name].update(wq=wq, w_scale=w_scale,
                                      wq_t=int8_weights_co_ci(wq))
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


def _bottleneck(params, h, cfg: ModelConfig, *, train=False, generator=None):
    """[B, T', F', C] → tokens [B, T', C·F'] ((C, F) flatten order) → FNet →
    back, in the transformer's dtype."""
    b, tt, ff, cc = h.shape
    z = h.permute(0, 1, 3, 2).reshape(b, tt, cc * ff).to(cfg.transformer_dtype)
    z = transformer_module_apply(params["transformer"], z,
                                 tcfg=cfg.transformers, train=train,
                                 generator=generator)
    return z.reshape(b, tt, cc, ff).permute(0, 1, 3, 2).to(h.dtype)


def _remat(fn, cfg: ModelConfig):
    """fn, rematerialised in the backward pass when ``cfg.remat`` (and a
    gradient is being recorded at all)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def apply_model(params, x, t, cfg: ModelConfig, *, train: bool = False,
                generator=None):
    """Denoiser forward: x [B, C, T, F], t int [B] → ε-prediction
    [B, C, T, F] fp32. ``train=False`` is the plain forward; ``train=True``
    the training forward (module docstring), with the FNet dropout drawn
    from ``generator`` (None: no dropout, as the JAX package without a
    key)."""
    if x.ndim != 4 or x.shape[1] != cfg.channels or x.shape[3] != cfg.f_size:
        raise ValueError(f"expected x of shape [B, {cfg.channels}, T, "
                         f"{cfg.f_size}], got {tuple(x.shape)}")
    _check_time(x.shape[2], cfg)
    h = x.permute(0, 2, 3, 1).to(cfg.dtype)
    if train and cfg.conv_impl != "xla":
        return _apply_model_flat_train(params, h, _temb_chunks(params, t, cfg),
                                       cfg, generator)
    temb_iter = iter(_temb_chunks(params, t, cfg))
    block_apply = _resblock_apply
    if train:
        block_apply = _remat(_resblock_apply, cfg)

    hidden = [conv_apply(params["down_modules"]["head"], h, padding=1)]
    h = hidden[0]
    for stage, krn in zip(params["down_modules"]["stages"], cfg.krn):
        if "down" in stage:
            h = conv_apply(stage["down"], h, stride=2, padding=1)
        for block in stage["blocks"]:
            h = block_apply(block, h, next(temb_iter), kernel_size=krn)
        hidden.append(h)
    h = _bottleneck(params, h, cfg, train=train, generator=generator)
    for stage, krn in zip(reversed(params["up_modules"]["stages"]),
                          reversed(cfg.krn)):
        h = h + hidden.pop()
        for block in stage["blocks"]:
            h = block_apply(block, h, next(temb_iter), kernel_size=krn)
        if "up" in stage:
            h = conv_transpose_apply(stage["up"], h, stride=2, padding=1)
    h = h + hidden.pop()
    h = conv_apply(params["up_modules"]["tail"], h, padding=1)
    return h.permute(0, 3, 1, 2).float()


def _apply_model_flat_train(params, x, temb_chunks, cfg: ModelConfig,
                            generator):
    """The training forward on the flat kernels: x [B, T, F, channels] in the
    compute dtype → ε-prediction [B, channels, T, F] fp32. Master weights
    go to the ops as they are (fp32); the ops cast them and hand back fp32
    gradients."""
    if any(k != 3 for k in cfg.krn):
        raise NotImplementedError("the flat training route has 3×3 "
                                  "resblocks only (set conv_impl: xla)")
    temb_iter = iter(temb_chunks)
    b, t, f, cin = x.shape
    c0 = cfg.ch[0]

    def run_blocks(stage, hf, f, c):
        block_fn = _remat(functools.partial(resblock_flat_train, f=f, c=c),
                          cfg)
        for block in stage["blocks"]:
            hf = block_fn(block, hf, next(temb_iter))
        return hf

    # Head as a square conv at c0: weight zero-padded over its input
    # channels, the input padded with zero channels.
    head = params["down_modules"]["head"]
    hf = conv3x3_flat_t(
        F.pad(x, (0, c0 - cin)).reshape(b, t, f * c0),
        F.pad(head["w"], (0, 0, 0, c0 - cin)), head["b"], c=c0)

    hidden = [hf]
    prev = None
    for stage, c in zip(params["down_modules"]["stages"], cfg.ch):
        if "down" in stage:
            hf = conv_down_flat_t(hf, stage["down"]["w"], stage["down"]["b"],
                                  c_in=prev, c_out=c)
            t //= 2
            f //= 2
        hf = run_blocks(stage, hf, f, c)
        hidden.append(hf)
        prev = c

    cc = cfg.ch[-1]
    hf = _bottleneck(params, hf.view(b, t, f, cc), cfg, train=True,
                     generator=generator).reshape(b, t, f * cc)

    chs = list(cfg.ch)
    up_stages = params["up_modules"]["stages"]
    for idx in range(len(up_stages) - 1, -1, -1):
        stage, c = up_stages[idx], chs[idx]
        hf = run_blocks(stage, hf + hidden.pop(), f, c)
        if "up" in stage:
            hf = conv_up_flat_t(hf, stage["up"]["w"], stage["up"]["b"],
                                c_in=c, c_out=chs[idx - 1])
            t *= 2
            f *= 2

    # Tail as a square conv at c0: weight and bias zero-padded over the
    # output channels, the result sliced.
    tail = params["up_modules"]["tail"]
    cout = tail["w"].shape[3]
    of = conv3x3_flat_t(hf + hidden.pop(),
                        F.pad(tail["w"], (0, c0 - cout)),
                        F.pad(tail["b"], (0, c0 - cout)), c=c0)
    return of.view(b, t, f, c0)[..., :cout].permute(0, 3, 1, 2).float()


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


def _apply_model_flat_core(params, xf, temb_chunks, cfg: ModelConfig):
    """Flat-layout forward: xf [B, T, F·channels] in the compute dtype."""
    dtype = cfg.dtype
    temb_iter = iter(temb_chunks)
    bsz, t, _ = xf.shape
    c0, f, cin = cfg.ch[0], cfg.f_size, cfg.channels

    def run_blocks(stage, hf, f, c, stats):
        blocks = stage["blocks"]
        if act_store_int8_stage(cfg, c):
            # int8 + scales between the kernels of the stage; its entry
            # arrives float from a transition kernel and its last block
            # emits the compute dtype for the transition / skip / bottleneck
            scales = None
            for k, block in enumerate(blocks):
                last = k == len(blocks) - 1
                hf, scales, stats = resblock_flat_int8(
                    block, hf, next(temb_iter), f=f, c=c, dtype=dtype,
                    in_stats=stats, in_scales=scales, quant_out=not last,
                    want_out_stats=not last)
            return hf
        for k, block in enumerate(blocks):
            last = k == len(blocks) - 1
            res = resblock_flat(block, hf, next(temb_iter), f=f, c=c,
                                in_stats=stats, want_out_stats=not last,
                                tap_int8=tap_int8_stage(cfg, c))
            hf, stats = res if not last else (res, None)
        return hf

    # Head conv in the state's own layout; its epilogue seeds stage 0's
    # GroupNorm statistics.
    head = params["down_modules"]["head"]
    hf, hs1, hs2 = conv_head_flat(xf, head["w"].to(dtype), head["b"],
                                  c_in=cin, c0=c0, want_stats=True)

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
            w, w_scale = conv_taps(stage["down"], dtype,
                                   strided_int8_transition(cfg, prev, c))
            hf, s1, s2 = conv_down_flat(
                hf, w, stage["down"]["b"], c_in=prev, c_out=c,
                want_stats=True, w_scale=w_scale)
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
            w, taps = conv3x3_taps(
                stage["up"], dtype,
                strided_int8_transition(cfg, c, chs[idx - 1], up=True))
            hf, s1, s2 = conv_up_flat(
                hf, w, stage["up"]["b"], c_in=c, c_out=chs[idx - 1],
                residual=hidden.pop(), want_stats=True, **taps)
            stats = (s1, s2)
            t *= 2
            f *= 2

    # Tail conv with the head skip fused into its input; it emits the
    # unpadded ε-prediction. Float taps always: its output is the model's
    # result, so requantisation noise would land on it un-normalised.
    tail = params["up_modules"]["tail"]
    return conv_tail_flat(hf, tail["w"].to(dtype), tail["b"], c0=c0,
                          c_out=tail["w"].shape[3], residual=hidden.pop())
