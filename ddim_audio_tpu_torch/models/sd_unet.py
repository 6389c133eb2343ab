"""The Stable Diffusion v1.5 UNet, as Riffusion v1 published it
(https://huggingface.co/riffusion/riffusion-model-v1, ``unet/config.json``;
fine-tuned from ``runwayml/stable-diffusion-v1-5``, same shape), for
sampling.

Every equation is that of diffusers' ``UNet2DConditionModel`` with
``use_linear_projection`` false and dropout 0:

- time: ``timestep_sinusoid`` (flip_sin_to_cos, freq_shift) of width
  C0 = block_out_channels[0], then Linear C0 → 4·C0, SiLU, Linear 4·C0 →
  4·C0;
- ``conv_in`` (3×3), the down blocks (``CrossAttnDownBlock2D``: per layer a
  ResNet block then a Transformer2D; ``DownBlock2D``: ResNet blocks only;
  each but the last ends in a stride-2 3×3 conv), the mid block (ResNet,
  Transformer2D, ResNet), the up blocks (per layer the next skip
  concatenated, not added, then a ResNet block and, in
  ``CrossAttnUpBlock2D``, a Transformer2D; each but the last ends in a
  nearest ×2 upsample and a 3×3 conv), GroupNorm, SiLU and ``conv_out``;
- ResNet block: GN, SiLU, 3×3 conv, + Linear(SiLU(temb)), GN, SiLU, 3×3
  conv, + the input (through a 1×1 conv where the widths differ);
- Transformer2D: GN (eps 1e-6), 1×1 ``proj_in``, then per token LayerNorm →
  self-attention, LayerNorm → cross-attention to the text embeddings,
  LayerNorm → GEGLU feed-forward (4× width), each added back; 1×1
  ``proj_out``; + the input. Heads: ``attention_head_dim`` (diffusers reads
  that key as the number of heads), of width C / heads; no biases on q, k, v.

Parameters are nested dicts of fp32 tensors named after diffusers' modules
(``down_blocks[i].resnets[j].conv1`` …), in the port's storage: conv
weights HWIO [kh, kw, in, out], linear weights [in, out], norms ``g`` /
``b``. ``prepare_params`` casts every leaf to the compute dtype once a run,
lays the conv weights out for cuDNN (OIHW, channels-last) and joins q, k, v
(k, v for cross-attention) into one weight. Activations are channels-last
[B, H, W, C], so ``layers.group_norm_apply`` and ``layers.linear_apply`` are
the U-Net's own; convs run through cuDNN (``F.conv2d``), attention through
``F.scaled_dot_product_attention``.

Spans (``utils/tracing.py``): ``ddim.sd.resnet`` around each ResNet block,
``ddim.sd.transformer`` around each Transformer2D with ``ddim.sd.attn.self``,
``ddim.sd.attn.cross`` and ``ddim.sd.ff`` inside, ``ddim.sd.sample`` around
the convs between stages (``conv_in``, the down and up samplers, the output
norm and ``conv_out``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.tracing import span
from .embeddings import timestep_sinusoid
from .layers import group_norm_apply, linear_apply

MODEL_TYPE = "sd_unet"
# constants of diffusers' Transformer2DModel and BasicTransformerBlock, not
# keys of the UNet's config
TRANSFORMER_GN_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
FF_MULT = 4

_DOWN = ("CrossAttnDownBlock2D", "DownBlock2D")
_UP = ("CrossAttnUpBlock2D", "UpBlock2D")


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """The keys of ``unet/config.json`` that set the shape (defaults: SD
    v1.5 / Riffusion v1), the conditioning's length and the compute
    dtype."""
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    attention_head_dim: int = 8  # diffusers reads it as the number of heads
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0
    text_tokens: int = 77  # CLIP's context length
    num_timesteps: int = 1000
    dtype: torch.dtype = torch.float32  # compute dtype; params stay fp32

    def __post_init__(self):
        n = len(self.block_out_channels)
        if (len(self.down_block_types) != n or len(self.up_block_types) != n
                or not set(self.down_block_types) <= set(_DOWN)
                or not set(self.up_block_types) <= set(_UP)):
            raise ValueError(
                f"unsupported block types {self.down_block_types} / "
                f"{self.up_block_types}: the down blocks are {_DOWN}, the up "
                f"blocks {_UP}, one each per block_out_channels entry")

    @classmethod
    def from_config(cls, config):
        """From a loaded YAML namespace (``config.model``, whose keys are
        ``unet/config.json``'s, and ``config.diffusion``)."""
        from ..config import resolve_dtype

        m = config.model
        return cls(
            in_channels=m.in_channels, out_channels=m.out_channels,
            sample_size=m.sample_size,
            block_out_channels=tuple(m.block_out_channels),
            layers_per_block=m.layers_per_block,
            down_block_types=tuple(m.down_block_types),
            up_block_types=tuple(m.up_block_types),
            attention_head_dim=m.attention_head_dim,
            cross_attention_dim=m.cross_attention_dim,
            norm_num_groups=m.norm_num_groups, norm_eps=float(m.norm_eps),
            flip_sin_to_cos=bool(m.flip_sin_to_cos),
            freq_shift=float(m.freq_shift), text_tokens=m.text_tokens,
            num_timesteps=config.diffusion.num_diffusion_timesteps,
            dtype=resolve_dtype(getattr(m, "dtype", None)))

    @property
    def heads(self) -> int:
        return self.attention_head_dim

    @property
    def temb_channels(self) -> int:
        return 4 * self.block_out_channels[0]


# ------------------------------------------------------------- parameters

def _w(shape, fan_in):
    return ("w", tuple(shape), fan_in)


def _conv(k, cin, cout):
    fan = cin * k * k
    return {"w": _w((k, k, cin, cout), fan), "b": _w((cout,), fan)}


def _linear(cin, cout, bias=True):
    p = {"w": _w((cin, cout), cin)}
    if bias:
        p["b"] = _w((cout,), cin)
    return p


def _norm(c):
    return {"g": ("one", (c,), None), "b": ("zero", (c,), None)}


def _resnet(cin, cout, temb):
    p = {"norm1": _norm(cin), "conv1": _conv(3, cin, cout),
         "time_emb_proj": _linear(temb, cout), "norm2": _norm(cout),
         "conv2": _conv(3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _conv(1, cin, cout)
    return p


def _transformer(c, ctx):
    inner = FF_MULT * c
    block = {
        "norm1": _norm(c),
        "attn1": {"to_q": _linear(c, c, False), "to_k": _linear(c, c, False),
                  "to_v": _linear(c, c, False), "to_out": _linear(c, c)},
        "norm2": _norm(c),
        "attn2": {"to_q": _linear(c, c, False),
                  "to_k": _linear(ctx, c, False),
                  "to_v": _linear(ctx, c, False), "to_out": _linear(c, c)},
        "norm3": _norm(c),
        "ff": {"proj": _linear(c, 2 * inner), "out": _linear(inner, c)},
    }
    return {"norm": _norm(c), "proj_in": _conv(1, c, c),
            "transformer_blocks": [block], "proj_out": _conv(1, c, c)}


def param_shapes(cfg: SDUNetConfig) -> dict:
    """The parameter tree with a (kind, shape, fan_in) triple at each leaf:
    kind "w" (uniform ±1/sqrt(fan_in), torch's default layers), "one" or
    "zero" (norm gains and biases)."""
    ch, temb = list(cfg.block_out_channels), cfg.temb_channels
    ctx, layers = cfg.cross_attention_dim, cfg.layers_per_block
    params = {
        "time_embedding": {"linear_1": _linear(ch[0], temb),
                           "linear_2": _linear(temb, temb)},
        "conv_in": _conv(3, cfg.in_channels, ch[0]),
    }
    down, skips, prev = [], [ch[0]], ch[0]
    for i, kind in enumerate(cfg.down_block_types):
        c = ch[i]
        blk = {"resnets": [_resnet(prev if j == 0 else c, c, temb)
                           for j in range(layers)]}
        if kind == "CrossAttnDownBlock2D":
            blk["attentions"] = [_transformer(c, ctx) for _ in range(layers)]
        skips += [c] * layers
        if i < len(ch) - 1:
            blk["downsamplers"] = [{"conv": _conv(3, c, c)}]
            skips.append(c)
        down.append(blk)
        prev = c
    params["down_blocks"] = down
    params["mid_block"] = {"resnets": [_resnet(ch[-1], ch[-1], temb)
                                       for _ in range(2)],
                           "attentions": [_transformer(ch[-1], ctx)]}
    up, rch = [], ch[::-1]
    for i, kind in enumerate(cfg.up_block_types):
        c = rch[i]
        resnets = []
        for j in range(layers + 1):
            resnets.append(_resnet(prev + skips.pop(), c, temb))
            prev = c
        blk = {"resnets": resnets}
        if kind == "CrossAttnUpBlock2D":
            blk["attentions"] = [_transformer(c, ctx)
                                 for _ in range(layers + 1)]
        if i < len(ch) - 1:
            blk["upsamplers"] = [{"conv": _conv(3, c, c)}]
        up.append(blk)
    params["up_blocks"] = up
    params["conv_norm_out"] = _norm(ch[0])
    params["conv_out"] = _conv(3, ch[0], cfg.out_channels)
    return params


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map_leaves(tree, out.append)
    return out


def count_params(cfg: SDUNetConfig) -> int:
    """The number of parameters, from the shapes alone (nothing allocated):
    859,520,964 at SD v1.5's config."""
    return sum(math.prod(shape) for _, shape, _ in _leaves(param_shapes(cfg)))


def init_model(gen: torch.Generator, cfg: SDUNetConfig, device="cuda"):
    """The fp32 parameter tree on device, drawn from ``gen`` (a CPU
    generator) leaf by leaf in the tree's order."""
    device = resolve_device(device)

    def draw(leaf):
        kind, shape, fan_in = leaf
        if kind == "one":
            return torch.ones(shape, device=device)
        if kind == "zero":
            return torch.zeros(shape, device=device)
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((2.0 * u - 1.0) / math.sqrt(fan_in)).to(device)

    return _map_leaves(param_shapes(cfg), draw)


def prepare_params(params, cfg: SDUNetConfig) -> dict:
    """The tree the sampler passes on every step, made once per run: every
    leaf in the compute dtype, conv weights as cuDNN reads them (OIHW,
    channels-last), self-attention's q, k, v joined as ``to_qkv`` [C, 3C]
    and cross-attention's k, v as ``to_kv`` [ctx, 2C]."""
    dt = cfg.dtype

    def walk(t, key=None):
        if isinstance(t, torch.Tensor):
            if t.ndim == 4:  # HWIO → OIHW, stored channels-last
                return t.permute(3, 2, 0, 1).to(dt).contiguous(
                    memory_format=torch.channels_last)
            return t.to(dt)
        if isinstance(t, list):
            return [walk(v) for v in t]
        if key in ("attn1", "attn2"):
            out = {"to_out": walk(t["to_out"])}
            kv = torch.cat([t["to_k"]["w"], t["to_v"]["w"]], dim=1)
            if key == "attn1":
                out["to_qkv"] = {"w": torch.cat([t["to_q"]["w"], kv],
                                                dim=1).to(dt)}
            else:
                out["to_q"] = walk(t["to_q"])
                out["to_kv"] = {"w": kv.to(dt)}
            return out
        return {k: walk(v, k) for k, v in t.items()}

    return {**walk(params), "prepared": True}


# ------------------------------------------------------------------ apply

def _conv2d(p, x, *, stride=1, padding=1):
    """x [B, H, W, C] → [B, H', W', C'] through cuDNN; p["w"] OIHW."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _gn(p, x, cfg, eps):
    return group_norm_apply(p, x, num_groups=cfg.norm_num_groups, eps=eps)


def _resnet_apply(p, x, temb_act, cfg):
    """ResnetBlock2D; temb_act = SiLU(temb) [B, 4·C0], the same for every
    block (diffusers applies the SiLU inside each block)."""
    with span("ddim.sd.resnet"):
        h = _conv2d(p["conv1"], F.silu(_gn(p["norm1"], x, cfg, cfg.norm_eps)))
        h = h + linear_apply(p["time_emb_proj"], temb_act)[:, None, None, :]
        h = _conv2d(p["conv2"], F.silu(_gn(p["norm2"], h, cfg, cfg.norm_eps)))
        if "conv_shortcut" in p:
            x = _conv2d(p["conv_shortcut"], x, padding=0)
        return x + h


def _layer_norm(p, x):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], LAYER_NORM_EPS)


def _heads(x, heads: int):
    """[B, N, C] → [B, heads, N, C / heads] (a view)."""
    b, n, c = x.shape
    return x.view(b, n, heads, c // heads).transpose(1, 2)


def _attend(p, q, k, v, heads: int):
    """softmax(q kᵀ / sqrt(d)) v per head, then ``to_out``."""
    b, n, c = q.shape
    o = F.scaled_dot_product_attention(_heads(q, heads), _heads(k, heads),
                                       _heads(v, heads))
    return linear_apply(p["to_out"], o.transpose(1, 2).reshape(b, n, c))


def self_attention(p, h, heads: int):
    q, k, v = linear_apply(p["to_qkv"], h).chunk(3, dim=-1)
    return _attend(p, q, k, v, heads)


def cross_attention(p, h, cond, heads: int):
    k, v = linear_apply(p["to_kv"], cond).chunk(2, dim=-1)
    return _attend(p, linear_apply(p["to_q"], h), k, v, heads)


def _transformer_apply(p, x, cond, cfg):
    """Transformer2DModel (one BasicTransformerBlock) over x [B, H, W, C]."""
    with span("ddim.sd.transformer"):
        b, hh, ww, c = x.shape
        h = _gn(p["norm"], x, cfg, TRANSFORMER_GN_EPS)
        h = _conv2d(p["proj_in"], h, padding=0).reshape(b, hh * ww, c)
        for blk in p["transformer_blocks"]:
            with span("ddim.sd.attn.self"):
                h = h + self_attention(blk["attn1"],
                                       _layer_norm(blk["norm1"], h), cfg.heads)
            with span("ddim.sd.attn.cross"):
                h = h + cross_attention(blk["attn2"],
                                        _layer_norm(blk["norm2"], h), cond,
                                        cfg.heads)
            with span("ddim.sd.ff"):
                a, gate = linear_apply(blk["ff"]["proj"],
                                       _layer_norm(blk["norm3"], h)).chunk(
                                           2, dim=-1)
                h = h + linear_apply(blk["ff"]["out"], a * F.gelu(gate))
        h = _conv2d(p["proj_out"], h.reshape(b, hh, ww, c), padding=0)
        return h + x


def _upsample2x(x):
    """Nearest ×2 over [B, H, W, C]."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def apply_model(params, x, t, cond, cfg: SDUNetConfig):
    """ε [B, out_channels, H, W] (compute dtype) of x [B, in_channels, H, W]
    at timesteps t [B] under the text embeddings cond [B, tokens,
    cross_attention_dim]. ``params`` is the fp32 tree or ``prepare_params``'
    (a run prepares it once)."""
    if not params.get("prepared"):
        params = prepare_params(params, cfg)
    dt = cfg.dtype
    temb = timestep_sinusoid(torch.as_tensor(t, device=x.device),
                             cfg.block_out_channels[0],
                             flip_sin_to_cos=cfg.flip_sin_to_cos,
                             freq_shift=cfg.freq_shift).to(dt)
    te = params["time_embedding"]
    temb = linear_apply(te["linear_2"],
                        F.silu(linear_apply(te["linear_1"], temb)))
    temb_act = F.silu(temb)
    cond = cond.to(dt)

    with span("ddim.sd.sample"):
        h = _conv2d(params["conv_in"], x.to(dt).permute(0, 2, 3, 1))
    skips = [h]
    for blk in params["down_blocks"]:
        for j, res in enumerate(blk["resnets"]):
            h = _resnet_apply(res, h, temb_act, cfg)
            if "attentions" in blk:
                h = _transformer_apply(blk["attentions"][j], h, cond, cfg)
            skips.append(h)
        for ds in blk.get("downsamplers", []):
            with span("ddim.sd.sample"):
                h = _conv2d(ds["conv"], h, stride=2, padding=1)
            skips.append(h)
    mid = params["mid_block"]
    h = _resnet_apply(mid["resnets"][0], h, temb_act, cfg)
    h = _transformer_apply(mid["attentions"][0], h, cond, cfg)
    h = _resnet_apply(mid["resnets"][1], h, temb_act, cfg)
    for blk in params["up_blocks"]:
        for j, res in enumerate(blk["resnets"]):
            h = _resnet_apply(res, torch.cat([h, skips.pop()], dim=-1),
                              temb_act, cfg)
            if "attentions" in blk:
                h = _transformer_apply(blk["attentions"][j], h, cond, cfg)
        for us in blk.get("upsamplers", []):
            with span("ddim.sd.sample"):
                h = _conv2d(us["conv"], _upsample2x(h))
    with span("ddim.sd.sample"):
        h = F.silu(_gn(params["conv_norm_out"], h, cfg, cfg.norm_eps))
        h = _conv2d(params["conv_out"], h)
    return h.permute(0, 3, 1, 2)
