"""The Stable Diffusion v1.5 UNet (Riffusion v1's: https://huggingface.co/
riffusion/riffusion-model-v1, ``unet/config.json``) and its DDIM chain with
classifier-free guidance, in plain PyTorch float32, written from diffusers'
``UNet2DConditionModel`` (``use_linear_projection`` false, dropout 0) and
its Stable Diffusion pipeline. It imports nothing of the program.

Layout NCHW; parameters are the program's tree (the names of diffusers'
modules, conv weights HWIO [kh, kw, in, out], linear weights [in, out],
norms ``g`` / ``b``), as ``param_spec`` lists it for
``harness.params.make_params``.

Departures from diffusers, none of which changes a value in exact
arithmetic: attention is written out as softmax(q kᵀ / sqrt(d)) v in blocks
of ``ATTN_BLOCK`` query rows, so that 4,096 tokens fit; the SiLU of the time
embedding is taken once a forward, not once a ResNet block; the guided
chain runs the unconditional and the text rows as two calls, not one
doubled batch; the DDIM subsequence is the program's (uniform, 0, k, 2k, …
with k = T // steps, ᾱ = 1 after the last step) rather than diffusers'
``DDIMScheduler`` with ``steps_offset`` 1 and ``set_alpha_to_one`` false.
Matmuls and convs run in float32 with TF32 off (``check.float32_math``).

``ControlOps`` is the control: the same model with every conv's, linear's
and attention product's operands rounded to float8 e4m3 (scaled per tensor),
one precision step below the bf16 the configuration states.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .check import fp8
from .sampler import ddim_plan

TRANSFORMER_GN_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
FF_MULT = 4
ATTN_BLOCK = 1024
# the norms' seed-made spread: gains 1 + 0.1·N, biases 0.1·N, so that no
# norm is the identity
NORM_SPREAD = 0.1


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """The UNet's shape, read from the configuration's YAML tree."""
    in_channels: int
    out_channels: int
    sample_size: int
    block_out_channels: tuple
    layers_per_block: int
    down_block_types: tuple
    up_block_types: tuple
    heads: int
    cross_attention_dim: int
    norm_num_groups: int
    norm_eps: float
    flip_sin_to_cos: bool
    freq_shift: float
    text_tokens: int

    @classmethod
    def from_config(cls, config: dict):
        m = config["model"]
        return cls(m["in_channels"], m["out_channels"], m["sample_size"],
                   tuple(m["block_out_channels"]), m["layers_per_block"],
                   tuple(m["down_block_types"]), tuple(m["up_block_types"]),
                   m["attention_head_dim"], m["cross_attention_dim"],
                   m["norm_num_groups"], float(m["norm_eps"]),
                   bool(m["flip_sin_to_cos"]), float(m["freq_shift"]),
                   m["text_tokens"])

    @property
    def temb(self) -> int:
        return 4 * self.block_out_channels[0]


def param_spec(cfg: SDConfig) -> dict:
    """The parameter tree as {name: spec}, a spec being ("uniform", shape,
    bound) with torch's default bound 1/sqrt(fan_in), ("norm_gain", shape,
    spread) or ("norm_bias", shape, spread)."""
    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(cin * k * k)
        return {"w": ("uniform", (k, k, cin, cout), bound),
                "b": ("uniform", (cout,), bound)}

    def linear(cin, cout, bias=True):
        bound = 1.0 / math.sqrt(cin)
        p = {"w": ("uniform", (cin, cout), bound)}
        if bias:
            p["b"] = ("uniform", (cout,), bound)
        return p

    def norm(c):
        return {"g": ("norm_gain", (c,), NORM_SPREAD),
                "b": ("norm_bias", (c,), NORM_SPREAD)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout),
             "time_emb_proj": linear(cfg.temb, cout), "norm2": norm(cout),
             "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = conv(1, cin, cout)
        return p

    def attn(c, ctx):
        return {"to_q": linear(c, c, False), "to_k": linear(ctx, c, False),
                "to_v": linear(ctx, c, False), "to_out": linear(c, c)}

    def transformer(c):
        block = {"norm1": norm(c), "attn1": attn(c, c), "norm2": norm(c),
                 "attn2": attn(c, cfg.cross_attention_dim), "norm3": norm(c),
                 "ff": {"proj": linear(c, 2 * FF_MULT * c),
                        "out": linear(FF_MULT * c, c)}}
        return {"norm": norm(c), "proj_in": conv(1, c, c),
                "transformer_blocks": [block], "proj_out": conv(1, c, c)}

    ch, r = list(cfg.block_out_channels), cfg.layers_per_block
    spec = {"time_embedding": {"linear_1": linear(ch[0], cfg.temb),
                               "linear_2": linear(cfg.temb, cfg.temb)},
            "conv_in": conv(3, cfg.in_channels, ch[0])}
    down, skips, prev = [], [ch[0]], ch[0]
    for i, kind in enumerate(cfg.down_block_types):
        blk = {"resnets": [resnet(prev if j == 0 else ch[i], ch[i])
                           for j in range(r)]}
        if "CrossAttn" in kind:
            blk["attentions"] = [transformer(ch[i]) for _ in range(r)]
        skips += [ch[i]] * r
        if i < len(ch) - 1:
            blk["downsamplers"] = [{"conv": conv(3, ch[i], ch[i])}]
            skips.append(ch[i])
        down.append(blk)
        prev = ch[i]
    spec["down_blocks"] = down
    spec["mid_block"] = {"resnets": [resnet(ch[-1], ch[-1]) for _ in "ab"],
                         "attentions": [transformer(ch[-1])]}
    up = []
    for i, kind in enumerate(cfg.up_block_types):
        c = ch[::-1][i]
        blk = {"resnets": []}
        for _ in range(r + 1):
            blk["resnets"].append(resnet(prev + skips.pop(), c))
            prev = c
        if "CrossAttn" in kind:
            blk["attentions"] = [transformer(c) for _ in range(r + 1)]
        if i < len(ch) - 1:
            blk["upsamplers"] = [{"conv": conv(3, c, c)}]
        up.append(blk)
    spec["up_blocks"] = up
    spec["conv_norm_out"] = norm(ch[0])
    spec["conv_out"] = conv(3, ch[0], cfg.out_channels)
    return spec


class Ops:
    """The products of the model, in the operands' own precision."""

    def conv(self, x, p, *, stride=1, padding=1):
        return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                        padding=padding)

    def linear(self, x, p):
        out = x @ p["w"]
        return out + p["b"] if "b" in p else out

    def matmul(self, a, b):
        return a @ b


class ControlOps(Ops):
    """Every product's operands in float8 e4m3 (one scale a tensor)."""

    def conv(self, x, p, *, stride=1, padding=1):
        return F.conv2d(fp8(x), fp8(p["w"]).permute(3, 2, 0, 1), p["b"],
                        stride=stride, padding=padding)

    def linear(self, x, p):
        out = fp8(x) @ fp8(p["w"])
        return out + p["b"] if "b" in p else out

    def matmul(self, a, b):
        return fp8(a) @ fp8(b)


def timestep_embedding(t, dim: int, flip: bool, shift: float):
    """diffusers' ``get_timestep_embedding`` (max_period 1e4, scale 1)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = t[:, None].float() * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class Model:
    def __init__(self, cfg: SDConfig, ops: Ops | None = None):
        self.cfg = cfg
        self.ops = ops or Ops()

    def _gn(self, p, x, eps):
        return F.group_norm(x, self.cfg.norm_num_groups, p["g"], p["b"], eps)

    def resnet(self, p, x, temb_act):
        o, eps = self.ops, self.cfg.norm_eps
        h = o.conv(F.silu(self._gn(p["norm1"], x, eps)), p["conv1"])
        h = h + o.linear(temb_act, p["time_emb_proj"])[:, :, None, None]
        h = o.conv(F.silu(self._gn(p["norm2"], h, eps)), p["conv2"])
        if "conv_shortcut" in p:
            x = o.conv(x, p["conv_shortcut"], padding=0)
        return x + h

    def attention(self, p, x, ctx):
        o = self.ops
        b, n, c = x.shape
        heads = self.cfg.heads
        d = c // heads

        def split(v):
            return v.reshape(b, -1, heads, d).transpose(1, 2)

        q = split(o.linear(x, p["to_q"]))
        k = split(o.linear(ctx, p["to_k"]))
        v = split(o.linear(ctx, p["to_v"]))
        out = torch.empty_like(q)
        for s in range(0, n, ATTN_BLOCK):
            scores = o.matmul(q[:, :, s:s + ATTN_BLOCK],
                              k.transpose(-1, -2)) / math.sqrt(d)
            out[:, :, s:s + ATTN_BLOCK] = o.matmul(scores.softmax(dim=-1), v)
        return o.linear(out.transpose(1, 2).reshape(b, n, c), p["to_out"])

    def transformer(self, p, x, cond):
        o = self.ops
        b, c, hh, ww = x.shape
        h = self._gn(p["norm"], x, TRANSFORMER_GN_EPS)
        h = o.conv(h, p["proj_in"], padding=0)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in p["transformer_blocks"]:
            def ln(name, v):
                return F.layer_norm(v, (c,), blk[name]["g"], blk[name]["b"],
                                    LAYER_NORM_EPS)

            n1 = ln("norm1", h)
            h = h + self.attention(blk["attn1"], n1, n1)
            h = h + self.attention(blk["attn2"], ln("norm2", h), cond)
            hidden, gate = o.linear(ln("norm3", h),
                                    blk["ff"]["proj"]).chunk(2, dim=-1)
            h = h + o.linear(hidden * F.gelu(gate), blk["ff"]["out"])
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return o.conv(h, p["proj_out"], padding=0) + x

    def __call__(self, p, x, t, cond):
        """ε [B, out, H, W] of x [B, in, H, W], t [B], cond [B, tokens,
        dim]."""
        cfg, o = self.cfg, self.ops
        n = len(cfg.block_out_channels)
        temb = timestep_embedding(t, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        te = p["time_embedding"]
        temb = o.linear(F.silu(o.linear(temb, te["linear_1"])),
                        te["linear_2"])
        temb_act = F.silu(temb)
        h = o.conv(x, p["conv_in"])
        skips = [h]
        for i, kind in enumerate(cfg.down_block_types):
            blk = p["down_blocks"][i]
            for j in range(cfg.layers_per_block):
                h = self.resnet(blk["resnets"][j], h, temb_act)
                if "CrossAttn" in kind:
                    h = self.transformer(blk["attentions"][j], h, cond)
                skips.append(h)
            if i < n - 1:
                h = o.conv(h, blk["downsamplers"][0]["conv"], stride=2)
                skips.append(h)
        mid = p["mid_block"]
        h = self.resnet(mid["resnets"][0], h, temb_act)
        h = self.transformer(mid["attentions"][0], h, cond)
        h = self.resnet(mid["resnets"][1], h, temb_act)
        for i, kind in enumerate(cfg.up_block_types):
            blk = p["up_blocks"][i]
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.resnet(blk["resnets"][j], h, temb_act)
                if "CrossAttn" in kind:
                    h = self.transformer(blk["attentions"][j], h, cond)
            if i < n - 1:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = o.conv(h, blk["upsamplers"][0]["conv"])
        h = F.silu(self._gn(p["conv_norm_out"], h, cfg.norm_eps))
        return o.conv(h, p["conv_out"])


def alphas_cumprod(diffusion: dict) -> np.ndarray:
    """ᾱ of the configuration's schedule (float32): ``quad`` (diffusers'
    scaled_linear, betas = linspace(sqrt(start), sqrt(end), T)²) or
    ``linear``."""
    lo, hi = diffusion["beta_start"], diffusion["beta_end"]
    n = diffusion["num_diffusion_timesteps"]
    if diffusion["beta_schedule"] == "quad":
        betas = np.linspace(lo ** 0.5, hi ** 0.5, n, dtype=np.float64) ** 2
    elif diffusion["beta_schedule"] == "linear":
        betas = np.linspace(lo, hi, n, dtype=np.float64)
    else:
        raise ValueError("the reference has the quad and linear schedules")
    return np.cumprod(1.0 - betas).astype(np.float32)


@torch.no_grad()
def guided_chain(model, params, x, text, uncond, abar, steps: int,
                 scale: float):
    """The DDIM (eta 0) walk with classifier-free guidance from x_T [N, C,
    H, W] under text [N, tokens, dim] and uncond [tokens, dim]: each step
    ε = ε_u + scale·(ε_c − ε_u). Returns (x after the first step, x_0)."""
    un = uncond.expand(x.shape[0], *uncond.shape)
    first = None
    for t, a, a_next in ddim_plan(abar, steps):
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps_u = model(params, x, tt, un)
        eps_c = model(params, x, tt, text)
        eps = eps_u + scale * (eps_c - eps_u)
        x0 = (x - eps * np.sqrt(1.0 - a)) / np.sqrt(a)
        x = np.sqrt(a_next) * x0 + np.sqrt(1.0 - a_next) * eps
        if first is None:
            first = x.clone()
    return first, x
