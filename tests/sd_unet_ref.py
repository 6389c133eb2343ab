"""The Stable Diffusion v1.5 UNet and its DDIM chain with classifier-free
guidance, in plain PyTorch float32, for the tier-1 tests: written from
diffusers' ``UNet2DConditionModel`` (``use_linear_projection`` false,
dropout 0) and its Stable Diffusion pipeline. It imports no JAX, no
``ddim_audio_tpu*`` module and no kernel of the port. (The benchmark keeps
its own copy, ``port_bench/reference/sd_unet.py``, with a control.)

Layout NCHW; parameters are the port's tree (the names of diffusers'
modules, conv weights HWIO [kh, kw, in, out], linear weights [in, out],
norms ``g`` / ``b``); the shape is read from a ``config.model`` dict with
``unet/config.json``'s keys.

Departures from diffusers, none of which changes a value in exact
arithmetic: attention is written out as softmax(q kᵀ / sqrt(d)) v in blocks
of ``ATTN_BLOCK`` query rows; the SiLU of the time embedding is taken once
a forward, not once a ResNet block; the guided chain runs the
unconditional and the text rows as two calls, not one doubled batch; the
DDIM subsequence is uniform, 0, k, 2k, … with k = T // steps and ᾱ = 1
after the last step (the port's), not diffusers' ``steps_offset`` 1 and
``set_alpha_to_one`` false. TF32 is off while it runs (``float32_math``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

TRANSFORMER_GN_EPS = 1e-6
LAYER_NORM_EPS = 1e-5
ATTN_BLOCK = 1024


@contextlib.contextmanager
def float32_math():
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


def conv(x, p, *, stride=1, padding=1):
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                    padding=padding)


def linear(x, p):
    out = x @ p["w"]
    return out + p["b"] if "b" in p else out


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
    """ε [B, out, H, W] = model(params, x [B, in, H, W], t [B], cond [B,
    tokens, dim])."""

    def __init__(self, m: dict):
        self.m = m

    def _gn(self, p, x, eps):
        return F.group_norm(x, self.m["norm_num_groups"], p["g"], p["b"], eps)

    def resnet(self, p, x, temb_act):
        eps = self.m["norm_eps"]
        h = conv(F.silu(self._gn(p["norm1"], x, eps)), p["conv1"])
        h = h + linear(temb_act, p["time_emb_proj"])[:, :, None, None]
        h = conv(F.silu(self._gn(p["norm2"], h, eps)), p["conv2"])
        if "conv_shortcut" in p:
            x = conv(x, p["conv_shortcut"], padding=0)
        return x + h

    def attention(self, p, x, ctx):
        b, n, c = x.shape
        heads = self.m["attention_head_dim"]  # diffusers: the head count
        d = c // heads

        def split(v):
            return v.reshape(b, -1, heads, d).transpose(1, 2)

        q, k, v = (split(linear(x, p["to_q"])), split(linear(ctx, p["to_k"])),
                   split(linear(ctx, p["to_v"])))
        out = torch.empty_like(q)
        for s in range(0, n, ATTN_BLOCK):
            scores = q[:, :, s:s + ATTN_BLOCK] @ k.transpose(-1, -2)
            out[:, :, s:s + ATTN_BLOCK] = (scores / math.sqrt(d)).softmax(
                dim=-1) @ v
        return linear(out.transpose(1, 2).reshape(b, n, c), p["to_out"])

    def transformer(self, p, x, cond):
        b, c, hh, ww = x.shape
        h = conv(self._gn(p["norm"], x, TRANSFORMER_GN_EPS), p["proj_in"],
                 padding=0)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in p["transformer_blocks"]:
            def ln(name, v):
                return F.layer_norm(v, (c,), blk[name]["g"], blk[name]["b"],
                                    LAYER_NORM_EPS)

            n1 = ln("norm1", h)
            h = h + self.attention(blk["attn1"], n1, n1)
            h = h + self.attention(blk["attn2"], ln("norm2", h), cond)
            hidden, gate = linear(ln("norm3", h), blk["ff"]["proj"]).chunk(
                2, dim=-1)
            h = h + linear(hidden * F.gelu(gate), blk["ff"]["out"])
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return conv(h, p["proj_out"], padding=0) + x

    def __call__(self, p, x, t, cond):
        m = self.m
        ch = m["block_out_channels"]
        r, n = m["layers_per_block"], len(ch)
        temb = timestep_embedding(t, ch[0], m["flip_sin_to_cos"],
                                  m["freq_shift"])
        te = p["time_embedding"]
        temb = linear(F.silu(linear(temb, te["linear_1"])), te["linear_2"])
        temb_act = F.silu(temb)
        h = conv(x, p["conv_in"])
        skips = [h]
        for i, kind in enumerate(m["down_block_types"]):
            blk = p["down_blocks"][i]
            for j in range(r):
                h = self.resnet(blk["resnets"][j], h, temb_act)
                if "CrossAttn" in kind:
                    h = self.transformer(blk["attentions"][j], h, cond)
                skips.append(h)
            if i < n - 1:
                h = conv(h, blk["downsamplers"][0]["conv"], stride=2)
                skips.append(h)
        mid = p["mid_block"]
        h = self.resnet(mid["resnets"][0], h, temb_act)
        h = self.transformer(mid["attentions"][0], h, cond)
        h = self.resnet(mid["resnets"][1], h, temb_act)
        for i, kind in enumerate(m["up_block_types"]):
            blk = p["up_blocks"][i]
            for j in range(r + 1):
                h = self.resnet(blk["resnets"][j],
                                torch.cat([h, skips.pop()], dim=1), temb_act)
                if "CrossAttn" in kind:
                    h = self.transformer(blk["attentions"][j], h, cond)
            if i < n - 1:
                h = conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                         blk["upsamplers"][0]["conv"])
        h = F.silu(self._gn(p["conv_norm_out"], h, m["norm_eps"]))
        return conv(h, p["conv_out"])


def alphas_cumprod(diffusion: dict) -> np.ndarray:
    """ᾱ (float32) of the ``quad`` schedule (diffusers' scaled_linear:
    betas = linspace(sqrt(start), sqrt(end), T)²)."""
    assert diffusion["beta_schedule"] == "quad"
    betas = np.linspace(diffusion["beta_start"] ** 0.5,
                        diffusion["beta_end"] ** 0.5,
                        diffusion["num_diffusion_timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_plan(abar: np.ndarray, steps: int) -> list:
    """[(t, ᾱ_t, ᾱ of the next lower timestep, 1 after the last)] from the
    top of the uniform subsequence."""
    seq = list(range(0, len(abar), len(abar) // steps))
    nxt = [1.0] + [float(abar[s]) for s in seq[:-1]]
    return [(t, float(abar[t]), a) for t, a in zip(seq[::-1], nxt[::-1])]


@torch.no_grad()
def guided_chain(model, params, x, text, uncond, abar, steps: int,
                 scale: float) -> list:
    """The DDIM (eta 0) walk with classifier-free guidance, ε = ε_u +
    scale·(ε_c − ε_u), from x_T [N, C, H, W] under text [N, tokens, dim]
    and uncond [tokens, dim]: the state after each step."""
    un = uncond.expand(x.shape[0], *uncond.shape)
    states = []
    for t, a, a_next in ddim_plan(abar, steps):
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps_u = model(params, x, tt, un)
        eps = eps_u + scale * (model(params, x, tt, text) - eps_u)
        x0 = (x - eps * np.sqrt(1.0 - a)) / np.sqrt(a)
        x = np.sqrt(a_next) * x0 + np.sqrt(1.0 - a_next) * eps
        states.append(x)
    return states
