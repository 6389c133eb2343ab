"""The denoiser of ddim-audio in plain PyTorch float32: a conv U-Net with an
FNet bottleneck, written from its equations, over [B, C, T, F] (NCHW).

    x ─ head 3×3 ─┬─ stage 0 ─┬─ down 4×4/2 ─ stage 1 … stage 5 ─ FNet ─┐
                  skip        skip                                     │
    ε ─ tail 3×3 ─┴─ stage 0 ─┴─ up 4×4/2 ─ … stage 5 (+ skip) ────────┘

A resblock: x + GN3(SiLU(conv2(GN2(SiLU(conv1(SiLU(GN1(x))) + temb))))),
GroupNorm with 8 groups and eps 1e-6, GN3 without bias. The timestep
embedding is a sinusoid table [num_timesteps, 128] (float32 arithmetic),
then Linear 128→512, SiLU, 512→512, SiLU, 512→Σ widths, split one chunk per
resblock (down stages in order, then the up stages from the deepest). The
bottleneck flattens [B, C, T', F'] to tokens [B, T', C·F'] (C major), adds
a sinusoid table, LayerNorm, projects to the FNet width, runs the FNet
layers ``f = LN(x + Re(DFT_S · x · DFT_H))``, ``y = LN(f + W2 gelu_tanh(W1
f))`` (dropout after the projection and after each feed-forward where
masks are given) and projects back.

Parameters are the nested dict the program takes: conv weights HWIO
[kh, kw, in, out]; a transposed conv's weight is that of the equivalent
forward conv on the 2-dilated input, HWIO; linear weights [in, out].

Every conv and matmul goes through ``Ops``, so the same equations can run
in a lower precision for the comparison's control. Nothing here imports
the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

GROUPS = 8
GN_EPS = 1e-6
POS_CH = 128
EMB_CH = 512


@dataclass(frozen=True)
class Geometry:
    channels: int
    f_size: int
    ch: tuple
    res: tuple
    num_timesteps: int
    fnet_hidden: int
    fnet_layers: int
    fnet_intermediate: int
    fnet_channels: int
    ln_eps: float
    dropout: float

    @classmethod
    def from_config(cls, config: dict) -> "Geometry":
        m = config["model"]
        tr = m["transformers"]
        kw = tr["kwargs"]
        if any(k != 3 for k in m["krn"]):
            raise ValueError("the reference has 3×3 resblocks only")
        return cls(channels=m["channels"], f_size=m["f_size"],
                   ch=tuple(m["ch"]), res=tuple(m["res"]),
                   num_timesteps=config["diffusion"]["num_diffusion_timesteps"],
                   fnet_hidden=kw["hidden_size"],
                   fnet_layers=kw["num_hidden_layers"],
                   fnet_intermediate=kw["intermediate_size"],
                   fnet_channels=tr["channels"],
                   ln_eps=float(kw["layer_norm_eps"]),
                   dropout=float(kw["hidden_dropout_prob"]))

    @property
    def widths(self) -> list:
        """Channel width of each resblock in the order it takes its chunk of
        the timestep embedding."""
        down = [c for c, r in zip(self.ch, self.res) for _ in range(r)]
        return down + down[::-1]

    @property
    def scale(self) -> int:
        return 2 ** (len(self.ch) - 1)

    @property
    def token_width(self) -> int:
        return self.ch[-1] * (self.f_size // self.scale)

    def mask_shapes(self, batch: int, t_size: int) -> list:
        """The shapes of the dropout keep masks, in the order of their
        sites."""
        s = t_size // self.scale
        return [(batch, s, self.fnet_hidden)] * (self.fnet_layers + 1)


def param_spec(g: Geometry) -> dict:
    """The parameter tree as {name: spec}, a spec being ("uniform", shape,
    bound), ("norm_gain", shape, spread), ("norm_bias", shape, spread): the
    program's structure, with the init bounds of torch's default layers
    (uniform ±1/sqrt(fan_in))."""
    def conv(kh, kw, cin, cout, bias=True, fan_in=None):
        bound = 1.0 / math.sqrt(fan_in or cin * kh * kw)
        p = {"w": ("uniform", (kh, kw, cin, cout), bound)}
        if bias:
            p["b"] = ("uniform", (cout,), bound)
        return p

    def linear(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return {"w": ("uniform", (cin, cout), bound),
                "b": ("uniform", (cout,), bound)}

    def norm(c, bias=True, spread=0.1):
        p = {"g": ("norm_gain", (c,), spread)}
        if bias:
            p["b"] = ("norm_bias", (c,), spread)
        return p

    def block(c):
        # GN3's gain is 0 at the program's init, which makes every block the
        # identity; a non-zero gain makes every conv count
        return {"norm1": norm(c), "conv1": conv(3, 3, c, c, bias=False),
                "norm2": norm(c), "conv2": conv(3, 3, c, c),
                "norm3": norm(c, bias=False, spread=0.2)}

    down_stages, up_stages, prev = [], [], None
    for c, r in zip(g.ch, g.res):
        ds, us = {}, {}
        if prev is not None:
            ds["down"] = conv(4, 4, prev, c)
            us["up"] = conv(4, 4, c, prev, fan_in=prev * 16)
        ds["blocks"] = [block(c) for _ in range(r)]
        us["blocks"] = [block(c) for _ in range(r)]
        down_stages.append(ds)
        up_stages.append(us)
        prev = c
    h, io = g.fnet_hidden, g.token_width
    if g.fnet_channels != h:
        raise ValueError("the FNet's channels must equal its hidden size")
    layers = [{"ln_fourier": norm(h), "dense_in": linear(h, g.fnet_intermediate),
               "dense_out": linear(g.fnet_intermediate, h), "ln_out": norm(h)}
              for _ in range(g.fnet_layers)]
    return {
        "temb": {"mlp": [linear(POS_CH, EMB_CH), linear(EMB_CH, EMB_CH),
                         linear(EMB_CH, sum(g.widths))]},
        "down_modules": {"head": conv(3, 3, g.channels, g.ch[0]),
                         "stages": down_stages},
        "up_modules": {"tail": conv(3, 3, g.ch[0], g.channels),
                       "stages": up_stages},
        "transformer": {"embedding": {"ln": norm(io),
                                      "projection": linear(io, h)},
                        "encoder": {"layers": layers},
                        "compute_out": linear(h, io)},
    }


def sinusoid_table(length: int, channels: int) -> torch.Tensor:
    """table[p, 2k] = sin(p·exp(−2k·ln(1e4)/C)), table[p, 2k+1] = cos(…),
    in float32 arithmetic (the model's definition)."""
    f32 = np.float32
    pos = np.arange(length, dtype=f32)[:, None]
    div = np.exp(np.arange(0, channels, 2, dtype=f32)
                 * f32(-math.log(10000.0) / channels))
    arg = pos * div
    table = np.zeros((length, channels), dtype=f32)
    table[:, 0::2] = np.sin(arg)
    table[:, 1::2] = np.cos(arg)
    return torch.from_numpy(table)


def dft_real_imag(n: int) -> tuple:
    """cos and sin parts of the DFT matrix exp(−2πi·k·m/n), built in float64
    and kept in float32."""
    k = np.arange(n)[:, None]
    theta = 2.0 * np.pi * ((k * np.arange(n)[None, :]) % n) / n
    return (torch.from_numpy(np.cos(theta).astype(np.float32)),
            torch.from_numpy(np.sin(theta).astype(np.float32)))


class Ops:
    """The products of the forward. ``operand`` rounds each operand of a
    conv (activation and weight) before the float32 product; the identity
    here, a lower precision in the comparison's control."""

    def operand(self, x):
        return x

    def conv(self, x, w_hwio, bias=None, *, stride=1, padding=1):
        w = w_hwio.permute(3, 2, 0, 1)
        out = F.conv2d(self.operand(x), self.operand(w), stride=stride,
                       padding=padding)
        return out if bias is None else out + bias[:, None, None]

    def conv_up(self, x, w_hwio, bias):
        """Transposed conv (k 4, s 2, p 1) from the equivalent forward
        kernel: torch's [in, out, kh, kw] weight is it flipped in space."""
        w = w_hwio.permute(2, 3, 0, 1).flip(2, 3)
        out = F.conv_transpose2d(self.operand(x), self.operand(w), stride=2,
                                 padding=1)
        return out + bias[:, None, None]

    def linear(self, x, p):
        return torch.matmul(x, p["w"]) + p["b"]

    def matmul(self, a, b):
        return torch.matmul(a, b)


class Model:
    """The forward pass for one geometry on one device, float32. Tables and
    DFT matrices are made once."""

    def __init__(self, geom: Geometry, device, ops: Ops | None = None):
        self.g = geom
        self.ops = ops or Ops()
        self.device = torch.device(device)
        self.temb_table = sinusoid_table(geom.num_timesteps, POS_CH).to(device)
        self._tables = {}

    def _token_table(self, s: int) -> torch.Tensor:
        pow2 = 1 << max(0, (s - 1).bit_length())
        key = ("tok", pow2)
        if key not in self._tables:
            self._tables[key] = sinusoid_table(
                pow2, self.g.token_width).to(self.device)
        return self._tables[key][:s]

    def _dft(self, n: int):
        key = ("dft", n)
        if key not in self._tables:
            self._tables[key] = tuple(m.to(self.device)
                                      for m in dft_real_imag(n))
        return self._tables[key]

    def temb(self, params, t):
        mlp = params["temb"]["mlp"]
        idx = t.long().clamp(0, self.g.num_timesteps - 1)
        x = F.silu(self.ops.linear(self.temb_table[idx], mlp[0]))
        x = F.silu(self.ops.linear(x, mlp[1]))
        return list(torch.split(self.ops.linear(x, mlp[2]), self.g.widths,
                                dim=-1))

    def resblock(self, p, x, temb):
        gn = F.group_norm
        h = F.silu(gn(x, GROUPS, p["norm1"]["g"], p["norm1"]["b"], GN_EPS))
        h = self.ops.conv(h, p["conv1"]["w"]) + temb[:, :, None, None]
        h = gn(F.silu(h), GROUPS, p["norm2"]["g"], p["norm2"]["b"], GN_EPS)
        h = F.silu(self.ops.conv(h, p["conv2"]["w"], p["conv2"]["b"]))
        return x + gn(h, GROUPS, p["norm3"]["g"], None, GN_EPS)

    def fnet(self, p, z, masks):
        """z [B, S, io] → same; masks: None, or one keep mask per dropout
        site (after the projection, after each layer's feed-forward)."""
        g = self.g
        keep = 1.0 - g.dropout

        def drop(y, i):
            if masks is None:
                return y
            return torch.where(masks[i], y / keep, torch.zeros_like(y))

        def ln(q, v):
            return F.layer_norm(v, v.shape[-1:], q["g"], q["b"], g.ln_eps)

        s = z.shape[1]
        x = ln(p["embedding"]["ln"], z + self._token_table(s))
        x = drop(self.ops.linear(x, p["embedding"]["projection"]), 0)
        cs, ss = self._dft(s)
        ch, sh = self._dft(g.fnet_hidden)
        mm = self.ops.matmul
        for i, layer in enumerate(p["encoder"]["layers"]):
            mixed = mm(mm(cs, x), ch) - mm(mm(ss, x), sh)
            f = ln(layer["ln_fourier"], x + mixed)
            y = self.ops.linear(F.gelu(self.ops.linear(f, layer["dense_in"]),
                                       approximate="tanh"), layer["dense_out"])
            x = ln(layer["ln_out"], f + drop(y, i + 1))
        return self.ops.linear(x, p["compute_out"])

    def __call__(self, params, x, t, masks=None):
        """x [B, C, T, F] float32, t int [B] → ε-prediction [B, C, T, F]."""
        if x.shape[2] % self.g.scale:
            raise ValueError(f"T={x.shape[2]} is not a multiple of "
                             f"{self.g.scale}")
        chunks = iter(self.temb(params, t))
        down, up = params["down_modules"], params["up_modules"]
        h = self.ops.conv(x, down["head"]["w"], down["head"]["b"])
        hidden = [h]
        for stage in down["stages"]:
            if "down" in stage:
                h = self.ops.conv(h, stage["down"]["w"], stage["down"]["b"],
                                  stride=2)
            for block in stage["blocks"]:
                h = self.resblock(block, h, next(chunks))
            hidden.append(h)
        b, c, tt, ff = h.shape
        z = h.permute(0, 2, 1, 3).reshape(b, tt, c * ff)
        z = self.fnet(params["transformer"], z, masks)
        h = z.reshape(b, tt, c, ff).permute(0, 2, 1, 3)
        for stage in reversed(up["stages"]):
            h = h + hidden.pop()
            for block in stage["blocks"]:
                h = self.resblock(block, h, next(chunks))
            if "up" in stage:
                h = self.ops.conv_up(h, stage["up"]["w"], stage["up"]["b"])
        h = h + hidden.pop()
        return self.ops.conv(h, up["tail"]["w"], up["tail"]["b"])
