"""The work of one forward of the SD v1.5 UNet (``reference/sd_unet.py``'s
``SDConfig``), counted from its shapes: the multiply-adds of its convs, its
matmuls (the time embedding, the ResNet blocks' time projections, every
linear of the transformers) and its attention products (q kᵀ and the
weights times v), and the shape of each Transformer2D's attention."""

from __future__ import annotations

FF_MULT = 4


def _walk(cfg, size: int):
    """[(kind, ...)] of one forward of one row at a latent [size, size]:
    ("conv", positions, k, c_in, c_out), ("matmul", macs) and
    ("transformer", tokens, width)."""
    ch, r = list(cfg.block_out_channels), cfg.layers_per_block
    out = [("matmul", ch[0] * cfg.temb + cfg.temb * cfg.temb)]

    def resnet(hw, cin, cout):
        out.extend([("conv", hw, 3, cin, cout), ("conv", hw, 3, cout, cout),
                    ("matmul", cfg.temb * cout)])
        if cin != cout:
            out.append(("conv", hw, 1, cin, cout))

    s = size
    out.append(("conv", s * s, 3, cfg.in_channels, ch[0]))
    skips, prev = [ch[0]], ch[0]
    for i, kind in enumerate(cfg.down_block_types):
        for j in range(r):
            resnet(s * s, prev if j == 0 else ch[i], ch[i])
            if "CrossAttn" in kind:
                out.append(("transformer", s * s, ch[i]))
        skips += [ch[i]] * r
        prev = ch[i]
        if i < len(ch) - 1:
            s //= 2
            out.append(("conv", s * s, 3, ch[i], ch[i]))
            skips.append(ch[i])
    resnet(s * s, ch[-1], ch[-1])
    out.append(("transformer", s * s, ch[-1]))
    resnet(s * s, ch[-1], ch[-1])
    for i, kind in enumerate(cfg.up_block_types):
        c = ch[::-1][i]
        for _ in range(r + 1):
            resnet(s * s, prev + skips.pop(), c)
            prev = c
            if "CrossAttn" in kind:
                out.append(("transformer", s * s, c))
        if i < len(ch) - 1:
            s *= 2
            out.append(("conv", s * s, 3, c, c))
    out.append(("conv", size * size, 3, ch[0], cfg.out_channels))
    return out


def transformers(cfg, size: int) -> list:
    """(tokens, width) of each Transformer2D of a forward."""
    return [(e[1], e[2]) for e in _walk(cfg, size) if e[0] == "transformer"]


def attention_macs(n: int, m: int, c: int) -> int:
    """Multiply-adds of one attention of n queries over m keys at width c
    (all heads): q kᵀ and the weights times v."""
    return 2 * n * m * c


def forward_macs(cfg, size: int) -> dict:
    """{"conv", "matmul", "attention"}: multiply-adds of one forward of one
    row."""
    macs = {"conv": 0, "matmul": 0, "attention": 0}
    t, ctx = cfg.text_tokens, cfg.cross_attention_dim
    for e in _walk(cfg, size):
        if e[0] == "conv":
            _, hw, k, cin, cout = e
            macs["conv"] += hw * k * k * cin * cout
        elif e[0] == "matmul":
            macs["matmul"] += e[1]
        else:
            _, n, c = e
            macs["conv"] += 2 * n * c * c  # proj_in, proj_out (1×1)
            # q, k, v, out of self-attention; q, out of cross-attention;
            # GEGLU's projection (2·4c) and its output (4c → c)
            macs["matmul"] += n * c * c * (4 + 2 + 3 * FF_MULT)
            macs["matmul"] += 2 * t * ctx * c  # cross-attention's k, v
            macs["attention"] += (attention_macs(n, n, c)
                                  + attention_macs(n, t, c))
    return macs


def forward_flops(cfg, rows: int, size: int) -> int:
    """2 × the multiply-adds of one forward of ``rows`` rows."""
    return 2 * rows * sum(forward_macs(cfg, size).values())
