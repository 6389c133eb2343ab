"""Kernel family attention: the attention cores of the SD UNet's
Transformer2Ds (``F.scaled_dot_product_attention``), self-attention over a
level's tokens and cross-attention to the text's.

``NAMES`` matches the kernels that torch's SDPA launches on the H100 for
bf16 (read from a trace of the cell): its flash-attention kernels, and the
memory-efficient and cuDNN ones it may pick instead.

Work per denoiser step, at the configuration's shapes and whatever kernel
does it: for each of the forward's Transformer2Ds and each of its two
attentions, over the step's rows (2 × the clips: the guided batch),
4·N·M·C operations (q kᵀ and the weights times v; N queries, M = N keys
for self-attention and the text's tokens for cross-attention, C the
width) and q, k, v and the output read or written once in the compute
dtype."""

from __future__ import annotations

import re

from port_bench.harness import sd_work
from port_bench.harness.work import BYTES, bound_s

NAMES = re.compile(r"flash_fwd|fmha_cutlass|AttentionKernel|"
                   r"cudnn\w*sdpa|\bsdpa_|flash_attention")


def calls(cfg, size: int) -> list:
    """(N, M, C) of each attention of one forward."""
    out = []
    for n, c in sd_work.transformers(cfg, size):
        out += [(n, n, c), (n, cfg.text_tokens, c)]
    return out


def bound_per_step(run) -> float:
    """The least seconds the card could take for the attention cores of
    one denoiser step."""
    dt = run.config["declared"]["sample_dtype"]
    rows = run.rows
    total = 0.0
    for n, m, c in calls(run.sd, run.size):
        ops = rows * 2 * sd_work.attention_macs(n, m, c)
        nbytes = rows * BYTES[dt] * c * (2 * n + 2 * m)
        total += bound_s(ops, nbytes, dt)
    return total
