"""Sums over the middle axis of [B, N, K] in an order that does not depend on
B (``csrc/batch_sums.cu``): the second half of the conv wrappers' GroupNorm
statistics (their per-tile partials [B, tiles, 2, C]) and the glue's
per-channel sums of an activation (``flat_resblock.channel_sums``).

torch's one reduction over a batch picks how it splits the work from the
number of its outputs, so a clip's sums, and with them its whole result,
would depend on the size of its batch. The kernel sums each sample over the
same blocks in the same order at any B. It ports no TPU kernel: the JAX
package finishes these sums in XLA.

On a CUDA tensor ``batch_sums`` launches the kernel (``batch_sums.launches``
counts its launches); on a CPU tensor, or inside ``twin_route``, it runs the
plain torch sums (``batch_sums_plain``).
"""

from __future__ import annotations

import torch

from ._cuda import check, kernels, ptr, stream_ptr, use_twin

# rows a block sums; more rows than this make another pass over the partials
ROWS = 512


def batch_sums_plain(x: torch.Tensor, squares: bool = False) -> torch.Tensor:
    """[B, 1 + squares, K] fp32: Σ_n x[:, n] (and Σ_n x[:, n]², the squared
    fp32 2-norm, so no fp32 copy of x is made)."""
    s1 = x.sum(dim=1, dtype=torch.float32)
    if not squares:
        return s1.unsqueeze(1)
    s2 = torch.linalg.vector_norm(x, dim=1, dtype=torch.float32).square()
    return torch.stack([s1, s2], dim=1)


def batch_sums(x: torch.Tensor, squares: bool = False) -> torch.Tensor:
    """x [B, N, K] fp32 or bf16 → [B, 1 + squares, K] fp32: the sum over N
    (and the sum of squares), each sample's in an order set by N and K
    alone."""
    if x.ndim != 3:
        raise ValueError(f"batch_sums: x must be [B, N, K], got "
                         f"{tuple(x.shape)}")
    if use_twin(x):
        return batch_sums_plain(x, squares)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"batch_sums: x must be fp32 or bf16, got {x.dtype}")
    b, n, k = x.shape
    src, rows, cols, sq = x.contiguous(), n, k, int(squares)
    with torch.cuda.device(x.device):
        lib = kernels()
        while True:
            chunks = -(-rows // ROWS)
            out = torch.empty((b, chunks, (1 + sq) * cols),
                              dtype=torch.float32, device=x.device)
            err = lib.ddim_batch_sums(ptr(src), ptr(out), b, rows, cols, sq,
                                      int(src.dtype == torch.bfloat16), ROWS,
                                      stream_ptr(x))
            check(err, "batch_sums")
            batch_sums.launches += 1
            if chunks == 1:
                return out.view(b, 1 + int(squares), k)
            # each chunk's partial sums [B, chunks, S·K], summed again
            src, rows, cols, sq = out, chunks, out.shape[2], 0


batch_sums.launches = 0


def partials_sum(stats: torch.Tensor):
    """A kernel's GroupNorm statistics partials [B, tiles, 2, C] summed over
    the tiles: (Σ, Σ²), each [B, C]."""
    b, tiles, two, c = stats.shape
    tot = batch_sums(stats.view(b, tiles, two * c)).view(b, two, c)
    return tot[:, 0], tot[:, 1]
