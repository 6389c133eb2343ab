"""The tensor-core head and tail convs' blocks, on the CPU.

``csrc/conv_head_tail.cu`` ``conv_head_mma_kernel`` and
``conv_tail_mma_kernel`` run only on the card. What surrounds their
arithmetic is checked here, against the plain twins at small ragged
geometries:

- the head: a model of the persistent walk of its plan
  (``tile_plan.conv_head_plan`` = ``csrc/conv_plan.h``, held equal in
  ``tests/test_torch_conv_redesign.py``): blocks ``bx, bx + G, …`` over
  tiles of whole time rows, each tile's Cin-wide halo with zero columns at
  f = −1 and F, the im2col A with K = 9·Cin padded to the kernel's k16 and
  k8 steps and its columns read at the kernel's per-lane offsets, the m16
  tiles' positions, the staged tile copied to the output as one contiguous
  run, and the statistics kept per block across its tiles, one partial a
  block; the staging writes of a warp fall in 32 banks;
- the tail: a model of its band walk (each input row staged once, the
  three column taps in N: P[(df, co)][p] = Σ_{dt, ci} v[t+dt−1, p, ci] ·
  w[dt, df, ci, co], then the shifted sum over df with P outside the row
  zero), in fp32 and with the residual rounded to bf16 first.

The models compute in fp64 from the stored operands; the twins in fp32.
"""

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.ops import conv_head_tail as cht
from ddim_audio_tpu_torch.ops.conv_head_tail import (
    conv_head_flat,
    conv_head_flat_plain,
    conv_tail_flat,
    conv_tail_flat_plain,
)
from ddim_audio_tpu_torch.ops.tile_plan import (
    VARIANT_FMA,
    VARIANT_MMA,
    VARIANT_NONE,
    TilePlan,
    conv_head_plan,
    conv_tail_plan,
    head_halo_pitch,
)

torch.set_num_threads(2)
C0 = 32


def _head_k_steps(c_in: int) -> tuple[int, int]:
    """(k16 steps, k8 steps) of the head's K = 9·Cin, as HeadK in the
    kernel: whole k16 steps, then a k16 step for a remainder above 8 or a
    k8 step for one of 1 … 8."""
    k = 9 * c_in
    return k // 16 + (k % 16 > 8), int(0 < k % 16 <= 8)


def _head_koff(k: int, c_in: int, hp: int):
    """Element offset of im2col column k from a position's own halo element
    (head_koff), or None past K."""
    if k >= 9 * c_in:
        return None
    tap, ci = divmod(k, c_in)
    return (tap // 3) * hp + (tap % 3 - 1) * c_in + ci


def emulate_head(x, w, bias, *, c_in, plan: TilePlan):
    """The tensor-core head as its blocks run it. x [B, T, F·Cin] → (out
    [B, T, F·C0], partials [B, G, 2, C0], the tiles each block walked)."""
    b_n, t_len, fc = x.shape
    f_len = fc // c_in
    xd = x.double().numpy().reshape(b_n, t_len * f_len * c_in)
    wd = w.double().numpy().reshape(9 * c_in, C0)
    tt, g = plan.tile_t, plan.tiles
    hp = head_halo_pitch(f_len, c_in)
    k16, k8 = _head_k_steps(c_in)
    kpad = 16 * k16 + 8 * k8
    # B: K rows padded with zeros to the k steps
    bmat = np.zeros((kpad, C0))
    bmat[:9 * c_in] = wd
    # the lanes' columns k → halo offsets, in the kernel's pair order
    offs = [_head_koff(k, c_in, hp) for k in range(kpad)]
    m_pad = -(-tt * f_len // 32) * 32  # whole pairs of m16 tiles (HEAD_MU)
    n_tiles = -(-t_len // tt)
    out = np.full(b_n * t_len * f_len * C0, np.nan)
    parts = np.zeros((b_n, g, 2, C0))
    walked = {}
    for b in range(b_n):
        for bx in range(g):
            s1, s2 = np.zeros(C0), np.zeros(C0)
            walked[b, bx] = list(range(bx, n_tiles, g))
            for tile in walked[b, bx]:
                t0 = tile * tt
                halo = np.zeros((tt + 2) * hp)  # pad and zero columns
                for r in range(tt + 2):
                    t = t0 - 1 + r
                    if 0 <= t < t_len:
                        row = xd[b, t * f_len * c_in:(t + 1) * f_len * c_in]
                        halo[r * hp + 8:r * hp + 8 + f_len * c_in] = row
                valid = min(tt, t_len - t0) * f_len
                a = np.zeros((m_pad, kpad))
                for p in range(valid):  # positions past the array read 0
                    r, f = divmod(p, f_len)
                    base = r * hp + 8 + f * c_in
                    a[p] = [0.0 if o is None else halo[base + o] for o in offs]
                o32 = a @ bmat + bias.double().numpy()
                s1 += o32[:valid].sum(axis=0)
                s2 += (o32[:valid] ** 2).sum(axis=0)
                # the staged tile's valid rows are one contiguous run
                start = (b * t_len + t0) * f_len * C0
                out[start:start + valid * C0] = o32[:valid].reshape(-1)
            parts[b, bx] = s1, s2
    return (torch.from_numpy(out.reshape(b_n, t_len, f_len * C0)),
            torch.from_numpy(parts), walked)


@pytest.mark.parametrize("b,t,f,c_in", [
    (2, 300, 256, 2),  # 150 tiles of 2 rows over 264 blocks a sample
    (1, 600, 256, 2),  # 300 tiles of 2 rows: some blocks walk two
    (1, 45, 24, 2),    # 21 rows a tile, the last tile 3 rows
    (2, 11, 13, 2),    # odd F: element-wise halo rows
    (1, 9, 40, 1), (2, 7, 12, 3), (1, 6, 20, 4)])
def test_head_block_model_matches_plain(b, t, f, c_in):
    rng = np.random.default_rng(t * f + c_in)
    x = torch.from_numpy(rng.standard_normal((b, t, f * c_in), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, c_in, C0),
                                             np.float32) * 0.2)
    bias = torch.from_numpy(rng.standard_normal(C0, np.float32))
    plan = conv_head_plan(t, f, c_in, C0, True, b)
    assert plan.variant == VARIANT_MMA and plan.tile_f == f
    out, parts, walked = emulate_head(x, w, bias, c_in=c_in, plan=plan)
    assert parts.shape == (b, plan.tiles, 2, C0)  # one partial a block
    n_tiles = -(-t // plan.tile_t)
    # every tile is walked by exactly one block of its sample
    for bb in range(b):
        tiles = sorted(i for bx in range(plan.tiles) for i in walked[bb, bx])
        assert tiles == list(range(n_tiles))
    if (b, t, f) == (2, 300, 256):
        assert max(len(v) for v in walked.values()) == 1
    if (b, t, f) == (1, 600, 256):
        assert max(len(v) for v in walked.values()) == 2
    ref, r1, r2 = conv_head_flat_plain(x, w, bias, c_in=c_in, c0=C0,
                                       want_stats=True)
    assert not torch.isnan(out).any()  # every output written
    scale = ref.abs().max().item()
    assert (out - ref.double()).abs().max().item() <= 1e-5 * scale
    tot = parts.sum(dim=1)
    for got, want in ((tot[:, 0], r1), (tot[:, 1], r2)):
        err = (got - want.double()).abs().max() / want.abs().max()
        assert err.item() <= 1e-5


def test_head_staging_writes_and_halo_reads_fall_in_distinct_banks():
    """B's columns are permuted, ch(8·nt + 2·q + e) = 8·q + 2·nt + e, so
    that lane (gid, tig), which holds columns 8·nt + 2·tig + e of the four
    n8 tiles, holds channels 8·tig … 8·tig + 7 in order: its 16-byte staging
    word of position p lies at byte 64·p + 16·tig, and each quarter warp
    (lanes 8·i … 8·i + 7: two positions) writes 128 contiguous bytes. The
    halo pitch is 16 words mod 32, so an im2col read of rows dt and dt + 1
    never lands two distinct words in one bank at Cin = 2."""
    perm = [8 * (j % 8 // 2) + 2 * (j // 8) + j % 2 for j in range(C0)]
    assert sorted(perm) == list(range(C0))
    for tig in range(4):
        held = [perm[8 * nt + 2 * tig + e] for nt in range(4) for e in (0, 1)]
        assert held == list(range(8 * tig, 8 * tig + 8))
    for m, hh in ((0, 0), (3, 1)):
        for quarter in range(4):
            spans = set()
            for lane in range(8 * quarter, 8 * quarter + 8):
                gid, tig = divmod(lane, 4)
                start = 64 * (16 * m + gid + 8 * hh) + 16 * tig
                spans.update(range(start, start + 16))
            assert len(spans) == 128 and max(spans) - min(spans) == 127
    for f in (12, 24, 40, 256, 1000):
        for c_in in (1, 2, 3, 4):
            hp = head_halo_pitch(f, c_in)
            assert hp % 8 == 0 and (hp // 2) % 32 == 16
            assert hp >= 8 + f * c_in + c_in  # zero column f = F
    hp = head_halo_pitch(256, 2)
    for s in range(2):  # Cin = 2: the two k16 pairs' words of a warp
        for hi in range(2):
            words = {}
            for lane in range(32):
                gid, tig = divmod(lane, 4)
                o = _head_koff(16 * s + 8 * hi + 2 * tig, 2, hp)
                if o is not None:
                    word = (8 + 2 * gid + o) // 2
                    words.setdefault(word % 32, set()).add(word)
            assert all(len(v) == 1 for v in words.values())


def emulate_tail(h, w, bias, *, c0, c_out, residual, plan: TilePlan):
    """The tensor-core tail as its blocks run it: each block slides down its
    band of output rows, staging input rows r0 − 1 … r1 once each; per
    output row the MMA P = Σ_dt v[t+dt−1] · W[dt] with N = (df, co), then
    out = bias + P[f−1, df=0] + P[f, df=1] + P[f+1, df=2]. Returns (out,
    the input rows each block staged)."""
    b_n, t_len, fc = h.shape
    f_len = fc // c0
    v = h if residual is None else (h.float() + residual.float()).to(h.dtype)
    vd = v.double().numpy().reshape(b_n, t_len, f_len, c0)
    wd = w.double().numpy()  # [dt, df, ci, co]
    n_cols = 8 * -(-3 * c_out // 8)
    # B[dt][ci][(df, co)], zero columns past 3·Cout
    bmat = np.zeros((3, c0, n_cols))
    bmat[:, :, :3 * c_out] = wd.transpose(0, 2, 1, 3).reshape(3, c0,
                                                             3 * c_out)
    band, g = plan.tile_t, plan.tiles
    out = np.full((b_n, t_len, f_len, c_out), np.nan)
    staged = {}
    for b in range(b_n):
        for bx in range(g):
            r0, r1 = bx * band, min(t_len, (bx + 1) * band)
            ring = {}
            staged[b, bx] = []
            for j in range(r1 - r0 + 2):
                u = r0 - 1 + j
                ring[j % 3] = vd[b, u] if 0 <= u < t_len else np.zeros(
                    (f_len, c0))
                staged[b, bx].append(u)
                if j < 2:
                    continue
                p = sum(ring[(j - 2 + dt) % 3] @ bmat[dt] for dt in range(3))
                p = np.pad(p, ((1, 1), (0, 0)))  # P at -1 and F: zero
                t = r0 + j - 2
                for co in range(c_out):
                    out[b, t, :, co] = (bias[co].item()
                                        + p[:-2, co]
                                        + p[1:-1, c_out + co]
                                        + p[2:, 2 * c_out + co])
    return torch.from_numpy(out.reshape(b_n, t_len, f_len * c_out)), staged


@pytest.mark.parametrize("b,t,f,c0,c_out,res", [
    (2, 301, 24, 32, 2, True),   # bands of 3 rows, the last one row
    (1, 40, 24, 32, 2, True),    # chip_smoke.py's small case
    (2, 17, 13, 32, 2, True),    # odd F
    (1, 9, 40, 64, 4, False), (2, 6, 7, 32, 1, True)])
def test_tail_band_model_matches_plain(b, t, f, c0, c_out, res):
    rng = np.random.default_rng(t + f + c_out)
    h = torch.from_numpy(rng.standard_normal((b, t, f * c0), np.float32))
    r = (torch.from_numpy(rng.standard_normal((b, t, f * c0), np.float32))
         if res else None)
    w = torch.from_numpy(rng.standard_normal((3, 3, c0, c_out), np.float32)
                         * (9 * c0) ** -0.5)
    bias = torch.from_numpy(rng.standard_normal(c_out, np.float32))
    plan = conv_tail_plan(t, f, c0, c_out, True, b)
    assert plan.variant == VARIANT_MMA and plan.tile_f == f
    out, staged = emulate_tail(h, w, bias, c0=c0, c_out=c_out, residual=r,
                               plan=plan)
    if (b, t) == (2, 301):
        assert plan.tile_t == 3 and plan.tiles == 101
    for (bb, bx), rows in staged.items():  # each input row staged once
        r0 = bx * plan.tile_t
        assert rows == list(range(r0 - 1, min(t, r0 + plan.tile_t) + 1))
    ref = conv_tail_flat_plain(h, w, bias, c0=c0, c_out=c_out, residual=r)
    assert not torch.isnan(out).any()
    assert (out - ref.double()).abs().max().item() <= \
        1e-5 * ref.abs().max().item()


def test_tail_band_model_rounds_the_residual_sum_to_bf16():
    """bf16 storage: v = bf16(h + residual) feeds the MMA; the model on the
    stored operands equals the twin's fp32 result before its one rounding."""
    rng = np.random.default_rng(5)
    h, r = (torch.from_numpy(rng.standard_normal((1, 12, 24 * 32),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 2), np.float32)
                         * 0.06).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(2, np.float32))
    plan = conv_tail_plan(12, 24, 32, 2, True, 1)
    out, _ = emulate_tail(h, w, bias, c0=32, c_out=2, residual=r, plan=plan)
    v = (h.float() + r.float()).bfloat16().float()
    ref = conv_tail_flat_plain(v, w.float(), bias, c0=32, c_out=2)
    assert (out - ref.double()).abs().max().item() <= \
        1e-5 * ref.abs().max().item()
    # the wrapper on bf16 CPU tensors: the same sum rounded once to bf16
    assert torch.equal(ref.bfloat16(), conv_tail_flat(h, w, bias, c0=32,
                                                      c_out=2, residual=r))


def test_bf16_shapes_without_the_tensor_core_kernel_have_no_kernel():
    """A bf16 head at C0 = 32 or a bf16 tail whose rows do not fit in shared
    memory has no kernel (the wrapper raises; the CUDA-core kernel never
    runs in the tensor-core one's place); fp32 and a bf16 head at another
    C0 take the CUDA cores; C_in or C_out outside the kernels' set has
    none."""
    none = TilePlan(VARIANT_NONE, 8, 16, 1, 1, 1, 0)
    with pytest.raises(ValueError, match="no variant takes"):
        cht._require_kernel(none, "conv_tail_flat", "T=8 F=4096")
    cht._require_kernel(none._replace(variant=VARIANT_FMA), "x", "y")
    assert conv_tail_plan(8, 4096, 32, 2, True, 1).variant == VARIANT_NONE
    assert conv_head_plan(8, 8192, 2, 32, True, 1).variant == VARIANT_NONE
    assert conv_tail_plan(8, 4096, 32, 2, False, 1).variant == VARIANT_FMA
    assert conv_head_plan(8, 8192, 2, 32, False, 1).variant == VARIANT_FMA
    assert conv_head_plan(8, 24, 2, 16, True, 1).variant == VARIANT_FMA
    assert conv_head_plan(8, 24, 5, 32, True, 1).variant == VARIANT_NONE
    assert conv_tail_plan(8, 24, 32, 3, True, 1).variant == VARIANT_NONE


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("t,f,c_in,b", [(8192, 256, 2, 2), (40, 24, 2, 1),
                                        (11, 13, 2, 2), (9, 40, 1, 1),
                                        (7, 12, 3, 2), (6, 20, 4, 1)])
def test_head_tensor_core_kernel_matches_twin_on_gpu(cuda, t, f, c_in, b):
    """bf16 on the tensor cores: within 2e-2 of max|twin|, statistics
    within 1e-3, twice bit-equal, one partial a block."""
    from ddim_audio_tpu_torch.ops import _cuda

    g = torch.Generator(device=cuda).manual_seed(t + f)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda).bfloat16()
    w = (0.2 * torch.randn(3, 3, c_in, C0, generator=g,
                           device=cuda)).bfloat16()
    bias = torch.randn(C0, generator=g, device=cuda)
    assert _cuda.kernels().ddim_conv_head_variant(t, f, c_in, C0, 1) == \
        VARIANT_MMA
    got = conv_head_flat(x, w, bias, c_in=c_in, c0=C0, want_stats=True)
    again = conv_head_flat(x, w, bias, c_in=c_in, c0=C0, want_stats=True)
    ref = conv_head_flat_plain(x, w, bias, c_in=c_in, c0=C0,
                               want_stats=True)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert _rel(got[0], ref[0]) <= 2e-2
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t,f,c0,c_out,b", [(8192, 256, 32, 2, 2),
                                            (40, 24, 32, 2, 1),
                                            (17, 13, 32, 2, 2),
                                            (9, 40, 64, 4, 1),
                                            (6, 7, 32, 1, 2)])
def test_tail_tensor_core_kernel_matches_twin_on_gpu(cuda, t, f, c0, c_out,
                                                     b):
    from ddim_audio_tpu_torch.ops import _cuda

    g = torch.Generator(device=cuda).manual_seed(t * f)
    h, r = (torch.randn(b, t, f * c0, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    w = (torch.randn(3, 3, c0, c_out, generator=g, device=cuda)
         * (9 * c0) ** -0.5).bfloat16()
    bias = torch.randn(c_out, generator=g, device=cuda)
    assert _cuda.kernels().ddim_conv_tail_variant(t, f, c0, c_out, 1) == \
        VARIANT_MMA
    if (t, f) == (40, 24):  # a bf16 row too wide for the kernel raises
        wide = torch.zeros(1, 2, 4096 * c0, device=cuda).bfloat16()
        with pytest.raises(ValueError, match="no variant takes"):
            conv_tail_flat(wide, w, bias, c0=c0, c_out=c_out)
    for res in (r, None):
        got = conv_tail_flat(h, w, bias, c0=c0, c_out=c_out, residual=res)
        assert torch.equal(got, conv_tail_flat(h, w, bias, c0=c0,
                                               c_out=c_out, residual=res))
        assert _rel(got, conv_tail_flat_plain(h, w, bias, c0=c0, c_out=c_out,
                                              residual=res)) <= 2e-2
