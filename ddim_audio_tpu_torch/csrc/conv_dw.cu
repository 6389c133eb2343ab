// Weight gradients of the three flat convs, over channels-last activations.
//
// Replaces the TPU kernels of ddim_audio_tpu/ops/flat_grad.py:
//   MODE 0  `_dw_kernel`      (wrapper `conv_dw_flat`):      3×3 SAME conv
//   MODE 1  `_down_dw_kernel` (wrapper `conv_down_dw_flat`): k4 s2 p1 conv
//   MODE 2  `_up_dw_kernel`   (wrapper `conv_up_dw_flat`):   transposed k4 s2
//                                                            p1 conv
// Each computes, per tap (kh, kw), the contraction over every position of
// every sample
//
//   dW[kh, kw, ci, co] = Σ_{b, i, j} x[b, XS·i + xo(kh), XS·j + xo(kw), ci]
//                                  · g[b, GS·i + go(kh), GS·j + go(kw), co]
//
// with x zero outside its array, (i, j) running over a "base grid":
//   MODE 0: base = the shared (T, F) grid, XS = GS = 1, xo(k) = k − 1, go = 0
//   MODE 1: base = g's (T/2, F/2) grid, XS = 2, xo(k) = k − 1, GS = 1, go = 0
//   MODE 2: base = x's (T, F) grid, XS = 1, xo(k) = (k + 1)/2 − 1, GS = 2,
//           go(k) = k & 1  (the stored weight of the transposed conv is the
//           equivalent forward kernel on the zero-dilated input, so tap k
//           meets only the output rows of its own parity)
// and writes HWIO [KH, KW, C_in, C_out] fp32 directly; the TPU kernels'
// packed [9P, P] / [12S, P] / [12Q, P_s] outputs, their even/odd scratch
// streams and the unpacking VJP exist only for the TPU's lanes.
//
// What bounds it on an H100: the contraction is long (T·F positions, 262,144
// at the first stage of the training geometry) and the result small
// (taps·C_in·C_out), so at the wide-and-shallow first stages the operations
// bound it (fp32 as three TF32 tensor-core products, 495 TFLOP/s; 67 on
// CUDA cores) and at the narrow-and-deep last stages the launch and the
// partials' write. The TPU kernel carries its sum in one output block over
// a sequential grid; here the positions are split over blocks instead.
// Block (x, y) owns one (ci, co) tile of all taps and the y-th share of the
// position tiles; it stages each tile's x halo and g tile in shared memory
// once and accumulates every tap from them, then writes its partial sums to
// part[y]. The wrapper finishes with torch.sum over y. No atomics: the
// result is the same bits run to run.
//
// Three variants, chosen per call by the plan (conv_plan.h: dw_first_plan,
// conv3x3_dw_plan, conv_down_dw_plan, conv_up_dw_plan):
// - conv_dw_tf32_kernel (fp32, every mode, C_in % 16 == C_out % 32 == 0):
//   split TF32 on the tensor cores, below;
// - conv_dw_mma_kernel (bf16 operands, base F >= 16, C_in % 32 == C_out % 32
//   == 0): WMMA 16×16×16 bf16 products, fp32 accumulation. For a tap, the
//   A operand is xᵀ: 16 channels × 16 consecutive base positions of a row,
//   read column-major from the staged halo (leading dimension XS·32), and B
//   is g: 16 positions × 16 channels, row-major (leading dimension GS·32).
//   The taps·4 (tap, ci half, co half) fragment jobs are dealt to the 8
//   warps round-robin.
// - conv_dw_kernel (bf16 at narrow F or channels no multiple of 32, fp32
//   at channels the split-TF32 kernel does not take): CUDA cores. Lane l
//   owns output channel co0 + l, warp w input channels ci0 + 4w … 4w + 3;
//   per position and tap one float4 broadcast read of x and one
//   conflict-free read of g feed 4 FMAs, with taps·4 fp32 accumulators per
//   thread.
//
// Training runs all three weight gradients in fp32 (an optimizer step: 924
// launches of mode 0, 70 of modes 1 and 2). On CUDA cores they took 0.836,
// 0.862 and 0.813 ms summed over the training shapes against one fp32
// conv2d_weight's 0.896, 0.546 and 0.549 (an H100 80GB HBM3 at 700 W,
// PERF.md). Each has the multiply-adds of its forward conv (2·taps·C_in·
// C_out·base positions), which runs split TF32 (conv3x3.cu,
// conv_strided.cu); so does conv_dw_tf32_kernel:
// * the GEMM per tap: K = the base positions, M = C_in, N = C_out;
// * a block owns all the taps × kDwTf32Ci input channels × kDwTf32Co output
//   channels (grid.x) and a contiguous share of the batch's position tiles
//   (grid.y: the partials' first dimension, planned per shape so that the
//   grid is about two blocks an SM);
// * per tile, the raw x halo and g tile are copied once by cp.async (the
//   next tile's while this one's products run), and one pass splits every
//   value into TF32 hi and lo planes laid out [position][channel]: each
//   halo row's even columns before its odd ones where the operand is read
//   at stride 2 (x in mode 1, g in mode 2), so that the 8 base positions of
//   a k8 step are 8 consecutive rows for every tap; a pitch of 8 mod 32
//   floats makes the fragments' scalar 32-bit loads conflict-free (ldmatrix
//   has no transpose for 32-bit elements, and both operands are read with
//   K = position contiguous in the fragment);
// * the tile: 64 base positions in modes 1 and 2, 128 in mode 0, its rows
//   halved until two blocks fit an SM's shared memory. Mode 2's g tile is
//   four times its base tile (at 64 positions 142 KB with the x halo, raw
//   and split, one block an SM), so it runs 32 positions (76 KB); mode 0's
//   halo at stride 1 takes 103 KB at 128 (56 KB at 64);
// * the warp map (DwTf32Map): in modes 1 and 2 warp w takes taps (w / 2,
//   w % 2) and (w / 2, w % 2 + 2), which read the same g positions: per k8
//   step four B fragments (hi and lo) serve both taps' A fragments. Mode
//   0's nine taps all read the same g, and one warp cannot hold them (9 ×
//   16 accumulators and as many for a tile's sum): warp w takes the three
//   taps of row w % 3, so that one B fragment pair serves three A
//   fragments (the shared-memory loads a product: 40 / 36, against 32 / 24
//   in modes 1 and 2), and two sets of three warps take a tile's even and
//   odd k8 steps; set 1 hands its totals to set 0 through shared memory
//   at the end. Each fragment pair gives three mma.sync.m16n8k8 products
//   (lo·hi + hi·lo + hi·hi);
// * each tile's sum is folded into the block's total by IEEE fp32 additions
//   (the tensor cores' accumulation is not round-to-nearest), the K sets'
//   totals and the partials are summed in a fixed order (the wrapper's
//   torch.sum, none where the plan has one share): fp32 accuracy and the
//   same bits run to run.
#include <mma.h>

#include "conv_mma.cuh"

namespace ddim {

template <int MODE>
struct DwGeom {
  static constexpr int KH = MODE == 0 ? 3 : 4;
  static constexpr int TAPS = KH * KH;
  static constexpr int XS = MODE == 1 ? 2 : 1;
  static constexpr int GS = MODE == 2 ? 2 : 1;
  static constexpr int XOMAX = MODE == 1 ? 2 : 1;  // max xo; min xo is −1
  // base positions per tile of the CUDA-core variant
  static constexpr int NP = dw_first_np(MODE);
  // rows of 16 base positions per tile of the tensor-core variant
  static constexpr int TTM = dw_first_ttm(MODE);
  __host__ __device__ static constexpr int halo(int n) {
    return XS * (n - 1) + XOMAX + 2;
  }
};

template <int MODE>
__host__ __device__ __forceinline__ int dw_xo(int k) {
  return MODE == 2 ? (k + 1) / 2 - 1 : k - 1;
}
template <int MODE>
__host__ __device__ __forceinline__ int dw_go(int k) {
  return MODE == 2 ? (k & 1) : 0;
}

// The plan of a call (conv_plan.h): the split-TF32 kernel's for fp32 where
// the channels allow it, else the first kernels'.
template <int MODE>
TilePlan dw_plan(int batch, int t_len, int f_len, int c_in, int c_out,
                 int bf16) {
  if (MODE == 0)
    return conv3x3_dw_plan(t_len, f_len, c_in, c_out, bf16, batch);
  if (MODE == 1)
    return conv_down_dw_plan(t_len, f_len, c_in, c_out, bf16, batch);
  return conv_up_dw_plan(t_len, f_len, c_in, c_out, bf16, batch);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ part, int batch, int t_len, int f_len,
                   int c_in, int c_out, int per_block) {
  using G = DwGeom<MODE>;
  constexpr int KH = G::KH, XS = G::XS, GS = G::GS;
  // the two tile shapes (FT = 16 or 8) bound the staged regions
  constexpr int kHaloMax =
      G::halo(G::NP / 16) * G::halo(16) > G::halo(G::NP / 8) * G::halo(8)
          ? G::halo(G::NP / 16) * G::halo(16)
          : G::halo(G::NP / 8) * G::halo(8);
  __shared__ __align__(16) float xs[kHaloMax * kDwCi];
  __shared__ __align__(16) float gs[GS * GS * G::NP * kCoTile];

  const int tb = MODE == 1 ? t_len / 2 : t_len;
  const int fb = MODE == 1 ? f_len / 2 : f_len;
  const int tg_len = GS * tb, fg_len = GS * fb;
  const int ft = tile_f(fb), tt = G::NP / ft;
  const int tiles_f = (fb + ft - 1) / ft;
  const int tiles = ((tb + tt - 1) / tt) * tiles_f;
  const int total = batch * tiles;
  const int co_tiles = (c_out + kCoTile - 1) / kCoTile;
  const int ci0 = (blockIdx.x / co_tiles) * kDwCi;
  const int co0 = (blockIdx.x % co_tiles) * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = G::halo(ft), hr = G::halo(tt);
  const int gw = GS * ft, gr = GS * tt;

  float acc[G::TAPS][4];
#pragma unroll
  for (int k = 0; k < G::TAPS; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  const int first = blockIdx.y * per_block;
  const int last = first + per_block < total ? first + per_block : total;
  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tiles, r = tile % tiles;
    const int t0 = (r / tiles_f) * tt, f0 = (r % tiles_f) * ft;
    __syncthreads();  // the previous tile's reads are done
    for (int idx = threadIdx.x; idx < hr * hw * kDwCi; idx += kThreads) {
      const int ci = idx % kDwCi, hp = idx / kDwCi;
      const int t = XS * t0 - 1 + hp / hw, f = XS * f0 - 1 + hp % hw;
      const int ch = ci0 + ci;
      float v = 0.f;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len && ch < c_in)
        v = to_f(x[(((size_t)b * t_len + t) * f_len + f) * c_in + ch]);
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < gr * gw * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, gp = idx / kCoTile;
      const int t = GS * t0 + gp / gw, f = GS * f0 + gp % gw;
      const int oc = co0 + l;
      float v = 0.f;
      if (t < tg_len && f < fg_len && oc < c_out)
        v = to_f(g[(((size_t)b * tg_len + t) * fg_len + f) * c_out + oc]);
      gs[idx] = v;
    }
    __syncthreads();

    for (int p = 0; p < G::NP; ++p) {
      const int i = p / ft, j = p % ft;
      const float* xp = &xs[((XS * i) * hw + XS * j) * kDwCi + 4 * warp];
      const float* gp = &gs[((GS * i) * gw + GS * j) * kCoTile + lane];
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
        for (int kw = 0; kw < KH; ++kw) {
          const float gv =
              gp[(dw_go<MODE>(kh) * gw + dw_go<MODE>(kw)) * kCoTile];
          const float4 xv = *reinterpret_cast<const float4*>(
              xp + ((dw_xo<MODE>(kh) + 1) * hw + dw_xo<MODE>(kw) + 1) * kDwCi);
          acc[kh * KH + kw][0] = fmaf(xv.x, gv, acc[kh * KH + kw][0]);
          acc[kh * KH + kw][1] = fmaf(xv.y, gv, acc[kh * KH + kw][1]);
          acc[kh * KH + kw][2] = fmaf(xv.z, gv, acc[kh * KH + kw][2]);
          acc[kh * KH + kw][3] = fmaf(xv.w, gv, acc[kh * KH + kw][3]);
        }
      }
    }
  }

  const int co = co0 + lane;
#pragma unroll
  for (int tap = 0; tap < G::TAPS; ++tap) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = ci0 + 4 * warp + k;
      if (ci < c_in && co < c_out)
        part[(((size_t)blockIdx.y * G::TAPS + tap) * c_in + ci) * c_out + co] =
            acc[tap][k];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) conv_dw_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    float* __restrict__ part, int batch, int t_len, int f_len, int c_in,
    int c_out, int per_block) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  using G = DwGeom<MODE>;
  constexpr int KH = G::KH, XS = G::XS, GS = G::GS;
  constexpr int TT = G::TTM, FT = 16;
  constexpr int HW = G::halo(FT), HR = G::halo(TT);
  constexpr int GW = GS * FT, GR = GS * TT;
  constexpr int JOBS = G::TAPS * 4, JPW = (JOBS + kWarps - 1) / kWarps;
  __shared__ __align__(32) T xs[HR * HW * kDwCi];
  __shared__ __align__(32) T gs[GR * GW * kCoTile];

  const int tb = MODE == 1 ? t_len / 2 : t_len;
  const int fb = MODE == 1 ? f_len / 2 : f_len;
  const int tg_len = GS * tb, fg_len = GS * fb;
  const int tiles_f = (fb + FT - 1) / FT;
  const int tiles = ((tb + TT - 1) / TT) * tiles_f;
  const int total = batch * tiles;
  const int co_tiles = c_out / kCoTile;
  const int ci0 = (blockIdx.x / co_tiles) * kDwCi;
  const int co0 = (blockIdx.x % co_tiles) * kCoTile;
  const int warp = threadIdx.x >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[JPW];
#pragma unroll
  for (int jj = 0; jj < JPW; ++jj) wmma::fill_fragment(acc[jj], 0.f);

  const int first = blockIdx.y * per_block;
  const int last = first + per_block < total ? first + per_block : total;
  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tiles, r = tile % tiles;
    const int t0 = (r / tiles_f) * TT, f0 = (r % tiles_f) * FT;
    __syncthreads();  // the previous tile's reads are done
    // 8 channels (16 bytes) per item; out-of-range positions are zero
    for (int idx = threadIdx.x; idx < HR * HW * (kDwCi / 8); idx += kThreads) {
      const int q = idx % (kDwCi / 8), hp = idx / (kDwCi / 8);
      const int t = XS * t0 - 1 + hp / HW, f = XS * f0 - 1 + hp % HW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < t_len && f >= 0 && f < f_len)
        v = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * t_len + t) * f_len + f) * c_in + ci0 + 8 * q);
      *reinterpret_cast<uint4*>(xs + hp * kDwCi + 8 * q) = v;
    }
    for (int idx = threadIdx.x; idx < GR * GW * (kCoTile / 8);
         idx += kThreads) {
      const int q = idx % (kCoTile / 8), gp = idx / (kCoTile / 8);
      const int t = GS * t0 + gp / GW, f = GS * f0 + gp % GW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < tg_len && f < fg_len)
        v = *reinterpret_cast<const uint4*>(
            g + (((size_t)b * tg_len + t) * fg_len + f) * c_out + co0 + 8 * q);
      *reinterpret_cast<uint4*>(gs + gp * kCoTile + 8 * q) = v;
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < JPW; ++jj) {
      const int job = warp + kWarps * jj;
      if (job < JOBS) {
        const int tap = job >> 2, mi = (job >> 1) & 1, ni = job & 1;
        const int kh = tap / KH, kw = tap % KH;
        const T* xa = xs +
                      ((dw_xo<MODE>(kh) + 1) * HW + dw_xo<MODE>(kw) + 1) * kDwCi +
                      16 * mi;
        const T* gb = gs +
                      (dw_go<MODE>(kh) * GW + dw_go<MODE>(kw)) * kCoTile +
                      16 * ni;
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
          wmma::load_matrix_sync(a, xa + XS * i * HW * kDwCi, XS * kDwCi);
          wmma::load_matrix_sync(bm, gb + GS * i * GW * kCoTile, GS * kCoTile);
          wmma::mma_sync(acc[jj], a, bm, acc[jj]);
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < JPW; ++jj) {
    const int job = warp + kWarps * jj;
    if (job < JOBS) {
      const int tap = job >> 2, mi = (job >> 1) & 1, ni = job & 1;
      float* dst = part +
                   (((size_t)blockIdx.y * G::TAPS + tap) * c_in + ci0 + 16 * mi) *
                       c_out +
                   co0 + 16 * ni;
      wmma::store_matrix_sync(dst, acc[jj], c_out, wmma::mem_row_major);
    }
  }
}

// The slot of halo position (r, c) in a plane whose rows are `w` positions
// wide: at stride S = 2 each row holds its even columns, then its odd ones.
template <int S>
__device__ __forceinline__ int dw_slot(int r, int c, int w) {
  return S == 2 ? r * w + (c & 1) * (w / 2) + (c >> 1) : r * w + c;
}

// The split-TF32 kernel's warp map. Modes 1 and 2: warp w takes the U = 2
// taps (w / 2, w % 2) and (w / 2, w % 2 + 2), which read the same g
// positions (go(kw) = go(kw + 2)); eight warps cover the 16 taps. Mode 0,
// whose nine taps all read the same g (go = 0): warp w takes the U = 3 taps
// of row w % 3, (w % 3, 0 … 2), so that one B fragment pair serves three A
// fragments, and the k8 steps s of each tile with s % KSETS == w / 3:
// KSETS sets of three warps share a tile, each set with totals of its own,
// which set 0 adds in set order at the end.
template <int MODE>
struct DwTf32Map {
  static constexpr int U = MODE == 0 ? 3 : 2;      // taps a warp
  static constexpr int KWS = MODE == 0 ? 1 : 2;    // kw step between them
  static constexpr int KSETS = MODE == 0 ? kDw3KSets : 1;
  static constexpr int THREADS = dw_tf32_threads(MODE);
  __device__ static int kh(int warp) {
    return MODE == 0 ? warp % 3 : warp >> 1;
  }
  __device__ static int kw0(int warp) { return MODE == 0 ? 0 : warp & 1; }
  __device__ static int kset(int warp) { return MODE == 0 ? warp / 3 : 0; }
};

template <int MODE>
__global__ void __launch_bounds__(DwTf32Map<MODE>::THREADS, kDwTf32Blocks)
    conv_dw_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, float* __restrict__ part,
                        int batch, int t_len, int f_len, int c_in, int c_out,
                        int tt, int ft, int per_block) {
  using G = DwGeom<MODE>;
  using M = DwTf32Map<MODE>;
  constexpr int KH = G::KH, XS = G::XS, GS = G::GS, U = M::U;
  constexpr int NTH = M::THREADS;
  constexpr int CI = kDwTf32Ci, CO = kDwTf32Co;
  constexpr int XP = kDwTf32XP, GP = kDwTf32GP;
  static_assert(NTH / 32 * U == G::TAPS * M::KSETS,
                "the warps take every tap once a K set");
  extern __shared__ __align__(16) float smem_dw[];
  const int hw = G::halo(ft), hx = G::halo(tt) * hw;  // the x halo
  const int gw = GS * ft, hg = GS * tt * gw;           // the g tile
  float* xr = smem_dw;        // raw x [hx][CI]
  float* gr = xr + hx * CI;   // raw g [hg][CO]
  float* xh = gr + hg * CO;   // x planes [hx][XP], hi then lo
  float* xl = xh + hx * XP;
  float* gh = xl + hx * XP;   // g planes [hg][GP], hi then lo
  float* gl = gh + hg * GP;

  const int tb = MODE == 1 ? t_len / 2 : t_len;  // the base grid
  const int fb = MODE == 1 ? f_len / 2 : f_len;
  const int tg_len = GS * tb, fg_len = GS * fb;
  const int tiles_f = (fb + ft - 1) / ft;
  const int tiles = ((tb + tt - 1) / tt) * tiles_f;
  const int total = batch * tiles;
  const int co_groups = c_out / CO;
  const int ci0 = (blockIdx.x / co_groups) * CI;
  const int co0 = (blockIdx.x % co_groups) * CO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kh = M::kh(warp), kw0 = M::kw0(warp), kset = M::kset(warp);
  const int fs = ft == 16 ? 1 : 0;  // log2 of the k8 steps a row
  const int steps = tt << fs;

  // A tile's raw x halo (rows XS·t0 − 1 …, columns XS·f0 − 1 …, zero
  // outside) and g tile (zero outside: positions past the array add
  // nothing), this block's channels.
  auto load_raw = [&](int tile) {
    const int b = tile / tiles, r = tile % tiles;
    const int t0 = (r / tiles_f) * tt, f0 = (r % tiles_f) * ft;
    const float* xb = x + (size_t)b * t_len * f_len * c_in + ci0;
    for (int i = threadIdx.x; i < hx * (CI / 4); i += NTH) {
      const int hp = i / (CI / 4), q = i % (CI / 4);
      const int t = XS * t0 - 1 + hp / hw, f = XS * f0 - 1 + hp % hw;
      const bool in = t >= 0 && t < t_len && f >= 0 && f < f_len;
      cp_async16_zfill(xr + hp * CI + 4 * q,
                       in ? xb + ((size_t)t * f_len + f) * c_in + 4 * q : x,
                       in);
    }
    const float* gb = g + (size_t)b * tg_len * fg_len * c_out + co0;
    for (int i = threadIdx.x; i < hg * (CO / 4); i += NTH) {
      const int gp = i / (CO / 4), q = i % (CO / 4);
      const int t = GS * t0 + gp / gw, f = GS * f0 + gp % gw;
      const bool in = t < tg_len && f < fg_len;
      cp_async16_zfill(gr + gp * CO + 4 * q,
                       in ? gb + ((size_t)t * fg_len + f) * c_out + 4 * q : g,
                       in);
    }
  };

  float acc[U][kNT][4];
  zero_acc(acc);
  const int first = blockIdx.y * per_block;
  const int last = first + per_block < total ? first + per_block : total;
  if (first < last) load_raw(first);
  cp_async_commit();
#pragma unroll 1
  for (int tile = first; tile < last; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // the raw tile landed; every warp is done with the planes
    // The split: every value once into its hi and lo planes.
    for (int i = threadIdx.x; i < hx * (CI / 4); i += NTH) {
      const int hp = i / (CI / 4), q = i % (CI / 4);
      const int sl = dw_slot<XS>(hp / hw, hp % hw, hw) * XP + 4 * q;
      store_split_tf32(xh + sl, xl + sl,
                       *reinterpret_cast<const float4*>(xr + hp * CI + 4 * q));
    }
    for (int i = threadIdx.x; i < hg * (CO / 4); i += NTH) {
      const int gp = i / (CO / 4), q = i % (CO / 4);
      const int sl = dw_slot<GS>(gp / gw, gp % gw, gw) * GP + 4 * q;
      store_split_tf32(gh + sl, gl + sl,
                       *reinterpret_cast<const float4*>(gr + gp * CO + 4 * q));
    }
    __syncthreads();  // the planes are complete and the raw buffers free
    if (tile + 1 < last) load_raw(tile + 1);
    cp_async_commit();

    // The tile's products: k8 step s = base positions (i, j0 … j0 + 7),
    // this warp's K set's steps.
    float sum[U][kNT][4];
    zero_acc(sum);
#pragma unroll 1
    for (int s = kset; s < steps; s += M::KSETS) {
      const int i = s >> fs, j0 = (s & fs) << 3;
      // B (every tap of the warp): g at (GS·i + go(kh), GS·j + go(kw0)),
      // k = j − j0
      const int gs = dw_slot<GS>(GS * i + dw_go<MODE>(kh),
                                 GS * j0 + dw_go<MODE>(kw0), gw);
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int o = (gs + tig) * GP + nt * 8 + gid;
        bh[nt][0] = __float_as_uint(gh[o]);
        bh[nt][1] = __float_as_uint(gh[o + 4 * GP]);
        bl[nt][0] = __float_as_uint(gl[o]);
        bl[nt][1] = __float_as_uint(gl[o + 4 * GP]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // A (tap (kh, kw0 + KWS·u)): x at (XS·i + xo(kh), XS·j + xo(kw)),
        // m = input channel
        const int kw = kw0 + M::KWS * u;
        const int xs = dw_slot<XS>(XS * i + dw_xo<MODE>(kh) + 1,
                                   XS * j0 + dw_xo<MODE>(kw) + 1, hw);
        const int o = (xs + tig) * XP + gid;
        const uint32_t ah[4] = {
            __float_as_uint(xh[o]), __float_as_uint(xh[o + 8]),
            __float_as_uint(xh[o + 4 * XP]),
            __float_as_uint(xh[o + 4 * XP + 8])};
        const uint32_t al[4] = {
            __float_as_uint(xl[o]), __float_as_uint(xl[o + 8]),
            __float_as_uint(xl[o + 4 * XP]),
            __float_as_uint(xl[o + 4 * XP + 8])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32x3(sum[u][nt], ah, al, bh[nt], bl[nt]);
      }
    }
    fold_acc(acc, sum);
  }

  if constexpr (M::KSETS > 1) {
    // Set 0 adds the other sets' totals, in set order, through the shared
    // memory ([set − 1][u][nt][thread of the set] float4s).
    constexpr int SET = NTH / M::KSETS;  // threads a set
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the planes
    float4* red = reinterpret_cast<float4*>(smem_dw);
    const int me = threadIdx.x % SET;
    if (kset > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          red[(((kset - 1) * U + u) * kNT + nt) * SET + me] =
              make_float4(acc[u][nt][0], acc[u][nt][1], acc[u][nt][2],
                          acc[u][nt][3]);
    }
    __syncthreads();
    if (kset > 0) return;
    for (int k = 1; k < M::KSETS; ++k) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float4 v = red[(((k - 1) * U + u) * kNT + nt) * SET + me];
          acc[u][nt][0] = __fadd_rn(acc[u][nt][0], v.x);
          acc[u][nt][1] = __fadd_rn(acc[u][nt][1], v.y);
          acc[u][nt][2] = __fadd_rn(acc[u][nt][2], v.z);
          acc[u][nt][3] = __fadd_rn(acc[u][nt][3], v.w);
        }
    }
  }

  // The block's partial: D row = input channel, column = output channel.
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int tap = kh * KH + kw0 + M::KWS * u;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float* dst = part +
                   (((size_t)blockIdx.y * G::TAPS + tap) * c_in + ci0 + gid) *
                       c_out +
                   co0 + nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(dst) =
          make_float2(acc[u][nt][0], acc[u][nt][1]);
      *reinterpret_cast<float2*>(dst + 8 * c_out) =
          make_float2(acc[u][nt][2], acc[u][nt][3]);
    }
  }
}

template <int MODE>
cudaError_t launch_dw_tf32(const TilePlan& p, const float* x, const float* g,
                           float* part, int batch, int t_len, int f_len,
                           int c_in, int c_out, cudaStream_t s) {
  constexpr int NTH = DwTf32Map<MODE>::THREADS;
  static int raised = 48 * 1024;  // per instantiation; one card per process
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_dw_tf32_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return err;
    raised = p.smem;
  }
  // The plan keeps kDwTf32Blocks blocks an SM: the card must keep them
  // resident (registers and shared memory), or its grid would not be the
  // one planned. Checked at the largest shared memory asked for so far.
  static int checked = 0;
  if (p.smem > checked) {
    int resident = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, conv_dw_tf32_kernel<MODE>, NTH, p.smem);
    if (err != cudaSuccess) return err;
    if (resident < kDwTf32Blocks) return cudaErrorInvalidConfiguration;
    checked = p.smem;
  }
  if (p.split == 0) return cudaSuccess;
  const int per = (p.tiles + p.split - 1) / p.split;
  conv_dw_tf32_kernel<MODE><<<dim3(p.groups, p.split), NTH, p.smem, s>>>(
      x, g, part, batch, t_len, f_len, c_in, c_out, p.tile_t, p.tile_f, per);
  return cudaGetLastError();
}

template <int MODE>
int dw_launch(const void* x, const void* g, float* part, int batch, int t_len,
              int f_len, int c_in, int c_out, int bf16, cudaStream_t s) {
  const TilePlan p = dw_plan<MODE>(batch, t_len, f_len, c_in, c_out, bf16);
  if (p.variant == kVariantTf32)
    return static_cast<int>(launch_dw_tf32<MODE>(
        p, static_cast<const float*>(x), static_cast<const float*>(g), part,
        batch, t_len, f_len, c_in, c_out, s));
  if (p.split == 0) return static_cast<int>(cudaSuccess);
  const int per = (p.tiles + p.split - 1) / p.split;
  const dim3 grid(p.groups, p.split);
  if (p.variant == kVariantMma) {
    using T = __nv_bfloat16;
    conv_dw_mma_kernel<MODE><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, batch,
        t_len, f_len, c_in, c_out, per);
  } else if (bf16) {
    using T = __nv_bfloat16;
    conv_dw_kernel<T, MODE><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, batch,
        t_len, f_len, c_in, c_out, per);
  } else {
    conv_dw_kernel<float, MODE><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), part,
        batch, t_len, f_len, c_in, c_out, per);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ddim

extern "C" {

// Partial sums that ddim_conv_dw writes for these arguments (the first
// dimension of `part`). mode: 0 = 3×3, 1 = down, 2 = up; t_len, f_len are
// x's.
int ddim_conv_dw_splits(int mode, int batch, int t_len, int f_len, int c_in,
                        int c_out, int bf16) {
  using namespace ddim;
  if (mode == 0)
    return dw_plan<0>(batch, t_len, f_len, c_in, c_out, bf16).split;
  if (mode == 1)
    return dw_plan<1>(batch, t_len, f_len, c_in, c_out, bf16).split;
  return dw_plan<2>(batch, t_len, f_len, c_in, c_out, bf16).split;
}

// x: [B, T, F, C_in]; g: [B, T, F, C_out] (mode 0), [B, T/2, F/2, C_out]
// (mode 1) or [B, 2T, 2F, C_out] (mode 2), both fp32 or both bf16; part:
// [ddim_conv_dw_splits(...), KH, KW, C_in, C_out] fp32, every element
// written. Every pointer is 16-byte aligned (32-byte for `part`). Returns
// cudaGetLastError() after the launch.
int ddim_conv_dw(const void* x, const void* g, float* part, int mode,
                 int batch, int t_len, int f_len, int c_in, int c_out,
                 int bf16, void* stream) {
  using namespace ddim;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 0)
    return dw_launch<0>(x, g, part, batch, t_len, f_len, c_in, c_out, bf16, s);
  if (mode == 1)
    return dw_launch<1>(x, g, part, batch, t_len, f_len, c_in, c_out, bf16, s);
  return dw_launch<2>(x, g, part, batch, t_len, f_len, c_in, c_out, bf16, s);
}

}  // extern "C"
