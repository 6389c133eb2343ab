// Strided stage transitions of the U-Net over channels-last activations:
//
// down  k4 s2 p1 conv, Cin → Cout, (T, F) → (T/2, F/2), + bias
//       out[to, fo] = bias + Σ_{dt,df ∈ 0..3} x[2·to+dt−1, 2·fo+df−1] · w[dt, df]
//       Replaces ddim_audio_tpu/ops/pallas/conv_strided.py `_down_kernel`
//       (wrapper `conv_down_flat`), float taps.
//
// up    transposed k4 s2 p1 conv (torch ConvTranspose2d semantics),
//       Cin → Cout, (T, F) → (2T, 2F), + bias, + fused skip residual.
//       w is the stored *equivalent forward* kernel (spatially flipped HWIO,
//       ddim_audio_tpu/models/layers.py): the output is the forward conv of
//       the 2×-dilated input with padding 2, so only the taps whose dilated
//       source is an even row/column contribute:
//       out[oy, ox] = bias + res[oy, ox]
//                   + Σ_{ky ≡ oy, kx ≡ ox (mod 2)} x[(oy+ky−2)/2, (ox+kx−2)/2] · w[ky, kx]
//       Replaces conv_strided.py `_up_kernel` (wrapper `conv_up_flat`), float
//       taps.
//
// Both can emit per-block partial (sum, sum²) of the fp32 output (for up: of
// the summed output up(h) + residual) before the store cast.
//
// down, two variants picked per call (down_use_mma):
// - tensor cores (bf16 storage, C_in % 16 == 0, C_out % 32 == 0, at least 16
//   output columns): WMMA 16×16×16 bf16 products, fp32 accumulation, 128
//   output positions × 32 output channels per block; the A operand for tap
//   (dt, df) is the staged input halo read with a leading dimension of two
//   positions (the stride-2 window), so no im2col copy is made. What bounds
//   it on an H100 is staging (synchronous 16-byte copies of the input halo
//   and of all 16 taps' weights per channel chunk, once per 32-channel
//   output slice) and the epilogue's 2-byte stores, not the MMAs.
// - CUDA cores (fp32, and bf16 where the above does not apply): FMA
//   implicit GEMM, 16·Cin MACs per output element, bound by FMA issue and
//   shared-memory reads. 64 output positions × 32 output channels per block,
//   input halo and weights staged per chunk as fp32, 8 accumulators per
//   thread.
//
// up, two variants picked per call (conv_up_plan, conv_plan.h;
// ddim_conv_up_variant reports it):
// - conv_up_mma_kernel (bf16, C_in % 32 == 0, C_out % 32 == 0: every bf16
//   transition of audio.yml, 256→192 at f_out = 16 included). On an H100 the
//   bf16 up conv is bound by bytes where C_in is narrow (4·C_in MACs per
//   output element against an output and a skip residual of C_out bf16
//   each: at 64→32, B = 1, 67 MB in, 134 MB residual, 134 MB out, 0.100 ms
//   at 3.35 TB/s) and by tensor-core operations from 192→128 on. The
//   kernel before this design re-staged the input halo and all 16 taps'
//   weights once per 32-channel output slice, synchronously, and spent its
//   epilogue on an fp32 tile round trip through shared memory and 2-byte
//   residual loads and stores; at f_out = 16 (256→192) it did not apply
//   and CUDA cores ran instead (13.6× cuDNN). This design stages 128 input
//   positions a block once (cp.async, zero-filled outside), for all four
//   output parity classes (the sub-pixel form below), streams the weights
//   (one (a, b) tap offset × 32 input channels × the four classes' taps ×
//   32 output channels a stage) through a 3-deep cp.async ring, runs the
//   taps as mma.sync.m16n8k16 bf16 → fp32 with ldmatrix (.trans for the
//   HWIO weights, so no repack; a warp owns one class × 64 input positions
//   × 32 channels: 128 registers, 32 bytes of spill, 2 blocks an SM), and
//   keeps the epilogue in registers: each lane holds 8 consecutive channels
//   of an output position after a quad transpose, so bias, residual,
//   statistics and store move 16 bytes a lane. 128 positions a block
//   rather than 64 halve the L2 traffic of the weights, which every block
//   re-reads (64 KB a block at 64→32). Output-channel groups (32 each) are
//   shared out over grid.z only where the spatial grid is under two blocks
//   per SM (192→128 and 256→192). Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py, B = 1): 0.343 / 0.233 / 0.124 ms from 64→32 to 128→96,
//   29 / 21 / 14% of the byte bound (cuDNN's bare transposed conv: 0.210 /
//   0.117 / 0.112), 0.060 / 0.071 ms at 192→128 / 256→192, 11 / 5% of the
//   tensor-core bound.
// - conv_up_kernel (fp32, and bf16 with channels no multiple of 32): the FMA
//   implicit GEMM, 4·Cin MACs per output element; every warp owns one
//   (row, column) parity class so each staged weight is reused 8 times.
#include <mma.h>

#include "conv_mma.cuh"

namespace ddim {

constexpr int kCkS = 8;             // input channels per staged chunk
constexpr int kHaloDown = 10 * 34;  // max (2TT+2)·(2FT+2) over the tile shapes
constexpr int kHaloUp = 6 * 10;     // max (TT/2+2)·(FT/2+2)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_down_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ stats, int t_in, int f_in, int c_in,
                     int c_out) {
  __shared__ __align__(16) float xs[kHaloDown * kCkS];
  __shared__ __align__(16) float ws[16 * kCkS * kCoTile];
  __shared__ float red[2 * kThreads];

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int b = blockIdx.y;
  const int ft = tile_f(f_out), tt = tile_t(f_out);
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt;
  const int f0 = (blockIdx.x % tiles_f) * ft;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const int hw = 2 * ft + 2, hn = (2 * tt + 2) * hw;
  const size_t xb = (size_t)b * t_in * f_in * c_in;

  float acc[kPosPerThread];
  int base[kPosPerThread];
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    acc[i] = 0.f;
    base[i] = (2 * (p / ft) * hw + 2 * (p % ft)) * kCkS;
  }

  for (int c0 = 0; c0 < c_in; c0 += kCkS) {
    for (int idx = threadIdx.x; idx < hn * kCkS; idx += kThreads) {
      const int ci = idx % kCkS, hp = idx / kCkS;
      const int t = 2 * t0 - 1 + hp / hw, f = 2 * f0 - 1 + hp % hw;
      float v = 0.f;
      if (t >= 0 && t < t_in && f >= 0 && f < f_in)
        v = to_f(x[xb + ((size_t)t * f_in + f) * c_in + c0 + ci]);
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < 16 * kCkS * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCkS, tap = r / kCkS;
      const int oc = co0 + l;
      ws[idx] = oc < c_out
                    ? to_f(w[((size_t)tap * c_in + c0 + ci) * c_out + oc])
                    : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 16; ++tap) {
      const int toff = ((tap / 4) * hw + tap % 4) * kCkS;
#pragma unroll
      for (int ci = 0; ci < kCkS; ci += 4) {
        const float* wr = &ws[(tap * kCkS + ci) * kCoTile + lane];
        const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                    w3 = wr[3 * kCoTile];
#pragma unroll
        for (int i = 0; i < kPosPerThread; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[base[i] + toff + ci]);
          acc[i] = fma4(acc[i], v, w0, w1, w2, w3);
        }
      }
    }
    __syncthreads();
  }

  float s1 = 0.f, s2 = 0.f;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    const int t = t0 + p / ft, f = f0 + p % ft;
    if (t < t_out && f < f_out && co < c_out) {
      const float o = acc[i] + bias[co];
      s1 += o;
      s2 += o * o;
      out[ob + ((size_t)t * f_out + f) * c_out + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
    block_stats(s1, s2, red, dst, co, c_out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_up_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, float* __restrict__ stats, int t_in,
                   int f_in, int c_in, int c_out) {
  __shared__ __align__(16) float xs[kHaloUp * kCkS];
  __shared__ __align__(16) float ws[16 * kCkS * kCoTile];
  __shared__ float red[2 * kThreads];

  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const int b = blockIdx.y;
  const int ft = tile_f(f_out), tt = tile_t(f_out);  // both even
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt;
  const int f0 = (blockIdx.x % tiles_f) * ft;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  // input halo rows t0/2 − 1 … t0/2 + tt/2, columns likewise
  const int hw = ft / 2 + 2, hn = (tt / 2 + 2) * hw;
  const size_t xb = (size_t)b * t_in * f_in * c_in;

  // Warp w owns 8 positions of parity class cls = w / 2 (row parity
  // cls / 2, column parity cls % 2); a class holds (tt/2)·(ft/2) = 16.
  const int cls = warp >> 1, py = cls >> 1, px = cls & 1;
  const int half_f = ft / 2;
  float acc[kPosPerThread];
  int base[kPosPerThread];
  int pos[kPosPerThread];  // position index in the tile (row-major tt × ft)
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int q = (warp & 1) * kPosPerThread + i;
    const int ry = 2 * (q / half_f) + py, rx = 2 * (q % half_f) + px;
    acc[i] = 0.f;
    pos[i] = ry * ft + rx;
    // local halo row of tap ky is (ry + ky) / 2 with ky ≡ ry (mod 2)
    base[i] = (((ry + py) / 2) * hw + (rx + px) / 2) * kCkS;
  }

  for (int c0 = 0; c0 < c_in; c0 += kCkS) {
    for (int idx = threadIdx.x; idx < hn * kCkS; idx += kThreads) {
      const int ci = idx % kCkS, hp = idx / kCkS;
      const int t = t0 / 2 - 1 + hp / hw, f = f0 / 2 - 1 + hp % hw;
      float v = 0.f;
      if (t >= 0 && t < t_in && f >= 0 && f < f_in)
        v = to_f(x[xb + ((size_t)t * f_in + f) * c_in + c0 + ci]);
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < 16 * kCkS * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCkS, tap = r / kCkS;
      const int oc = co0 + l;
      ws[idx] = oc < c_out
                    ? to_f(w[((size_t)tap * c_in + c0 + ci) * c_out + oc])
                    : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // live taps of this parity class: ky = py + 2·(j/2), kx = px + 2·(j%2);
      // relative to the (ky, kx) = (py, px) tap the halo moves by (j/2, j%2)
      const int ky = py + 2 * (j >> 1), kx = px + 2 * (j & 1);
      const int tap = ky * 4 + kx;
      const int toff = ((j >> 1) * hw + (j & 1)) * kCkS;
#pragma unroll
      for (int ci = 0; ci < kCkS; ci += 4) {
        const float* wr = &ws[(tap * kCkS + ci) * kCoTile + lane];
        const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                    w3 = wr[3 * kCoTile];
#pragma unroll
        for (int i = 0; i < kPosPerThread; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[base[i] + toff + ci]);
          acc[i] = fma4(acc[i], v, w0, w1, w2, w3);
        }
      }
    }
    __syncthreads();
  }

  float s1 = 0.f, s2 = 0.f;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int t = t0 + pos[i] / ft, f = f0 + pos[i] % ft;
    if (t < t_out && f < f_out && co < c_out) {
      const size_t off = ob + ((size_t)t * f_out + f) * c_out + co;
      float o = acc[i] + bias[co];
      if (res != nullptr) o += to_f(res[off]);
      s1 += o;
      s2 += o * o;
      out[off] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
    block_stats(s1, s2, red, dst, co, c_out);
  }
}

// ------------------------------------------------- tensor-core variants --

constexpr int kCkD = 16;                 // down: input channels per chunk
constexpr int kTtD = 8, kFtD = 16;       // down: 8 × 16 output positions
constexpr int kHwD = 2 * kFtD + 2;       // 34 input columns
constexpr int kHaloDM = (2 * kTtD + 2) * kHwD;

__host__ __device__ __forceinline__ bool down_use_mma(int f_out, int c_in,
                                                      int c_out, int bf16) {
  return bf16 && f_out >= kFtD && c_in % kCkD == 0 && c_out % kCoTile == 0;
}

__host__ __device__ __forceinline__ int down_tiles(int t_out, int f_out,
                                                   int c_in, int c_out,
                                                   int bf16) {
  if (!down_use_mma(f_out, c_in, c_out, bf16)) return num_tiles(t_out, f_out);
  return ((t_out + kTtD - 1) / kTtD) * ((f_out + kFtD - 1) / kFtD);
}

// 16-byte copy of 8 bf16 channels, or zeros outside the input.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool inside) {
  *reinterpret_cast<uint4*>(dst) =
      inside ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads) conv_down_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ stats, int t_in, int f_in, int c_in, int c_out) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  __shared__ __align__(32) T xs[kHaloDM * kCkD];
  // all 16 taps' weights of the chunk [tap][ci][32 co]; after the last chunk
  // the same bytes hold the fp32 accumulator tile [128][32]
  __shared__ __align__(32) T ws[16 * kCkD * kCoTile];
  __shared__ float red[2 * kThreads];
  static_assert(sizeof(ws) >= kTtD * kFtD * kCoTile * sizeof(float),
                "accumulator tile must fit the weight buffer");

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int b = blockIdx.y;
  const int tiles_f = (f_out + kFtD - 1) / kFtD;
  const int t0 = (blockIdx.x / tiles_f) * kTtD;
  const int f0 = (blockIdx.x % tiles_f) * kFtD;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const size_t xb = (size_t)b * t_in * f_in * c_in;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int c0 = 0; c0 < c_in; c0 += kCkD) {
    for (int idx = threadIdx.x; idx < kHaloDM * kCkD / 8; idx += kThreads) {
      const int q = idx % (kCkD / 8), hp = idx / (kCkD / 8);
      const int t = 2 * t0 - 1 + hp / kHwD, f = 2 * f0 - 1 + hp % kHwD;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      copy8(xs + hp * kCkD + 8 * q,
            x + xb + ((size_t)(inside ? t : 0) * f_in + (inside ? f : 0)) *
                         c_in + c0 + 8 * q,
            inside);
    }
    for (int idx = threadIdx.x; idx < 16 * kCkD * kCoTile / 8;
         idx += kThreads) {
      const int q = idx % (kCoTile / 8), r = idx / (kCoTile / 8);
      const int ci = r % kCkD, tap = r / kCkD;
      copy8(ws + r * kCoTile + 8 * q,
            w + ((size_t)tap * c_in + c0 + ci) * c_out + co0 + 8 * q, true);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      // output column m reads input column 2m + df: leading dimension 2·Ck
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(
          a, xs + ((2 * warp + tap / 4) * kHwD + tap % 4) * kCkD, 2 * kCkD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, ws + tap * kCkD * kCoTile + 16 * j,
                               kCoTile);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
    __syncthreads();
  }

  float* accs = reinterpret_cast<float*>(ws);
  wmma::store_matrix_sync(accs + warp * 16 * kCoTile, acc[0], kCoTile,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(accs + warp * 16 * kCoTile + 16, acc[1], kCoTile,
                          wmma::mem_row_major);
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  const int t = t0 + warp;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll 4
  for (int i = 0; i < kFtD; ++i) {
    const int f = f0 + i;
    if (t < t_out && f < f_out) {
      const float o = accs[(warp * 16 + i) * kCoTile + lane] + bias[co];
      s1 += o;
      s2 += o * o;
      out[ob + ((size_t)t * f_out + f) * c_out + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
    block_stats(s1, s2, red, dst, co, c_out);
  }
}

// Sub-pixel form of the up conv: output (2i + py, 2j + px) is a 2×2 conv of
// the input around (i, j), one per parity class (py, px):
//   out = Σ_{a, b ∈ {0, 1}} x[i + py − 1 + a, j + px − 1 + b] · w[py + 2a, px + 2b]
// A block stages its 128 input positions plus a 1-position halo once (by
// cp.async, zero-filled outside the input) and computes all four classes
// from it: M = input positions, N = output channels, K = 4 taps × C_in per
// class. Warp w owns class w % 4 for input positions 64·(w / 4) … +63; a
// weight stage holds, for one (a, b) and 32 input channels, the four
// classes' taps × 32 output channels.
__global__ void __launch_bounds__(kThreads, 2) conv_up_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_in,
    int f_in, int c_in, int c_out, int split) {
  using T = __nv_bfloat16;
  constexpr int MT = 4;                     // m16 tiles per warp
  constexpr int kNB = 32;                   // output channels per group
  constexpr int kWP = kNB + 8;              // stage pitch (elements)
  constexpr int kClass = kMmaK * kWP;       // one class's taps in a stage
  constexpr int kStage = 4 * kClass;
  extern __shared__ __align__(16) unsigned char smem[];

  const int fi = f_in >= 16 ? 16 : 8, ti = 32 * MT / fi;  // 128 positions
  const int hw = fi + 2, hn = (ti + 2) * hw, pitch = c_in + 8;
  T* halo = reinterpret_cast<T*>(smem);  // [hn][pitch]
  T* ring = halo + hn * pitch;           // [stages][4 classes][32 ci][kWP]
  float* red = reinterpret_cast<float*>(ring + kUpStages * kStage);

  const int b = blockIdx.y, z = blockIdx.z;
  const int tiles_f = (f_in + fi - 1) / fi;
  const int i0 = (blockIdx.x / tiles_f) * ti, j0 = (blockIdx.x % tiles_f) * fi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cls = warp & 3, py = cls >> 1, px = cls & 1, half = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
  const int kc_n = c_in / kMmaK, group_steps = 4 * kc_n;
  const int nsteps = (c_out / kNB - z + split - 1) / split * group_steps;

  // step s: group z + (s / group_steps)·split, tap offset (a, b), chunk kc
  auto load_stage = [&](int s) {
    const int rem = s % group_steps, ab = rem / kc_n, kc = rem % kc_n;
    const int g = z + (s / group_steps) * split;
    T* dst = ring + (s % kUpStages) * kStage;
    for (int i = threadIdx.x; i < 4 * kMmaK * kNB / 8; i += kThreads) {
      const int q = i % (kNB / 8), r = (i / (kNB / 8)) % kMmaK;
      const int k = i / (kMmaK * kNB / 8);  // class of the tap
      const int tap = ((k >> 1) + 2 * (ab >> 1)) * 4 + (k & 1) + 2 * (ab & 1);
      cp_async16(dst + k * kClass + r * kWP + 8 * q,
                 w + ((size_t)tap * c_in + kc * kMmaK + r) * c_out + g * kNB +
                     8 * q);
    }
  };
  // the halo joins the first stage's copy group
  for (int i = threadIdx.x; i < hn * (c_in / 8); i += kThreads) {
    const int hp = i / (c_in / 8), q = i % (c_in / 8);
    const int t = i0 - 1 + hp / hw, f = j0 - 1 + hp % hw;
    const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
    const T* src =
        inside ? x + xb + ((size_t)t * f_in + f) * c_in + 8 * q : x;
    cp_async16_zfill(halo + hp * pitch + 8 * q, src, inside);
  }
#pragma unroll
  for (int s = 0; s < kUpStages - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row in the halo, tap offset (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = half * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(halo + ((p / fi + py) * hw + p % fi + px) * pitch +
                          (lane >> 4) * 8);
  }
  const uint32_t b_base =
      smem_u32(ring) + (cls * kClass) * 2 + b_lane_offset(lane, kWP);
  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kUpStages - 2>();
    __syncthreads();  // stage s (and the halo) visible; slot s − 1 free
    const int rem = s % group_steps, ab = rem / kc_n, kc = rem % kc_n;
    if (s + kUpStages - 1 < nsteps) load_stage(s + kUpStages - 1);
    cp_async_commit();
    const uint32_t a_off =
        (((ab >> 1) * hw + (ab & 1)) * pitch + kc * kMmaK) * 2;
    const uint32_t b_stage = b_base + (s % kUpStages) * kStage * 2;
#pragma unroll
    for (int kk = 0; kk < kMmaK / 16; ++kk) {
      uint32_t aa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) aa[mt] = a_base[mt] + a_off + kk * 32;
      warp_mma_k16(acc, aa, b_stage + kk * 16 * kWP * 2, 32);
    }
    if (rem != group_steps - 1) continue;

    // Epilogue of group g from the registers: bias, the skip residual read
    // as 16-byte vectors, statistics of the sum, 16-byte bf16 stores.
    const int g = z + (s / group_steps) * split;
    const int co = g * kNB + 8 * tig;
    float bv[8], s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bv[k] = __ldg(bias + co + k);
      s1[k] = s2[k] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(acc[mt], r, tig);
        const int p = half * 16 * MT + mt * 16 + gid + 8 * r;
        const int i = i0 + p / fi, j = j0 + p % fi;
        if (i < t_in && j < f_in) {
          const size_t off =
              ob + ((size_t)(2 * i + py) * f_out + 2 * j + px) * c_out + co;
          const Vec8 rv =
              res != nullptr ? unpack8(ldg16(res + off)) : Vec8{};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float v = o.v[k] + bv[k];
            if (res != nullptr) v += rv.v[k];
            s1[k] += v;
            s2[k] += v * v;
            o.v[k] = v;
          }
          store8(out + off, o);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[mt][nt][2 * r + k] = 0.f;
      }
    if (stats != nullptr) {
      sum_over_gid(s1);
      sum_over_gid(s2);
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[(warp * 2) * kNB + 8 * tig + k] = s1[k];
          red[(warp * 2 + 1) * kNB + 8 * tig + k] = s2[k];
        }
      }
      finish_group_stats(
          red, kWarps, kNB,
          stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out + g * kNB,
          c_out);
    }
  }
}

}  // namespace ddim

extern "C" {

// Spatial tiles per sample of the variant that ddim_conv_down picks for
// these arguments (the partials' second dimension; ddim_conv_up's:
// conv_plan.cu).
int ddim_conv_down_tiles(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::down_tiles(t_in / 2, f_in / 2, c_in, c_out, bf16);
}


// x: [B, T, F, Cin]; w: [4, 4, Cin, Cout]; bias: [Cout] fp32; out:
// [B, T/2, F/2, Cout]; stats: [B, ddim_conv_down_tiles(...), 2, Cout] fp32 or
// null. Every pointer 16-byte aligned.
int ddim_conv_down(const void* x, const void* w, const float* bias, void* out,
                   float* stats, int batch, int t_in, int f_in, int c_in,
                   int c_out, int bf16, void* stream) {
  using namespace ddim;
  const dim3 grid(down_tiles(t_in / 2, f_in / 2, c_in, c_out, bf16), batch,
                  (c_out + kCoTile - 1) / kCoTile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (down_use_mma(f_in / 2, c_in, c_out, bf16)) {
    using T = __nv_bfloat16;
    conv_down_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<T*>(out), stats, t_in, f_in, c_in, c_out);
  } else if (bf16) {
    using T = __nv_bfloat16;
    conv_down_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<T*>(out), stats, t_in, f_in, c_in, c_out);
  } else {
    conv_down_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(out), stats, t_in, f_in, c_in, c_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [B, T, F, Cin]; w: [4, 4, Cin, Cout] (equivalent forward kernel); bias:
// [Cout] fp32; res (or null), out: [B, 2T, 2F, Cout]; stats:
// [B, ddim_conv_up_tiles(...), 2, Cout] fp32 or null. Every pointer 16-byte
// aligned.
int ddim_conv_up(const void* x, const void* w, const float* bias,
                 const void* res, void* out, float* stats, int batch, int t_in,
                 int f_in, int c_in, int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_up_plan(t_in, f_in, c_in, c_out, bf16, batch);
  const dim3 grid(p.tiles, batch, p.split);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma) {
    using T = __nv_bfloat16;
    static bool raised = false;  // one card per process
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_up_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised = true;
    }
    conv_up_mma_kernel<<<grid, kThreads, p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<const T*>(res), static_cast<T*>(out), stats, t_in, f_in,
        c_in, c_out, p.split);
  } else if (bf16) {
    using T = __nv_bfloat16;
    conv_up_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<const T*>(res), static_cast<T*>(out), stats, t_in, f_in,
        c_in, c_out);
  } else {
    conv_up_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<const float*>(res), static_cast<float*>(out), stats, t_in,
        f_in, c_in, c_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
