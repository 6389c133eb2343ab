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
// Each has two variants, picked per call (down_use_mma / up_use_mma):
//
// - tensor cores (bf16 storage, channel counts multiples of 32 — 16 for the
//   down conv's input — and at least 16 (down) / 32 (up) output columns):
//   WMMA 16×16×16 bf16 products, fp32 accumulation, 128 output positions ×
//   32 output channels per block. The down conv's A operand for tap (dt, df)
//   is the staged input halo read with a leading dimension of two positions
//   (the stride-2 window), so no im2col copy is made. In the up conv each
//   warp owns one output row and one column parity, so its 16 positions
//   read 16 consecutive input columns and its 4 live taps are fixed. On an
//   H100 the MMAs are cheap; what bounds these variants is staging (16-byte
//   copies of the input halo and of all 16 taps' weights per channel chunk,
//   from L2) and the epilogue's stores.
// - CUDA cores (fp32, and bf16 where the above do not apply): the FMA
//   implicit GEMM of conv3x3.cu (down: 16·Cin MACs per output element, up:
//   4·Cin), bound by FMA issue and shared-memory reads. 64 output positions
//   × 32 output channels per block, input halo and weights staged per chunk
//   as fp32, 8 accumulators per thread; in the up kernel every warp owns
//   one (row, column) parity class so each staged weight is reused 8 times.
#include <mma.h>

#include "conv_common.cuh"

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
constexpr int kCkU = 32;                 // up: input channels per chunk
constexpr int kTtU = 4, kFtU = 32;       // up: 4 × 32 output positions
constexpr int kHwU = kFtU / 2 + 2;       // 18 input columns
constexpr int kHaloUM = (kTtU / 2 + 2) * kHwU;

__host__ __device__ __forceinline__ bool down_use_mma(int f_out, int c_in,
                                                      int c_out, int bf16) {
  return bf16 && f_out >= kFtD && c_in % kCkD == 0 && c_out % kCoTile == 0;
}

__host__ __device__ __forceinline__ bool up_use_mma(int f_out, int c_in,
                                                    int c_out, int bf16) {
  return bf16 && f_out >= kFtU && c_in % kCkU == 0 && c_out % kCoTile == 0;
}

__host__ __device__ __forceinline__ int down_tiles(int t_out, int f_out,
                                                   int c_in, int c_out,
                                                   int bf16) {
  if (!down_use_mma(f_out, c_in, c_out, bf16)) return num_tiles(t_out, f_out);
  return ((t_out + kTtD - 1) / kTtD) * ((f_out + kFtD - 1) / kFtD);
}

__host__ __device__ __forceinline__ int up_tiles(int t_out, int f_out,
                                                 int c_in, int c_out,
                                                 int bf16) {
  if (!up_use_mma(f_out, c_in, c_out, bf16)) return num_tiles(t_out, f_out);
  return ((t_out + kTtU - 1) / kTtU) * ((f_out + kFtU - 1) / kFtU);
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

__global__ void __launch_bounds__(kThreads) conv_up_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_in,
    int f_in, int c_in, int c_out) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  __shared__ __align__(32) T xs[kHaloUM * kCkU];
  __shared__ __align__(32) T ws[16 * kCkU * kCoTile];
  __shared__ float red[2 * kThreads];
  static_assert(sizeof(ws) >= kTtU * kFtU * kCoTile * sizeof(float),
                "accumulator tile must fit the weight buffer");

  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const int b = blockIdx.y;
  const int tiles_f = (f_out + kFtU - 1) / kFtU;
  const int t0 = (blockIdx.x / tiles_f) * kTtU;  // even
  const int f0 = (blockIdx.x % tiles_f) * kFtU;  // even
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  // warp → output row ry of the tile and column parity px; its 16
  // positions are columns 2q + px, q = 0..15
  const int ry = warp >> 1, px = warp & 1, py = ry & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int c0 = 0; c0 < c_in; c0 += kCkU) {
    // input halo rows t0/2 − 1 …, columns f0/2 − 1 …
    for (int idx = threadIdx.x; idx < kHaloUM * kCkU / 8; idx += kThreads) {
      const int q = idx % (kCkU / 8), hp = idx / (kCkU / 8);
      const int t = t0 / 2 - 1 + hp / kHwU, f = f0 / 2 - 1 + hp % kHwU;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      copy8(xs + hp * kCkU + 8 * q,
            x + xb + ((size_t)(inside ? t : 0) * f_in + (inside ? f : 0)) *
                         c_in + c0 + 8 * q,
            inside);
    }
    for (int idx = threadIdx.x; idx < 16 * kCkU * kCoTile / 8;
         idx += kThreads) {
      const int q = idx % (kCoTile / 8), r = idx / (kCoTile / 8);
      const int ci = r % kCkU, tap = r / kCkU;
      copy8(ws + r * kCoTile + 8 * q,
            w + ((size_t)tap * c_in + c0 + ci) * c_out + co0 + 8 * q, true);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // live taps ky = py + 2·(j/2), kx = px + 2·(j%2); position q reads
      // halo row (ry + py)/2 + j/2 and column q + px + j%2
      const int tap = (py + 2 * (j >> 1)) * 4 + px + 2 * (j & 1);
      const T* arow =
          xs + (((ry + py) / 2 + (j >> 1)) * kHwU + px + (j & 1)) * kCkU;
#pragma unroll
      for (int kk = 0; kk < kCkU; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, arow + kk, kCkU);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
          wmma::load_matrix_sync(
              bm, ws + (tap * kCkU + kk) * kCoTile + 16 * jj, kCoTile);
          wmma::mma_sync(acc[jj], a, bm, acc[jj]);
        }
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
  const int t = t0 + ry;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int f = f0 + 2 * i + px;
    if (t < t_out && f < f_out) {
      const size_t off = ob + ((size_t)t * f_out + f) * c_out + co;
      float o = accs[(warp * 16 + i) * kCoTile + lane] + bias[co];
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

}  // namespace ddim

extern "C" {

// Spatial tiles per sample of the variant that ddim_conv_down /
// ddim_conv_up pick for these arguments (the partials' second dimension).
int ddim_conv_down_tiles(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::down_tiles(t_in / 2, f_in / 2, c_in, c_out, bf16);
}

int ddim_conv_up_tiles(int t_in, int f_in, int c_in, int c_out, int bf16) {
  return ddim::up_tiles(2 * t_in, 2 * f_in, c_in, c_out, bf16);
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
  const dim3 grid(up_tiles(2 * t_in, 2 * f_in, c_in, c_out, bf16), batch,
                  (c_out + kCoTile - 1) / kCoTile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (up_use_mma(2 * f_in, c_in, c_out, bf16)) {
    using T = __nv_bfloat16;
    conv_up_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<const T*>(res), static_cast<T*>(out), stats, t_in, f_in,
        c_in, c_out);
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
