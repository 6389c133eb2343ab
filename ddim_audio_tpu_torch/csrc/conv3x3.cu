// Fused 3×3 SAME conv, C → C, over channels-last [B, T, F, C] activations.
//
// Replaces the TPU kernel ddim_audio_tpu/ops/pallas/conv_flat.py
// `_conv_kernel` (wrapper `conv3x3_flat`) on its float-tap path:
//
//   prologue  v = x (+ residual, rounded to the storage dtype)
//             v = v·scale[b, c] + shift[b, c]     (GroupNorm folded, optional)
//             v = silu(v)                          (optional)
//             v rounded to the compute dtype; positions outside [0,T)×[0,F)
//             are zero AFTER the prologue (pad-after-norm)
//   taps      out32 = Σ_{dt,df,ci} v[t+dt−1, f+df−1, ci] · w[dt, df, ci, co]
//   epilogue  out32 += add[b, co] (bias or per-sample temb, fp32)
//             out32 = silu(out32)                  (optional)
//             partial (sum, sum²) of out32 per channel (optional)
//             out = out32 rounded to the storage dtype
//
// Two variants, chosen per call by conv3x3_use_mma:
//
// - conv3x3_mma_kernel (bf16 storage, F >= 16, C % 32 == 0 — every bf16
//   conv of the audio.yml main path but the F = 8 bottleneck stage): the
//   taps run on the tensor cores as WMMA 16×16×16 bf16 products with fp32
//   accumulation. A block owns 8 time rows × 16 columns × 32 output
//   channels; warp w owns time row w, so for tap (dt, df) its A operand
//   (16 positions × 16 channels) is a plain row-major slice of the staged
//   halo (leading dimension = the chunk width) and no im2col copy is made.
//   On an H100 the MMAs are cheap next to the staging pass; what bounds it
//   is the prologue (load, residual add, GroupNorm affine, SiLU, rounding)
//   and the L2 traffic of re-staging each chunk's weights per block, so the
//   block is as tall as the static shared-memory budget allows.
// - conv3x3_kernel (fp32, and bf16 at narrow F): the MACs run on CUDA cores
//   in fp32, bound by FMA issue and shared-memory reads (one float4
//   broadcast read per 4 MACs of a position, one weight read per 4 MACs per
//   lane), not by HBM. 8 positions per thread reuse each staged weight 8
//   times; the input halo is staged once per channel chunk.
//
// Both fuse the prologue into the staging pass, so the activation makes one
// trip from HBM. wgmma/TMA pipelines are later work.
#include <mma.h>

#include "conv_common.cuh"

namespace ddim {

constexpr int kCk3 = 16;        // input channels per staged chunk
constexpr int kHalo3 = 6 * 18;  // max (TT+2)·(FT+2) over the two tile shapes

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ pre_scale,
                   const float* __restrict__ pre_shift,
                   const T* __restrict__ w, const float* __restrict__ add,
                   T* __restrict__ out, float* __restrict__ stats, int t_len,
                   int f_len, int c, int pre_silu, int post_silu) {
  __shared__ __align__(16) float xs[kHalo3 * kCk3];
  __shared__ __align__(16) float ws[9 * kCk3 * kCoTile];
  __shared__ float red[2 * kThreads];

  const int b = blockIdx.y;
  const int ft = tile_f(f_len), tt = tile_t(f_len);
  const int tiles_f = (f_len + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt;
  const int f0 = (blockIdx.x % tiles_f) * ft;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const int hw = ft + 2, hn = (tt + 2) * hw;
  const size_t xb = (size_t)b * t_len * f_len * c;

  float acc[kPosPerThread];
  int base[kPosPerThread];  // halo offset of each owned position's (0,0) tap
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    acc[i] = 0.f;
    base[i] = ((p / ft) * hw + p % ft) * kCk3;
  }

  for (int c0 = 0; c0 < c; c0 += kCk3) {
    // Stage the prologue-applied halo tile of this channel chunk.
    for (int idx = threadIdx.x; idx < hn * kCk3; idx += kThreads) {
      const int ci = idx % kCk3, hp = idx / kCk3;
      const int t = t0 + hp / hw - 1, f = f0 + hp % hw - 1, ch = c0 + ci;
      float v = 0.f;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
        const size_t off = xb + ((size_t)t * f_len + f) * c + ch;
        v = to_f(x[off]);
        if (res != nullptr) v = round_to<T>(v + to_f(res[off]));
        if (pre_scale != nullptr)
          v = v * pre_scale[b * c + ch] + pre_shift[b * c + ch];
        if (pre_silu) v = silu(v);
        v = round_to<T>(v);
      }
      xs[idx] = v;
    }
    // Stage the chunk's weights: ws[tap][ci][lane].
    for (int idx = threadIdx.x; idx < 9 * kCk3 * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCk3, tap = r / kCk3;
      const int oc = co0 + l;
      ws[idx] = oc < c ? to_f(w[((size_t)tap * c + c0 + ci) * c + oc]) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * hw + tap % 3) * kCk3;
#pragma unroll
      for (int ci = 0; ci < kCk3; ci += 4) {
        const float* wr = &ws[(tap * kCk3 + ci) * kCoTile + lane];
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
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    const int t = t0 + p / ft, f = f0 + p % ft;
    if (t < t_len && f < f_len && co < c) {
      float o = acc[i];
      if (add != nullptr) o += add[b * c + co];
      if (post_silu) o = silu(o);
      s1 += o;
      s2 += o * o;
      out[xb + ((size_t)t * f_len + f) * c + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

constexpr int kCkM = 32;                // input channels per staged chunk
constexpr int kTtM = 8, kFtM = 16;      // 128 positions per block
constexpr int kHwM = kFtM + 2;
constexpr int kHaloM = (kTtM + 2) * kHwM;

__host__ __device__ __forceinline__ bool conv3x3_use_mma(int f_len, int c,
                                                         int bf16) {
  return bf16 && f_len >= kFtM && c % kCkM == 0;
}

__host__ __device__ __forceinline__ int conv3x3_tiles(int t_len, int f_len,
                                                      int c, int bf16) {
  if (!conv3x3_use_mma(f_len, c, bf16)) return num_tiles(t_len, f_len);
  return ((t_len + kTtM - 1) / kTtM) * ((f_len + kFtM - 1) / kFtM);
}

__global__ void __launch_bounds__(kThreads) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ add,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_len,
    int f_len, int c, int pre_silu, int post_silu) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  __shared__ __align__(32) T xs[kHaloM * kCkM];
  // the chunk's weights [tap][ci][32 co]; after the last chunk the same
  // bytes hold the fp32 accumulator tile [128 positions][32 co]
  __shared__ __align__(32) T ws[9 * kCkM * kCoTile];
  __shared__ float red[2 * kThreads];
  static_assert(sizeof(ws) >= kTtM * kFtM * kCoTile * sizeof(float),
                "accumulator tile must fit the weight buffer");

  const int b = blockIdx.y;
  const int tiles_f = (f_len + kFtM - 1) / kFtM;
  const int t0 = (blockIdx.x / tiles_f) * kTtM;
  const int f0 = (blockIdx.x % tiles_f) * kFtM;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const size_t xb = (size_t)b * t_len * f_len * c;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int c0 = 0; c0 < c; c0 += kCkM) {
    // Stage the prologue-applied halo chunk, 8 channels (16 bytes) per item.
    for (int idx = threadIdx.x; idx < kHaloM * kCkM / 8; idx += kThreads) {
      const int q = idx % (kCkM / 8), hp = idx / (kCkM / 8);
      const int t = t0 + hp / kHwM - 1, f = f0 + hp % kHwM - 1;
      const int ch = c0 + 8 * q;
      Vec8 v;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
        const size_t off = xb + ((size_t)t * f_len + f) * c + ch;
        v = load8(x + off);
        if (res != nullptr) {
          const Vec8 r = load8(res + off);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = round_to<T>(v.v[k] + r.v[k]);
        }
        if (pre_scale != nullptr) {
          const Vec8 sc = load8(pre_scale + b * c + ch);
          const Vec8 sh = load8(pre_shift + b * c + ch);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = v.v[k] * sc.v[k] + sh.v[k];
        }
        if (pre_silu) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = silu(v.v[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = 0.f;
      }
      store8(xs + hp * kCkM + 8 * q, v);
    }
    // Stage the chunk's weights ws[tap][ci][32 co] as 16-byte copies
    // (C % 32 == 0 on this path, so the co tile is never ragged).
    for (int idx = threadIdx.x; idx < 9 * kCkM * kCoTile / 8;
         idx += kThreads) {
      const int q = idx % (kCoTile / 8), r = idx / (kCoTile / 8);
      const int ci = r % kCkM, tap = r / kCkM;
      *reinterpret_cast<uint4*>(ws + r * kCoTile + 8 * q) =
          *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * c + c0 + ci) * c + co0 + 8 * q);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* arow = xs + ((warp + tap / 3) * kHwM + tap % 3) * kCkM;
#pragma unroll
      for (int kk = 0; kk < kCkM; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, arow + kk, kCkM);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, ws + (tap * kCkM + kk) * kCoTile + 16 * j,
                                 kCoTile);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
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
  const int t = t0 + warp;
#pragma unroll 4
  for (int i = 0; i < kFtM; ++i) {
    const int f = f0 + i;
    if (t < t_len && f < f_len && co < c) {
      float o = accs[(warp * 16 + i) * kCoTile + lane];
      if (add != nullptr) o += add[b * c + co];
      if (post_silu) o = silu(o);
      s1 += o;
      s2 += o * o;
      out[xb + ((size_t)t * f_len + f) * c + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

}  // namespace ddim

extern "C" {

// Spatial tiles per sample of the variant that ddim_conv3x3 picks for these
// arguments (the partials' second dimension).
int ddim_conv3x3_tiles(int t_len, int f_len, int c, int bf16) {
  return ddim::conv3x3_tiles(t_len, f_len, c, bf16);
}

// x, res, out: [B, T, F, C] (fp32 or bf16, as `bf16` says); w: [3, 3, C, C]
// in the same dtype; pre_scale, pre_shift, add: [B, C] fp32; stats:
// [B, ddim_conv3x3_tiles(...), 2, C] fp32. res, pre_*, add and stats may be
// null; every pointer is 16-byte aligned. Returns cudaGetLastError() after
// the launch.
int ddim_conv3x3(const void* x, const void* res, const float* pre_scale,
                 const float* pre_shift, const void* w, const float* add,
                 void* out, float* stats, int batch, int t_len, int f_len,
                 int c, int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  const dim3 grid(conv3x3_tiles(t_len, f_len, c, bf16), batch,
                  (c + kCoTile - 1) / kCoTile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (conv3x3_use_mma(f_len, c, bf16)) {
    using T = __nv_bfloat16;
    conv3x3_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
        pre_shift, static_cast<const T*>(w), add, static_cast<T*>(out), stats,
        t_len, f_len, c, pre_silu, post_silu);
  } else if (bf16) {
    using T = __nv_bfloat16;
    conv3x3_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
        pre_shift, static_cast<const T*>(w), add, static_cast<T*>(out), stats,
        t_len, f_len, c, pre_silu, post_silu);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(res),
        pre_scale, pre_shift, static_cast<const float*>(w), add,
        static_cast<float*>(out), stats, t_len, f_len, c, pre_silu,
        post_silu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
