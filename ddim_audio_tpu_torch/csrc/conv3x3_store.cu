// Fused 3×3 SAME conv, C → C, with int8 activation storage, over
// channels-last [B, T, F, C] activations. Replaces the int8-storage modes of
// the TPU kernel ddim_audio_tpu/ops/pallas/conv_flat.py `_conv_kernel`
// (`in_q`, `res_q`, `quant_out`; wrapper `conv3x3_flat(in_scales=,
// res_scales=, quant_out=)`), float taps:
//
//   prologue  v = deq(x) (+ deq(residual))   deq(q) = q · scale of the storage
//             group that owns the position (halo positions included); a
//             float operand is read as it is; the sum is fp32 when either
//             operand is int8, else rounded to the compute dtype
//             v = v·scale[b, c] + shift[b, c]; v = silu(v)   (optional)
//             v rounded to the compute dtype T (the staging dtype); zero
//             outside [0,T)×[0,F) after the prologue
//   taps      out32 = Σ_{dt,df,ci} v[t+dt−1, f+df−1, ci] · w[dt, df, ci, co]
//   epilogue  + add[b, co], silu (optional), partial (sum, sum²) of out32,
//             then either out = out32 rounded to T, or (quant_out) per
//             storage group amax = max(max|out32|, 1e-30),
//             q = clip(rint(out32 · (127 / amax)), −127, 127) and the scale
//             amax · (1/127)
//
// The storage group (conv_common.cuh: kTtS × kFtS positions × one channel) is
// a block's output tile, so the amax of every group a block writes is a
// reduction inside the block and no second pass is needed. The consumers
// (this kernel's prologue, residual_affine.cu) dequantise with the same
// groups; ddim_store_geometry reports them to the plain twin.
//
// Design. One block: 8 time rows × 16 columns × 32 output channels, 8 warps,
// warp w owns time row w and lane l output channel co0 + l in the epilogue.
// bf16 (the production dtype): WMMA 16×16×16 taps with fp32 accumulation, the
// A operand a row-major slice of the staged halo, as conv3x3.cu's tensor-core
// variant; fp32: FMA taps on CUDA cores, 16 accumulators per thread. The
// int8 operands halve (against bf16) the bytes read and written per
// position, which is what bounds the float kernel's staging pass on an
// H100; the epilogue's amax costs one shared-memory reduction per block.
// What bounds this kernel is still that staging pass (dequantise, affine,
// SiLU, round) and the per-block weight restaging, not the MMAs.
#include <mma.h>

#include <type_traits>

#include "conv_common.cuh"

namespace ddim {

constexpr int kHwS = kFtS + 2;
constexpr int kHaloS = (kTtS + 2) * kHwS;

// Input channels per staged chunk: two WMMA k-steps in bf16, 16 in fp32.
template <typename T>
__host__ __device__ constexpr int store_chunk() {
  return std::is_same<T, float>::value ? 16 : 32;
}

// Eight stored values as fp32: int8 dequantised with its group's scales, or
// a float operand of type T.
template <typename T>
__device__ __forceinline__ Vec8 load_stored(const void* p, const float* scales,
                                            int q, int b, int t, int f, int ch,
                                            int t_len, int f_len, int c) {
  const size_t off = (((size_t)b * t_len + t) * f_len + f) * c + ch;
  if (!q) return load8(static_cast<const T*>(p) + off);
  Vec8 v = load8(static_cast<const int8_t*>(p) + off);
  const Vec8 s = load8(scales + group_offset(b, t, f, ch, t_len, f_len, c));
#pragma unroll
  for (int k = 0; k < 8; ++k) v.v[k] = __fmul_rn(v.v[k], s.v[k]);
  return v;
}

template <typename T>
__device__ __forceinline__ void stage_store_chunk(
    T* xs, const void* x, const float* x_scales, const void* res,
    const float* res_scales, const float* pre_scale, const float* pre_shift,
    int b, int t0, int f0, int c0, int t_len, int f_len, int c, int x_q,
    int res_q, int pre_silu) {
  constexpr int kCk = store_chunk<T>();
  for (int idx = threadIdx.x; idx < kHaloS * kCk / 8; idx += kThreads) {
    const int q = idx % (kCk / 8), hp = idx / (kCk / 8);
    const int t = t0 + hp / kHwS - 1, f = f0 + hp % kHwS - 1;
    const int ch = c0 + 8 * q;
    Vec8 v;
    if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
      v = load_stored<T>(x, x_scales, x_q, b, t, f, ch, t_len, f_len, c);
      if (res != nullptr) {
        const Vec8 r =
            load_stored<T>(res, res_scales, res_q, b, t, f, ch, t_len, f_len, c);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v.v[k] = (x_q || res_q) ? __fadd_rn(v.v[k], r.v[k])
                                  : round_to<T>(v.v[k] + r.v[k]);
      }
      if (pre_scale != nullptr) {
        const Vec8 sc = load8(pre_scale + b * c + ch);
        const Vec8 sh = load8(pre_shift + b * c + ch);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v.v[k] = __fadd_rn(__fmul_rn(v.v[k], sc.v[k]), sh.v[k]);
      }
      if (pre_silu) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = silu(v.v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v.v[k] = 0.f;
    }
    store8(xs + hp * kCk + 8 * q, v);  // rounds to T
  }
}

// The chunk's weights ws[tap][ci][32 co], 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_store_weights(T* ws, const T* w, int c0,
                                                    int co0, int c) {
  constexpr int kCk = store_chunk<T>();
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  for (int idx = threadIdx.x; idx < 9 * kCk * kCoTile / kPer;
       idx += kThreads) {
    const int q = idx % (kCoTile / kPer), r = idx / (kCoTile / kPer);
    const int ci = r % kCk, tap = r / kCk;
    *reinterpret_cast<uint4*>(ws + r * kCoTile + kPer * q) =
        *reinterpret_cast<const uint4*>(
            w + ((size_t)tap * c + c0 + ci) * c + co0 + kPer * q);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3x3_store_kernel(
    const void* __restrict__ x, const float* __restrict__ x_scales,
    const void* __restrict__ res, const float* __restrict__ res_scales,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const T* __restrict__ w, const float* __restrict__ add,
    void* __restrict__ out, float* __restrict__ out_scales,
    float* __restrict__ stats, int t_len, int f_len, int c, int x_q, int res_q,
    int pre_silu, int post_silu) {
  constexpr int kCk = store_chunk<T>();
  __shared__ __align__(32) T xs[kHaloS * kCk];
  // the chunk's weights; after the last chunk (bf16) the fp32 accumulator
  // tile [128 positions][32 co]
  __shared__ __align__(32) T ws[9 * kCk * kCoTile];
  __shared__ float red[2 * kThreads];
  static_assert(sizeof(ws) >= kTtS * kFtS * kCoTile * sizeof(float),
                "accumulator tile must fit the weight buffer");

  const int b = blockIdx.y;
  const int tiles_f = (f_len + kFtS - 1) / kFtS;
  const int t0 = (blockIdx.x / tiles_f) * kTtS;
  const int f0 = (blockIdx.x % tiles_f) * kFtS;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;

  float o[kFtS];  // this thread's outputs: time row warp, columns i, channel co
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < kFtS; ++i) o[i] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kCk) {
      stage_store_chunk<T>(xs, x, x_scales, res, res_scales, pre_scale,
                           pre_shift, b, t0, f0, c0, t_len, f_len, c, x_q,
                           res_q, pre_silu);
      stage_store_weights<T>(ws, w, c0, co0, c);
      __syncthreads();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const float* xrow = xs + ((warp + tap / 3) * kHwS + tap % 3) * kCk;
#pragma unroll
        for (int ci = 0; ci < kCk; ci += 4) {
          const float* wr = &ws[(tap * kCk + ci) * kCoTile + lane];
          const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                      w3 = wr[3 * kCoTile];
#pragma unroll
          for (int i = 0; i < kFtS; ++i) {
            const float4 v =
                *reinterpret_cast<const float4*>(xrow + i * kCk + ci);
            o[i] = fma4(o[i], v, w0, w1, w2, w3);
          }
        }
      }
      __syncthreads();
    }
  } else {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int c0 = 0; c0 < c; c0 += kCk) {
      stage_store_chunk<T>(xs, x, x_scales, res, res_scales, pre_scale,
                           pre_shift, b, t0, f0, c0, t_len, f_len, c, x_q,
                           res_q, pre_silu);
      stage_store_weights<T>(ws, w, c0, co0, c);
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const T* arow = xs + ((warp + tap / 3) * kHwS + tap % 3) * kCk;
#pragma unroll
        for (int kk = 0; kk < kCk; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::load_matrix_sync(a, arow + kk, kCk);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
            wmma::load_matrix_sync(
                bm, ws + (tap * kCk + kk) * kCoTile + 16 * j, kCoTile);
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
#pragma unroll
    for (int i = 0; i < kFtS; ++i)
      o[i] = accs[(warp * 16 + i) * kCoTile + lane];
  }

  // Epilogue: add, SiLU, statistics and the group amax on the fp32 output.
  const int t = t0 + warp;
  const float av = add != nullptr ? add[b * c + co] : 0.f;
  float s1 = 0.f, s2 = 0.f, am = 0.f;
#pragma unroll
  for (int i = 0; i < kFtS; ++i) {
    float v = add != nullptr ? __fadd_rn(o[i], av) : o[i];
    if (post_silu) v = silu(v);
    o[i] = v;
    if (t < t_len && f0 + i < f_len) {
      s1 += v;
      s2 += v * v;
      am = fmaxf(am, fabsf(v));
    }
  }
  const size_t row = ((size_t)b * t_len + t) * f_len;
  if (out_scales != nullptr) {
    red[warp * 32 + lane] = am;
    __syncthreads();
    float amax = red[lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) amax = fmaxf(amax, red[k * 32 + lane]);
    amax = fmaxf(amax, 1e-30f);
    const float inv = 127.0f / amax;
    int8_t* q = static_cast<int8_t*>(out);
#pragma unroll
    for (int i = 0; i < kFtS; ++i)
      if (t < t_len && f0 + i < f_len)
        q[(row + f0 + i) * c + co] = (int8_t)quant1(o[i], inv);
    if (warp == 0)
      out_scales[group_offset(b, t0, f0, co, t_len, f_len, c)] =
          amax * (1.0f / 127.0f);
    __syncthreads();  // red is reused below
  } else {
    T* y = static_cast<T*>(out);
#pragma unroll
    for (int i = 0; i < kFtS; ++i)
      if (t < t_len && f0 + i < f_len) y[(row + f0 + i) * c + co] = from_f<T>(o[i]);
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

}  // namespace ddim

extern "C" {

// The storage group: i = 0 → time rows, i = 1 → frequency columns.
int ddim_store_geometry(int i) {
  const int g[2] = {ddim::kTtS, ddim::kFtS};
  return i >= 0 && i < 2 ? g[i] : -1;
}

// Spatial tiles per sample (the partials' second dimension) of
// ddim_conv3x3_store and ddim_residual_affine.
int ddim_conv3x3_store_tiles(int t_len, int f_len) {
  return ddim::store_tiles(t_len, f_len);
}

// x, res: [B, T, F, C] int8 (x_q / res_q, with scales [B, ceil(T/8),
// ceil(F/16), C] fp32) or the compute dtype; w: [3, 3, C, C] in the compute
// dtype (bf16 or fp32, as `bf16` says); pre_scale, pre_shift, add: [B, C]
// fp32; out: [B, T, F, C] int8 when out_scales is given (quant_out), else the
// compute dtype; stats: [B, ddim_conv3x3_store_tiles(...), 2, C] fp32. res,
// its scales, pre_*, add, out_scales and stats may be null; every pointer is
// 16-byte aligned; C % 32 == 0.
int ddim_conv3x3_store(const void* x, const float* x_scales, const void* res,
                       const float* res_scales, const float* pre_scale,
                       const float* pre_shift, const void* w, const float* add,
                       void* out, float* out_scales, float* stats, int batch,
                       int t_len, int f_len, int c, int x_q, int res_q,
                       int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  if (c % kCoTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(store_tiles(t_len, f_len), batch, c / kCoTile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    conv3x3_store_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        x, x_scales, res, res_scales, pre_scale, pre_shift,
        static_cast<const __nv_bfloat16*>(w), add, out, out_scales, stats,
        t_len, f_len, c, x_q, res_q, pre_silu, post_silu);
  } else {
    conv3x3_store_kernel<float><<<grid, kThreads, 0, s>>>(
        x, x_scales, res, res_scales, pre_scale, pre_shift,
        static_cast<const float*>(w), add, out, out_scales, stats, t_len,
        f_len, c, x_q, res_q, pre_silu, post_silu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
