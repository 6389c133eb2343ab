// Shared pieces of the hand-written Hopper conv kernels (conv3x3.cu,
// conv_strided.cu).
//
// Layout: every activation is channels-last [B, T, F, C] (the port's flat
// [B, T, F·C] state viewed with C minor), weights are HWIO [kh, kw, Cin, Cout].
//
// Common block shape: one block computes a tile of kPos = 64 output positions
// (TT time rows × FT frequency columns, TT·FT = 64) for kCoTile = 32 output
// channels. Lane l of every warp owns output channel co0 + l; warp w owns 8 of
// the 64 positions, so each thread keeps 8 fp32 accumulators. Input channels
// are consumed in chunks: the block stages the (prologue-applied) input halo
// of the tile and the chunk's weights in shared memory as fp32, then every
// thread runs FMAs on CUDA cores (float4 broadcast reads of the input, one
// conflict-free weight read per lane). fp32 and bf16 storage share the code;
// bf16 values are widened on staging and the accumulation is fp32.
//
// GroupNorm statistics: blocks run in no order, so nothing accumulates across
// the grid. Each block writes the per-channel (sum, sum²) of its own tile to
// a partials array [B, n_tiles, 2, Cout] (fixed-order reduction inside the
// block); the Python wrapper finishes the sum with torch.sum over n_tiles.
// The result is deterministic run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ddim {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPos = 64;       // output positions per block
constexpr int kPosPerThread = kPos / kWarps;
constexpr int kCoTile = 32;    // output channels per block, one per lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the storage type and widen back (the prologue result is rounded
// to the compute dtype before the taps, as the TPU kernel's staging scratch).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Tile geometry shared by the kernels and the host-side tile count:
// FT = 16 frequency columns when the output is at least that wide, else 8.
__host__ __device__ __forceinline__ int tile_f(int f_out) {
  return f_out >= 16 ? 16 : 8;
}
__host__ __device__ __forceinline__ int tile_t(int f_out) {
  return kPos / tile_f(f_out);
}
__host__ __device__ __forceinline__ int num_tiles(int t_out, int f_out) {
  const int ft = tile_f(f_out), tt = tile_t(f_out);
  return ((t_out + tt - 1) / tt) * ((f_out + ft - 1) / ft);
}

// Per-block partial (sum, sum²) for the block's 32 output channels. Every
// thread of the block must call it (it synchronises). dst points at
// partials[b, tile, :, :] = [2, c_out].
__device__ __forceinline__ void block_stats(float s1, float s2, float* red,
                                            float* dst, int co, int c_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[warp * 32 + lane] = s1;
  red[kThreads + warp * 32 + lane] = s2;
  __syncthreads();
  if (warp == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * 32 + lane];
      b += red[kThreads + w * 32 + lane];
    }
    if (co < c_out) {
      dst[co] = a;
      dst[c_out + co] = b;
    }
  }
}

// Eight consecutive values widened to fp32, moved as one 16-byte (bf16) or
// two 16-byte (fp32) accesses; the address must be 16-byte aligned.
struct Vec8 {
  float v[8];
};

__device__ __forceinline__ Vec8 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out.v[2 * k] = f.x;
    out.v[2 * k + 1] = f.y;
  }
  return out;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const Vec8& v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v.v[2 * k], v.v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// acc += dot(v, (w0, w1, w2, w3)) in a fixed order.
__device__ __forceinline__ float fma4(float acc, float4 v, float w0, float w1,
                                      float w2, float w3) {
  acc = fmaf(v.x, w0, acc);
  acc = fmaf(v.y, w1, acc);
  acc = fmaf(v.z, w2, acc);
  return fmaf(v.w, w3, acc);
}

}  // namespace ddim
