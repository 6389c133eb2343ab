// Shared pieces of the hand-written Hopper conv kernels (conv3x3.cu,
// conv_strided.cu and the int8 kernels beside them).
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
// block); the Python wrapper finishes the sum over n_tiles with the
// batch_sums kernel (batch_sums.cu), whose order of additions does not depend
// on B. The result is deterministic run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_plan.h"

namespace ddim {

constexpr int kWarps = kThreads / 32;  // kThreads, kPos: conv_plan.h
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

// Tile geometry (tile_f, tile_t, num_tiles): conv_plan.h.

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

// Eight int8 values (8 bytes, aligned) widened to fp32.
__device__ __forceinline__ Vec8 load8(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out.v[k] = (float)(int8_t)((raw.x >> (8 * k)) & 0xff);
    out.v[4 + k] = (float)(int8_t)((raw.y >> (8 * k)) & 0xff);
  }
  return out;
}

__device__ __forceinline__ void store8(float* p, const Vec8& v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
  *reinterpret_cast<float4*>(p + 4) =
      make_float4(v.v[4], v.v[5], v.v[6], v.v[7]);
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

// int8 activation storage (conv3x3_store.cu, residual_affine.cu): one fp32
// scale per storage group (kTtS × kFtS × one channel, conv_plan.h).
// Offset into the scales of the group that owns (t, f), channel ch.
__device__ __forceinline__ size_t group_offset(int b, int t, int f, int ch,
                                               int t_len, int f_len, int c) {
  const int nt = (t_len + kTtS - 1) / kTtS, nf = (f_len + kFtS - 1) / kFtS;
  return (((size_t)b * nt + t / kTtS) * nf + f / kFtS) * c + ch;
}

// clip(rint(v · inv), −127, 127), inv = 127 / amax (round half to even).
__device__ __forceinline__ int quant1(float v, float inv) {
  return max(-127, min(127, __float2int_rn(v * inv)));
}

// D += A·B, A 16×32 (row, K contiguous), B 32×8 (column, K contiguous), s8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ddim
