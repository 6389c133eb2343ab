// The resblock tail of int8 activation storage, over channels-last
// [B, T, F, C]. Replaces the TPU kernel
// ddim_audio_tpu/ops/pallas/conv_flat.py `_res_affine_kernel` (wrapper
// `residual_affine_flat`):
//
//   out32 = deq(x) + deq(s) · scale[b, c] + shift[b, c]   (or deq(x) + deq(s))
//
// where deq(q) = q · the scale of the storage group that owns the position
// (int8 operands) or the value itself (fp32 / bf16 operands); then the
// partial (sum, sum²) of out32 per channel, and either out = out32 in the
// output dtype or, quantised per storage group, amax = max(max|out32|, 1e-30),
// q = clip(rint(out32 · (127 / amax)), −127, 127) with the scale
// amax · (1/127). Bit-equal to the twin: the same fp32 operations in the
// same order (deq, then the affine: (deq(x) + deq(s) · scale) + shift; no
// affine is scale 1 and shift −0, which change no bit), the IEEE division
// 127 / amax, round half to even.
//
// With x and s both float (the float resblock tail, ops/flat_resblock.py
// `resblock_tail`) the kernel computes what torch's three passes compute:
// x + s · scale as one product-sum (addcmul, fused), then + shift, rounded
// once to the output dtype; and the statistics are taken on the values as
// stored (bf16-rounded where out is bf16), as the twin's `channel_sums` of
// the output reads them. Only the arithmetic order differs between the
// float and the int8 instantiations; the walk is the same.
//
// What bounds it on an H100: bytes. At the int8-storage forward's s0 (B = 1,
// 8192 × 256 × 32) it reads 67 MB of int8 x and 67 MB of int8 s and writes
// 67 MB of int8 out (+ 0.5 MB of scales each): 0.060 ms at 3.35 TB/s, and
// some 15 fp32 operations a value, which take about as long to issue on
// the SMs' CUDA cores unless the conversions stay off the quarter-rate
// conversion pipe. The design:
//
//   * persistent blocks (residual_affine_plan in conv_plan.h): a block owns
//     one sample and one group of 32 channels and walks that sample's
//     storage groups (8 × 16 positions × 32 channels: a "unit") blockIdx.x,
//     + gridDim.x, …, so the per-channel affine sits in registers once;
//   * the next kResStages − 1 units' x, s and scale rows are in flight by
//     cp.async (16 bytes a copy, neighbouring threads on neighbouring
//     addresses: a position's 32 channels are 32-128 contiguous bytes)
//     while the current unit is computed, so the loads of a thread are not
//     waiting behind its arithmetic or behind a branch on the operand kind:
//     the kinds, the quantisation and the statistics are template
//     arguments, and the copies move raw bytes;
//   * thread (warp w, lane l) owns channels 4·(l % 8) … + 3 of column
//     4·w + l / 8 for the unit's 8 rows: 32 fp32 results in registers, so
//     each value is computed once (a thread of 16 channels would hold 128).
//     A warp reads 4 whole positions a row from shared memory (4 × 32
//     channels, conflict-free); the row max stays in the thread, the max
//     over the warp's 4 columns is two shuffles and over the 4 warps one
//     exchange in shared memory, after which each thread divides 127 by its
//     4 channels' amax;
//   * int8 values widen through a byte permute and an exact fp32
//     subtraction (2^23 + q + 128 − (2^23 + 128)), and quantise through an
//     fp32 add of 1.5 · 2^23 (rint, ties to even, into the low byte): no
//     conversion instruction;
//   * the 4 bytes (int8) / 8 (bf16) / 16 (fp32) of a thread's row leave
//     with one store, a warp's 4 positions contiguous;
//   * (sum, sum²) stay in registers across the block's units and are
//     reduced once a block in a fixed order: one partial a block
//     ([B, grid, 2, C], a few hundred rows), deterministic.
#include "conv_mma.cuh"

namespace ddim {

// Bytes of a cp.async copy of the staging (16; 4 and 8 also work).
constexpr int kResCopy = 16;

template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
  }
}

// Four consecutive values of kind K (0 fp32, 1 bf16, 2 int8) at p as fp32;
// int8 gives the integer itself (exactly: 2^23 + (q + 128) − (2^23 + 128)).
template <int K>
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4]) {
  if constexpr (K == 0) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (K == 1) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7640 + k)),
                       8388736.0f);
  }
}

// rint(v[k] · inv[k]) as four int8 bytes: |v| <= amax, so |v · inv| <= 127
// to within two fp32 roundings and the twin's clip never acts (quant8 in
// conv3x3_store.cu, one scale a value).
__device__ __forceinline__ uint32_t quant4v(const float (&v)[4],
                                            const float (&inv)[4]) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = __float_as_uint(__fadd_rn(__fmul_rn(v[k], inv[k]), 12582912.0f));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// XK, SK: the kinds of x and s; QUANT: out is int8 with scales (else fp32
// or bf16 as out_bf16 says); STATS: the statistics partials.
template <int XK, int SK, bool QUANT, bool STATS>
__global__ void __launch_bounds__(kResThreads, kResBlocks)
    residual_affine_kernel(const unsigned char* __restrict__ x,
                           const float* __restrict__ x_scales,
                           const unsigned char* __restrict__ s,
                           const float* __restrict__ s_scales,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           void* __restrict__ out,
                           float* __restrict__ out_scales,
                           float* __restrict__ stats, int t_len, int f_len,
                           int c, int out_bf16) {
  constexpr bool FLOAT = XK != 2 && SK != 2;  // the float resblock tail
  constexpr int XB = XK == 0 ? 4 : XK == 1 ? 2 : 1;
  constexpr int SB = SK == 0 ? 4 : SK == 1 ? 2 : 1;
  constexpr int XP = 32 * XB, SP = 32 * SB;  // bytes of a position
  constexpr int NPOS = kTtS * kFtS;
  constexpr int STAGE = NPOS * (XP + SP) + 2 * 32 * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kResStages * STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ck = lane & 7;                 // channels 4·ck … 4·ck + 3
  const int col = 4 * warp + (lane >> 3);  // the unit's column
  const int b = blockIdx.y, c0 = blockIdx.z * 32, ch = c0 + 4 * ck;
  const int nt = (t_len + kTtS - 1) / kTtS, nf = (f_len + kFtS - 1) / kFtS;
  const int units = nt * nf;
  const int mine = (int)blockIdx.x < units
                       ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  float sc[4], sh[4];  // no affine: 1 and −0, which change no bit
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sc[k] = scale != nullptr ? scale[(size_t)b * c + ch + k] : 1.f;
    sh[k] = shift != nullptr ? shift[(size_t)b * c + ch + k] : -0.f;
  }

  // Unit u's x, s and scale rows into stage buffer buf (positions past the
  // array are not copied: their values are never read). Thread tid makes
  // copies tid, tid + kResThreads, … of each operand: XQ of x, SQ of s, at
  // offsets within the unit that are the same for every unit.
  constexpr int XQ = XP / kResCopy, SQ = SP / kResCopy;
  const size_t pitch = (size_t)f_len * c;  // elements of a time row
  auto load_unit = [&](int u, int buf) {
    unsigned char* st = smem + buf * STAGE;
    const int gt = u / nf, gf = u % nf, t0 = gt * kTtS, f0 = gf * kFtS;
    const int rows = min(kTtS, t_len - t0), cols = min(kFtS, f_len - f0);
    const size_t e0 = ((size_t)b * t_len + t0) * pitch + (size_t)f0 * c + c0;
#pragma unroll
    for (int k = 0; k < XQ + SQ; ++k) {
      const bool is_x = k < XQ;
      const int nq = is_x ? XQ : SQ;
      const int i = tid + kResThreads * (is_x ? k : k - XQ);
      const int pos = i / nq, q = i % nq, r = pos / kFtS, col = pos % kFtS;
      if (r < rows && col < cols) {
        const size_t e = e0 + r * pitch + (size_t)col * c;
        if (is_x)
          cp_async_n<kResCopy>(st + pos * XP + q * kResCopy,
                               x + e * XB + q * kResCopy);
        else
          cp_async_n<kResCopy>(st + NPOS * XP + pos * SP + q * kResCopy,
                               s + e * SB + q * kResCopy);
      }
    }
    const size_t g = (((size_t)b * nt + gt) * nf + gf) * c + c0;
    float* scl = reinterpret_cast<float*>(st + NPOS * (XP + SP));
    if (XK == 2 && tid < 8) cp_async16(scl + 4 * tid, x_scales + g + 4 * tid);
    if (SK == 2 && tid >= 8 && tid < 16)
      cp_async16(scl + 32 + 4 * (tid - 8), s_scales + g + 4 * (tid - 8));
  };

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kResStages - 1; ++i) {
    if (i < mine) load_unit(blockIdx.x + i * gridDim.x, i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    const int u = blockIdx.x + i * gridDim.x;
    if constexpr (kResStages == 1) {
      load_unit(u, 0);
      cp_async_commit();
    }
    cp_async_wait<(kResStages > 1 ? kResStages - 2 : 0)>();
    __syncthreads();  // unit i has landed; unit i − 1's buffer is free
    if constexpr (kResStages > 1) {
      if (i + kResStages - 1 < mine)
        load_unit(u + (kResStages - 1) * gridDim.x,
                  (i + kResStages - 1) % kResStages);
      cp_async_commit();
    }
    const unsigned char* st = smem + (i % kResStages) * STAGE;
    const float* scl = reinterpret_cast<const float*>(st + NPOS * (XP + SP));
    float xs[4] = {1.f, 1.f, 1.f, 1.f}, ss[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (XK == 2) {
      const float4 a = *reinterpret_cast<const float4*>(scl + 4 * ck);
      xs[0] = a.x, xs[1] = a.y, xs[2] = a.z, xs[3] = a.w;
    }
    if constexpr (SK == 2) {
      const float4 a = *reinterpret_cast<const float4*>(scl + 32 + 4 * ck);
      ss[0] = a.x, ss[1] = a.y, ss[2] = a.z, ss[3] = a.w;
    }
    const int gt = u / nf, gf = u % nf, t0 = gt * kTtS;
    const int f = gf * kFtS + col;
    const int rows = f < f_len ? min(kTtS, t_len - t0) : 0;
    float v[kTtS][4], am[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kTtS; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[r][k] = 0.f;
      if (r < rows) {
        const int pos = r * kFtS + col;
        float xv[4], sv[4];
        load4<XK>(st + pos * XP + 4 * ck * XB, xv);
        load4<SK>(st + NPOS * XP + pos * SP + 4 * ck * SB, sv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float a = XK == 2 ? __fmul_rn(xv[k], xs[k]) : xv[k];
          const float d = SK == 2 ? __fmul_rn(sv[k], ss[k]) : sv[k];
          const float o =
              FLOAT ? __fadd_rn(__fmaf_rn(d, sc[k], a), sh[k])
                    : __fadd_rn(__fadd_rn(a, __fmul_rn(d, sc[k])), sh[k]);
          v[r][k] = o;
          if constexpr (QUANT) am[k] = fmaxf(am[k], fabsf(o));
          if constexpr (STATS) {
            // the float tail's statistics read the stored values
            const float w = FLOAT && !QUANT && out_bf16
                                ? __bfloat162float(__float2bfloat16_rn(o))
                                : o;
            s1[k] += w;
            s2[k] = fmaf(w, w, s2[k]);
          }
        }
      }
    }
    const size_t row0 = ((size_t)b * t_len + t0) * pitch + (size_t)f * c;
    if constexpr (QUANT) {
      // the group's amax: the warp's 4 columns, then the 4 warps
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        am[k] = fmaxf(am[k], __shfl_xor_sync(0xffffffffu, am[k], 8));
        am[k] = fmaxf(am[k], __shfl_xor_sync(0xffffffffu, am[k], 16));
      }
      if (lane < 8)
        *reinterpret_cast<float4*>(red + warp * 32 + 4 * ck) =
            make_float4(am[0], am[1], am[2], am[3]);
      __syncthreads();
      float4 m = *reinterpret_cast<const float4*>(red + 4 * ck);
#pragma unroll
      for (int w = 1; w < kResThreads / 32; ++w) {
        const float4 o = *reinterpret_cast<const float4*>(red + w * 32 + 4 * ck);
        m = make_float4(fmaxf(m.x, o.x), fmaxf(m.y, o.y), fmaxf(m.z, o.z),
                        fmaxf(m.w, o.w));
      }
      const float amax[4] = {fmaxf(m.x, 1e-30f), fmaxf(m.y, 1e-30f),
                             fmaxf(m.z, 1e-30f), fmaxf(m.w, 1e-30f)};
      float inv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) inv[k] = 127.0f / amax[k];
      if (warp == 0 && lane < 8)
        *reinterpret_cast<float4*>(
            out_scales + (((size_t)b * nt + gt) * nf + gf) * c + ch) =
            make_float4(amax[0] * (1.0f / 127.0f), amax[1] * (1.0f / 127.0f),
                        amax[2] * (1.0f / 127.0f), amax[3] * (1.0f / 127.0f));
      int8_t* q = static_cast<int8_t*>(out);
#pragma unroll
      for (int r = 0; r < kTtS; ++r)
        if (r < rows)
          *reinterpret_cast<uint32_t*>(q + row0 + r * pitch + ch) =
              quant4v(v[r], inv);
    } else {
#pragma unroll
      for (int r = 0; r < kTtS; ++r) {
        if (r >= rows) continue;
        const size_t off = row0 + r * pitch + ch;
        if (out_bf16) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[r][0], v[r][1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[r][2], v[r][3]);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
              make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
        }
      }
    }
    if constexpr (kResStages == 1) __syncthreads();  // the buffer is reused
  }
  if constexpr (STATS) {
    // one partial a block: over the warp's 4 columns by shuffles, then
    // over the warps in order
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], 8);
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], 16);
      s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], 8);
      s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], 16);
    }
    __syncthreads();  // the amax exchange is done with red
    if (lane < 8) {
      *reinterpret_cast<float4*>(red + (2 * warp) * 32 + 4 * ck) =
          make_float4(s1[0], s1[1], s1[2], s1[3]);
      *reinterpret_cast<float4*>(red + (2 * warp + 1) * 32 + 4 * ck) =
          make_float4(s2[0], s2[1], s2[2], s2[3]);
    }
    __syncthreads();
    if (tid < 64) {
      const int which = tid / 32, cc = tid % 32;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kResThreads / 32; ++w) a += red[(2 * w + which) * 32 + cc];
      stats[(((size_t)b * gridDim.x + blockIdx.x) * 2 + which) * c + c0 + cc] =
          a;
    }
  }
}

template <int XK, int SK, bool QUANT, bool STATS>
cudaError_t launch_residual_affine(const TilePlan& p, const void* x,
                                   const float* x_scales, const void* s,
                                   const float* s_scales, const float* scale,
                                   const float* shift, void* out,
                                   float* out_scales, float* stats, int batch,
                                   int t_len, int f_len, int c, int out_bf16,
                                   cudaStream_t st) {
  static int raised = 48 * 1024;  // per instantiation; one card per process
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_affine_kernel<XK, SK, QUANT, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    raised = p.smem;
  }
  residual_affine_kernel<XK, SK, QUANT, STATS>
      <<<dim3(p.grid, batch, p.groups), kResThreads, p.smem, st>>>(
      static_cast<const unsigned char*>(x), x_scales,
      static_cast<const unsigned char*>(s), s_scales, scale, shift, out,
      out_scales, stats, t_len, f_len, c, out_bf16);
  return cudaGetLastError();
}

using ResLaunch = cudaError_t (*)(const TilePlan&, const void*, const float*,
                                  const void*, const float*, const float*,
                                  const float*, void*, float*, float*, int,
                                  int, int, int, int, cudaStream_t);

template <int XK, int SK>
ResLaunch pick_quant_stats(bool quant, bool with_stats) {
  if (quant)
    return with_stats ? launch_residual_affine<XK, SK, true, true>
                      : launch_residual_affine<XK, SK, true, false>;
  return with_stats ? launch_residual_affine<XK, SK, false, true>
                    : launch_residual_affine<XK, SK, false, false>;
}

template <int XK>
ResLaunch pick_s(int s_kind, bool quant, bool with_stats) {
  switch (s_kind) {
    case 0: return pick_quant_stats<XK, 0>(quant, with_stats);
    case 1: return pick_quant_stats<XK, 1>(quant, with_stats);
    case 2: return pick_quant_stats<XK, 2>(quant, with_stats);
  }
  return nullptr;
}

}  // namespace ddim

extern "C" {

// x, s, out: [B, T, F, C] of kind x_kind / s_kind / out_kind (0 fp32, 1 bf16,
// 2 int8); an int8 x or s comes with its scales [B, ceil(T/8), ceil(F/16), C]
// fp32, an int8 out (quantised) writes out_scales of that shape; scale,
// shift: [B, C] fp32 or both null; stats: [B, residual_affine_plan(...).tiles,
// 2, C] fp32 or null. C % 32 == 0; every pointer 16-byte aligned.
int ddim_residual_affine(const void* x, const float* x_scales, const void* s,
                         const float* s_scales, const float* scale,
                         const float* shift, void* out, float* out_scales,
                         float* stats, int batch, int t_len, int f_len, int c,
                         int x_kind, int s_kind, int out_kind, void* stream) {
  using namespace ddim;
  const TilePlan p = residual_affine_plan(t_len, f_len, c, x_kind, s_kind,
                                          batch);
  if (p.variant != kVariantFma || x_kind < 0 || x_kind > 2 || s_kind < 0 ||
      s_kind > 2 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = out_kind == 2, with_stats = stats != nullptr;
  ResLaunch launch = x_kind == 0   ? pick_s<0>(s_kind, quant, with_stats)
                     : x_kind == 1 ? pick_s<1>(s_kind, quant, with_stats)
                                   : pick_s<2>(s_kind, quant, with_stats);
  if (p.grid == 0) return 0;  // no positions
  return static_cast<int>(launch(p, x, x_scales, s, s_scales, scale, shift,
                                 out, out_scales, stats, batch, t_len, f_len,
                                 c, out_kind == 1,
                                 reinterpret_cast<cudaStream_t>(stream)));
}

}  // extern "C"
