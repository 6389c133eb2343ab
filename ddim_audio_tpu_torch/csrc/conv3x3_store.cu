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
//             v = v·scale[b, c] + shift[b, c] (a rounded multiply, then a
//             rounded add); v = silu(v)   (optional)
//             v rounded to the compute dtype T (the staging dtype); zero
//             outside [0,T)×[0,F) after the prologue
//   taps      out32 = Σ_{dt,df,ci} v[t+dt−1, f+df−1, ci] · w[dt, df, ci, co]
//   epilogue  + add[b, co], silu (optional), partial (sum, sum²) of out32,
//             then either out = out32 rounded to T, or (quant_out) per
//             storage group amax = max(max|out32|, 1e-30),
//             q = clip(rint(out32 · (127 / amax)), −127, 127) and the scale
//             amax · (1/127)
//
// The storage group is kTtS × kFtS = 8 × 16 positions × one channel
// (conv_plan.h; the consumers, residual_affine.cu and this kernel's own
// prologue, dequantise with the same groups, and ddim_store_geometry reports
// them to the plain twin). Every tile a block owns is a union of whole
// groups, so the amax of every group it writes is a reduction inside the
// block and no second pass is needed.
//
// Two variants; conv3x3_store_plan (conv_plan.h) picks one per call:
//
// - conv3x3_store_mma_kernel (bf16, C % 32 == 0: every storage stage of
//   audio.yml, s0-s3). The conv3x3 tensor-core block of conv3x3.cu
//   (Conv3x3Mma in conv_mma.cuh: the halo staged once for all C output
//   channels, a 3-deep cp.async ring of tap-row weight stages, mma.sync bf16
//   → fp32 with A rows read by ldmatrix straight from the halo and B by
//   ldmatrix.trans, the epilogue in registers after a quad transpose), with
//   its tile always 16 columns wide: 16 × 16 positions at C <= 96, 8 × 16
//   from C = 128 on. On an H100 its bound at s0-s2 is about balanced between
//   bytes (1 byte in, 1 out a value) and tensor-core operations (9·C MACs a
//   value); the block before this design reached 2-6% of it: it staged
//   every halo C/32 times (8 × 16 positions × 32 output channels a block),
//   synchronously, ran WMMA, and took its fp32 tile through shared memory
//   on the way to 1-byte stores. What differs from conv3x3.cu:
//   * the prologue reads int8 as 16-byte vectors (16 channels an item) and
//     dequantises them with their group's scale from the scale rows of the
//     groups the halo touches, staged in shared memory once a tile
//     (store_halo_groups: 4 × 3 groups of a 16 × 16 tile's halo, 3 × 3 of
//     an 8 × 16 one; 4.6 KB at C = 96 and 128), where the previous block
//     fetched them from global memory for every 8 values. Its arithmetic is
//     the twin's, rounding for rounding: the dequantised sum in fp32, the
//     affine as __fmul_rn then __fadd_rn, SiLU with expf and the IEEE
//     division (conv_common.cuh's silu, as torch computes it on the card),
//     one rounding to bf16. The fast SiLU of the float-tap kernels would
//     flip a bf16 rounding now and then, and one flipped input moves the
//     amax of a group whose values are all small (a channel that SiLU
//     holds near its minimum of −0.28) by ~1e-3 of itself: an H100 read
//     scales 2.5e-3 off the twin's that way (chip_smoke), where these give
//     1e-5. The int8 operand's bytes become floats by a byte permute under
//     the exponent of 2^23 and one subtraction (dequant16), in place of
//     the quarter-rate conversion;
//   * the quantising epilogue: after add and SiLU the fp32 values stay in
//     the accumulator registers; |out32| is reduced per (storage group,
//     channel) over the lane's positions, over the warp by shuffles and over
//     the four warps that share a group (8 rows of 16: each warp owns two)
//     through shared memory (SiLU here takes the fast exponential and
//     division, silu_fast: a few ulp of out32, ~1e-7 of a scale); the
//     registers are quantised with the twin's
//     127 / amax (an IEEE division) and a rounding add of 1.5·2^23 (rint
//     with ties to even, exact below 2^22), each lane storing the 8
//     consecutive channels of a position as 8 bytes; one scale per (group,
//     channel). max is independent of order, so the result is
//     deterministic. The statistics are taken on the fp32 values before
//     quantisation, in a fixed order, without atomics (per-tile partials).
//   Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, int8 in,
//   quant_out, statistics, B = 1): 0.468 / 0.312 / 0.161 / 0.095 ms at
//   s0-s3, against 0.736 / 0.766 / 0.451 / 0.207 for the block before and
//   0.217 / 0.103 / 0.080 / 0.031 for cuDNN's bare conv. Its prologue, taps
//   and epilogue run in series inside a block, each about a third of the
//   time at s0 (tools/conv_ablation.py; PERF.md §6).
// - conv3x3_store_fma_kernel (fp32, which only tests and twin checks use):
//   one storage group × 32 output channels a block, 8 warps, warp w owns
//   time row w and lane l output channel co0 + l; FMA taps on CUDA cores,
//   16 accumulators per thread, the input staged 16 channels at a time.
#include "conv_mma.cuh"

namespace ddim {

// ------------------------------------------------- tensor-core variant --

// Sixteen int8 values (one 16-byte word) dequantised: q[k] · s[k], the
// scales s in shared memory. Each byte, offset by 128, is placed under the
// exponent of 2^23 by a byte permute and the float 2^23 + 128 subtracted:
// q exactly, by a full-rate permute and add in place of a conversion, which
// runs at a quarter of the rate on an H100.
__device__ __forceinline__ void dequant16(uint4 raw, const float* s,
                                          float (&v)[16]) {
  const uint32_t w4[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                          raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 sc = *reinterpret_cast<const float4*>(s + 4 * j);
    const float sk[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float q = __fsub_rn(
          __uint_as_float(__byte_perm(w4[j], 0x4B000000u, 0x7640 + k)),
          8388736.0f);
      v[4 * j + k] = __fmul_rn(q, sk[k]);
    }
  }
}

// Sixteen bf16 values (two 16-byte words) as fp32.
__device__ __forceinline__ void unpack16(const uint4 (&raw)[2],
                                         float (&v)[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Vec8 u = unpack8(raw[h]);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[8 * h + k] = u.v[k];
  }
}

// Eight values v · inv rounded to integers (ties to even) as int8 bytes.
// |v| <= amax, so |v · inv| <= 127 to within two fp32 roundings and the
// twin's clip never acts; adding 1.5·2^23 to the rounded product leaves
// rint of it in the low mantissa bits, whose low byte is the int8 value.
__device__ __forceinline__ uint2 quant8(const float (&v)[8],
                                        const float (&inv)[8]) {
  uint32_t q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    q[k] = __float_as_uint(__fadd_rn(__fmul_rn(v[k], inv[k]), 12582912.0f));
  return make_uint2(__byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                __byte_perm(q[2], q[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                                __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

// XQ: x is int8 with scales (else bf16). The residual is int8 with scales
// (res_q), bf16, or absent. out is int8 with out_scales (quant_out), else
// bf16. WN, MINB as conv3x3_mma_kernel's.
template <int WN, int MINB, bool XQ>
__global__ void __launch_bounds__(kThreads, MINB) conv3x3_store_mma_kernel(
    const void* __restrict__ x, const float* __restrict__ x_scales,
    const void* __restrict__ res, const float* __restrict__ res_scales,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ add,
    void* __restrict__ out, float* __restrict__ out_scales,
    float* __restrict__ stats, int t_len, int f_len, int c, int res_q,
    int pre_silu, int post_silu, int split) {
  using T = __nv_bfloat16;
  using Blk = Conv3x3Mma<WN>;
  constexpr int kWarpsM = Blk::kWarpsM;
  constexpr int kNB = Blk::kNB;
  constexpr int kFt = kFtS;                     // tile columns = a group's
  constexpr int kTt = Blk::kM / kFt;            // 16 (WN = 1) or 8 rows
  constexpr int kGroupWarps = kTtS * kFtS / 32;  // warps sharing a group
  static_assert(kTt % kTtS == 0 && kWarpsM % kGroupWarps == 0,
                "a tile is a union of whole storage groups");
  constexpr int kHw = kFt + 2, kHn = (kTt + 2) * kHw;
  constexpr int kSg = (kTt / kTtS + 2) * 3;     // store_halo_groups(kTt)
  extern __shared__ __align__(16) unsigned char smem[];

  const int pitch = c + 8;
  T* halo = reinterpret_cast<T*>(smem);         // [kHn][pitch]
  T* ring = halo + kHn * pitch;                 // [stages][3 df][32 ci][kWP]
  float* red = reinterpret_cast<float*>(ring + kConvStages * Blk::kStage);
  float* xsc = red + kMmaRed / 4;               // [kSg][c] when XQ
  float* rsc = xsc + (XQ ? kSg * c : 0);        // [kSg][c] when res_q

  const int b = blockIdx.y, z = blockIdx.z;
  const int tiles_f = (f_len + kFt - 1) / kFt;
  const int t0 = (blockIdx.x / tiles_f) * kTt, f0 = (blockIdx.x % tiles_f) * kFt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_len * f_len * c;
  const int group_steps = 3 * (c / kMmaK);
  const int nsteps = Blk::steps(c, z, split);
  const int n_t = (t_len + kTtS - 1) / kTtS, n_f = (f_len + kFtS - 1) / kFtS;
  const int gr0 = t0 / kTtS - 1, gc0 = f0 / kFtS - 1;  // first staged group

#pragma unroll
  for (int s = 0; s < kConvStages - 1; ++s) {
    if (s < nsteps) Blk::load_stage(ring, w, s, z, split, c);
    cp_async_commit();
  }

  // Stage the scale rows of the groups the halo touches (those inside the
  // array), 4 channels a copy.
  auto stage_scales = [&](float* dst, const float* src) {
    const int c4 = c / 4;
    for (int i = threadIdx.x; i < kSg * c4; i += kThreads) {
      const int gi = i / c4, q = i % c4;
      const int gr = gr0 + gi / 3, gc = gc0 + gi % 3;
      if (gr >= 0 && gr < n_t && gc >= 0 && gc < n_f)
        reinterpret_cast<float4*>(dst + gi * c)[q] = __ldg(
            reinterpret_cast<const float4*>(
                src + (((size_t)b * n_t + gr) * n_f + gc) * c) +
            q);
    }
  };
  if (XQ) stage_scales(xsc, x_scales);
  if (res_q) stage_scales(rsc, res_scales);
  if (XQ || res_q) __syncthreads();

  // Stage the prologue-applied halo once (while the first weight stages
  // load), 16 channels per item, kBatch items' loads in flight per thread
  // before their arithmetic.
  constexpr int kBatch = 2;
  const int cq = c / 16, n_items = kHn * cq;
  for (int i0 = threadIdx.x; i0 < n_items; i0 += kBatch * kThreads) {
    uint4 xr[kBatch][2], rr[kBatch][2];
    bool in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads, hp = idx / cq, q = idx % cq;
      const int t = t0 + hp / kHw - 1, f = f0 + hp % kHw - 1;
      in[u] = idx < n_items && t >= 0 && t < t_len && f >= 0 && f < f_len;
      xr[u][0] = xr[u][1] = rr[u][0] = rr[u][1] = make_uint4(0, 0, 0, 0);
      if (in[u]) {
        const size_t off = xb + ((size_t)t * f_len + f) * c + 16 * q;
        if constexpr (XQ) {
          xr[u][0] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(x) + off));
        } else {
          xr[u][0] = ldg16(static_cast<const T*>(x) + off);
          xr[u][1] = ldg16(static_cast<const T*>(x) + off + 8);
        }
        if (res != nullptr) {
          if (res_q) {
            rr[u][0] = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(res) + off));
          } else {
            rr[u][0] = ldg16(static_cast<const T*>(res) + off);
            rr[u][1] = ldg16(static_cast<const T*>(res) + off + 8);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx >= n_items) break;
      const int hp = idx / cq, ch = 16 * (idx % cq);
      float v[16];
      if (in[u]) {
        const int t = t0 + hp / kHw - 1, f = f0 + hp % kHw - 1;
        const int gi = (t / kTtS - gr0) * 3 + (f / kFtS - gc0);
        if constexpr (XQ)
          dequant16(xr[u][0], xsc + gi * c + ch, v);
        else
          unpack16(xr[u], v);
        if (res != nullptr) {
          float r[16];
          if (res_q)
            dequant16(rr[u][0], rsc + gi * c + ch, r);
          else
            unpack16(rr[u], r);
#pragma unroll
          for (int k = 0; k < 16; ++k)
            v[k] = (XQ || res_q) ? __fadd_rn(v[k], r[k])
                                 : round_to<T>(v[k] + r[k]);
        }
        if (pre_scale != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 sc = __ldg(
                reinterpret_cast<const float4*>(pre_scale + b * c + ch) + j);
            const float4 sh = __ldg(
                reinterpret_cast<const float4*>(pre_shift + b * c + ch) + j);
            v[4 * j] = __fadd_rn(__fmul_rn(v[4 * j], sc.x), sh.x);
            v[4 * j + 1] = __fadd_rn(__fmul_rn(v[4 * j + 1], sc.y), sh.y);
            v[4 * j + 2] = __fadd_rn(__fmul_rn(v[4 * j + 2], sc.z), sh.z);
            v[4 * j + 3] = __fadd_rn(__fmul_rn(v[4 * j + 3], sc.w), sh.w);
          }
        }
        if (pre_silu) {
#pragma unroll
          for (int k = 0; k < 16; ++k) v[k] = silu(v[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Vec8 o;
#pragma unroll
        for (int k = 0; k < 8; ++k) o.v[k] = v[8 * h + k];
        store8(halo + hp * pitch + ch + 8 * h, o);  // rounds to bf16
      }
    }
  }

  uint32_t a_base[kMT], b_base;  // lane's A rows (tap (0, 0)), B offset
  Blk::bases(a_base, b_base, halo, ring, kFt, kHw, pitch);
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kConvStages - 2>();
    __syncthreads();  // stage s (and the halo) visible; slot s − 1 free
    if (s + kConvStages - 1 < nsteps)
      Blk::load_stage(ring, w, s + kConvStages - 1, z, split, c);
    cp_async_commit();
    Blk::step(acc, a_base, b_base, s, c, kHw, pitch);
    if (s % group_steps != group_steps - 1) continue;

    // Epilogue of group g from the registers. 1. add, SiLU, statistics and
    // the lane's |out32| maximum; the values go back into the accumulators,
    // acc[mt][nt][2r + e] = channel 8·tig + 2·nt + e of the lane's position
    // (mt, r).
    const int g = z + (s / group_steps) * split;
    const int co = g * kNB + wn * 32 + 8 * tig;
    float av[8], s1[8], s2[8], am[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      av[k] = add != nullptr ? __ldg(add + b * c + co + k) : 0.f;
      s1[k] = s2[k] = am[k] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(acc[mt], r, tig);
        const int p = wm * 32 + mt * 16 + gid + 8 * r;
        const bool inside = t0 + p / kFt < t_len && f0 + p % kFt < f_len;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v = add != nullptr ? __fadd_rn(o.v[k], av[k]) : o.v[k];
          if (post_silu) v = silu_fast(v);
          if (inside) {
            s1[k] += v;
            s2[k] += v * v;
            am[k] = fmaxf(am[k], fabsf(v));
          }
          acc[mt][k >> 1][2 * r + (k & 1)] = v;
        }
      }
    if (out_scales == nullptr) {  // float out: bf16, 16 bytes a position
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = wm * 32 + mt * 16 + gid + 8 * r;
          const int t = t0 + p / kFt, f = f0 + p % kFt;
          Vec8 o;
#pragma unroll
          for (int k = 0; k < 8; ++k) o.v[k] = acc[mt][k >> 1][2 * r + (k & 1)];
          if (t < t_len && f < f_len)
            store8(static_cast<T*>(out) + xb + ((size_t)t * f_len + f) * c + co,
                   o);
        }
    } else {
      // 2. amax per (storage group, channel): the warp's by shuffles over
      // its eight position rows, then the group's warps through red.
#pragma unroll
      for (int m = 4; m < 32; m <<= 1)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          am[k] = fmaxf(am[k], __shfl_xor_sync(0xffffffffu, am[k], m));
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) red[wm * kNB + wn * 32 + 8 * tig + k] = am[k];
      }
      __syncthreads();
      const int gw = wm / kGroupWarps * kGroupWarps;  // the group's first warp
      float inv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float a = red[gw * kNB + wn * 32 + 8 * tig + k];
#pragma unroll
        for (int j = 1; j < kGroupWarps; ++j)
          a = fmaxf(a, red[(gw + j) * kNB + wn * 32 + 8 * tig + k]);
        am[k] = fmaxf(a, 1e-30f);
        inv[k] = 127.0f / am[k];  // a division, as the twin's
      }
      // 3. Quantise the registers: 8 bytes (8 channels) a position.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = wm * 32 + mt * 16 + gid + 8 * r;
          const int t = t0 + p / kFt, f = f0 + p % kFt;
          float o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = acc[mt][k >> 1][2 * r + (k & 1)];
          if (t < t_len && f < f_len)
            *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + xb +
                                      ((size_t)t * f_len + f) * c + co) =
                quant8(o, inv);
        }
      // 4. One scale per (group, channel), from the group's first warp.
      const int grow = t0 / kTtS + wm / kGroupWarps;
      if (wm == gw && gid == 0 && grow < n_t) {
        float* dst =
            out_scales + (((size_t)b * n_t + grow) * n_f + f0 / kFtS) * c + co;
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = am[k] * (1.0f / 127.0f);
      }
      __syncthreads();  // red is reused by the statistics
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
    if (stats != nullptr) {
      sum_over_gid(s1);
      sum_over_gid(s2);
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[(wm * 2) * kNB + wn * 32 + 8 * tig + k] = s1[k];
          red[(wm * 2 + 1) * kNB + wn * 32 + 8 * tig + k] = s2[k];
        }
      }
      finish_group_stats(
          red, kWarpsM, kNB,
          stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c + g * kNB, c);
    }
  }
}

template <int WN, int MINB, bool XQ>
cudaError_t launch_store_mma(const TilePlan& p, const void* x,
                             const float* x_scales, const void* res,
                             const float* res_scales, const float* pre_scale,
                             const float* pre_shift, const void* w,
                             const float* add, void* out, float* out_scales,
                             float* stats, int batch, int t_len, int f_len,
                             int c, int res_q, int pre_silu, int post_silu,
                             cudaStream_t s) {
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_store_mma_kernel<WN, MINB, XQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  conv3x3_store_mma_kernel<WN, MINB, XQ>
      <<<dim3(p.tiles, batch, p.split), kThreads, p.smem, s>>>(
          x, x_scales, res, res_scales, pre_scale, pre_shift,
          static_cast<const __nv_bfloat16*>(w), add, out, out_scales, stats,
          t_len, f_len, c, res_q, pre_silu, post_silu, p.split);
  return cudaGetLastError();
}

// --------------------------------------------------- CUDA-core variant --

constexpr int kHwS = kFtS + 2;
constexpr int kHaloS = (kTtS + 2) * kHwS;
constexpr int kCkS = 16;  // input channels per staged chunk

// Eight stored values as fp32: int8 dequantised with its group's scales, or
// fp32 as it is.
__device__ __forceinline__ Vec8 load_stored(const void* p, const float* scales,
                                            int q, int b, int t, int f, int ch,
                                            int t_len, int f_len, int c) {
  const size_t off = (((size_t)b * t_len + t) * f_len + f) * c + ch;
  if (!q) return load8(static_cast<const float*>(p) + off);
  Vec8 v = load8(static_cast<const int8_t*>(p) + off);
  const Vec8 s = load8(scales + group_offset(b, t, f, ch, t_len, f_len, c));
#pragma unroll
  for (int k = 0; k < 8; ++k) v.v[k] = __fmul_rn(v.v[k], s.v[k]);
  return v;
}

__global__ void __launch_bounds__(kThreads) conv3x3_store_fma_kernel(
    const void* __restrict__ x, const float* __restrict__ x_scales,
    const void* __restrict__ res, const float* __restrict__ res_scales,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const float* __restrict__ w, const float* __restrict__ add,
    void* __restrict__ out, float* __restrict__ out_scales,
    float* __restrict__ stats, int t_len, int f_len, int c, int x_q, int res_q,
    int pre_silu, int post_silu) {
  __shared__ __align__(16) float xs[kHaloS * kCkS];
  __shared__ __align__(16) float ws[9 * kCkS * kCoTile];
  __shared__ float red[2 * kThreads];

  const int b = blockIdx.y;
  const int tiles_f = (f_len + kFtS - 1) / kFtS;
  const int t0 = (blockIdx.x / tiles_f) * kTtS;
  const int f0 = (blockIdx.x % tiles_f) * kFtS;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;

  float o[kFtS];  // this thread's outputs: time row warp, columns i, channel co
#pragma unroll
  for (int i = 0; i < kFtS; ++i) o[i] = 0.f;
  for (int c0 = 0; c0 < c; c0 += kCkS) {
    // the prologue-applied halo of the chunk
    for (int idx = threadIdx.x; idx < kHaloS * kCkS / 8; idx += kThreads) {
      const int q = idx % (kCkS / 8), hp = idx / (kCkS / 8);
      const int t = t0 + hp / kHwS - 1, f = f0 + hp % kHwS - 1;
      const int ch = c0 + 8 * q;
      Vec8 v;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
        v = load_stored(x, x_scales, x_q, b, t, f, ch, t_len, f_len, c);
        if (res != nullptr) {
          const Vec8 r = load_stored(res, res_scales, res_q, b, t, f, ch,
                                     t_len, f_len, c);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = __fadd_rn(v.v[k], r.v[k]);
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
      store8(xs + hp * kCkS + 8 * q, v);
    }
    // the chunk's weights ws[tap][ci][32 co]
    for (int idx = threadIdx.x; idx < 9 * kCkS * kCoTile / 4; idx += kThreads) {
      const int q = idx % (kCoTile / 4), r = idx / (kCoTile / 4);
      const int ci = r % kCkS, tap = r / kCkS;
      *reinterpret_cast<float4*>(ws + r * kCoTile + 4 * q) =
          *reinterpret_cast<const float4*>(
              w + ((size_t)tap * c + c0 + ci) * c + co0 + 4 * q);
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* xrow = xs + ((warp + tap / 3) * kHwS + tap % 3) * kCkS;
#pragma unroll
      for (int ci = 0; ci < kCkS; ci += 4) {
        const float* wr = &ws[(tap * kCkS + ci) * kCoTile + lane];
        const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                    w3 = wr[3 * kCoTile];
#pragma unroll
        for (int i = 0; i < kFtS; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xrow + i * kCkS + ci);
          o[i] = fma4(o[i], v, w0, w1, w2, w3);
        }
      }
    }
    __syncthreads();
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
    float* y = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < kFtS; ++i)
      if (t < t_len && f0 + i < f_len) y[(row + f0 + i) * c + co] = o[i];
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

}  // namespace ddim

extern "C" {

// x, res: [B, T, F, C] int8 (x_q / res_q, with scales [B, ceil(T/8),
// ceil(F/16), C] fp32) or the compute dtype; w: [3, 3, C, C] in the compute
// dtype (bf16 or fp32, as `bf16` says); pre_scale, pre_shift, add: [B, C]
// fp32; out: [B, T, F, C] int8 when out_scales is given (quant_out), else the
// compute dtype; stats: [B, tiles, 2, C] fp32 with tiles from
// ddim_conv3x3_store_plan (conv_plan.cu). res, its scales, pre_*, add,
// out_scales and stats may be null; every pointer is 16-byte aligned;
// C % 32 == 0. Returns cudaErrorInvalidValue for a shape no variant takes,
// else cudaGetLastError() after the launch.
int ddim_conv3x3_store(const void* x, const float* x_scales, const void* res,
                       const float* res_scales, const float* pre_scale,
                       const float* pre_shift, const void* w, const float* add,
                       void* out, float* out_scales, float* stats, int batch,
                       int t_len, int f_len, int c, int x_q, int res_q,
                       int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  const int scaled = (x_q ? 1 : 0) + (res != nullptr && res_q ? 1 : 0);
  const TilePlan p = conv3x3_store_plan(t_len, f_len, c, bf16, batch, scaled);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma) {
    // audio.yml: C = 32, 64 → <1, 3>; 96 → <1, 2>; 128 → <2, 2>
    const bool wn2 = conv3x3_warps_n(c) == 2;
    const bool mb3 = conv3x3_min_blocks(c) == 3;
    const auto launch =
        x_q ? (wn2 ? launch_store_mma<2, 2, true>
                   : mb3 ? launch_store_mma<1, 3, true>
                         : launch_store_mma<1, 2, true>)
            : (wn2 ? launch_store_mma<2, 2, false>
                   : mb3 ? launch_store_mma<1, 3, false>
                         : launch_store_mma<1, 2, false>);
    return static_cast<int>(launch(p, x, x_scales, res, res_scales, pre_scale,
                                   pre_shift, w, add, out, out_scales, stats,
                                   batch, t_len, f_len, c,
                                   res != nullptr ? res_q : 0, pre_silu,
                                   post_silu, s));
  }
  if (p.variant != kVariantFma)
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_store_fma_kernel<<<dim3(p.tiles, batch, p.split), kThreads, 0, s>>>(
      x, x_scales, res, res_scales, pre_scale, pre_shift,
      static_cast<const float*>(w), add, out, out_scales, stats, t_len, f_len,
      c, x_q, res_q, pre_silu, post_silu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
