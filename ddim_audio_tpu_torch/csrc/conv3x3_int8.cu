// Fused 3×3 SAME conv, C → C, with int8 × int8 → int32 taps on the tensor
// cores. Replaces the `mxu_i8` branch of the TPU kernel
// ddim_audio_tpu/ops/pallas/conv_flat.py `_conv_kernel` (wrapper
// `conv3x3_flat(mxu_int8=True)`, weights from `pack_conv_weights_int8`).
//
//   prologue  as conv3x3.cu (residual, GroupNorm affine, SiLU), but the
//             staged value is rounded to bf16 whatever the storage dtype;
//             positions outside the array are zero after the prologue
//   requant   one scale per quantisation group:
//             amax = max(max|v|, 1e-30) over every staged value of the group,
//             q = clip(rint(v · (127 / amax)), −127, 127)   (round half even)
//   taps      acc32 = Σ_{dt,df,ci} q[t+dt−1, f+df−1, ci] · wq[dt, df, ci, co]
//   dequant   out32 = float(acc32) · ((amax · (1/127)) · w_scale[co])
//   epilogue  as conv3x3.cu (add, SiLU, partial (sum, sum²), store cast)
//
// The quantisation group is an 8 × 16 output tile with its 1-position halo
// (10 × 18 positions, clipped to the array) over all C input channels.
// ddim_conv3x3_int8_geometry reports it; the plain twin takes the same group
// as arguments; the statistics partials have one row per group.
//
// Design (C ∈ {32, 64, 96}, conv3x3_int8_plan in conv_plan.h). On an H100
// the int8 taps (9·C² MACs a position at 1,979 TOP/s) are far from the
// bound, and so are the bytes (x, out in bf16: 0.080 ms at s0, B = 1); what
// holds the kernel is the per-value work around the taps, the prologue
// (residual, affine, SiLU on 1.41 values an output: the group's halo) and
// the epilogue (dequant, add, SiLU, statistics), and the latency between
// them inside a group. The kernel before this design made two synchronous
// passes over shared memory (stage the prologue in bf16, then
// requantise), had every block read the nine taps' weights from global
// memory and transpose them in registers one tap row at a time, loaded
// fragments 32 bits at a time, and took its epilogue through an fp32 tile
// in shared memory to 2-byte stores with one block reduction per 32
// channels. This one:
// * is persistent: as many blocks as stay resident on the card, each walking
//   groups blockIdx.x, + gridDim.x, …; every group is computed by one block
//   in a fixed order, so the result does not depend on the grid;
// * stages the nine taps' weights once a block, from the [3, 3, co, ci]
//   copy that models/unet.py::prepare_params makes beside the HWIO `wq`
//   (K contiguous, as the B operand of mma.sync.m16n8k32.s8 wants), by
//   cp.async: 13.8 / 46 / 97 KB at C = 32 / 64 / 96;
// * stages a group's raw input halo (and in bf16 its residual's) by
//   cp.async, and issues the next group's as soon as the prologue has read
//   this one's, so that it lands while this group's requant, MMAs and
//   epilogue run;
// * gives each thread one fixed 8-channel slice of the halo (256 threads
//   at C = 32 and 64, 384 at C = 96, where 256 is no multiple of the 12
//   slices), so the GroupNorm scale and shift are read once a group, and
//   loads every item of its slice before the arithmetic; the prologue's
//   bf16 result stays in registers across the group's one amax reduction
//   and is requantised from there into the int8 halo ([180][C + 16]: the
//   pad keeps ldmatrix rows in distinct banks) — one pass over shared
//   memory, not two;
// * reads A (positions × ci) and B (co × ci) fragments with ldmatrix; warp
//   (wm, wn) owns MT output rows × output channels 32·wn … (C = 32: one
//   row, else two);
// * dequantises in registers, float(acc)·(s_q·w_scale[co]) then + add with
//   no fused multiply-add (the twin's two roundings), and stores each
//   lane's channel pairs as the fragments hold them (a quad writes 16
//   contiguous bytes of bf16): the quad transpose of the float kernels
//   would cost more arithmetic than it saves in stores here, where the
//   per-value work is what bounds the kernel; the statistics reduce over
//   the quad columns by shuffles and over the warps through the block
//   scratch once a group, in a fixed order.
// The prologue's affine is a multiply then an add, each rounded, as the
// twin computes them; both SiLUs take the fast exponential and division
// (silu_fast), whose few-ulp differences from the twin's rarely move a
// value across a bf16 rounding or quantisation boundary.
#include "conv_mma.cuh"

namespace ddim {

constexpr int kHwQ = kFtQ + 2;  // kTtQ, kFtQ, kHaloQ: conv_plan.h

// Resident blocks an SM that the kernel's registers are bounded for: 3 at
// C = 32 (85 registers; bounded for 4, ptxas spills), 2 at C = 64, 1 at
// C = 96 (what their shared memory allows: 108 and 189 KB a block).
__host__ __device__ constexpr int int8_min_blocks(int c) {
  return c == 32 ? 3 : c == 64 ? 2 : 1;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint4 pack8_bf16(const Vec8& v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(v.v[2 * k], v.v[2 * k + 1]);
  return raw;
}

template <typename T, int C>
__global__ void __launch_bounds__(conv3x3_int8_threads(C), int8_min_blocks(C))
    conv3x3_int8_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const float* __restrict__ pre_scale,
                        const float* __restrict__ pre_shift,
                        const int8_t* __restrict__ wq_t,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ add, T* __restrict__ out,
                        float* __restrict__ stats, int batch, int t_len,
                        int f_len, int pre_silu, int post_silu) {
  using B16 = __nv_bfloat16;
  constexpr int kT = conv3x3_int8_threads(C), kW = kT / 32;
  constexpr int WN = conv3x3_int8_warps_n(C), WM = kW / WN;
  constexpr int MT = kTtQ * kFtQ / (16 * WM);  // output rows a warp
  constexpr int QP = int8_pitch(C);
  constexpr int CQ = C / 8;      // 8-channel slices a position
  constexpr int kPS = kT / CQ;   // positions a sweep of the block
  constexpr int kItems = (kHaloQ + kPS - 1) / kPS;
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr bool kResSmem = sizeof(T) == 2;
  static_assert(C % 32 == 0 && C <= 96, "int8 taps: C in {32, 64, 96}");
  static_assert(kT % CQ == 0 && 16 * MT * WM == kTtQ * kFtQ,
                "a thread keeps one channel slice; warps cover the group");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);     // [9][C co][QP]
  int8_t* qbuf = wbuf + 9 * C * QP;                   // [180][QP]
  T* raw = reinterpret_cast<T*>(qbuf + kHaloQ * QP);  // [180][C]
  T* rawr = raw + kHaloQ * C;  // [180][C] residual (bf16; fp32: unused)
  float* red = reinterpret_cast<float*>(qbuf + kHaloQ * QP +
                                        kHaloQ * C * 4);  // [WM][2][C]
  float* red_amax = red + WM * 2 * C;  // [kW]

  const int tiles_f = (f_len + kFtQ - 1) / kFtQ;
  const int tiles = ((t_len + kTtQ - 1) / kTtQ) * tiles_f;
  const int n_groups = batch * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  // the prologue's channel slice and first halo position of this thread
  const int ch = 8 * (threadIdx.x % CQ), p0 = threadIdx.x / CQ;
  const bool stage_res = kResSmem && res != nullptr;

  // The nine taps' weights, once for the block's lifetime.
  for (int i = threadIdx.x; i < 9 * C * (C / 16); i += kT) {
    const int r = i / (C / 16), q = i % (C / 16);
    cp_async16(wbuf + r * QP + 16 * q, wq_t + (size_t)r * C + 16 * q);
  }
  auto load_raw = [&](int grp) {
    const int b = grp / tiles, tile = grp % tiles;
    const int t0 = (tile / tiles_f) * kTtQ, f0 = (tile % tiles_f) * kFtQ;
    const size_t xb = (size_t)b * t_len * f_len * C;
    for (int i = threadIdx.x; i < kHaloQ * (C / V); i += kT) {
      const int hp = i / (C / V), q = i % (C / V);
      const int t = t0 - 1 + hp / kHwQ, f = f0 - 1 + hp % kHwQ;
      const bool inside = t >= 0 && t < t_len && f >= 0 && f < f_len;
      const size_t off = inside ? xb + ((size_t)t * f_len + f) * C + V * q : 0;
      cp_async16_zfill(raw + hp * C + V * q, x + off, inside);
      if (stage_res) cp_async16_zfill(rawr + hp * C + V * q, res + off, inside);
    }
  };
  if (blockIdx.x < n_groups) load_raw(blockIdx.x);
  cp_async_commit();

  // lane's ldmatrix rows: A at an output position's halo row (tap (0, 0)),
  // k half lane / 16; B at output channel (m / 2)·8 + lane % 8 of the pair
  // of n8 tiles, k half m % 2 (m = lane / 8)
  uint32_t a_base[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = wm * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(qbuf + ((p / kFtQ) * kHwQ + p % kFtQ) * QP +
                          (lane >> 4) * 16);
  }
  const int m = lane >> 3;
  const uint32_t b_base = smem_u32(
      wbuf + (wn * 32 + (m >> 1) * 8 + (lane & 7)) * QP + (m & 1) * 16);
  // the epilogue's output channels of this lane: cb + 8·nt + {0, 1} of the
  // four n8 tiles (value k = 2·nt + e)
  const int cb = wn * 32 + 2 * tig;

#pragma unroll 1
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int b = grp / tiles, tile = grp % tiles;
    const int t0 = (tile / tiles_f) * kTtQ, f0 = (tile % tiles_f) * kFtQ;
    const size_t xb = (size_t)b * t_len * f_len * C;
    Vec8 sc{}, sh{};
    if (pre_scale != nullptr) {
      sc = load8(pre_scale + b * C + ch);
      sh = load8(pre_shift + b * C + ch);
    }
    cp_async_wait<0>();
    __syncthreads();  // the raw halo (and, the first time, the weights)

    // 1. The prologue on the staged halo, rounded to bf16 and kept in
    // registers, with the running max|v|. Every item's 16-byte words are
    // loaded before the arithmetic; the staged values outside the array
    // are zero, and zeroed again after the prologue.
    Raw8<T> xr[kItems], rr[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int hp = min(p0 + u * kPS, kHaloQ - 1);
      xr[u] = Raw8<T>::load(raw + hp * C + ch);
      if (res != nullptr) {
        if (kResSmem) {
          rr[u] = Raw8<T>::load(rawr + hp * C + ch);
        } else {  // fp32: from global memory, at a clamped address
          const int t = min(max(t0 - 1 + hp / kHwQ, 0), t_len - 1);
          const int f = min(max(f0 - 1 + hp % kHwQ, 0), f_len - 1);
          rr[u] = Raw8<T>::load(res + xb + ((size_t)t * f_len + f) * C + ch);
        }
      }
    }
    uint4 vq[kItems];
    float am = 0.f;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int hp = p0 + u * kPS;
      const int t = t0 - 1 + hp / kHwQ, f = f0 - 1 + hp % kHwQ;
      const bool inside = hp < kHaloQ && t >= 0 && t < t_len && f >= 0 &&
                          f < f_len;
      Vec8 v = res != nullptr ? xr[u].plus(rr[u]) : xr[u].vec();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float e = v.v[k];
        if (pre_scale != nullptr) e = __fadd_rn(__fmul_rn(e, sc.v[k]), sh.v[k]);
        if (pre_silu) e = silu_fast(e);
        e = inside ? e : 0.f;
        am = fmaxf(am, fabsf(e));
        v.v[k] = e;
      }
      vq[u] = pack8_bf16(v);
    }
    // one block reduction a group; rounding is monotonic and symmetric:
    // max|bf16(v)| = bf16(max|v|)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    if (lane == 0) red_amax[warp] = am;
    __syncthreads();  // also: every thread has read the raw halo
    am = red_amax[0];
#pragma unroll
    for (int k = 1; k < kW; ++k) am = fmaxf(am, red_amax[k]);
    const float amax = fmaxf(round_to<B16>(am), 1e-30f);
    const float inv = 127.0f / amax;
    const float s_q = amax * (1.0f / 127.0f);

    // The next group's raw halo lands while this one computes.
    if (grp + gridDim.x < n_groups) load_raw(grp + gridDim.x);
    cp_async_commit();

    // 2. Requantise from the registers into the int8 halo.
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int hp = p0 + u * kPS;
      if (hp < kHaloQ) {
        const Vec8 v = unpack8(vq[u]);
        *reinterpret_cast<uint2*>(qbuf + hp * QP + ch) =
            make_uint2(quant4(v.v, inv), quant4(v.v + 4, inv));
      }
    }
    __syncthreads();  // the int8 halo is complete

    // 3. The taps: mma.sync.m16n8k32 s8 → s32, fragments by ldmatrix; a
    // warp owns MT output rows × 32 channels.
    int acc[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, df = tap % 3;
#pragma unroll
      for (int kc = 0; kc < C / 32; ++kc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], a_base[mt] + (dt * kHwQ + df) * QP + kc * 32);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, b_base + (tap * C + np * 16) * QP + kc * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8(acc[mt][2 * np], a[mt], bb[0], bb[1]);
            mma_s8(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }

    // 4. Dequantise, add, SiLU, statistics and stores from the registers,
    // as the mma.sync fragments hold them: lane (gid, tig) has channels
    // cb + 8·nt + {0, 1} of rows gid and gid + 8 of each m16 tile, stored
    // as pairs (a quad writes 16 contiguous bytes of bf16).
    // (w_scale and add are read where they are used, from L1, which keeps
    // the registers of the C = 32 kernel under its bound)
    float s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = wm * 16 * MT + mt * 16 + gid + 8 * r;
        const int t = t0 + p / kFtQ, f = f0 + p % kFtQ;
        if (t < t_len && f < f_len) {
          T* dst = out + xb + ((size_t)t * f_len + f) * C + cb;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 2 * nt + e, c = cb + 8 * nt + e;
              float o = __fmul_rn((float)acc[mt][nt][2 * r + e],
                                  s_q * __ldg(w_scale + c));
              if (add != nullptr) o = __fadd_rn(o, __ldg(add + b * C + c));
              if (post_silu) o = silu_fast(o);
              s1[k] += o;
              s2[k] += o * o;
              v[e] = o;
            }
            store2(dst + 8 * nt, v[0], v[1]);
          }
        }
      }
    if (stats != nullptr) {
      sum_over_gid(s1);
      sum_over_gid(s2);
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cb + 8 * (k >> 1) + (k & 1);
          red[(wm * 2) * C + c] = s1[k];
          red[(wm * 2 + 1) * C + c] = s2[k];
        }
      }
      finish_group_stats(red, WM, C,
                         stats + ((size_t)b * tiles + tile) * 2 * C, C);
    }
  }
}

template <typename T, int C>
cudaError_t launch_int8(const void* x, const void* res, const float* pre_scale,
                        const float* pre_shift, const int8_t* wq_t,
                        const float* w_scale, const float* add, void* out,
                        float* stats, int batch, int t_len, int f_len,
                        int pre_silu, int post_silu, cudaStream_t s) {
  constexpr int kBytes = conv3x3_int8_smem(C, sizeof(T) == 2);
  constexpr int kT = conv3x3_int8_threads(C);
  // resident blocks × SMs, once per instantiation; one card per process
  static bool raised = false;
  static int grid_cap = 0;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_int8_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv3x3_int8_kernel<T, C>, kT, kBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_cap = per_sm * sms;
  }
  const int n_groups =
      batch * ((t_len + kTtQ - 1) / kTtQ) * ((f_len + kFtQ - 1) / kFtQ);
  if (n_groups == 0) return cudaSuccess;
  const int grid = n_groups < grid_cap ? n_groups : grid_cap;
  conv3x3_int8_kernel<T, C><<<grid, kT, kBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
      pre_shift, wq_t, w_scale, add, static_cast<T*>(out), stats, batch,
      t_len, f_len, pre_silu, post_silu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_int8(int c, const void* x, const void* res,
                          const float* pre_scale, const float* pre_shift,
                          const int8_t* wq_t, const float* w_scale,
                          const float* add, void* out, float* stats, int batch,
                          int t_len, int f_len, int pre_silu, int post_silu,
                          cudaStream_t s) {
  switch (c) {
    case 32:
      return launch_int8<T, 32>(x, res, pre_scale, pre_shift, wq_t, w_scale,
                                add, out, stats, batch, t_len, f_len,
                                pre_silu, post_silu, s);
    case 64:
      return launch_int8<T, 64>(x, res, pre_scale, pre_shift, wq_t, w_scale,
                                add, out, stats, batch, t_len, f_len,
                                pre_silu, post_silu, s);
    case 96:
      return launch_int8<T, 96>(x, res, pre_scale, pre_shift, wq_t, w_scale,
                                add, out, stats, batch, t_len, f_len,
                                pre_silu, post_silu, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ddim

extern "C" {

// The quantisation group of ddim_conv3x3_int8: i = 0, 1 → tile rows, columns;
// i = 2, 3 → halo rows, columns staged around the tile.
int ddim_conv3x3_int8_geometry(int i) {
  const int g[4] = {ddim::kTtQ, ddim::kFtQ, 1, 1};
  return i >= 0 && i < 4 ? g[i] : -1;
}

// Spatial tiles (quantisation groups) per sample: the partials' second
// dimension (ddim_conv3x3_int8_plan: conv_plan.cu).
int ddim_conv3x3_int8_tiles(int t_len, int f_len) {
  return ddim::conv3x3_int8_plan(t_len, f_len, 32, 1, 1).tiles;
}

// x, res, out: [B, T, F, C] (fp32 or bf16, as `bf16` says); wq_t: [3, 3, C,
// C] int8 laid out [dt, df, co, ci] (the HWIO int8 weights with the last two
// axes swapped); w_scale: [C] fp32; pre_scale, pre_shift, add: [B, C] fp32;
// stats: [B, ddim_conv3x3_int8_tiles(...), 2, C] fp32. res, pre_*, add and
// stats may be null; every pointer is 16-byte aligned. C in {32, 64, 96}.
int ddim_conv3x3_int8(const void* x, const void* res, const float* pre_scale,
                      const float* pre_shift, const void* wq_t,
                      const float* w_scale, const float* add, void* out,
                      float* stats, int batch, int t_len, int f_len, int c,
                      int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq_t);
  const cudaError_t err =
      bf16 ? dispatch_int8<__nv_bfloat16>(c, x, res, pre_scale, pre_shift, w8,
                                          w_scale, add, out, stats, batch,
                                          t_len, f_len, pre_silu, post_silu, s)
           : dispatch_int8<float>(c, x, res, pre_scale, pre_shift, w8, w_scale,
                                  add, out, stats, batch, t_len, f_len,
                                  pre_silu, post_silu, s);
  return static_cast<int>(err);
}

}  // extern "C"
