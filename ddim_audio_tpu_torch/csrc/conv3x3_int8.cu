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
// The quantisation group is what one thread block stages: the halo tile of
// its 8 rows × 16 columns (10 × 18 positions, clipped to the array) over all
// C input channels. ddim_conv3x3_int8_geometry reports it; the plain twin
// takes the same group as arguments.
//
// Design. A block computes all C output channels of its 128 positions, so the
// prologue (which bounds the float kernel, see conv3x3.cu) runs once per
// position instead of once per 32-channel output slice. C ∈ {32, 64, 96}:
// 1. stage the prologue result as bf16 [180][C] with the running |v| max;
//    one block reduction gives amax;
// 2. requantise into int8 [180][C + 16] (the 16-byte pad makes the fragment
//    reads below conflict-free);
// 3. per tap row dt, stage the three taps' weights over the now free bf16
//    buffer, transposed to [co][ci] in 4×4-byte register blocks, because
//    `mma.sync.m16n8k32.s8` wants K contiguous in both operands and HWIO has
//    co contiguous; warp w owns time row w (M = 16 positions) and runs
//    C/32 · C/8 MMAs per tap with plain 32-bit shared-memory fragment loads;
// 4. dequantise into an fp32 [128][C + 8] tile over the same shared memory
//    and run the float kernel's epilogue with lane = output channel.
// What bounds it on an H100 is still the staging pass plus the requant pass,
// not the int8 MMAs (9·C² MACs per position at 1,979 TOP/s) and not HBM.
#include "conv_common.cuh"

namespace ddim {

constexpr int kTtQ = 8, kFtQ = 16;  // output tile = quantisation group
constexpr int kHwQ = kFtQ + 2;
constexpr int kHaloQ = (kTtQ + 2) * kHwQ;

__host__ __device__ constexpr int int8_pitch(int c) { return c + 16; }
__host__ __device__ constexpr int int8_acc_pitch(int c) { return c + 8; }
__host__ __device__ constexpr int int8_stage_bytes(int c) {
  return kHaloQ * c * 2;
}
__host__ __device__ constexpr int int8_smem_bytes(int c) {
  const int a = int8_stage_bytes(c) + kHaloQ * int8_pitch(c);
  const int b = kTtQ * kFtQ * int8_acc_pitch(c) * 4;
  return a > b ? a : b;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) conv3x3_int8_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const int8_t* __restrict__ wq, const float* __restrict__ w_scale,
    const float* __restrict__ add, T* __restrict__ out,
    float* __restrict__ stats, int t_len, int f_len, int pre_silu,
    int post_silu) {
  using B16 = __nv_bfloat16;
  constexpr int kPitch = int8_pitch(C);
  constexpr int kAccPitch = int8_acc_pitch(C);
  static_assert(C % 32 == 0 && C <= 96, "int8 taps: C in {32, 64, 96}");
  static_assert(3 * C * kPitch <= int8_stage_bytes(C),
                "a tap row's weights must fit the freed staging buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  B16* sbuf = reinterpret_cast<B16*>(smem);          // [180][C] bf16
  unsigned char* wbuf = smem;                        // [3][C co][kPitch]
  unsigned char* qbuf = smem + int8_stage_bytes(C);  // [180][kPitch] int8
  float* accs = reinterpret_cast<float*>(smem);      // [128][kAccPitch]
  __shared__ float red[2 * kThreads];

  const int b = blockIdx.y;
  const int tiles_f = (f_len + kFtQ - 1) / kFtQ;
  const int t0 = (blockIdx.x / tiles_f) * kTtQ;
  const int f0 = (blockIdx.x % tiles_f) * kFtQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_len * f_len * C;

  // 1. Stage the prologue result as bf16, tracking max|v|.
  float am = 0.f;
  for (int idx = threadIdx.x; idx < kHaloQ * C / 8; idx += kThreads) {
    const int q = idx % (C / 8), hp = idx / (C / 8);
    const int t = t0 + hp / kHwQ - 1, f = f0 + hp % kHwQ - 1;
    const int ch = 8 * q;
    Vec8 v;
    if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
      const size_t off = xb + ((size_t)t * f_len + f) * C + ch;
      v = load8(x + off);
      if (res != nullptr) {
        const Vec8 r = load8(res + off);
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = round_to<T>(v.v[k] + r.v[k]);
      }
      if (pre_scale != nullptr) {
        const Vec8 sc = load8(pre_scale + b * C + ch);
        const Vec8 sh = load8(pre_shift + b * C + ch);
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = v.v[k] * sc.v[k] + sh.v[k];
      }
      if (pre_silu) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = silu(v.v[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) am = fmaxf(am, fabsf(v.v[k]));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v.v[k] = 0.f;
    }
    store8(sbuf + hp * C + ch, v);
  }
  // rounding is monotonic and symmetric: max|bf16(v)| = bf16(max|v|)
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, m));
  if (lane == 0) red[warp] = am;
  __syncthreads();
  am = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) am = fmaxf(am, red[k]);
  const float amax = fmaxf(round_to<B16>(am), 1e-30f);
  const float inv = 127.0f / amax;
  const float s_q = amax * (1.0f / 127.0f);

  // 2. Requantise the staged tile.
  for (int idx = threadIdx.x; idx < kHaloQ * C / 8; idx += kThreads) {
    const int q = idx % (C / 8), hp = idx / (C / 8);
    const Vec8 v = load8(sbuf + hp * C + 8 * q);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= (uint32_t)(quant1(v.v[k], inv) & 0xff) << (8 * k);
      hi |= (uint32_t)(quant1(v.v[4 + k], inv) & 0xff) << (8 * k);
    }
    *reinterpret_cast<uint2*>(qbuf + hp * kPitch + 8 * q) = make_uint2(lo, hi);
  }

  // 3. Taps on the tensor cores, one tap row's weights at a time.
  int acc[C / 8][4];
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0;

#pragma unroll 1
  for (int dt = 0; dt < 3; ++dt) {
    __syncthreads();  // requant done (dt = 0) / previous tap row consumed
    // 4×4-byte blocks: 8 consecutive threads read 32 contiguous bytes of a
    // weight row (co), the next threads move along ci
    for (int idx = threadIdx.x; idx < 3 * (C / 4) * (C / 4); idx += kThreads) {
      const int co_lo = idx % 8;
      int r = idx / 8;
      const int ci4 = r % (C / 4);
      r /= (C / 4);
      const int co_hi = r % (C / 32), df = r / (C / 32);
      const int co = (co_hi * 8 + co_lo) * 4, ci = ci4 * 4;
      const int8_t* src = wq + ((size_t)((dt * 3 + df) * C + ci)) * C + co;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + C);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * C);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * C);
      const uint32_t t0w = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1w = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2w = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3w = __byte_perm(r2, r3, 0x7362);
      unsigned char* dst = wbuf + (df * C + co) * kPitch + ci;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0w, t1w, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kPitch) = __byte_perm(t0w, t1w, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kPitch) =
          __byte_perm(t2w, t3w, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kPitch) =
          __byte_perm(t2w, t3w, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int df = 0; df < 3; ++df) {
      const unsigned char* arow =
          qbuf + ((warp + dt) * kHwQ + df + gid) * kPitch + tig * 4;
#pragma unroll
      for (int kc = 0; kc < C / 32; ++kc) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(arow + kc * 32);
        a[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * kPitch + kc * 32);
        a[2] = *reinterpret_cast<const uint32_t*>(arow + kc * 32 + 16);
        a[3] =
            *reinterpret_cast<const uint32_t*>(arow + 8 * kPitch + kc * 32 + 16);
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
          const unsigned char* brow =
              wbuf + (df * C + nt * 8 + gid) * kPitch + kc * 32 + tig * 4;
          mma_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(brow),
                 *reinterpret_cast<const uint32_t*>(brow + 16));
        }
      }
    }
  }
  __syncthreads();  // every warp is done with qbuf / wbuf

  // 4. Dequantise into the fp32 tile (each warp writes and reads its own
  // 16 rows), then the float kernel's epilogue.
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    const float sc0 = s_q * w_scale[col], sc1 = s_q * w_scale[col + 1];
    float* r0 = accs + (warp * 16 + gid) * kAccPitch + col;
    *reinterpret_cast<float2*>(r0) =
        make_float2((float)acc[nt][0] * sc0, (float)acc[nt][1] * sc1);
    *reinterpret_cast<float2*>(r0 + 8 * kAccPitch) =
        make_float2((float)acc[nt][2] * sc0, (float)acc[nt][3] * sc1);
  }
  __syncwarp();

  const int t = t0 + warp;
#pragma unroll 1
  for (int g = 0; g < C / 32; ++g) {
    const int co = g * 32 + lane;
    float s1 = 0.f, s2 = 0.f;
    const float av = add != nullptr ? add[b * C + co] : 0.f;
#pragma unroll 4
    for (int i = 0; i < kFtQ; ++i) {
      const int f = f0 + i;
      if (t < t_len && f < f_len) {
        float o = accs[(warp * 16 + i) * kAccPitch + co] + av;
        if (post_silu) o = silu(o);
        s1 += o;
        s2 += o * o;
        out[xb + ((size_t)t * f_len + f) * C + co] = from_f<T>(o);
      }
    }
    if (stats != nullptr) {
      if (g) __syncthreads();  // the previous group's partials were read
      float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
      block_stats(s1, s2, red, dst, co, C);
    }
  }
}

template <typename T, int C>
cudaError_t launch_int8(const void* x, const void* res, const float* pre_scale,
                        const float* pre_shift, const int8_t* wq,
                        const float* w_scale, const float* add, void* out,
                        float* stats, int batch, int t_len, int f_len,
                        int pre_silu, int post_silu, cudaStream_t s) {
  constexpr int kBytes = int8_smem_bytes(C);
  static bool raised = false;  // per instantiation; one card per process
  if (kBytes > 48 * 1024 && !raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_int8_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid(((t_len + kTtQ - 1) / kTtQ) * ((f_len + kFtQ - 1) / kFtQ),
                  batch);
  conv3x3_int8_kernel<T, C><<<grid, kThreads, kBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
      pre_shift, wq, w_scale, add, static_cast<T*>(out), stats, t_len, f_len,
      pre_silu, post_silu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_int8(int c, const void* x, const void* res,
                          const float* pre_scale, const float* pre_shift,
                          const int8_t* wq, const float* w_scale,
                          const float* add, void* out, float* stats, int batch,
                          int t_len, int f_len, int pre_silu, int post_silu,
                          cudaStream_t s) {
  switch (c) {
    case 32:
      return launch_int8<T, 32>(x, res, pre_scale, pre_shift, wq, w_scale, add,
                                out, stats, batch, t_len, f_len, pre_silu,
                                post_silu, s);
    case 64:
      return launch_int8<T, 64>(x, res, pre_scale, pre_shift, wq, w_scale, add,
                                out, stats, batch, t_len, f_len, pre_silu,
                                post_silu, s);
    case 96:
      return launch_int8<T, 96>(x, res, pre_scale, pre_shift, wq, w_scale, add,
                                out, stats, batch, t_len, f_len, pre_silu,
                                post_silu, s);
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

// Spatial tiles per sample (the partials' second dimension).
int ddim_conv3x3_int8_tiles(int t_len, int f_len) {
  return ((t_len + ddim::kTtQ - 1) / ddim::kTtQ) *
         ((f_len + ddim::kFtQ - 1) / ddim::kFtQ);
}

// x, res, out: [B, T, F, C] (fp32 or bf16, as `bf16` says); wq: [3, 3, C, C]
// int8 HWIO; w_scale: [C] fp32; pre_scale, pre_shift, add: [B, C] fp32;
// stats: [B, ddim_conv3x3_int8_tiles(...), 2, C] fp32. res, pre_*, add and
// stats may be null; every pointer is 16-byte aligned. C in {32, 64, 96}.
int ddim_conv3x3_int8(const void* x, const void* res, const float* pre_scale,
                      const float* pre_shift, const void* wq,
                      const float* w_scale, const float* add, void* out,
                      float* stats, int batch, int t_len, int f_len, int c,
                      int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
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
