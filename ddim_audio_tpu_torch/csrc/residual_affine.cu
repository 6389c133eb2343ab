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
// amax · (1/127).
//
// Design. An elementwise pass with a per-group reduction: one block owns one
// storage group tile (kTtS × kFtS positions × 32 channels, conv_plan.h),
// warp w its time row w and lane l channel c0 + l; each thread keeps its 16
// results in registers, the group amax is one shared-memory reduction, and
// the statistics are per-block partials that the wrapper finishes with
// torch.sum. What bounds it on an H100 is the bytes it moves (at most one
// read of each operand and one write of the result, 1-2 bytes a value); a
// lane per channel makes each warp access 32-64 contiguous bytes, which is
// what keeps this first version off that bound.
#include "conv_common.cuh"

namespace ddim {

// Operand kinds: 0 fp32, 1 bf16, 2 int8.
__device__ __forceinline__ float load1(const void* p, int kind, size_t off) {
  if (kind == 0) return static_cast<const float*>(p)[off];
  if (kind == 1) return to_f(static_cast<const __nv_bfloat16*>(p)[off]);
  return (float)static_cast<const int8_t*>(p)[off];
}

__global__ void __launch_bounds__(kThreads) residual_affine_kernel(
    const void* __restrict__ x, const float* __restrict__ x_scales,
    const void* __restrict__ s, const float* __restrict__ s_scales,
    const float* __restrict__ scale, const float* __restrict__ shift,
    void* __restrict__ out, float* __restrict__ out_scales,
    float* __restrict__ stats, int t_len, int f_len, int c, int x_kind,
    int s_kind, int out_kind) {
  __shared__ float red[2 * kThreads];
  const int b = blockIdx.y;
  const int tiles_f = (f_len + kFtS - 1) / kFtS;
  const int t0 = (blockIdx.x / tiles_f) * kTtS;
  const int f0 = (blockIdx.x % tiles_f) * kFtS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = blockIdx.z * kCoTile + lane;
  const int t = t0 + warp;
  const float sc = scale != nullptr ? scale[b * c + co] : 0.f;
  const float sh = shift != nullptr ? shift[b * c + co] : 0.f;
  // every position of the thread shares its storage group
  const size_t g = group_offset(b, t0, f0, co, t_len, f_len, c);
  const float xs = x_kind == 2 ? x_scales[g] : 1.f;
  const float ss = s_kind == 2 ? s_scales[g] : 1.f;
  const size_t row = ((size_t)b * t_len + t) * f_len;

  float o[kFtS];
  float s1 = 0.f, s2 = 0.f, am = 0.f;
#pragma unroll
  for (int i = 0; i < kFtS; ++i) {
    o[i] = 0.f;
    if (t < t_len && f0 + i < f_len) {
      const size_t off = (row + f0 + i) * c + co;
      float v = load1(x, x_kind, off), sv = load1(s, s_kind, off);
      if (x_kind == 2) v = __fmul_rn(v, xs);
      if (s_kind == 2) sv = __fmul_rn(sv, ss);
      const float r = scale != nullptr
                          ? __fadd_rn(__fadd_rn(v, __fmul_rn(sv, sc)), sh)
                          : __fadd_rn(v, sv);
      o[i] = r;
      s1 += r;
      s2 += r * r;
      am = fmaxf(am, fabsf(r));
    }
  }
  if (out_kind == 2) {
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
    if (warp == 0) out_scales[g] = amax * (1.0f / 127.0f);
    __syncthreads();  // red is reused below
  } else {
#pragma unroll
    for (int i = 0; i < kFtS; ++i) {
      if (t >= t_len || f0 + i >= f_len) continue;
      const size_t off = (row + f0 + i) * c + co;
      if (out_kind == 0)
        static_cast<float*>(out)[off] = o[i];
      else
        static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(o[i]);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

}  // namespace ddim

extern "C" {

// x, s, out: [B, T, F, C] of kind x_kind / s_kind / out_kind (0 fp32, 1 bf16,
// 2 int8); an int8 x or s comes with its scales [B, ceil(T/8), ceil(F/16), C]
// fp32, an int8 out (quantised) writes out_scales of that shape; scale,
// shift: [B, C] fp32 or both null; stats: [B, ddim_residual_affine_tiles(...),
// 2, C] fp32 or null. C % 32 == 0.
int ddim_residual_affine(const void* x, const float* x_scales, const void* s,
                         const float* s_scales, const float* scale,
                         const float* shift, void* out, float* out_scales,
                         float* stats, int batch, int t_len, int f_len, int c,
                         int x_kind, int s_kind, int out_kind, void* stream) {
  using namespace ddim;
  if (c % kCoTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(residual_affine_tiles(t_len, f_len), batch, c / kCoTile);
  residual_affine_kernel<<<grid, kThreads, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      x, x_scales, s, s_scales, scale, shift, out, out_scales, stats, t_len,
      f_len, c, x_kind, s_kind, out_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
