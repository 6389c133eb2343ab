// The U-Net's channel-asymmetric 3×3 SAME convs over channels-last
// activations, read and written in the state's own unpadded layout:
//
// head  out[b,t,f,co] = bias[co] + Σ_{dt,df,ci} x[b,t+dt−1,f+df−1,ci] · w[dt,df,ci,co]
//       Cin (2 for stereo audio) → C0 (32), zero padding, fp32 accumulation,
//       output rounded to the storage dtype, and per-block partial
//       (sum, sum²) of the fp32 output per channel (the first GroupNorm's
//       statistics). Replaces ddim_audio_tpu/ops/pallas/conv_head_tail.py
//       `_head_kernel` (wrapper `conv_head_flat`).
//
// tail  v = h + residual (summed in fp32, rounded to the storage dtype)
//       out[b,t,f,co] = bias[co] + Σ_{dt,df,ci} v[b,t+dt−1,f+df−1,ci] · w[dt,df,ci,co]
//       C0 → Cout (2), no statistics. Replaces conv_head_tail.py
//       `_tail_kernel` (wrapper `conv_tail_flat`).
//
// What bounds them on an H100: bytes. The head writes 16× what it reads and
// the tail reads 32× what it writes (two C0-wide streams); the arithmetic
// (K = 9·Cin = 18 for the head, N = Cout = 2 for the tail) is far too thin
// for an MMA shape, so both run on CUDA cores:
//
// - head: the block shape of conv3x3.cu's CUDA-core variant (64 positions ×
//   32 output channels, lane = output channel, 8 positions per thread); all
//   9·Cin·32 weights and the Cin-wide halo sit in shared memory, so the only
//   HBM traffic is the input halo and the 64-byte-per-position output rows.
// - tail: a block owns 8 rows × 16 columns; the summed, rounded halo tile is
//   staged once per 32-channel chunk as fp32 [180][32]. Warp w owns row w:
//   lane = input channel, the 9·Cout weights of the lane's channel live in
//   registers, every position is 9 conflict-free shared-memory reads and
//   9·Cout FMAs per lane, and one butterfly reduction per (position, output
//   channel) finishes the K = 288 sum. The 16·Cout results of a row are
//   contiguous in memory and leave as one coalesced store.
#include "conv_common.cuh"

namespace ddim {

constexpr int kHeadMaxCin = 4;    // input channels of the head kernel, at most
constexpr int kHeadHalo = 6 * 18; // max (TT+2)·(FT+2) over the two tile shapes

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ stats, int t_len, int f_len, int c_in,
                     int c0) {
  __shared__ float xs[kHeadHalo * kHeadMaxCin];
  __shared__ float ws[9 * kHeadMaxCin * kCoTile];
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
  const size_t pb = (size_t)b * t_len * f_len;

  for (int idx = threadIdx.x; idx < hn * c_in; idx += kThreads) {
    const int ci = idx % c_in, hp = idx / c_in;
    const int t = t0 + hp / hw - 1, f = f0 + hp % hw - 1;
    float v = 0.f;
    if (t >= 0 && t < t_len && f >= 0 && f < f_len)
      v = to_f(x[(pb + (size_t)t * f_len + f) * c_in + ci]);
    xs[hp * kHeadMaxCin + ci] = v;
  }
  // ws[tap·Cin + ci][lane] from HWIO [3, 3, Cin, C0]
  for (int idx = threadIdx.x; idx < 9 * c_in * kCoTile; idx += kThreads) {
    const int l = idx % kCoTile, r = idx / kCoTile;
    ws[idx] = co0 + l < c0 ? to_f(w[(size_t)r * c0 + co0 + l]) : 0.f;
  }
  __syncthreads();

  float acc[kPosPerThread];
  int base[kPosPerThread];
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    acc[i] = 0.f;
    base[i] = ((p / ft) * hw + p % ft) * kHeadMaxCin;
  }
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * hw + tap % 3) * kHeadMaxCin;
    for (int ci = 0; ci < c_in; ++ci) {
      const float wv = ws[(tap * c_in + ci) * kCoTile + lane];
#pragma unroll
      for (int i = 0; i < kPosPerThread; ++i)
        acc[i] = fmaf(xs[base[i] + toff + ci], wv, acc[i]);
    }
  }

  float s1 = 0.f, s2 = 0.f;
  const float bv = co < c0 ? bias[co] : 0.f;
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    const int t = t0 + p / ft, f = f0 + p % ft;
    if (t < t_len && f < f_len && co < c0) {
      const float o = acc[i] + bv;
      s1 += o;
      s2 += o * o;
      out[(pb + (size_t)t * f_len + f) * c0 + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c0;
    block_stats(s1, s2, red, dst, co, c0);
  }
}

constexpr int kTailTt = 8, kTailFt = 16;  // 128 positions per block
constexpr int kTailHw = kTailFt + 2;
constexpr int kTailHalo = (kTailTt + 2) * kTailHw;
constexpr int kTailCk = 32;               // input channels per chunk = lanes

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
    conv_tail_kernel(const T* __restrict__ h, const T* __restrict__ res,
                     const T* __restrict__ w, const float* __restrict__ bias,
                     T* __restrict__ out, int t_len, int f_len, int c0) {
  __shared__ __align__(16) float vs[kTailHalo * kTailCk];

  const int b = blockIdx.y;
  const int tiles_f = (f_len + kTailFt - 1) / kTailFt;
  const int t0 = (blockIdx.x / tiles_f) * kTailTt;
  const int f0 = (blockIdx.x % tiles_f) * kTailFt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t pb = (size_t)b * t_len * f_len;

  float acc[kTailFt][COUT];
#pragma unroll
  for (int i = 0; i < kTailFt; ++i)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[i][co] = 0.f;

  for (int c0s = 0; c0s < c0; c0s += kTailCk) {
    if (c0s) __syncthreads();
    // Stage round(h + residual) of this channel chunk, 8 channels per item.
    for (int idx = threadIdx.x; idx < kTailHalo * kTailCk / 8;
         idx += kThreads) {
      const int q = idx % (kTailCk / 8), hp = idx / (kTailCk / 8);
      const int t = t0 + hp / kTailHw - 1, f = f0 + hp % kTailHw - 1;
      Vec8 v;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
        const size_t off = (pb + (size_t)t * f_len + f) * c0 + c0s + 8 * q;
        v = load8(h + off);
        if (res != nullptr) {
          const Vec8 r = load8(res + off);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = round_to<T>(v.v[k] + r.v[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(vs + hp * kTailCk + 8 * q);
      dst[0] = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
      dst[1] = make_float4(v.v[4], v.v[5], v.v[6], v.v[7]);
    }
    // The lane's channel: its 9·COUT weights, HWIO [3, 3, C0, COUT].
    float wr[9][COUT];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int co = 0; co < COUT; ++co)
        wr[tap][co] = to_f(w[((size_t)tap * c0 + c0s + lane) * COUT + co]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kTailFt; ++i) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v =
            vs[((warp + tap / 3) * kTailHw + i + tap % 3) * kTailCk + lane];
#pragma unroll
        for (int co = 0; co < COUT; ++co)
          acc[i][co] = fmaf(v, wr[tap][co], acc[i][co]);
      }
    }
  }

  // Finish the sums over the lanes (channels); every lane gets every total.
#pragma unroll
  for (int i = 0; i < kTailFt; ++i)
#pragma unroll
    for (int co = 0; co < COUT; ++co)
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        acc[i][co] += __shfl_xor_sync(0xffffffffu, acc[i][co], m);

  // The row's 16·COUT results are contiguous in memory ((f, co), co minor):
  // lane l of round r stores element r·32 + l.
  const int t = t0 + warp;
  if (t >= t_len) return;
  constexpr int kRounds = (kTailFt * COUT + 31) / 32;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = r * 32 + lane;
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < kTailFt; ++i)
#pragma unroll
      for (int co = 0; co < COUT; ++co)
        if (e == i * COUT + co) mine = acc[i][co];
    const int f = f0 + e / COUT;
    if (e < kTailFt * COUT && f < f_len)
      out[(pb + (size_t)t * f_len + f0) * COUT + e] =
          from_f<T>(mine + bias[e % COUT]);
  }
}

template <typename T>
cudaError_t launch_tail(const void* h, const void* res, const void* w,
                        const float* bias, void* out, int batch, int t_len,
                        int f_len, int c0, int c_out, cudaStream_t s) {
  const dim3 grid(((t_len + kTailTt - 1) / kTailTt) *
                      ((f_len + kTailFt - 1) / kTailFt),
                  batch);
  const T* hp = static_cast<const T*>(h);
  const T* rp = static_cast<const T*>(res);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (c_out) {
    case 1:
      conv_tail_kernel<T, 1><<<grid, kThreads, 0, s>>>(hp, rp, wp, bias, op,
                                                       t_len, f_len, c0);
      break;
    case 2:
      conv_tail_kernel<T, 2><<<grid, kThreads, 0, s>>>(hp, rp, wp, bias, op,
                                                       t_len, f_len, c0);
      break;
    case 4:
      conv_tail_kernel<T, 4><<<grid, kThreads, 0, s>>>(hp, rp, wp, bias, op,
                                                       t_len, f_len, c0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace ddim

extern "C" {

// Spatial tiles per sample of the head kernel (the partials' second dimension).
int ddim_conv_head_tiles(int t_len, int f_len) {
  return ddim::num_tiles(t_len, f_len);
}

// x: [B, T, F, Cin], out: [B, T, F, C0] (fp32 or bf16, as `bf16` says);
// w: [3, 3, Cin, C0] in the same dtype; bias: [C0] fp32; stats:
// [B, ddim_conv_head_tiles(...), 2, C0] fp32 or null. Cin <= 4.
int ddim_conv_head(const void* x, const void* w, const float* bias, void* out,
                   float* stats, int batch, int t_len, int f_len, int c_in,
                   int c0, int bf16, void* stream) {
  using namespace ddim;
  if (c_in < 1 || c_in > kHeadMaxCin)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_tiles(t_len, f_len), batch,
                  (c0 + kCoTile - 1) / kCoTile);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    conv_head_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<T*>(out), stats, t_len, f_len, c_in, c0);
  } else {
    conv_head_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(out), stats, t_len, f_len, c_in, c0);
  }
  return static_cast<int>(cudaGetLastError());
}

// h, res: [B, T, F, C0]; out: [B, T, F, Cout]; w: [3, 3, C0, Cout] in the
// same dtype; bias: [Cout] fp32. res may be null. C0 % 32 == 0, Cout in
// {1, 2, 4}; h and res are read 16 bytes at a time.
int ddim_conv_tail(const void* h, const void* res, const void* w,
                   const float* bias, void* out, int batch, int t_len,
                   int f_len, int c0, int c_out, int bf16, void* stream) {
  using namespace ddim;
  if (c0 % kTailCk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_tail<__nv_bfloat16>(h, res, w, bias, out, batch, t_len,
                                        f_len, c0, c_out, s)
           : launch_tail<float>(h, res, w, bias, out, batch, t_len, f_len, c0,
                                c_out, s);
  return static_cast<int>(err);
}

}  // extern "C"
