// The strided stage transitions with int8 × int8 → int32 taps on the tensor
// cores, over channels-last activations. Replace the `mxu_i8` branches of the
// TPU kernels ddim_audio_tpu/ops/pallas/conv_strided.py `_down_kernel`
// (wrapper `conv_down_flat(mxu_int8=True)`) and `_up_kernel`
// (`conv_up_flat(mxu_int8=True)`), weights from `pack_down_weights_int8` /
// `pack_up_weights_int8` (here quantize_strided_weights_int8, HWIO):
//
// down  k4 s2 p1 conv, Cin → Cout, (T, F) → (T/2, F/2)
// up    transposed k4 s2 p1 conv, (T, F) → (2T, 2F), w the stored equivalent
//       forward kernel (conv_strided.cu), + the fused skip residual
//
//   requant   one scale per quantisation group: the input tile a block
//             stages, halo included, over all Cin channels:
//             amax = max(max|x|, 1e-30), q = clip(rint(x · (127 / amax)),
//             −127, 127) (round half to even); positions outside the input
//             are zero
//   taps      acc32 = Σ q · wq            (int32, exact)
//   epilogue  out32 = float(acc32) · ((amax · (1/127)) · w_scale[co]) + bias
//             (+ residual, up), partial (sum, sum²) of out32, store cast
//
// The group: a block's output tile of kTtI × kFtI positions reads the input
// tile 2kTtI × 2kFtI (down) or kTtI/2 × kFtI/2 (up) and a 1-position halo
// around it, staged whole; ddim_strided_int8_geometry reports the output
// tile and the halo to the plain twin. In the TPU kernel the down conv's two
// time-parity streams share one scale; here the block stages both parities
// together, so they do too.
//
// Design. Pass 1 reads the staged input once for its amax (one block
// reduction), pass 2 reads it again (from L2) and stores it requantised into
// shared memory [halo position][Cin + 16] (the pad keeps fragment reads off
// one bank). Per 32-channel K chunk all 16 taps' weights of the block's
// output channels are staged transposed to [tap][co][ci] (4×4-byte blocks
// through __byte_perm, as conv3x3_int8.cu), because
// `mma.sync.m16n8k32.s8` wants K contiguous in both operands. Each warp owns
// 16 output positions: down, one output row (its A rows are the stride-2
// input columns of the tap, read at their own addresses); up, 2 rows × 8
// columns of one (row, column) parity class, whose 4 live taps are fixed. A
// block computes up to 64 output channels (Cout/64 or Cout/32 blocks along
// z, each restaging the same input and finding the same amax). What bounds
// it on an H100 is the two staging passes and the weight restaging per
// block, not the int8 MMAs (16·Cin·Cout MACs per output position down,
// 4·Cin·Cout up, at 1,979 TOP/s) and not HBM.
#include "conv_common.cuh"

namespace ddim {

constexpr int kTtI = 8, kFtI = 16;         // output tile (the group's)
constexpr int kHwDI = 2 * kFtI + 2;        // down: 34 staged input columns
constexpr int kHaloDI = (2 * kTtI + 2) * kHwDI;
constexpr int kHwUI = kFtI / 2 + 2;        // up: 10 staged input columns
constexpr int kHaloUI = (kTtI / 2 + 2) * kHwUI;
constexpr int kWPitch = 32 + 16;           // staged weight row: 32 ci + pad

__host__ __device__ constexpr int strided_int8_halo(bool up) {
  return up ? kHaloUI : kHaloDI;
}

__host__ __device__ inline int strided_int8_q_bytes(bool up, int c_in) {
  return ((strided_int8_halo(up) * (c_in + 16) + 15) / 16) * 16;
}

template <int CO>
__host__ __device__ constexpr int strided_int8_w_bytes() {
  constexpr int w = 16 * CO * kWPitch, a = kTtI * kFtI * (CO + 8) * 4;
  return w > a ? w : a;
}

template <typename T, bool UP, int CO>
__global__ void __launch_bounds__(kThreads) conv_strided_int8_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ w_scale, const float* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ out, float* __restrict__ stats,
    int t_in, int f_in, int c_in, int c_out) {
  constexpr int kHw = UP ? kHwUI : kHwDI;
  constexpr int kHalo = strided_int8_halo(UP);
  constexpr int kAccPitch = CO + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = c_in + 16;
  unsigned char* qbuf = smem;                                  // [halo][pitch]
  unsigned char* wbuf = smem + strided_int8_q_bytes(UP, c_in);  // [16][CO][48]
  float* accs = reinterpret_cast<float*>(wbuf);  // [128][kAccPitch] at the end
  __shared__ float red[2 * kThreads];

  const int t_out = UP ? 2 * t_in : t_in / 2, f_out = UP ? 2 * f_in : f_in / 2;
  const int b = blockIdx.y;
  const int tiles_f = (f_out + kFtI - 1) / kFtI;
  const int t0 = (blockIdx.x / tiles_f) * kTtI;  // even
  const int f0 = (blockIdx.x % tiles_f) * kFtI;  // even
  const int cz0 = blockIdx.z * CO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // first staged input row and column (halo 1 around the input tile)
  const int ti0 = UP ? t0 / 2 - 1 : 2 * t0 - 1;
  const int fi0 = UP ? f0 / 2 - 1 : 2 * f0 - 1;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const int n8 = c_in / 8;

  // 1. amax over the staged input tile.
  float am = 0.f;
  for (int idx = threadIdx.x; idx < kHalo * n8; idx += kThreads) {
    const int hp = idx / n8, ch = 8 * (idx % n8);
    const int t = ti0 + hp / kHw, f = fi0 + hp % kHw;
    if (t >= 0 && t < t_in && f >= 0 && f < f_in) {
      const Vec8 v = load8(x + xb + ((size_t)t * f_in + f) * c_in + ch);
#pragma unroll
      for (int k = 0; k < 8; ++k) am = fmaxf(am, fabsf(v.v[k]));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, m));
  if (lane == 0) red[warp] = am;
  __syncthreads();
  am = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) am = fmaxf(am, red[k]);
  const float amax = fmaxf(am, 1e-30f);
  const float inv = 127.0f / amax;
  const float s_q = amax * (1.0f / 127.0f);

  // 2. The staged input, requantised.
  for (int idx = threadIdx.x; idx < kHalo * n8; idx += kThreads) {
    const int hp = idx / n8, ch = 8 * (idx % n8);
    const int t = ti0 + hp / kHw, f = fi0 + hp % kHw;
    uint32_t lo = 0, hi = 0;
    if (t >= 0 && t < t_in && f >= 0 && f < f_in) {
      const Vec8 v = load8(x + xb + ((size_t)t * f_in + f) * c_in + ch);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo |= (uint32_t)(quant1(v.v[k], inv) & 0xff) << (8 * k);
        hi |= (uint32_t)(quant1(v.v[4 + k], inv) & 0xff) << (8 * k);
      }
    }
    *reinterpret_cast<uint2*>(qbuf + hp * pitch + ch) = make_uint2(lo, hi);
  }

  // 3. Taps, one 32-channel K chunk at a time.
  int acc[CO / 8][4];
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0;
  // the warp's positions: down, output row warp, columns 0..15; up, parity
  // class (py, px) = (warp >> 2, (warp >> 1) & 1), class rows 2hh, 2hh + 1
  const int py = warp >> 2, px = (warp >> 1) & 1, hh = warp & 1;

#pragma unroll 1
  for (int kc = 0; kc < c_in; kc += 32) {
    __syncthreads();  // requant done (first chunk) / previous chunk consumed
    for (int idx = threadIdx.x; idx < 16 * 8 * (CO / 4); idx += kThreads) {
      const int co = 4 * (idx % (CO / 4));
      int r = idx / (CO / 4);
      const int ci = 4 * (r % 8), tap = r / 8;
      const int8_t* src =
          wq + ((size_t)(tap * c_in + kc + ci)) * c_out + cz0 + co;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + c_out);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * c_out);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * c_out);
      const uint32_t t0w = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1w = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2w = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3w = __byte_perm(r2, r3, 0x7362);
      unsigned char* dst = wbuf + (tap * CO + co) * kWPitch + ci;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0w, t1w, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kWPitch) =
          __byte_perm(t0w, t1w, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kWPitch) =
          __byte_perm(t2w, t3w, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kWPitch) =
          __byte_perm(t2w, t3w, 0x7632);
    }
    __syncthreads();

    constexpr int kLive = UP ? 4 : 16;
#pragma unroll
    for (int j = 0; j < kLive; ++j) {
      int tap;
      const unsigned char* arow;
      int step;  // bytes from A row gid to A row gid + 8
      if constexpr (UP) {
        // live taps ky = py + 2·(j/2), kx = px + 2·(j%2); position (r, q)
        // of the class reads halo row r + py + j/2, column q + px + j%2
        tap = (py + 2 * (j >> 1)) * 4 + px + 2 * (j & 1);
        arow = qbuf +
               ((2 * hh + py + (j >> 1)) * kHw + gid + px + (j & 1)) * pitch;
        step = kHw * pitch;
      } else {
        // output column m reads input column 2m + df of halo row 2w + dt
        tap = j;
        arow = qbuf + ((2 * warp + (j >> 2)) * kHw + 2 * gid + (j & 3)) * pitch;
        step = 16 * pitch;
      }
      arow += kc + tig * 4;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(arow);
      a[1] = *reinterpret_cast<const uint32_t*>(arow + step);
      a[2] = *reinterpret_cast<const uint32_t*>(arow + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(arow + step + 16);
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt) {
        const unsigned char* brow =
            wbuf + (tap * CO + nt * 8 + gid) * kWPitch + tig * 4;
        mma_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(brow),
               *reinterpret_cast<const uint32_t*>(brow + 16));
      }
    }
  }
  __syncthreads();  // every warp is done with wbuf

  // 4. Dequantise into the fp32 tile (each warp its own 16 rows), then the
  // epilogue with lane = output channel.
#pragma unroll
  for (int nt = 0; nt < CO / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    const float sc0 = __fmul_rn(s_q, w_scale[cz0 + col]);
    const float sc1 = __fmul_rn(s_q, w_scale[cz0 + col + 1]);
    float* r0 = accs + (warp * 16 + gid) * kAccPitch + col;
    *reinterpret_cast<float2*>(r0) =
        make_float2(__fmul_rn((float)acc[nt][0], sc0),
                    __fmul_rn((float)acc[nt][1], sc1));
    *reinterpret_cast<float2*>(r0 + 8 * kAccPitch) =
        make_float2(__fmul_rn((float)acc[nt][2], sc0),
                    __fmul_rn((float)acc[nt][3], sc1));
  }
  __syncwarp();

  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll 1
  for (int g = 0; g < CO / 32; ++g) {
    const int co = cz0 + g * 32 + lane;
    const float bv = bias[co];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int m = 0; m < 16; ++m) {
      int t, f;
      if constexpr (UP) {
        t = t0 + 2 * (2 * hh + (m >> 3)) + py;
        f = f0 + 2 * (m & 7) + px;
      } else {
        t = t0 + warp;
        f = f0 + m;
      }
      if (t < t_out && f < f_out) {
        const size_t off = ob + ((size_t)t * f_out + f) * c_out + co;
        float o = __fadd_rn(accs[(warp * 16 + m) * kAccPitch + g * 32 + lane],
                            bv);
        if (res != nullptr) o = __fadd_rn(o, to_f(res[off]));
        s1 += o;
        s2 += o * o;
        out[off] = from_f<T>(o);
      }
    }
    if (stats != nullptr) {
      if (g) __syncthreads();  // the previous group's partials were read
      float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
      block_stats(s1, s2, red, dst, co, c_out);
    }
  }
}

template <typename T, bool UP, int CO>
cudaError_t launch_strided_int8(const void* x, const int8_t* wq,
                                const float* w_scale, const float* bias,
                                const void* res, void* out, float* stats,
                                int batch, int t_in, int f_in, int c_in,
                                int c_out, cudaStream_t s) {
  const int bytes = strided_int8_q_bytes(UP, c_in) + strided_int8_w_bytes<CO>();
  static int raised = 48 * 1024;  // per instantiation; one card per process
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_strided_int8_kernel<T, UP, CO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised = bytes;
  }
  const int t_out = UP ? 2 * t_in : t_in / 2, f_out = UP ? 2 * f_in : f_in / 2;
  const dim3 grid(((t_out + kTtI - 1) / kTtI) * ((f_out + kFtI - 1) / kFtI),
                  batch, c_out / CO);
  conv_strided_int8_kernel<T, UP, CO><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), wq, w_scale, bias, static_cast<const T*>(res),
      static_cast<T*>(out), stats, t_in, f_in, c_in, c_out);
  return cudaGetLastError();
}

template <typename T, bool UP>
cudaError_t dispatch_strided_int8(const void* x, const int8_t* wq,
                                  const float* w_scale, const float* bias,
                                  const void* res, void* out, float* stats,
                                  int batch, int t_in, int f_in, int c_in,
                                  int c_out, cudaStream_t s) {
  if (c_out % 64 == 0)
    return launch_strided_int8<T, UP, 64>(x, wq, w_scale, bias, res, out,
                                          stats, batch, t_in, f_in, c_in,
                                          c_out, s);
  return launch_strided_int8<T, UP, 32>(x, wq, w_scale, bias, res, out, stats,
                                        batch, t_in, f_in, c_in, c_out, s);
}

}  // namespace ddim

extern "C" {

// The quantisation group: i = 0, 1 → the output tile's rows, columns;
// i = 2, 3 → the input halo rows, columns staged around its input tile.
int ddim_strided_int8_geometry(int i) {
  const int g[4] = {ddim::kTtI, ddim::kFtI, 1, 1};
  return i >= 0 && i < 4 ? g[i] : -1;
}

// Spatial tiles per sample (the partials' second dimension), both directions.
int ddim_strided_int8_tiles(int t_out, int f_out) {
  return ((t_out + ddim::kTtI - 1) / ddim::kTtI) *
         ((f_out + ddim::kFtI - 1) / ddim::kFtI);
}

// x: [B, T, F, Cin] (fp32 or bf16, as `bf16` says); wq: [4, 4, Cin, Cout]
// int8 HWIO (up: the equivalent forward kernel); w_scale, bias: [Cout] fp32;
// res (up only, or null), out: [B, T', F', Cout] in x's dtype; stats:
// [B, ddim_strided_int8_tiles(...), 2, Cout] fp32 or null. Cin and Cout
// multiples of 32 (Cin ≤ 256); every pointer 16-byte aligned.
int ddim_conv_strided_int8(const void* x, const void* wq, const float* w_scale,
                           const float* bias, const void* res, void* out,
                           float* stats, int up, int batch, int t_in, int f_in,
                           int c_in, int c_out, int bf16, void* stream) {
  using namespace ddim;
  if (c_in % 32 || c_out % 32 || c_in > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  cudaError_t err;
  if (bf16)
    err = up ? dispatch_strided_int8<__nv_bfloat16, true>(
                   x, w8, w_scale, bias, res, out, stats, batch, t_in, f_in,
                   c_in, c_out, s)
             : dispatch_strided_int8<__nv_bfloat16, false>(
                   x, w8, w_scale, bias, res, out, stats, batch, t_in, f_in,
                   c_in, c_out, s);
  else
    err = up ? dispatch_strided_int8<float, true>(x, w8, w_scale, bias, res,
                                                  out, stats, batch, t_in,
                                                  f_in, c_in, c_out, s)
             : dispatch_strided_int8<float, false>(x, w8, w_scale, bias, res,
                                                   out, stats, batch, t_in,
                                                   f_in, c_in, c_out, s);
  return static_cast<int>(err);
}

}  // extern "C"
