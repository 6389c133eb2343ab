// Strided stage transitions of the U-Net over channels-last activations:
//
// down  k4 s2 p1 conv, Cin → Cout, (T, F) → (T/2, F/2), + bias
//       out[to, fo] = bias + Σ_{dt,df ∈ 0..3} x[2·to+dt−1, 2·fo+df−1] · w[dt, df]
//       Replaces ddim_audio_tpu/ops/pallas/conv_strided.py `_down_kernel`
//       (wrapper `conv_down_flat`), float taps.
//
// up    transposed k4 s2 p1 conv (torch ConvTranspose2d semantics),
//       Cin → Cout, (T, F) → (2T, 2F), + bias, + fused skip residual.
//       w is the stored *equivalent forward* kernel (spatially flipped HWIO,
//       ddim_audio_tpu/models/layers.py): the output is the forward conv of
//       the 2×-dilated input with padding 2, so only the taps whose dilated
//       source is an even row/column contribute:
//       out[oy, ox] = bias + res[oy, ox]
//                   + Σ_{ky ≡ oy, kx ≡ ox (mod 2)} x[(oy+ky−2)/2, (ox+kx−2)/2] · w[ky, kx]
//       Replaces conv_strided.py `_up_kernel` (wrapper `conv_up_flat`), float
//       taps.
//
// Both can emit per-block partial (sum, sum²) of the fp32 output (for up: of
// the summed output up(h) + residual) before the store cast.
//
// down, three variants picked per call (conv_down_plan, conv_plan.h;
// ddim_conv_down_variant reports it):
// - conv_down_mma_kernel (bf16, C_in % 32 == 0, C_out % 32 == 0: every bf16
//   transition of audio.yml, 192→256 at f_out = 8 included). On an H100 the
//   bf16 down conv is bound by bytes at 32→64 (16·C_in MACs per output
//   element against an input four times the output's positions: at B = 1,
//   134 MB in, 67 MB out, 0.060 ms at 3.35 TB/s) and by tensor-core
//   operations from 64→96 on. The kernel before this design (WMMA, 128
//   positions × 32 channels a block) staged the input halo once per
//   32-channel output slice and all 16 taps' weights per 16-channel chunk,
//   synchronously, took its epilogue through an fp32 tile in shared memory
//   to 2-byte stores, and at f_out = 8 (192→256) did not apply: CUDA cores
//   ran there at 19× cuDNN. This design stages a tile's input halo once for
//   all its output-channel groups (cp.async, zero-filled outside, each halo
//   row split into its even and odd columns so that the stride-2 window of
//   a tap is 8 consecutive rows for ldmatrix), streams the weights (a tap
//   row, 4 taps × 32 input channels × the group's 32 or 64 output channels,
//   a stage) through a 3-deep cp.async ring, runs the taps as
//   mma.sync.m16n8k16
//   bf16 → fp32 (ldmatrix at each output position's own halo address, so
//   no im2col; ldmatrix.trans on the HWIO weights, so no repack) and keeps
//   the epilogue in registers (quad transpose, bias, fixed-order
//   statistics, 16-byte stores). A block owns 256 output positions (16 ×
//   16) at 64→96, 128 (8 × 16) at 32→64, 96→128 and 128→192, and 64 (8 ×
//   8) at 192→256, where a stride-2 tile's halo (4.8 times its output
//   positions × all C_in) leaves no room for more (one block an SM from
//   64→96 on: a warp tile of 32 positions beat a second resident block of
//   16-position tiles). Output-channel groups go to grid.z only where the
//   spatial grid is under two blocks per SM (96→128 at B = 1, 128→192,
//   192→256). Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, B =
//   1, through the wrapper): 0.225 / 0.185 / 0.106 / 0.087 / 0.081 ms from
//   32→64 to 192→256 (the WMMA / CUDA-core kernel before: 0.666 / 0.508 /
//   0.257 / 0.135 / 0.313; cuDNN's bare conv 0.188 / 0.068 / 0.046 / 0.031
//   / 0.034), 32→64 at 27% of its byte bound. Without its MMAs the kernel
//   still takes 64% of its time at 32→64 and 51% at 64→96 (B = 1)
//   (tools/conv_ablation.py, PERF.md): staging, ldmatrix and the ring's
//   barriers, not the tensor cores, hold it.
// - conv_down_tf32_kernel (fp32, C_in % 32 == 0, C_out % 32 == 0: the
//   training transitions and the dx of the up convs, ops/flat_grad.py): the
//   bf16 kernel's block on the tensor cores in split TF32. Each fp32
//   operand is split once into hi = tf32(v) and lo = tf32(v − hi), and
//   mma.sync.m16n8k8 accumulates lo·hi + hi·lo + hi·hi into fp32: 16·C_in
//   MACs an output at three products each, 495 / 3 TFLOP/s at best against
//   the 67 of the CUDA cores, at fp32 accuracy (single-pass TF32 keeps ten
//   mantissa bits and fails the training's 100 dB per-call guard). The
//   tensor cores' fp32 accumulation is not IEEE round-to-nearest, so each
//   ring step (a tap row × 16 channels) sums into accumulators of its own,
//   added into the block's total by IEEE fp32 additions: each
//   truncating sum spans 48 products, not all 48·C_in. fp32 doubles the
//   halo's bytes, so the halo streams through two buffers in 16-channel
//   chunks beside a 3-deep ring of tap-row weight stages, and a block owns
//   one output-channel group (grid.z); A fragments come by ldmatrix (8
//   rows of 16 bytes are 8 rows × 4 fp32), B by 32-bit shared-memory reads
//   (ldmatrix.trans moves 16-bit elements); the epilogue runs from the
//   registers as the bf16 kernel's. The kernel before this design (below,
//   which fp32 and bf16 keep where channels are no multiple of 32) ran
//   0.398 / 0.253 / 0.161 / 0.175 / 0.251 ms from 32→64 to 192→256 at the
//   training shapes (B = 1, H100 80GB HBM3 at 700 W, chip_smoke.py), 16-23%
//   of its fp32 FMA bound and 2.3 times one fp32 cuDNN call; this one
//   0.135 / 0.116 / 0.060 / 0.044 / 0.028 ms on the same card, 0.73 times
//   that call summed, each call 122-127 dB against it (PERF.md).
// - conv_down_kernel (fp32 and bf16 with channels no multiple of 32): FMA
//   implicit GEMM, 16·Cin MACs per output element, bound by FMA issue and
//   shared-memory reads. 64 output positions × 32 output channels per block,
//   input halo and weights staged per chunk as fp32, 8 accumulators per
//   thread.
//
// up, three variants picked per call (conv_up_plan, conv_plan.h;
// ddim_conv_up_variant reports it):
// - conv_up_mma_kernel (bf16, C_in % 32 == 0, C_out % 32 == 0: every bf16
//   transition of audio.yml, 256→192 at f_out = 16 included). On an H100 the
//   bf16 up conv is bound by bytes where C_in is narrow (4·C_in MACs per
//   output element against an output and a skip residual of C_out bf16
//   each: at 64→32, B = 1, 67 MB in, 134 MB residual, 134 MB out, 0.100 ms
//   at 3.35 TB/s) and by tensor-core operations from 192→128 on. The
//   kernel before this design re-staged the input halo and all 16 taps'
//   weights once per 32-channel output slice, synchronously, and spent its
//   epilogue on an fp32 tile round trip through shared memory and 2-byte
//   residual loads and stores; at f_out = 16 (256→192) it did not apply
//   and CUDA cores ran instead (13.6× cuDNN). This design stages 128 input
//   positions a block once (cp.async, zero-filled outside), for all four
//   output parity classes (the sub-pixel form below), streams the weights
//   (one (a, b) tap offset × 32 input channels × the four classes' taps ×
//   32 output channels a stage) through a 3-deep cp.async ring, runs the
//   taps as mma.sync.m16n8k16 bf16 → fp32 with ldmatrix (.trans for the
//   HWIO weights, so no repack; a warp owns one class × 64 input positions
//   × 32 channels: 128 registers, 32 bytes of spill, 2 blocks an SM), and
//   keeps the epilogue in registers: each lane holds 8 consecutive channels
//   of an output position after a quad transpose, so bias, residual,
//   statistics and store move 16 bytes a lane. 128 positions a block
//   rather than 64 halve the L2 traffic of the weights, which every block
//   re-reads (64 KB a block at 64→32). Output-channel groups (32 each) are
//   shared out over grid.z only where the spatial grid is under two blocks
//   per SM (192→128 and 256→192). Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py, B = 1): 0.343 / 0.233 / 0.124 ms from 64→32 to 128→96,
//   29 / 21 / 14% of the byte bound (cuDNN's bare transposed conv: 0.210 /
//   0.117 / 0.112), 0.060 / 0.071 ms at 192→128 / 256→192, 11 / 5% of the
//   tensor-core bound.
// - conv_up_tf32_kernel (fp32, C_in % 32 == 0, C_out % 32 == 0: training's
//   up convs and the dx of its down convs, ops/flat_grad.py): the sub-pixel
//   block of the bf16 kernel on the tensor cores in split TF32, as the fp32
//   down conv, on 64 input positions and one group of 32 output channels a
//   block (a warp a class × 32 positions: the fp32 sums of a wider tile do
//   not fit the registers). Each 16-channel chunk of the input halo is
//   copied raw and split once into TF32 hi and lo planes (each value feeds
//   four taps), the tap offsets stream through a 3-deep ring, and the small
//   grids (192→128, 256→192 at a training microbatch) split the chunks over
//   a cluster. The kernel before it (below) ran at 2.1 times one fp32 cuDNN
//   call summed over the training shapes; this one 0.145 / 0.103 / 0.064 /
//   0.036 / 0.033 ms from 64→32 to 256→192, 0.41 times that call summed,
//   133-135 dB against it (H100 80GB HBM3 at 700 W, chip_smoke.py;
//   PERF.md).
// - conv_up_kernel (bf16 with channels no multiple of 32, and fp32 there):
//   the FMA implicit GEMM, 4·Cin MACs per output element; every warp owns
//   one (row, column) parity class so each staged weight is reused 8 times.
#include "conv_mma.cuh"

namespace ddim {

constexpr int kCkS = 8;             // input channels per staged chunk
constexpr int kHaloDown = 10 * 34;  // max (2TT+2)·(2FT+2) over the tile shapes
constexpr int kHaloUp = 6 * 10;     // max (TT/2+2)·(FT/2+2)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_down_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ stats, int t_in, int f_in, int c_in,
                     int c_out) {
  __shared__ __align__(16) float xs[kHaloDown * kCkS];
  __shared__ __align__(16) float ws[16 * kCkS * kCoTile];
  __shared__ float red[2 * kThreads];

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int b = blockIdx.y;
  const int ft = tile_f(f_out), tt = tile_t(f_out);
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt;
  const int f0 = (blockIdx.x % tiles_f) * ft;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const int hw = 2 * ft + 2, hn = (2 * tt + 2) * hw;
  const size_t xb = (size_t)b * t_in * f_in * c_in;

  float acc[kPosPerThread];
  int base[kPosPerThread];
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    acc[i] = 0.f;
    base[i] = (2 * (p / ft) * hw + 2 * (p % ft)) * kCkS;
  }

  for (int c0 = 0; c0 < c_in; c0 += kCkS) {
    for (int idx = threadIdx.x; idx < hn * kCkS; idx += kThreads) {
      const int ci = idx % kCkS, hp = idx / kCkS;
      const int t = 2 * t0 - 1 + hp / hw, f = 2 * f0 - 1 + hp % hw;
      float v = 0.f;
      if (t >= 0 && t < t_in && f >= 0 && f < f_in)
        v = to_f(x[xb + ((size_t)t * f_in + f) * c_in + c0 + ci]);
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < 16 * kCkS * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCkS, tap = r / kCkS;
      const int oc = co0 + l;
      ws[idx] = oc < c_out
                    ? to_f(w[((size_t)tap * c_in + c0 + ci) * c_out + oc])
                    : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 16; ++tap) {
      const int toff = ((tap / 4) * hw + tap % 4) * kCkS;
#pragma unroll
      for (int ci = 0; ci < kCkS; ci += 4) {
        const float* wr = &ws[(tap * kCkS + ci) * kCoTile + lane];
        const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                    w3 = wr[3 * kCoTile];
#pragma unroll
        for (int i = 0; i < kPosPerThread; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[base[i] + toff + ci]);
          acc[i] = fma4(acc[i], v, w0, w1, w2, w3);
        }
      }
    }
    __syncthreads();
  }

  float s1 = 0.f, s2 = 0.f;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    const int t = t0 + p / ft, f = f0 + p % ft;
    if (t < t_out && f < f_out && co < c_out) {
      const float o = acc[i] + bias[co];
      s1 += o;
      s2 += o * o;
      out[ob + ((size_t)t * f_out + f) * c_out + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
    block_stats(s1, s2, red, dst, co, c_out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_up_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, float* __restrict__ stats, int t_in,
                   int f_in, int c_in, int c_out) {
  __shared__ __align__(16) float xs[kHaloUp * kCkS];
  __shared__ __align__(16) float ws[16 * kCkS * kCoTile];
  __shared__ float red[2 * kThreads];

  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const int b = blockIdx.y;
  const int ft = tile_f(f_out), tt = tile_t(f_out);  // both even
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt;
  const int f0 = (blockIdx.x % tiles_f) * ft;
  const int co0 = blockIdx.z * kCoTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  // input halo rows t0/2 − 1 … t0/2 + tt/2, columns likewise
  const int hw = ft / 2 + 2, hn = (tt / 2 + 2) * hw;
  const size_t xb = (size_t)b * t_in * f_in * c_in;

  // Warp w owns 8 positions of parity class cls = w / 2 (row parity
  // cls / 2, column parity cls % 2); a class holds (tt/2)·(ft/2) = 16.
  const int cls = warp >> 1, py = cls >> 1, px = cls & 1;
  const int half_f = ft / 2;
  float acc[kPosPerThread];
  int base[kPosPerThread];
  int pos[kPosPerThread];  // position index in the tile (row-major tt × ft)
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int q = (warp & 1) * kPosPerThread + i;
    const int ry = 2 * (q / half_f) + py, rx = 2 * (q % half_f) + px;
    acc[i] = 0.f;
    pos[i] = ry * ft + rx;
    // local halo row of tap ky is (ry + ky) / 2 with ky ≡ ry (mod 2)
    base[i] = (((ry + py) / 2) * hw + (rx + px) / 2) * kCkS;
  }

  for (int c0 = 0; c0 < c_in; c0 += kCkS) {
    for (int idx = threadIdx.x; idx < hn * kCkS; idx += kThreads) {
      const int ci = idx % kCkS, hp = idx / kCkS;
      const int t = t0 / 2 - 1 + hp / hw, f = f0 / 2 - 1 + hp % hw;
      float v = 0.f;
      if (t >= 0 && t < t_in && f >= 0 && f < f_in)
        v = to_f(x[xb + ((size_t)t * f_in + f) * c_in + c0 + ci]);
      xs[idx] = v;
    }
    for (int idx = threadIdx.x; idx < 16 * kCkS * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCkS, tap = r / kCkS;
      const int oc = co0 + l;
      ws[idx] = oc < c_out
                    ? to_f(w[((size_t)tap * c_in + c0 + ci) * c_out + oc])
                    : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // live taps of this parity class: ky = py + 2·(j/2), kx = px + 2·(j%2);
      // relative to the (ky, kx) = (py, px) tap the halo moves by (j/2, j%2)
      const int ky = py + 2 * (j >> 1), kx = px + 2 * (j & 1);
      const int tap = ky * 4 + kx;
      const int toff = ((j >> 1) * hw + (j & 1)) * kCkS;
#pragma unroll
      for (int ci = 0; ci < kCkS; ci += 4) {
        const float* wr = &ws[(tap * kCkS + ci) * kCoTile + lane];
        const float w0 = wr[0], w1 = wr[kCoTile], w2 = wr[2 * kCoTile],
                    w3 = wr[3 * kCoTile];
#pragma unroll
        for (int i = 0; i < kPosPerThread; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[base[i] + toff + ci]);
          acc[i] = fma4(acc[i], v, w0, w1, w2, w3);
        }
      }
    }
    __syncthreads();
  }

  float s1 = 0.f, s2 = 0.f;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int t = t0 + pos[i] / ft, f = f0 + pos[i] % ft;
    if (t < t_out && f < f_out && co < c_out) {
      const size_t off = ob + ((size_t)t * f_out + f) * c_out + co;
      float o = acc[i] + bias[co];
      if (res != nullptr) o += to_f(res[off]);
      s1 += o;
      s2 += o * o;
      out[off] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out;
    block_stats(s1, s2, red, dst, co, c_out);
  }
}

// ------------------------------------------------- tensor-core variants --

// The down conv on the tensor cores. A block owns TT × FT output positions
// (16·MT·WM of them) and stages their input halo, rows 2·t0 − 1 … 2·t0 + 2TT
// and columns 2·f0 − 1 … 2·f0 + 2FT, once for all its output-channel groups,
// all C_in channels (cp.async, zero-filled outside the input). Each halo row
// keeps its even columns first and its odd ones after (slot (hc % 2)·(FT + 1)
// + hc / 2): tap (dt, df) of output column fo reads halo column 2·fo + df,
// which this order puts at slot (df % 2)·(FT + 1) + fo + df / 2, so the 8
// rows of an ldmatrix are 8 consecutive slots (conflict-free at pitch
// C_in + 8) and every tap is one constant offset from a position's base.
// Warp (wm, wn) computes MT m16 tiles of positions × 32 output channels
// (wn·32 … of the group), mma.sync.m16n8k16 bf16 → fp32; the weights stream
// through a kDownStages-deep cp.async ring, kDownTaps taps × 32 input
// channels × NB output channels a stage, read by ldmatrix.trans from
// HWIO; the epilogue (bias, statistics, 16-byte stores) runs from the
// registers, as conv3x3's.
template <int MT, int WN>
__global__ void __launch_bounds__(kThreads, 2) conv_down_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ stats, int t_in, int f_in, int c_in, int c_out,
    int split) {
  using T = __nv_bfloat16;
  constexpr int kWarpsM = 8 / WN;
  constexpr int kM = 16 * MT * kWarpsM;  // output positions per block
  constexpr int kNB = 32 * WN;           // output channels per group
  constexpr int kWP = kNB + 8;           // stage pitch (elements)
  constexpr int kTap = kMmaK * kWP;      // one tap's 32 ci × NB in a stage
  constexpr int kStage = kDownTaps * kTap;
  constexpr int kChunks = 16 / kDownTaps;  // tap chunks (stages) a 32 ci
  extern __shared__ __align__(16) unsigned char smem[];

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int ft = f_out >= 16 ? 16 : 8, tt = kM / ft;
  const int hw = 2 * ft + 2, half = ft + 1, hn = (2 * tt + 2) * hw;
  const int pitch = c_in + 8;
  T* halo = reinterpret_cast<T*>(smem);  // [hn][pitch], parity-split rows
  T* ring = halo + hn * pitch;           // [stages][taps][32 ci][kWP]
  float* red = reinterpret_cast<float*>(ring + kDownStages * kStage);

  const int b = blockIdx.y, z = blockIdx.z;
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt, f0 = (blockIdx.x % tiles_f) * ft;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
  // step s: group z + (s / group_steps)·split, tap chunk (taps
  // kDownTaps·chunk … of the 16, dt·4 + df), 32-channel chunk kc
  const int kc_n = c_in / kMmaK, group_steps = kChunks * kc_n;
  const int nsteps = (c_out / kNB - z + split - 1) / split * group_steps;

  auto load_stage = [&](int s) {
    const int rem = s % group_steps, chunk = rem / kc_n, kc = rem % kc_n;
    const int g = z + (s / group_steps) * split;
    T* dst = ring + (s % kDownStages) * kStage;
    for (int i = threadIdx.x; i < kDownTaps * kMmaK * kNB / 8;
         i += kThreads) {
      const int q = i % (kNB / 8), r = (i / (kNB / 8)) % kMmaK;
      const int j = i / (kMmaK * kNB / 8);  // tap of the chunk
      const int tap = kDownTaps * chunk + j;  // dt·4 + df
      cp_async16(dst + j * kTap + r * kWP + 8 * q,
                 w + ((size_t)tap * c_in + kc * kMmaK + r) * c_out + g * kNB +
                     8 * q);
    }
  };
  // the halo joins the first stage's copy group
  const int cq = c_in / 8;
  for (int i = threadIdx.x; i < hn * cq; i += kThreads) {
    const int hp = i / cq, q = i % cq;
    const int hr = hp / hw, hc = hp % hw;
    const int t = 2 * t0 - 1 + hr, f = 2 * f0 - 1 + hc;
    const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
    const T* src = inside ? x + xb + ((size_t)t * f_in + f) * c_in + 8 * q : x;
    cp_async16_zfill(
        halo + (hr * hw + (hc & 1) * half + (hc >> 1)) * pitch + 8 * q, src,
        inside);
  }
#pragma unroll
  for (int s = 0; s < kDownStages - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row (output position), tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = wm * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(halo + (2 * (p / ft) * hw + p % ft) * pitch +
                          (lane >> 4) * 8);
  }
  const uint32_t b_base =
      smem_u32(ring) + b_lane_offset(lane, kWP) + wn * 32 * 2;
  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kDownStages - 2>();
    __syncthreads();  // stage s (and the halo) visible; slot s − 1 free
    if (s + kDownStages - 1 < nsteps) load_stage(s + kDownStages - 1);
    cp_async_commit();
    const int rem = s % group_steps, chunk = rem / kc_n, kc = rem % kc_n;
    const uint32_t b_stage = b_base + (s % kDownStages) * kStage * 2;
#pragma unroll
    for (int j = 0; j < kDownTaps; ++j) {
      const int tap = kDownTaps * chunk + j, dt = tap >> 2, df = tap & 3;
      const uint32_t a_off =
          ((dt * hw + (df & 1) * half + (df >> 1)) * pitch + kc * kMmaK) * 2;
#pragma unroll
      for (int kk = 0; kk < kMmaK / 16; ++kk) {
        uint32_t aa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) aa[mt] = a_base[mt] + a_off + kk * 32;
        warp_mma_k16(acc, aa, b_stage + (j * kTap + kk * 16 * kWP) * 2, 32);
      }
    }
    if (rem != group_steps - 1) continue;

    // Epilogue of group g from the registers: bias, statistics, 16-byte
    // bf16 stores.
    const int g = z + (s / group_steps) * split;
    const int co = g * kNB + wn * 32 + 8 * tig;
    float bv[8], s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bv[k] = __ldg(bias + co + k);
      s1[k] = s2[k] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(acc[mt], r, tig);
        const int p = wm * 16 * MT + mt * 16 + gid + 8 * r;
        const int t = t0 + p / ft, f = f0 + p % ft;
        if (t < t_out && f < f_out) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float v = o.v[k] + bv[k];
            s1[k] += v;
            s2[k] += v * v;
            o.v[k] = v;
          }
          store8(out + ob + ((size_t)t * f_out + f) * c_out + co, o);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[mt][nt][2 * r + k] = 0.f;
      }
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
          stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out + g * kNB,
          c_out);
    }
  }
}

template <int MT, int WN>
cudaError_t launch_conv_down_mma(const TilePlan& p, const void* x,
                                 const void* w, const float* bias, void* out,
                                 float* stats, int batch, int t_in, int f_in,
                                 int c_in, int c_out, cudaStream_t s) {
  using T = __nv_bfloat16;
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_down_mma_kernel<MT, WN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  conv_down_mma_kernel<MT, WN>
      <<<dim3(p.tiles, batch, p.split), kThreads, p.smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), bias,
          static_cast<T*>(out), stats, t_in, f_in, c_in, c_out, p.split);
  return cudaGetLastError();
}

// The fp32 down conv on the tensor cores in split TF32. A block owns TT × FT
// output positions (16·MT·WM) × the NB output channels of group
// blockIdx.z / ksplit, and input channels chunks kz·C/ksplit … of them (kz
// = blockIdx.z % ksplit). Step s = 4·kc + dt of the K loop stages tap row dt (taps
// (dt, 0 … 3)) × input channels kTf32K·kc … +15 × NB into a kTf32Stages-deep
// cp.async ring; the first step of chunk kc also stages that chunk's input
// halo (rows 2·t0 − 1 … 2·t0 + 2TT, columns 2·f0 − 1 … 2·f0 + 2FT, zero
// outside, each row's even columns before its odd ones as in
// conv_down_mma_kernel) into halo buffer kc % 2, which chunk kc − 2 last
// read. Warp (wm, wn) computes MT m16 tiles × 32 channels: per k8 step its A
// fragments by ldmatrix at each position's own halo address and B by 32-bit
// reads (pitch NB + 8 ≡ 8 mod 32 words: conflict-free), each split into
// TF32 hi and lo, then three mma.sync.m16n8k8 a tile pair. A step sums into
// acc_s, which IEEE additions fold into acc when the step ends. Where a
// sample's grid is small (128→192, 192→256) the plan splits the chunks over
// ksplit blocks of one thread block cluster (grid.z = groups · ksplit): each
// leaves its sums in its shared memory, and rank 0 adds the ranks' sums in
// rank order over the cluster's distributed shared memory, then runs the
// epilogue, so the result does not depend on which block finishes first.
template <int MT, int WN>
__global__ void __launch_bounds__(kThreads, 1) conv_down_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ stats, int t_in, int f_in, int c_in, int c_out,
    int ksplit) {
  constexpr int kWarpsM = 8 / WN;
  constexpr int kM = 16 * MT * kWarpsM;   // output positions per block
  constexpr int kNB = 32 * WN;            // output channels per block
  constexpr int kWP = kNB + 8;            // stage pitch (floats)
  constexpr int kTap = kTf32K * kWP;      // one tap's 16 ci × NB in a stage
  constexpr int kStage = kDownTaps * kTap;
  constexpr int kTf32Q = kTf32K / 4;      // 16-byte copies a halo position
  extern __shared__ __align__(16) unsigned char smem[];

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int ft = f_out >= 16 ? 16 : 8, tt = kM / ft;
  const int hw = 2 * ft + 2, half = ft + 1, hn = (2 * tt + 2) * hw;
  float* halo = reinterpret_cast<float*>(smem);  // [2][hn][kTf32Pitch]
  float* ring = halo + 2 * hn * kTf32Pitch;      // [stages][taps][16 ci][kWP]
  float* red = ring + kTf32Stages * kStage;      // [kWarpsM][2][kNB]

  const int b = blockIdx.y;
  const int g = blockIdx.z / ksplit, kz = blockIdx.z % ksplit;
  const int tiles_f = (f_out + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt, f0 = (blockIdx.x % tiles_f) * ft;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
  // this block's steps: chunks kz·chunks/ksplit … (kz + 1)·chunks/ksplit − 1
  const int chunks = c_in / kTf32K;
  const int s_lo = 4 * (kz * chunks / ksplit);
  const int s_hi = 4 * ((kz + 1) * chunks / ksplit);

  auto load_stage = [&](int s) {
    const int kc = s >> 2, dt = s & 3;
    float* dst = ring + (s % kTf32Stages) * kStage;
    for (int i = threadIdx.x; i < kDownTaps * kTf32K * kNB / 4;
         i += kThreads) {
      const int q = i % (kNB / 4), r = (i / (kNB / 4)) % kTf32K;
      const int df = i / (kTf32K * kNB / 4);
      cp_async16(dst + df * kTap + r * kWP + 4 * q,
                 w + ((size_t)(dt * 4 + df) * c_in + kc * kTf32K + r) * c_out +
                     g * kNB + 4 * q);
    }
    if (dt != 0) return;
    float* hb = halo + (kc & 1) * hn * kTf32Pitch;
    for (int i = threadIdx.x; i < hn * kTf32Q; i += kThreads) {
      const int hp = i / kTf32Q, q = i % kTf32Q;
      const int hr = hp / hw, hc = hp % hw;
      const int t = 2 * t0 - 1 + hr, f = 2 * f0 - 1 + hc;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      const float* src =
          inside ? x + xb + ((size_t)t * f_in + f) * c_in + kc * kTf32K + 4 * q
                 : x;
      cp_async16_zfill(
          hb + (hr * hw + (hc & 1) * half + (hc >> 1)) * kTf32Pitch + 4 * q,
          src, inside);
    }
  };
#pragma unroll
  for (int s = s_lo; s < s_lo + kTf32Stages - 1; ++s) {
    if (s < s_hi) load_stage(s);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row (output position), tap (0, 0), buffer 0
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = wm * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(halo + (2 * (p / ft) * hw + p % ft) * kTf32Pitch +
                          (lane >> 4) * 4);
  }
  float acc[MT][kNT][4];
  zero_acc(acc);

#pragma unroll 1
  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait<kTf32Stages - 2>();
    __syncthreads();  // stage s and its chunk's halo visible; slot s − 1 free
    if (s + kTf32Stages - 1 < s_hi) load_stage(s + kTf32Stages - 1);
    cp_async_commit();
    const int kc = s >> 2, dt = s & 3;
    const uint32_t a_buf = (kc & 1) * hn * kTf32Pitch * 4;
    // lane's b0 in the stage: k row tig, column wn·32 + gid (+ 8·nt)
    const float* bst = ring + (s % kTf32Stages) * kStage + tig * kWP +
                       wn * 32 + gid;
    float acc_s[MT][kNT][4];
    zero_acc(acc_s);
#pragma unroll
    for (int df = 0; df < 4; ++df) {
      const uint32_t a_off =
          a_buf + (dt * hw + (df & 1) * half + (df >> 1)) * kTf32Pitch * 4;
#pragma unroll
      for (int kk = 0; kk < kTf32K / 8; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          split_a_tf32(ah[mt], al[mt], a_base[mt] + a_off + kk * 32);
        const float* bp = bst + df * kTap + kk * 8 * kWP;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bh[2], bl[2];
          split_tf32(bp[nt * 8], bh[0], bl[0]);
          split_tf32(bp[nt * 8 + 4 * kWP], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32x3(acc_s[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    }
    fold_acc(acc, acc_s);
  }
  // the K split's ranks sum in rank 0 (the halo's memory is free by then)
  if (ksplit > 1 && !cluster_sum(acc, smem, ksplit)) return;

  // Epilogue from the registers: bias, statistics, 16-byte stores.
  const int co = g * kNB + wn * 32 + 8 * tig;
  float bv[8], s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bv[k] = __ldg(bias + co + k);
    s1[k] = s2[k] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Vec8 o = quad_gather(acc[mt], r, tig);
      const int p = wm * 16 * MT + mt * 16 + gid + 8 * r;
      const int t = t0 + p / ft, f = f0 + p % ft;
      const bool inside = t < t_out && f < f_out;
      if (inside) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float v = o.v[k] + bv[k];
          s1[k] += v;
          s2[k] += v * v;
          o.v[k] = v;
        }
        store8(out + ob + ((size_t)t * f_out + f) * c_out + co, o);
      }
    }
  if (stats != nullptr)
    group_stats(
        s1, s2, red, wm, wn, kWarpsM, kNB,
        stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out + g * kNB,
        c_out);
}

template <int MT, int WN>
cudaError_t launch_conv_down_tf32(const TilePlan& p, const void* x,
                                  const void* w, const float* bias, void* out,
                                  float* stats, int batch, int t_in, int f_in,
                                  int c_in, int c_out, cudaStream_t s) {
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_down_tf32_kernel<MT, WN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return launch_cluster_z(conv_down_tf32_kernel<MT, WN>, p, batch, s,
                          static_cast<const float*>(x),
                          static_cast<const float*>(w), bias,
                          static_cast<float*>(out), stats, t_in, f_in, c_in,
                          c_out, p.split / p.groups);
}

// Sub-pixel form of the up conv: output (2i + py, 2j + px) is a 2×2 conv of
// the input around (i, j), one per parity class (py, px):
//   out = Σ_{a, b ∈ {0, 1}} x[i + py − 1 + a, j + px − 1 + b] · w[py + 2a, px + 2b]
// A block stages its 128 input positions plus a 1-position halo once (by
// cp.async, zero-filled outside the input) and computes all four classes
// from it: M = input positions, N = output channels, K = 4 taps × C_in per
// class. Warp w owns class w % 4 for input positions 64·(w / 4) … +63; a
// weight stage holds, for one (a, b) and 32 input channels, the four
// classes' taps × 32 output channels.
__global__ void __launch_bounds__(kThreads, 2) conv_up_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_in,
    int f_in, int c_in, int c_out, int split) {
  using T = __nv_bfloat16;
  constexpr int MT = 4;                     // m16 tiles per warp
  constexpr int kNB = 32;                   // output channels per group
  constexpr int kWP = kNB + 8;              // stage pitch (elements)
  constexpr int kClass = kMmaK * kWP;       // one class's taps in a stage
  constexpr int kStage = 4 * kClass;
  extern __shared__ __align__(16) unsigned char smem[];

  const int fi = f_in >= 16 ? 16 : 8, ti = 32 * MT / fi;  // 128 positions
  const int hw = fi + 2, hn = (ti + 2) * hw, pitch = c_in + 8;
  T* halo = reinterpret_cast<T*>(smem);  // [hn][pitch]
  T* ring = halo + hn * pitch;           // [stages][4 classes][32 ci][kWP]
  float* red = reinterpret_cast<float*>(ring + kUpStages * kStage);

  const int b = blockIdx.y, z = blockIdx.z;
  const int tiles_f = (f_in + fi - 1) / fi;
  const int i0 = (blockIdx.x / tiles_f) * ti, j0 = (blockIdx.x % tiles_f) * fi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cls = warp & 3, py = cls >> 1, px = cls & 1, half = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
  const int kc_n = c_in / kMmaK, group_steps = 4 * kc_n;
  const int nsteps = (c_out / kNB - z + split - 1) / split * group_steps;

  // step s: group z + (s / group_steps)·split, tap offset (a, b), chunk kc
  auto load_stage = [&](int s) {
    const int rem = s % group_steps, ab = rem / kc_n, kc = rem % kc_n;
    const int g = z + (s / group_steps) * split;
    T* dst = ring + (s % kUpStages) * kStage;
    for (int i = threadIdx.x; i < 4 * kMmaK * kNB / 8; i += kThreads) {
      const int q = i % (kNB / 8), r = (i / (kNB / 8)) % kMmaK;
      const int k = i / (kMmaK * kNB / 8);  // class of the tap
      const int tap = ((k >> 1) + 2 * (ab >> 1)) * 4 + (k & 1) + 2 * (ab & 1);
      cp_async16(dst + k * kClass + r * kWP + 8 * q,
                 w + ((size_t)tap * c_in + kc * kMmaK + r) * c_out + g * kNB +
                     8 * q);
    }
  };
  // the halo joins the first stage's copy group
  for (int i = threadIdx.x; i < hn * (c_in / 8); i += kThreads) {
    const int hp = i / (c_in / 8), q = i % (c_in / 8);
    const int t = i0 - 1 + hp / hw, f = j0 - 1 + hp % hw;
    const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
    const T* src =
        inside ? x + xb + ((size_t)t * f_in + f) * c_in + 8 * q : x;
    cp_async16_zfill(halo + hp * pitch + 8 * q, src, inside);
  }
#pragma unroll
  for (int s = 0; s < kUpStages - 1; ++s) {
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row in the halo, tap offset (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = half * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(halo + ((p / fi + py) * hw + p % fi + px) * pitch +
                          (lane >> 4) * 8);
  }
  const uint32_t b_base =
      smem_u32(ring) + (cls * kClass) * 2 + b_lane_offset(lane, kWP);
  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kUpStages - 2>();
    __syncthreads();  // stage s (and the halo) visible; slot s − 1 free
    const int rem = s % group_steps, ab = rem / kc_n, kc = rem % kc_n;
    if (s + kUpStages - 1 < nsteps) load_stage(s + kUpStages - 1);
    cp_async_commit();
    const uint32_t a_off =
        (((ab >> 1) * hw + (ab & 1)) * pitch + kc * kMmaK) * 2;
    const uint32_t b_stage = b_base + (s % kUpStages) * kStage * 2;
#pragma unroll
    for (int kk = 0; kk < kMmaK / 16; ++kk) {
      uint32_t aa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) aa[mt] = a_base[mt] + a_off + kk * 32;
      warp_mma_k16(acc, aa, b_stage + kk * 16 * kWP * 2, 32);
    }
    if (rem != group_steps - 1) continue;

    // Epilogue of group g from the registers: bias, the skip residual read
    // as 16-byte vectors, statistics of the sum, 16-byte bf16 stores.
    const int g = z + (s / group_steps) * split;
    const int co = g * kNB + 8 * tig;
    float bv[8], s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bv[k] = __ldg(bias + co + k);
      s1[k] = s2[k] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(acc[mt], r, tig);
        const int p = half * 16 * MT + mt * 16 + gid + 8 * r;
        const int i = i0 + p / fi, j = j0 + p % fi;
        if (i < t_in && j < f_in) {
          const size_t off =
              ob + ((size_t)(2 * i + py) * f_out + 2 * j + px) * c_out + co;
          const Vec8 rv =
              res != nullptr ? unpack8(ldg16(res + off)) : Vec8{};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float v = o.v[k] + bv[k];
            if (res != nullptr) v += rv.v[k];
            s1[k] += v;
            s2[k] += v * v;
            o.v[k] = v;
          }
          store8(out + off, o);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[mt][nt][2 * r + k] = 0.f;
      }
    if (stats != nullptr) {
      sum_over_gid(s1);
      sum_over_gid(s2);
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[(warp * 2) * kNB + 8 * tig + k] = s1[k];
          red[(warp * 2 + 1) * kNB + 8 * tig + k] = s2[k];
        }
      }
      finish_group_stats(
          red, kWarps, kNB,
          stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out + g * kNB,
          c_out);
    }
  }
}


// The fp32 up conv on the tensor cores in split TF32: the sub-pixel form of
// conv_up_mma_kernel on kUpTf32Pos input positions a block (TT × FT = 4 ×
// 16, or 8 × 8 where F_in < 16) and one group of 32 output channels
// (blockIdx.z / ksplit); warp w computes class w % 4 of input positions
// 32·(w / 4) … +31, MT = 2 m16 tiles × 4 n8 tiles. Step s = 2·kc + h of
// the K loop stages, for tap offsets ab = 2h, 2h + 1 ((a, b) = (ab >> 1,
// ab & 1)) and input channels kTf32K·kc … +15, the four classes' taps × 32
// output channels into a kTf32Stages-deep cp.async ring; the step that
// stages chunk kc's first weights also copies the chunk's input halo (rows
// i0 − 1 … i0 + TT, columns j0 − 1 … j0 + FT, zero outside) raw into one
// buffer, which chunk kc's first step splits once into TF32 hi and lo
// planes (store_split_tf32) before it issues the next copies and runs its
// MMAs. Per k8 step a warp's A fragments
// (hi, lo) come by ldmatrix at each position's own plane address, B by
// 32-bit reads split into hi and lo, then three mma.sync.m16n8k8 a tile
// pair; a step sums into acc_s, folded into acc by IEEE additions, and
// where a sample's grid is small the chunks split over a cluster
// (cluster_sum). The epilogue is conv_up_mma_kernel's: bias, the fp32 skip
// residual, statistics of the sum, 16-byte stores.
__global__ void __launch_bounds__(kThreads, 2) conv_up_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, float* __restrict__ stats, int t_in, int f_in,
    int c_in, int c_out, int ksplit) {
  constexpr int MT = 2;                  // m16 tiles per warp
  constexpr int kNB = 32;                // output channels per block
  constexpr int kWP = kNB + 8;           // stage pitch (floats)
  constexpr int kClass = kTf32K * kWP;   // one class's tap in a stage
  constexpr int kStage = kUpTf32Offs * 4 * kClass;
  constexpr int kSteps = 4 / kUpTf32Offs;  // ring steps a chunk
  constexpr int kQ = kTf32K / 4;         // 16-byte copies a halo position
  extern __shared__ __align__(16) unsigned char smem[];

  const int fi = f_in >= 16 ? 16 : 8, ti = kUpTf32Pos / fi;
  const int hw = fi + 2, hn = (ti + 2) * hw;
  float* raw = reinterpret_cast<float*>(smem);  // [hn][kTf32K]
  float* hi = raw + hn * kTf32K;                // [hn][kTf32Pitch]
  float* lo = hi + hn * kTf32Pitch;             // [hn][kTf32Pitch]
  float* ring = lo + hn * kTf32Pitch;  // [stages][2 ab][4 cls][16 ci][kWP]
  float* red = ring + kTf32Stages * kStage;  // [kWarps][2][kNB]

  const int b = blockIdx.y;
  const int g = blockIdx.z / ksplit, kz = blockIdx.z % ksplit;
  const int tiles_f = (f_in + fi - 1) / fi;
  const int i0 = (blockIdx.x / tiles_f) * ti, j0 = (blockIdx.x % tiles_f) * fi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cls = warp & 3, py = cls >> 1, px = cls & 1, half = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const size_t xb = (size_t)b * t_in * f_in * c_in;
  const size_t ob = (size_t)b * t_out * f_out * c_out;
  // this block's steps: chunks kz·chunks/ksplit … (kz + 1)·chunks/ksplit − 1
  const int chunks = c_in / kTf32K;
  const int s_lo = kSteps * (kz * chunks / ksplit);
  const int s_hi = kSteps * ((kz + 1) * chunks / ksplit);

  auto load_weights = [&](int s) {
    const int kc = s / kSteps;
    float* dst = ring + (s % kTf32Stages) * kStage;
    for (int i = threadIdx.x; i < kUpTf32Offs * 4 * kTf32K * kNB / 4;
         i += kThreads) {
      const int q = i % (kNB / 4), r = (i / (kNB / 4)) % kTf32K;
      const int ko = i / (kTf32K * kNB / 4);  // (offset, class) of the tap
      const int k = ko & 3, ab = (s % kSteps) * kUpTf32Offs + (ko >> 2);
      const int tap = ((k >> 1) + 2 * (ab >> 1)) * 4 + (k & 1) + 2 * (ab & 1);
      cp_async16(dst + ko * kClass + r * kWP + 4 * q,
                 w + ((size_t)tap * c_in + kc * kTf32K + r) * c_out +
                     g * kNB + 4 * q);
    }
  };
  auto load_raw = [&](int kc) {
    for (int i = threadIdx.x; i < hn * kQ; i += kThreads) {
      const int hp = i / kQ, q = i % kQ;
      const int t = i0 - 1 + hp / hw, f = j0 - 1 + hp % hw;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      const float* src =
          inside ? x + xb + ((size_t)t * f_in + f) * c_in + kc * kTf32K + 4 * q
                 : x;
      cp_async16_zfill(raw + hp * kTf32K + 4 * q, src, inside);
    }
  };
#pragma unroll
  for (int s = s_lo; s < s_lo + kTf32Stages - 1; ++s) {
    if (s < s_hi) load_weights(s);
    if (s < s_hi && s % kSteps == 0) load_raw(s / kSteps);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row in the hi plane, tap offset (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = half * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(hi + ((p / fi + py) * hw + p % fi + px) * kTf32Pitch +
                          (lane >> 4) * 4);
  }
  const uint32_t lo_off = hn * kTf32Pitch * 4;
  // lane's b0 in a stage: offset 0, class cls, k row tig, column gid (+ 8·nt)
  const float* bst = ring + cls * kClass + tig * kWP + gid;
  float acc[MT][kNT][4];
  zero_acc(acc);

#pragma unroll 1
  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait<kTf32Stages - 2>();
    __syncthreads();  // stage s and its chunk's raw halo visible; slot s − 1
                      // free
    if (s % kSteps == 0) {  // split the chunk's halo into its planes, once
      for (int i = threadIdx.x; i < hn * kQ; i += kThreads) {
        const int hp = i / kQ, q = i % kQ;
        store_split_tf32(
            hi + hp * kTf32Pitch + 4 * q, lo + hp * kTf32Pitch + 4 * q,
            *reinterpret_cast<const float4*>(raw + hp * kTf32K + 4 * q));
      }
      __syncthreads();  // the planes written; the raw buffer free
    }
    const int nxt = s + kTf32Stages - 1;
    if (nxt < s_hi) load_weights(nxt);
    if (nxt < s_hi && nxt % kSteps == 0) load_raw(nxt / kSteps);
    cp_async_commit();
    float acc_s[MT][kNT][4];
    zero_acc(acc_s);
#pragma unroll
    for (int o = 0; o < kUpTf32Offs; ++o)
#pragma unroll
      for (int kk = 0; kk < kTf32K / 8; ++kk) {
        const int ab = (s % kSteps) * kUpTf32Offs + o;
        const uint32_t a_off = ((ab >> 1) * hw + (ab & 1)) * kTf32Pitch * 4;
        uint32_t ah[MT][4], al[MT][4], aa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) aa[mt] = a_base[mt] + a_off + kk * 32;
        load_a_tf32(ah, al, aa, lo_off);
        const float* bp = bst + (s % kTf32Stages) * kStage +
                          o * 4 * kClass + kk * 8 * kWP;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t bh[2], bl[2];
          split_tf32(bp[nt * 8], bh[0], bl[0]);
          split_tf32(bp[nt * 8 + 4 * kWP], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32x3(acc_s[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    fold_acc(acc, acc_s);
  }
  // the K split's ranks sum in rank 0 (the planes' memory is free by then)
  if (ksplit > 1 && !cluster_sum(acc, smem, ksplit)) return;

  // Epilogue from the registers: bias, the skip residual, statistics of the
  // sum, 16-byte stores.
  const int co = g * kNB + 8 * tig;
  float bv[8], s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bv[k] = __ldg(bias + co + k);
    s1[k] = s2[k] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Vec8 o = quad_gather(acc[mt], r, tig);
      const int p = half * 16 * MT + mt * 16 + gid + 8 * r;
      const int i = i0 + p / fi, j = j0 + p % fi;
      if (i < t_in && j < f_in) {  // the epilogue of an output position
        const size_t off =
            ob + ((size_t)(2 * i + py) * f_out + 2 * j + px) * c_out + co;
        const Vec8 rv = res != nullptr ? load8(res + off) : Vec8{};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v = o.v[k] + bv[k];
          if (res != nullptr) v += rv.v[k];
          s1[k] += v;
          s2[k] += v * v;
          o.v[k] = v;
        }
        store8(out + off, o);
      }
    }
  if (stats != nullptr)
    group_stats(
        s1, s2, red, warp, 0, kWarps, kNB,
        stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c_out + g * kNB,
        c_out);
}

cudaError_t launch_conv_up_tf32(const TilePlan& p, const void* x,
                                const void* w, const float* bias,
                                const void* res, void* out, float* stats,
                                int batch, int t_in, int f_in, int c_in,
                                int c_out, cudaStream_t s) {
  static bool raised = false;  // one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_up_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return launch_cluster_z(conv_up_tf32_kernel, p, batch, s,
                          static_cast<const float*>(x),
                          static_cast<const float*>(w), bias,
                          static_cast<const float*>(res),
                          static_cast<float*>(out), stats, t_in, f_in, c_in,
                          c_out, p.split / p.groups);
}

}  // namespace ddim

extern "C" {

// x: [B, T, F, Cin]; w: [4, 4, Cin, Cout]; bias: [Cout] fp32; out:
// [B, T/2, F/2, Cout]; stats: [B, ddim_conv_down_tiles(...), 2, Cout] fp32 or
// null (ddim_conv_down_tiles, _variant, _plan: conv_plan.cu). Every pointer
// 16-byte aligned.
int ddim_conv_down(const void* x, const void* w, const float* bias, void* out,
                   float* stats, int batch, int t_in, int f_in, int c_in,
                   int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_down_plan(t_in, f_in, c_in, c_out, bf16, batch);
  const dim3 grid(p.tiles, batch, p.split);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma || p.variant == kVariantTf32) {
    // MT from the tile (16·MT·WM positions), WN from the group width
    const int wn = c_out / p.groups / 32;
    const int mt = p.tile_t * p.tile_f / (16 * (8 / wn));
    using Launch = cudaError_t (*)(const TilePlan&, const void*, const void*,
                                   const float*, void*, float*, int, int, int,
                                   int, int, cudaStream_t);
    const Launch launch =
        p.variant == kVariantTf32
            ? (wn == 2 ? (mt == 2 ? launch_conv_down_tf32<2, 2>
                                  : launch_conv_down_tf32<1, 2>)
                       : (mt == 2 ? launch_conv_down_tf32<2, 1>
                                  : launch_conv_down_tf32<1, 1>))
            : (wn == 2 ? (mt == 2 ? launch_conv_down_mma<2, 2>
                                  : launch_conv_down_mma<1, 2>)
                       : (mt == 2 ? launch_conv_down_mma<2, 1>
                                  : launch_conv_down_mma<1, 1>));
    return static_cast<int>(launch(p, x, w, bias, out, stats, batch, t_in,
                                   f_in, c_in, c_out, s));
  }
  if (bf16) {
    using T = __nv_bfloat16;
    conv_down_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<T*>(out), stats, t_in, f_in, c_in, c_out);
  } else {
    conv_down_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(out), stats, t_in, f_in, c_in, c_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [B, T, F, Cin]; w: [4, 4, Cin, Cout] (equivalent forward kernel); bias:
// [Cout] fp32; res (or null), out: [B, 2T, 2F, Cout]; stats:
// [B, ddim_conv_up_tiles(...), 2, Cout] fp32 or null. Every pointer 16-byte
// aligned.
int ddim_conv_up(const void* x, const void* w, const float* bias,
                 const void* res, void* out, float* stats, int batch, int t_in,
                 int f_in, int c_in, int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_up_plan(t_in, f_in, c_in, c_out, bf16, batch);
  const dim3 grid(p.tiles, batch, p.split);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantTf32)
    return static_cast<int>(launch_conv_up_tf32(p, x, w, bias, res, out,
                                                stats, batch, t_in, f_in,
                                                c_in, c_out, s));
  if (p.variant == kVariantMma) {
    using T = __nv_bfloat16;
    static bool raised = false;  // one card per process
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_up_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised = true;
    }
    conv_up_mma_kernel<<<grid, kThreads, p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<const T*>(res), static_cast<T*>(out), stats, t_in, f_in,
        c_in, c_out, p.split);
  } else if (bf16) {
    using T = __nv_bfloat16;
    conv_up_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), bias,
        static_cast<const T*>(res), static_cast<T*>(out), stats, t_in, f_in,
        c_in, c_out);
  } else {
    conv_up_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<const float*>(res), static_cast<float*>(out), stats, t_in,
        f_in, c_in, c_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
