// Fused 3×3 SAME conv, C → C, over channels-last [B, T, F, C] activations.
//
// Replaces the TPU kernel ddim_audio_tpu/ops/pallas/conv_flat.py
// `_conv_kernel` (wrapper `conv3x3_flat`) on its float-tap path:
//
//   prologue  v = x (+ residual, rounded to the storage dtype)
//             v = v·scale[b, c] + shift[b, c]     (GroupNorm folded, optional)
//             v = silu(v)                          (optional)
//             v rounded to the compute dtype; positions outside [0,T)×[0,F)
//             are zero AFTER the prologue (pad-after-norm)
//   taps      out32 = Σ_{dt,df,ci} v[t+dt−1, f+df−1, ci] · w[dt, df, ci, co]
//   epilogue  out32 += add[b, co] (bias or per-sample temb, fp32)
//             out32 = silu(out32)                  (optional)
//             partial (sum, sum²) of out32 per channel (optional)
//             out = out32 rounded to the storage dtype
//
// Two variants; conv3x3_plan (conv_plan.h) picks one per call and
// ddim_conv3x3_variant reports it:
//
// - conv3x3_mma_kernel (bf16, C % 32 == 0: every bf16 conv of the audio.yml
//   stages, F = 8 included). On an H100 its bound is bytes at s0-s2 (x,
//   residual and out in bf16 against 9·C MACs a value) and tensor-core
//   operations from s3 on. The kernel before this design reached 3-16% of
//   that bound: its staging ran once per 32-channel output slice (C/32
//   times a position), synchronously, and its epilogue took an fp32 tile
//   through shared memory to 2-byte stores. This one:
//   * stages the prologue-applied bf16 halo of a tile once for all C output
//     channels: (TT+2)·(FT+2) positions × C in dynamic shared memory (pitch
//     C + 8, so ldmatrix rows fall in distinct banks; 95 KB at C = 256).
//     A block owns 256 positions (16 × 16, or 32 × 8 where F < 16) at
//     C <= 96, 128 (8 × 16 / 16 × 8) from C = 128 on, and walks its C / NB
//     output-channel groups (NB = 32, or 64 from C = 128 on) over the same
//     halo. Where the spatial grid alone is under two blocks per SM (s3 at
//     B = 1, s4-s5 at B = 1 and 2) the groups are shared out over grid.z
//     and each such block stages the L2-resident halo again (conv_plan.h);
//   * streams the weights as tap rows (3 taps × 32 input channels × NB)
//     through a 3-deep cp.async ring, the first two while the halo is staged;
//   * runs the taps as mma.sync.m16n8k16 bf16 → fp32: a warp owns 32
//     positions × 32 channels, its A rows are halo positions read by
//     ldmatrix at their own addresses (no im2col), its B fragments come from
//     the HWIO stage by ldmatrix.trans (no repack). mma.sync rather than
//     wgmma: a tap's A rows are scattered halo rows, which wgmma's
//     shared-memory descriptors cannot address, and the register epilogue
//     wants mma.sync's fragment layout. ptxas: 123 registers (WN = 2,
//     2 blocks an SM), 126 (WN = 1 at C = 96), 80 with 60 bytes of spill
//     (C <= 64, bounded for 3 blocks an SM: conv3x3_min_blocks);
//   * keeps the epilogue in registers: a quad transpose gives each lane 8
//     consecutive channels of a position, so add, SiLU, (sum, sum²) and the
//     bf16 store move 16 bytes a lane; the statistics reduce over the quad
//     columns by shuffles and over the block's warps through 2 KB of shared
//     memory, in a fixed order (no atomics, deterministic). SiLU, twice a
//     value (prologue and epilogue), takes the fast exponential and
//     division (silu_fast) in place of the IEEE division's instruction
//     sequence.
//   Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, all fusions on,
//   B = 1): 0.378 / 0.265 / 0.147 ms at s0-s2, 32 / 23 / 15% of the byte
//   bound (cuDNN's bare conv: 0.224 / 0.101 / 0.078), 0.079 / 0.077 / 0.053
//   ms at s3-s5, 12 / 7 / 5% of the tensor-core bound. No single piece
//   holds it there (tools/conv_ablation.py takes one out at a time; PERF.md
//   §6): the prologue, the MMAs, the weight stream and the epilogue run in
//   series inside a block, and one block's phases overlap only other
//   blocks'.
// - conv3x3_kernel (fp32, and bf16 where C % 32 != 0): the MACs run on CUDA
//   cores in fp32, bound by FMA issue and shared-memory reads (one float4
//   broadcast read per 4 MACs of a position, one weight read per 4 MACs per
//   lane), not by HBM. 8 positions per thread reuse each staged weight 8
//   times; the input halo is staged once per channel chunk. It fuses the
//   prologue into the staging pass, so the activation makes one trip from
//   HBM.
#include "conv_mma.cuh"

namespace ddim {

constexpr int kCk3 = 16;        // input channels per staged chunk
constexpr int kHalo3 = 6 * 18;  // max (TT+2)·(FT+2) over the two tile shapes

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ pre_scale,
                   const float* __restrict__ pre_shift,
                   const T* __restrict__ w, const float* __restrict__ add,
                   T* __restrict__ out, float* __restrict__ stats, int t_len,
                   int f_len, int c, int pre_silu, int post_silu) {
  __shared__ __align__(16) float xs[kHalo3 * kCk3];
  __shared__ __align__(16) float ws[9 * kCk3 * kCoTile];
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
  const size_t xb = (size_t)b * t_len * f_len * c;

  float acc[kPosPerThread];
  int base[kPosPerThread];  // halo offset of each owned position's (0,0) tap
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    acc[i] = 0.f;
    base[i] = ((p / ft) * hw + p % ft) * kCk3;
  }

  for (int c0 = 0; c0 < c; c0 += kCk3) {
    // Stage the prologue-applied halo tile of this channel chunk.
    for (int idx = threadIdx.x; idx < hn * kCk3; idx += kThreads) {
      const int ci = idx % kCk3, hp = idx / kCk3;
      const int t = t0 + hp / hw - 1, f = f0 + hp % hw - 1, ch = c0 + ci;
      float v = 0.f;
      if (t >= 0 && t < t_len && f >= 0 && f < f_len) {
        const size_t off = xb + ((size_t)t * f_len + f) * c + ch;
        v = to_f(x[off]);
        if (res != nullptr) v = round_to<T>(v + to_f(res[off]));
        if (pre_scale != nullptr)
          v = v * pre_scale[b * c + ch] + pre_shift[b * c + ch];
        if (pre_silu) v = silu(v);
        v = round_to<T>(v);
      }
      xs[idx] = v;
    }
    // Stage the chunk's weights: ws[tap][ci][lane].
    for (int idx = threadIdx.x; idx < 9 * kCk3 * kCoTile; idx += kThreads) {
      const int l = idx % kCoTile, r = idx / kCoTile;
      const int ci = r % kCk3, tap = r / kCk3;
      const int oc = co0 + l;
      ws[idx] = oc < c ? to_f(w[((size_t)tap * c + c0 + ci) * c + oc]) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * hw + tap % 3) * kCk3;
#pragma unroll
      for (int ci = 0; ci < kCk3; ci += 4) {
        const float* wr = &ws[(tap * kCk3 + ci) * kCoTile + lane];
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
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = warp * kPosPerThread + i;
    const int t = t0 + p / ft, f = f0 + p % ft;
    if (t < t_len && f < f_len && co < c) {
      float o = acc[i];
      if (add != nullptr) o += add[b * c + co];
      if (post_silu) o = silu(o);
      s1 += o;
      s2 += o * o;
      out[xb + ((size_t)t * f_len + f) * c + co] = from_f<T>(o);
    }
  }
  if (stats != nullptr) {
    float* dst = stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c;
    block_stats(s1, s2, red, dst, co, c);
  }
}

// ------------------------------------------------- tensor-core variant --

// WN warps share a tile's positions across NB = 32·WN output channels;
// registers are bounded for MINB resident blocks per SM.
template <int WN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ add,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int t_len,
    int f_len, int c, int pre_silu, int post_silu, int split) {
  using T = __nv_bfloat16;
  using Blk = Conv3x3Mma<WN>;
  constexpr int kWarpsM = Blk::kWarpsM;
  constexpr int kNB = Blk::kNB;
  extern __shared__ __align__(16) unsigned char smem[];

  const int ft = f_len >= 16 ? 16 : 8, tt = Blk::kM / ft;
  const int hw = ft + 2, hn = (tt + 2) * hw, pitch = c + 8;
  T* halo = reinterpret_cast<T*>(smem);         // [hn][pitch]
  T* ring = halo + hn * pitch;             // [stages][3 df][32 ci][kWP]
  float* red = reinterpret_cast<float*>(ring + kConvStages * Blk::kStage);

  const int b = blockIdx.y, z = blockIdx.z;
  const int tiles_f = (f_len + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt, f0 = (blockIdx.x % tiles_f) * ft;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_len * f_len * c;
  const int group_steps = 3 * (c / kMmaK);
  const int nsteps = Blk::steps(c, z, split);

#pragma unroll
  for (int s = 0; s < kConvStages - 1; ++s) {
    if (s < nsteps) Blk::load_stage(ring, w, s, z, split, c);
    cp_async_commit();
  }

  // Stage the prologue-applied halo once (while the first weight stages
  // load), 8 channels (16 bytes) per item, kBatch items' loads in flight per
  // thread before their arithmetic.
  constexpr int kBatch = 4;
  const int cq = c / 8, n_items = hn * cq;
  for (int i0 = threadIdx.x; i0 < n_items; i0 += kBatch * kThreads) {
    uint4 xr[kBatch], rr[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads, hp = idx / cq, q = idx % cq;
      const int t = t0 + hp / hw - 1, f = f0 + hp % hw - 1;
      in[u] = idx < n_items && t >= 0 && t < t_len && f >= 0 && f < f_len;
      xr[u] = rr[u] = make_uint4(0, 0, 0, 0);
      if (in[u]) {
        const size_t off = xb + ((size_t)t * f_len + f) * c + 8 * q;
        xr[u] = ldg16(x + off);
        if (res != nullptr) rr[u] = ldg16(res + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx >= n_items) break;
      const int hp = idx / cq, ch = 8 * (idx % cq);
      Vec8 v = unpack8(xr[u]);
      if (in[u]) {
        if (res != nullptr) {
          const Vec8 r = unpack8(rr[u]);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = round_to<T>(v.v[k] + r.v[k]);
        }
        if (pre_scale != nullptr) {
          const Vec8 sc = load8(pre_scale + b * c + ch);
          const Vec8 sh = load8(pre_shift + b * c + ch);
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = v.v[k] * sc.v[k] + sh.v[k];
        }
        if (pre_silu) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v.v[k] = silu_fast(v.v[k]);
        }
      }
      store8(halo + hp * pitch + ch, v);
    }
  }

  uint32_t a_base[kMT], b_base;  // lane's A rows (tap (0, 0)), B offset
  Blk::bases(a_base, b_base, halo, ring, ft, hw, pitch);
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
    Blk::step(acc, a_base, b_base, s, c, hw, pitch);
    const int rem = s % group_steps;
    if (rem != group_steps - 1) continue;

    // Epilogue of group g from the registers.
    const int g = z + (s / group_steps) * split;
    const int co = g * kNB + wn * 32 + 8 * tig;
    float av[8], s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      av[k] = add != nullptr ? __ldg(add + b * c + co + k) : 0.f;
      s1[k] = s2[k] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(acc[mt], r, tig);
        const int p = wm * 32 + mt * 16 + gid + 8 * r;
        const int t = t0 + p / ft, f = f0 + p % ft;
        if (t < t_len && f < f_len) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float v = o.v[k] + av[k];
            if (post_silu) v = silu_fast(v);
            s1[k] += v;
            s2[k] += v * v;
            o.v[k] = v;
          }
          store8(out + xb + ((size_t)t * f_len + f) * c + co, o);
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
          stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c + g * kNB, c);
    }
  }
}

template <int WN, int MINB>
cudaError_t launch_conv3x3_mma(const TilePlan& p, const void* x,
                               const void* res, const float* pre_scale,
                               const float* pre_shift, const void* w,
                               const float* add, void* out, float* stats,
                               int batch, int t_len, int f_len, int c,
                               int pre_silu, int post_silu, cudaStream_t s) {
  using T = __nv_bfloat16;
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_mma_kernel<WN, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  conv3x3_mma_kernel<WN, MINB>
      <<<dim3(p.tiles, batch, p.split), kThreads, p.smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
          pre_shift, static_cast<const T*>(w), add, static_cast<T*>(out),
          stats, t_len, f_len, c, pre_silu, post_silu, p.split);
  return cudaGetLastError();
}

}  // namespace ddim

extern "C" {

// x, res, out: [B, T, F, C] (fp32 or bf16, as `bf16` says); w: [3, 3, C, C]
// in the same dtype; pre_scale, pre_shift, add: [B, C] fp32; stats:
// [B, ddim_conv3x3_tiles(...), 2, C] fp32. res, pre_*, add and stats may be
// null; x, res, w, out and pre_* are 16-byte aligned. Returns
// cudaGetLastError() after the launch.
int ddim_conv3x3(const void* x, const void* res, const float* pre_scale,
                 const float* pre_shift, const void* w, const float* add,
                 void* out, float* stats, int batch, int t_len, int f_len,
                 int c, int pre_silu, int post_silu, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv3x3_plan(t_len, f_len, c, bf16, batch);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma) {
    // audio.yml: C = 32, 64 → <1, 3>; 96 → <1, 2>; 128 … 256 → <2, 2>
    const auto launch = conv3x3_warps_n(c) == 2      ? launch_conv3x3_mma<2, 2>
                        : conv3x3_min_blocks(c) == 3 ? launch_conv3x3_mma<1, 3>
                                                     : launch_conv3x3_mma<1, 2>;
    return static_cast<int>(launch(p, x, res, pre_scale, pre_shift, w, add,
                                   out, stats, batch, t_len, f_len, c,
                                   pre_silu, post_silu, s));
  }
  const dim3 grid(p.tiles, batch, p.split);
  if (bf16) {
    using T = __nv_bfloat16;
    conv3x3_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), pre_scale,
        pre_shift, static_cast<const T*>(w), add, static_cast<T*>(out), stats,
        t_len, f_len, c, pre_silu, post_silu);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(res),
        pre_scale, pre_shift, static_cast<const float*>(w), add,
        static_cast<float*>(out), stats, t_len, f_len, c, pre_silu,
        post_silu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
