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
// Three variants; conv3x3_plan (conv_plan.h) picks one per call and
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
// - conv3x3_tf32_kernel (fp32, C % 32 == 0: training's convs, forward,
//   recompute and dx, and the fp32 float-tap sampling route): the bf16
//   kernel's warps on the tensor cores in split TF32, as the fp32 down conv
//   (conv_strided.cu): each fp32 operand split into hi = tf32(v) and lo =
//   tf32(v − hi), lo·hi + hi·lo + hi·hi accumulated by mma.sync.m16n8k8
//   into fp32, each ring step's sum folded into the total by IEEE
//   additions (the tensor cores' fp32 sum does not round to nearest;
//   single-pass TF32 keeps ten mantissa bits and fails training's 100 dB
//   guard). fp32 doubles the halo (190 KB at C = 256 for the bf16 tile), so
//   the halo streams in 16-channel chunks beside a 3-deep ring of tap-row
//   stages, one output-channel group a block (grid.z). Each halo value
//   feeds nine taps, so a chunk is copied raw (x and the residual) by
//   cp.async, and one pass applies the prologue and splits each value once
//   into TF32 hi and lo planes that ldmatrix reads as they are, in place of
//   a split a value a tap in the registers (store_split_tf32,
//   conv_mma.cuh).
//   Where a sample's grid does not reach one block an SM (s3-s5 of a
//   training microbatch) the chunks split over a thread block cluster whose
//   rank 0 sums the ranks in rank order (deterministic, no atomics). The
//   kernel before it (below, which bf16 keeps where C % 32 != 0) ran at
//   13-19% of the fp32 FMA bound and 2.1 times one fp32 cuDNN call summed
//   over the training shapes; this one 0.198 / 0.137 / 0.106 / 0.057 /
//   0.047 / 0.030 ms at s0-s5 of a training microbatch, 0.83 times that
//   call summed, 123-129 dB against it (H100 80GB HBM3 at 700 W,
//   chip_smoke.py; PERF.md).
// - conv3x3_kernel (bf16 where C % 32 != 0, and fp32 there): the MACs run
//   on CUDA cores in fp32, bound by FMA issue and shared-memory reads (one
//   float4 broadcast read per 4 MACs of a position, one weight read per 4
//   MACs per lane), not by HBM. 8 positions per thread reuse each staged weight 8
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


// The fp32 conv3x3 on the tensor cores in split TF32. A block owns TT × FT
// positions (16·MT·WM: 128 at MT = 2, WN = 2; 128 or 64 at MT = 1) × the
// NB = 32·WN output channels of group blockIdx.z / ksplit, and the input
// channels' chunks kz·C/(16·ksplit) … of them (kz = blockIdx.z % ksplit).
// Step s = 3·kc + dt of the K loop stages tap row dt (taps (dt, 0 … 2)) ×
// input channels kTf32K·kc … +15 × NB into a kTf32Stages-deep cp.async
// ring; the step that stages chunk kc's first tap row also copies the
// chunk's halo (rows t0 − 1 … t0 + TT, columns f0 − 1 … f0 + FT, zero
// outside) of x and of the residual raw into one buffer each. Chunk kc's
// first step runs the prologue on it (x + residual, the GroupNorm affine,
// SiLU, zero outside the array after all of it: pad after norm) and splits
// each value once into TF32 hi and lo planes (store_split_tf32) before it
// issues the next copies. Per k8 step a warp's A fragments (hi, lo) come by
// ldmatrix at each position's own plane address, B by 32-bit reads split
// into hi and lo, then three mma.sync.m16n8k8 a tile pair. A step (3 taps ×
// 16 channels: 48 products an output) sums into acc_s, folded into acc by
// IEEE additions; the K split's ranks sum over the cluster (cluster_sum). The
// epilogue runs from the registers as conv3x3_mma_kernel's, in fp32: add,
// SiLU (conv_common's, as the CUDA-core kernel), statistics, 16-byte
// stores. Registers are bounded for two blocks an SM (ptxas: 128 at MT =
// 2, no spill; 96-99 at MT = 1).
template <int MT, int WN>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    const float* __restrict__ pre_scale, const float* __restrict__ pre_shift,
    const float* __restrict__ w, const float* __restrict__ add,
    float* __restrict__ out, float* __restrict__ stats, int t_len, int f_len,
    int c, int pre_silu, int post_silu, int ksplit) {
  constexpr int kWarpsM = 8 / WN;
  constexpr int kM = 16 * MT * kWarpsM;  // positions per block
  constexpr int kNB = 32 * WN;           // output channels per block
  constexpr int kWP = kNB + 8;           // stage pitch (floats)
  constexpr int kTap = kTf32K * kWP;     // one tap's 16 ci × NB in a stage
  constexpr int kStage = 3 * kTap;       // a tap row
  constexpr int kQ = kTf32K / 4;         // 16-byte copies a halo position
  extern __shared__ __align__(16) unsigned char smem[];

  const int ft = f_len >= 16 ? 16 : 8, tt = kM / ft;
  const int hw = ft + 2, hn = (tt + 2) * hw;
  float* raw = reinterpret_cast<float*>(smem);  // [2][hn][kTf32K]: x, res
  float* hi = raw + 2 * hn * kTf32K;            // [hn][kTf32Pitch]
  float* lo = hi + hn * kTf32Pitch;             // [hn][kTf32Pitch]
  float* ring = lo + hn * kTf32Pitch;  // [stages][3 df][16 ci][kWP]
  float* red = ring + kTf32Stages * kStage;  // [kWarpsM][2][kNB]

  const int b = blockIdx.y;
  const int g = blockIdx.z / ksplit, kz = blockIdx.z % ksplit;
  const int tiles_f = (f_len + ft - 1) / ft;
  const int t0 = (blockIdx.x / tiles_f) * tt, f0 = (blockIdx.x % tiles_f) * ft;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t xb = (size_t)b * t_len * f_len * c;
  // this block's steps: chunks kz·chunks/ksplit … (kz + 1)·chunks/ksplit − 1
  const int chunks = c / kTf32K;
  const int s_lo = 3 * (kz * chunks / ksplit);
  const int s_hi = 3 * ((kz + 1) * chunks / ksplit);

  auto load_weights = [&](int s) {
    const int kc = s / 3, dt = s % 3;
    float* dst = ring + (s % kTf32Stages) * kStage;
    for (int i = threadIdx.x; i < 3 * kTf32K * kNB / 4; i += kThreads) {
      const int q = i % (kNB / 4), r = (i / (kNB / 4)) % kTf32K;
      const int df = i / (kTf32K * kNB / 4);
      cp_async16(dst + df * kTap + r * kWP + 4 * q,
                 w + ((size_t)(dt * 3 + df) * c + kc * kTf32K + r) * c +
                     g * kNB + 4 * q);
    }
  };
  auto load_raw = [&](int kc) {
    for (int i = threadIdx.x; i < hn * kQ; i += kThreads) {
      const int hp = i / kQ, q = i % kQ;
      const int t = t0 - 1 + hp / hw, f = f0 - 1 + hp % hw;
      const bool inside = t >= 0 && t < t_len && f >= 0 && f < f_len;
      const size_t off =
          inside ? xb + ((size_t)t * f_len + f) * c + kc * kTf32K + 4 * q : 0;
      cp_async16_zfill(raw + hp * kTf32K + 4 * q, x + off, inside);
      if (res != nullptr)
        cp_async16_zfill(raw + (hn + hp) * kTf32K + 4 * q, res + off, inside);
    }
  };
#pragma unroll
  for (int s = s_lo; s < s_lo + kTf32Stages - 1; ++s) {
    if (s < s_hi) load_weights(s);
    if (s < s_hi && s % 3 == 0) load_raw(s / 3);
    cp_async_commit();
  }

  uint32_t a_base[MT];  // lane's A row (position) in the hi plane, tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = wm * 16 * MT + mt * 16 + (lane & 15);
    a_base[mt] = smem_u32(hi + ((p / ft) * hw + p % ft) * kTf32Pitch +
                          (lane >> 4) * 4);
  }
  const uint32_t lo_off = hn * kTf32Pitch * 4;
  // lane's b0 in a stage: k row tig, column wn·32 + gid (+ 8·nt)
  const float* bst = ring + tig * kWP + wn * 32 + gid;
  float acc[MT][kNT][4];
  zero_acc(acc);

#pragma unroll 1
  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait<kTf32Stages - 2>();
    __syncthreads();  // stage s and its chunk's raw halo visible; slot s − 1
                      // free
    const int kc = s / 3, dt = s % 3;
    if (dt == 0) {  // the chunk's prologue, split once into the planes
      for (int i = threadIdx.x; i < hn * kQ; i += kThreads) {
        const int hp = i / kQ, q = i % kQ;
        const int t = t0 - 1 + hp / hw, f = f0 - 1 + hp % hw;
        float4 v = *reinterpret_cast<const float4*>(raw + hp * kTf32K + 4 * q);
        if (res != nullptr) {
          const float4 r =
              *reinterpret_cast<const float4*>(raw + (hn + hp) * kTf32K + 4 * q);
          v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
        }
        if (pre_scale != nullptr) {
          const int ch = b * c + kc * kTf32K + 4 * q;
          const float4 sc = __ldg(reinterpret_cast<const float4*>(pre_scale + ch));
          const float4 sh = __ldg(reinterpret_cast<const float4*>(pre_shift + ch));
          v = make_float4(v.x * sc.x + sh.x, v.y * sc.y + sh.y,
                          v.z * sc.z + sh.z, v.w * sc.w + sh.w);
        }
        if (pre_silu) v = make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
        if (t < 0 || t >= t_len || f < 0 || f >= f_len)  // pad after norm
          v = make_float4(0.f, 0.f, 0.f, 0.f);
        store_split_tf32(hi + hp * kTf32Pitch + 4 * q,
                         lo + hp * kTf32Pitch + 4 * q, v);
      }
      __syncthreads();  // the planes written; the raw buffers free
    }
    const int nxt = s + kTf32Stages - 1;
    if (nxt < s_hi) load_weights(nxt);
    if (nxt < s_hi && nxt % 3 == 0) load_raw(nxt / 3);
    cp_async_commit();
    const float* bs = bst + (s % kTf32Stages) * kStage;
    float acc_s[MT][kNT][4];
    zero_acc(acc_s);
#pragma unroll
    for (int df = 0; df < 3; ++df) {
      const uint32_t a_off = (dt * hw + df) * kTf32Pitch * 4;
#pragma unroll
      for (int kk = 0; kk < kTf32K / 8; ++kk) {
        uint32_t ah[MT][4], al[MT][4], aa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) aa[mt] = a_base[mt] + a_off + kk * 32;
        load_a_tf32(ah, al, aa, lo_off);
        const float* bp = bs + df * kTap + kk * 8 * kWP;
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
  // the K split's ranks sum in rank 0 (the planes' memory is free by then)
  if (ksplit > 1 && !cluster_sum(acc, smem, ksplit)) return;

  // Epilogue from the registers: add, SiLU, statistics, 16-byte stores.
  const int co = g * kNB + wn * 32 + 8 * tig;
  float av[8], s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    av[k] = add != nullptr ? __ldg(add + b * c + co + k) : 0.f;
    s1[k] = s2[k] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Vec8 o = quad_gather(acc[mt], r, tig);
      const int p = wm * 16 * MT + mt * 16 + gid + 8 * r;
      const int t = t0 + p / ft, f = f0 + p % ft;
      if (t < t_len && f < f_len) {  // the epilogue of an output position
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v = o.v[k] + av[k];
          if (post_silu) v = silu(v);
          s1[k] += v;
          s2[k] += v * v;
          o.v[k] = v;
        }
        store8(out + xb + ((size_t)t * f_len + f) * c + co, o);
      }
    }
  if (stats != nullptr)
    group_stats(s1, s2, red, wm, wn, kWarpsM, kNB,
                stats + ((size_t)b * gridDim.x + blockIdx.x) * 2 * c + g * kNB,
                c);
}

template <int MT, int WN>
cudaError_t launch_conv3x3_tf32(const TilePlan& p, const void* x,
                                const void* res, const float* pre_scale,
                                const float* pre_shift, const void* w,
                                const float* add, void* out, float* stats,
                                int batch, int t_len, int f_len, int c,
                                int pre_silu, int post_silu, cudaStream_t s) {
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_tf32_kernel<MT, WN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return launch_cluster_z(
      conv3x3_tf32_kernel<MT, WN>, p, batch, s, static_cast<const float*>(x),
      static_cast<const float*>(res), pre_scale, pre_shift,
      static_cast<const float*>(w), add, static_cast<float*>(out), stats,
      t_len, f_len, c, pre_silu, post_silu, p.split / p.groups);
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
  if (p.variant == kVariantTf32) {
    // MT from the tile (16·MT·WM positions), WN from the group width; at
    // WN = 1 the plan takes MT = 1 (MT = 2 leaves no room for two blocks)
    const int wn = c / p.groups / 32;
    const int mt = p.tile_t * p.tile_f / (16 * (8 / wn));
    const auto launch = wn == 1    ? launch_conv3x3_tf32<1, 1>
                        : mt == 2 ? launch_conv3x3_tf32<2, 2>
                                  : launch_conv3x3_tf32<1, 2>;
    return static_cast<int>(launch(p, x, res, pre_scale, pre_shift, w, add,
                                   out, stats, batch, t_len, f_len, c,
                                   pre_silu, post_silu, s));
  }
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
