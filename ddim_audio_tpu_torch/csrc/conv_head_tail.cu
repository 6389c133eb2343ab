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
// What bounds them on an H100: bytes. The head writes 16× what it reads
// (64 bytes an output position at C0 = 32, bf16; 128 in fp32), the tail
// reads 32× what it writes (two C0-wide streams). bf16 runs the
// tensor-core kernels below wherever their plan (conv_head_plan,
// conv_tail_plan in conv_plan.h) takes the shape; the fp32 head at C0 = 32
// runs conv_head_tf32_kernel (split TF32, the bf16 head's persistent block)
// where its rows fit; the fp32 tail and the rest run the CUDA-core kernels.
//
// conv_head_mma_kernel (bf16, C0 = 32, Cin <= 4). Its products cannot stay
// on the CUDA cores: 9·Cin·C0 = 576 FMAs an output position are 1.2 G FMA
// a sample at 8192 × 256, 0.036 ms at the 67 TFLOP/s of fp32 FMA, 85% of
// the head's 0.043 ms byte bound, before a single load or store is issued.
// As an MMA the products are an im2col A [positions × (tap, ci)], K = 9·Cin
// = 18 (one k16 and one k8 step of mma.sync bf16 → fp32), times the block's
// weights B [(tap, ci) × C0], N = 32 (four n8 tiles):
//   * persistent blocks, grid.x = min(tiles, 264 / B) a sample, each
//     walking tiles of whole time rows (512 positions: two rows at F = 256)
//     blockIdx.x, + gridDim.x, …; the weights and bias are loaded once a
//     block into B fragments and registers;
//   * the next tile's Cin-wide halo (TT + 2 rows with zero columns at f = −1
//     and F) is in flight by cp.async while the current tile computes;
//   * A fragments are read from the halo as bf16 pairs at per-lane offsets
//     (at Cin = 2 a pair of K is one tap's two channels, one 32-bit word);
//     a warp computes two m16 tiles at once;
//   * the accumulators start at the bias (fp32: the MMA's C operand); B's
//     columns are permuted so that a lane's accumulators are 8 consecutive
//     channels of its position, which leave, rounded once to bf16, as one
//     16-byte word into a staging tile in shared memory (a quarter warp
//     writes 128 contiguous bytes: no bank conflict, no transpose); the
//     tile's rows are contiguous in the output, so one thread hands the
//     whole staged tile (32 KB) to the bulk-copy engine (cp.async.bulk),
//     which writes it while the block computes the next tile into the
//     other staging buffer;
//   * each thread keeps (sum, sum²) of its 8 channels in registers across
//     all of its block's tiles; they are reduced once a block in a fixed
//     order, so there is one partial a block ([B, tiles, 2, C0], a few
//     hundred rows, not one a 64-position tile), and the result is
//     deterministic.
//
// conv_tail_mma_kernel (bf16, C0 % 32 == 0, Cout in {1, 2, 4}). The three
// column taps go into N: P[t, p, (df, co)] = Σ_{dt, ci} v[t+dt−1, p, ci] ·
// w[dt, df, ci, co] is an MMA with K = 3·C0 = 96 and N = 3·Cout = 6 padded
// to 8, and out[t, f, co] = bias[co] + Σ_df P[t, f+df−1, (df, co)] with P at
// p = −1 and p = F taken as zero (a quarter of the MMAs of N = Cout padded
// to 8 with K = 9·C0):
//   * a block owns a band of whole output rows (as many bands as blocks
//     stay resident, conv_tail_plan) and slides down it: each input row of
//     h and residual is staged once, kTailStages rows ahead by cp.async,
//     summed in fp32 and rounded to bf16 once into a ring of three v rows
//     (16-byte words, bf16x2 additions: the exact sum rounded once);
//   * A fragments by ldmatrix from the v rows, B (the weights as
//     [(df, co)][(dt, ci)]) from shared memory, staged once a block;
//   * P goes to shared memory column-major, and the shifted sum reads it
//     back a float4 at a time; each thread forms 4 positions × Cout outputs
//     and stores them as one vector (16 bytes at Cout = 2) where the row
//     allows, so a row of F · Cout bf16 (1 KB at F = 256) leaves in whole
//     lines;
//   * two barriers an input row.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, B = 1): the head
// 0.066 ms (its statistics' torch.sum included) against a byte bound of
// 0.043 and cuDNN's bare conv 0.340 (the CUDA-core kernel: 0.414); the
// tail 0.102 ms against 0.083 and cuDNN's 0.254 (0.232). Taking one piece
// out at a time (tools/conv_ablation.py): the head's bulk stores are what
// holds it (0.059 → 0.039 ms without them; its MMAs and statistics cost
// nothing measurable), the tail's input stream (0.102 → 0.064 ms).
//
// conv_head_kernel (bf16 and fp32 at C0 != 32, fp32 rows too wide for
// conv_head_tf32_kernel) and conv_tail_kernel (fp32), on CUDA cores:
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
#include "conv_mma.cuh"

namespace ddim {

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


// ------------------------------------------------------- tensor cores --

// Bulk copies from shared to global memory (the copy engine of TMA, without
// a tensor map) and their groups; each thread waits for its own groups.
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(gdst)),
      "r"(smem_u32(ssrc)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the newest N groups have finished reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before the copy engine's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D += A·B, A 16×8 (row), B 8×8 (col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// D = A·B + C, A 16×16 (row), B 16×8 (col), bf16, fp32 C and D apart.
__device__ __forceinline__ void mma_bf16_from(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1,
                                              const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The head's K = 9·Cin (tap, ci) in mma.sync steps: whole k16 steps, then
// a k16 step for a remainder above 8 or a k8 step for one of 1 … 8.
template <int CIN>
struct HeadK {
  static constexpr int K = 9 * CIN;
  static constexpr int K16 = K / 16 + (K % 16 > 8 ? 1 : 0);
  static constexpr int K8 = K % 16 > 0 && K % 16 <= 8 ? 1 : 0;
  static constexpr int NPAIR = 2 * K16 + K8;  // A pairs a fragment row
};

constexpr int kZeroK = -(1 << 29);  // an im2col column past K: zero

// Element offset of column k = (tap, ci) of the im2col A from a position's
// own element in the halo (row pitch hp), or kZeroK past K.
template <int CIN>
__device__ __forceinline__ int head_koff(int k, int hp) {
  if (k >= 9 * CIN) return kZeroK;
  const int tap = k / CIN, ci = k % CIN;
  return (tap / 3) * hp + (tap % 3 - 1) * CIN + ci;
}

// Columns k, k + 1 of one A row as a bf16 pair (k in the low half): one
// 32-bit word where Cin is even (both are one tap's channels), else two.
template <int CIN>
__device__ __forceinline__ uint32_t head_pair(const __nv_bfloat16* halo,
                                              int base, int o0, int o1) {
  if constexpr (CIN % 2 == 0) {
    return o0 == kZeroK
               ? 0u
               : *reinterpret_cast<const uint32_t*>(halo + base + o0);
  } else {
    const unsigned short* hs = reinterpret_cast<const unsigned short*>(halo);
    const uint32_t lo = o0 == kZeroK ? 0u : hs[base + o0];
    const uint32_t hi = o1 == kZeroK ? 0u : hs[base + o1];
    return lo | (hi << 16);
  }
}

template <int CIN>
__global__ void __launch_bounds__(kThreads, 2)
    conv_head_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ stats, int t_len, int f_len,
                         int tt) {
  using B16 = __nv_bfloat16;
  using HK = HeadK<CIN>;
  constexpr int C0 = kHeadC0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y;
  // m16 tiles a tile, rounded up to whole kHeadMU (conv_head_plan's m)
  const int mtiles =
      (tt * f_len + 16 * kHeadMU - 1) / (16 * kHeadMU) * kHeadMU;
  const int hp = head_halo_pitch(f_len, CIN);
  const int hrow = f_len * CIN;                // input elements a row
  const int halo_n = (tt + 2) * hp;
  const int n_tiles = (t_len + tt - 1) / tt;
  extern __shared__ __align__(16) unsigned char smem[];
  // [kHeadStages][mtiles·16][C0], [2][tt + 2][hp], [8][2][C0]
  B16* stage = reinterpret_cast<B16*>(smem);
  B16* halo = stage + kHeadStages * mtiles * 16 * C0;
  float* red = reinterpret_cast<float*>(halo + 2 * halo_n);
  const B16* xb = x + (size_t)b * t_len * hrow;

  // Each halo row is positions −1 … F at element 8 − Cin …; the copies fill
  // only positions 0 … F − 1, so the zero columns are written once.
  for (int i = threadIdx.x; i < 2 * halo_n; i += kThreads) {
    const int e = i % hp;
    if (e < 8 || e >= 8 + hrow) halo[i] = __float2bfloat16(0.f);
  }
  // Rows t0 − 1 … t0 + tt of tile `tile` into halo buffer `buf`: 16-byte
  // cp.async copies where a row is whole 16-byte words (zero-filled outside
  // the array), else element by element.
  const bool words = hrow % 8 == 0;
  auto load_halo = [&](int tile, int buf) {
    const int t0 = tile * tt;
    B16* dst = halo + buf * halo_n;
    if (words) {
      const int nq = hrow / 8;
      for (int i = threadIdx.x; i < (tt + 2) * nq; i += kThreads) {
        const int r = i / nq, q = i % nq, t = t0 - 1 + r;
        const bool inside = t >= 0 && t < t_len;
        cp_async16_zfill(dst + r * hp + 8 + 8 * q,
                         xb + (inside ? (size_t)t * hrow : 0) + 8 * q, inside);
      }
    } else {
      for (int i = threadIdx.x; i < (tt + 2) * hrow; i += kThreads) {
        const int r = i / hrow, e = i % hrow, t = t0 - 1 + r;
        dst[r * hp + 8 + e] = t >= 0 && t < t_len ? xb[(size_t)t * hrow + e]
                                                  : __float2bfloat16(0.f);
      }
    }
  };

  // The weights as B fragments, once: B[k][n] = w[k·C0 + ch(n)], zero past
  // K, lane (gid, tig) holding column n = 8·nt + gid, rows 2·tig (+1) (+8).
  // The columns are permuted, ch(8·nt + 2·q + e) = 8·q + 2·nt + e, so that
  // the accumulators of lane (gid, tig), columns 8·nt + 2·tig + e of the
  // four n8 tiles, are channels 8·tig … 8·tig + 7 in order: the epilogue
  // stores them as one 16-byte word, with no transpose.
  auto wv = [&](int k, int ch) -> uint32_t {
    return k < HK::K ? bf16_bits(w[k * C0 + ch]) : 0u;
  };
  uint32_t bw[HK::K16][4][2], bw8[4];
  float bs[4][4];  // the bias as each n8 tile's accumulators start
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int ch = 8 * (gid >> 1) + 2 * nt + (gid & 1);
#pragma unroll
    for (int s = 0; s < HK::K16; ++s) {
      const int k0 = 16 * s + 2 * tig;
      bw[s][nt][0] = wv(k0, ch) | wv(k0 + 1, ch) << 16;
      bw[s][nt][1] = wv(k0 + 8, ch) | wv(k0 + 9, ch) << 16;
    }
    const int k8 = 16 * HK::K16 + 2 * tig;
    bw8[nt] = HK::K8 ? wv(k8, ch) | wv(k8 + 1, ch) << 16 : 0u;
    bs[nt][0] = bs[nt][2] = bias[8 * tig + 2 * nt];
    bs[nt][1] = bs[nt][3] = bias[8 * tig + 2 * nt + 1];
  }
  // The lane's im2col columns: pair j = (k16 step j / 2, high half j % 2),
  // then the k8 step's pair.
  int o0[HK::NPAIR], o1[HK::NPAIR];
#pragma unroll
  for (int j = 0; j < HK::NPAIR; ++j) {
    const int k = j < 2 * HK::K16 ? 16 * (j / 2) + 8 * (j % 2) + 2 * tig
                                  : 16 * HK::K16 + 2 * tig;
    o0[j] = head_koff<CIN>(k, hp);
    o1[j] = head_koff<CIN>(k + 1, hp);
  }
  float s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;

  int it = 0;
  if ((int)blockIdx.x < n_tiles) load_halo(blockIdx.x, 0);
  cp_async_commit();
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int nxt = tile + gridDim.x;
    if (nxt < n_tiles) load_halo(nxt, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    // the store of kHeadStages tiles ago has read this staging buffer
    if (threadIdx.x == 0) bulk_wait_read<kHeadStages - 1>();
    __syncthreads();
    const B16* hal = halo + (it & 1) * halo_n;
    B16* stg = stage + (it % kHeadStages) * mtiles * 16 * C0;
    const int t0 = tile * tt;
    const int valid = min(tt, t_len - t0) * f_len;  // positions in the array
    // warp w: m16 tiles kHeadMU·w … + kHeadMU − 1, then 8·kHeadMU further
#pragma unroll 1
    for (int m0 = kHeadMU * warp; m0 < mtiles; m0 += kHeadMU * kWarps) {
      // rows gid and gid + 8 of each m16 tile: their positions' elements
      int base[kHeadMU][2];
      bool ok[kHeadMU][2];
      {
        int r = 16 * m0 / f_len, f = 16 * m0 - r * f_len + gid;
#pragma unroll
        for (int u = 0; u < kHeadMU; ++u)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            while (f >= f_len) {
              f -= f_len;
              ++r;
            }
            ok[u][hh] = 16 * (m0 + u) + gid + 8 * hh < valid;
            base[u][hh] = ok[u][hh] ? r * hp + 8 + f * CIN : 8;
            f += 8;
          }
      }
      // fp32 accumulators that start at the bias (fp32), then + A·B
      float acc[kHeadMU][4][4];
#pragma unroll
      for (int u = 0; u < kHeadMU; ++u) {
#pragma unroll
        for (int s = 0; s < HK::K16; ++s) {
          const uint32_t a[4] = {
              head_pair<CIN>(hal, base[u][0], o0[2 * s], o1[2 * s]),
              head_pair<CIN>(hal, base[u][1], o0[2 * s], o1[2 * s]),
              head_pair<CIN>(hal, base[u][0], o0[2 * s + 1], o1[2 * s + 1]),
              head_pair<CIN>(hal, base[u][1], o0[2 * s + 1], o1[2 * s + 1])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (s == 0)
              mma_bf16_from(acc[u][nt], a, bw[s][nt][0], bw[s][nt][1],
                            bs[nt]);
            else
              mma_bf16(acc[u][nt], a, bw[s][nt][0], bw[s][nt][1]);
          }
        }
        if constexpr (HK::K8 == 1) {
          constexpr int j = 2 * HK::K16;
          const uint32_t a0 = head_pair<CIN>(hal, base[u][0], o0[j], o1[j]);
          const uint32_t a1 = head_pair<CIN>(hal, base[u][1], o0[j], o1[j]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16_k8(acc[u][nt], a0, a1, bw8[nt]);
        }
      }
      // statistics of the fp32 output, one rounding, staging: lane (gid,
      // tig) writes channels 8·tig … 8·tig + 7 of its two positions as
      // 16-byte words, a quarter warp 128 contiguous bytes (m16 tiles past
      // the tile's last write into the staging pad)
#pragma unroll
      for (int u = 0; u < kHeadMU; ++u)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t wd[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float v0 = acc[u][nt][2 * hh];
            const float v1 = acc[u][nt][2 * hh + 1];
            if (ok[u][hh]) {
              s1[2 * nt] += v0;
              s2[2 * nt] += v0 * v0;
              s1[2 * nt + 1] += v1;
              s2[2 * nt + 1] += v1 * v1;
            }
            wd[nt] = pack_bf16x2(v0, v1);
          }
          *reinterpret_cast<uint4*>(
              stg + (16 * (m0 + u) + gid + 8 * hh) * C0 + 8 * tig) =
              make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
    }
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {  // the tile's rows are contiguous in the output
      bulk_store(out + ((size_t)b * t_len + t0) * f_len * C0, stg,
                 valid * C0 * 2);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
  if (stats == nullptr) return;
  // One partial a block: over the quad columns by shuffles, then over the
  // warps in order.
  sum_over_gid(s1);
  sum_over_gid(s2);
  if (gid == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 8 * tig + k;
      red[(warp * 2) * C0 + c] = s1[k];
      red[(warp * 2 + 1) * C0 + c] = s2[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C0) {
    const int which = threadIdx.x / C0, c = threadIdx.x % C0;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[(wi * 2 + which) * C0 + c];
    stats[((size_t)b * gridDim.x + blockIdx.x) * 2 * C0 + which * C0 + c] = v;
  }
}

// The fp32 head on the bf16 head's persistent block in split TF32: each
// fp32 x and w value is hi + lo, two TF32 values (cvt.rna), and each
// product is lo·hi + hi·lo + hi·hi on mma.sync.m16n8k8 (fp32 accuracy).
// K = 9·Cin (18 at Cin = 2) in whole k8 steps (24), N = C0 = 32 in four
// n8 tiles whose columns are permuted as conv_head_mma_kernel's, M = the
// tile's positions. Per tile: the raw halo (TT + 2 rows of Cin-wide positions
// −1 … F, zero outside the array) lands by cp.async while the previous
// tile computes, and is split once into a hi and a lo plane, from which
// the lanes read their A values at per-lane offsets (9 taps read each
// value); the sum of the k8 steps is taken from zero on the tensor cores
// and the bias added by one IEEE add; a lane's 8 consecutive channels of a
// position leave as two 16-byte stores (a warp's 16 positions are 2 KB of
// contiguous output) while the block goes on; statistics stay in
// registers across the block's tiles. Measured on an H100 80GB HBM3 at
// 700 W (tools/conv_ablation.py, B = 1, 8192 × 256): 0.116 ms against a
// byte bound of 0.085; the outputs staged for the bulk-copy engine as the
// bf16 head does (which writes half the bytes) took 0.156, the same block
// with its products on CUDA cores 0.201.
template <int CIN>
struct Head32K {
  static constexpr int K = 9 * CIN;
  static constexpr int KS = (K + 7) / 8;  // k8 steps
};

template <int CIN>
__global__ void __launch_bounds__(kThreads, 2)
    conv_head_tf32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ out, float* __restrict__ stats,
                          int t_len, int f_len, int tt) {
  using HK = Head32K<CIN>;
  constexpr int C0 = kHeadC0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y;
  const int mtiles = (tt * f_len + 15) / 16;  // m16 tiles a tile
  const int hp = head32_halo_pitch(f_len, CIN);
  const int hrow = f_len * CIN;  // input floats a row
  const int halo_n = (tt + 2) * hp;
  const int n_tiles = (t_len + tt - 1) / tt;
  extern __shared__ __align__(16) unsigned char smem[];
  // raw [2][tt + 2][hp], hi, lo [tt + 2][hp], [8][2][C0]
  float* raw = reinterpret_cast<float*>(smem);
  float* hi = raw + 2 * halo_n;
  float* lo = hi + halo_n;
  float* red = lo + halo_n;
  const float* xb = x + (size_t)b * t_len * hrow;
  constexpr int P0 = kHead32Pad;  // position 0's first float in a halo row

  // The copies fill positions 0 … F − 1 of the raw rows; the pad, the zero
  // columns and the pitch's tail are written once.
  for (int i = threadIdx.x; i < 2 * halo_n; i += kThreads) raw[i] = 0.f;
  __syncthreads();
  const bool words = hrow % 4 == 0;
  auto load_halo = [&](int tile, int buf) {
    const int t0 = tile * tt;
    float* dst = raw + buf * halo_n;
    if (words) {
      const int nq = hrow / 4;
      for (int i = threadIdx.x; i < (tt + 2) * nq; i += kThreads) {
        const int r = i / nq, q = i % nq, t = t0 - 1 + r;
        const bool inside = t >= 0 && t < t_len;
        cp_async16_zfill(dst + r * hp + P0 + 4 * q,
                         xb + (inside ? (size_t)t * hrow : 0) + 4 * q, inside);
      }
    } else {
      for (int i = threadIdx.x; i < (tt + 2) * hrow; i += kThreads) {
        const int r = i / hrow, e = i % hrow, t = t0 - 1 + r;
        dst[r * hp + P0 + e] =
            t >= 0 && t < t_len ? xb[(size_t)t * hrow + e] : 0.f;
      }
    }
  };

  // B fragments (hi, lo) once: B[k][n] = w[k·C0 + ch(n)], zero past K,
  // ch(8·nt + 2·q + e) = 8·q + 2·nt + e as conv_head_mma_kernel's, so that
  // lane (gid, tig)'s accumulators are channels 8·tig … 8·tig + 7 in order.
  uint32_t bh[HK::KS][4][2], bl[HK::KS][4][2];
  float bs[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int ch = 8 * (gid >> 1) + 2 * nt + (gid & 1);
#pragma unroll
    for (int s = 0; s < HK::KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + tig + 4 * h;
        split_tf32(k < HK::K ? w[k * C0 + ch] : 0.f, bh[s][nt][h],
                   bl[s][nt][h]);
      }
    bs[nt][0] = bias[8 * tig + 2 * nt];
    bs[nt][1] = bias[8 * tig + 2 * nt + 1];
  }
  // The lane's im2col offsets: columns 8·s + tig (+ 4) of each k8 step.
  int ok0[HK::KS], ok1[HK::KS];
#pragma unroll
  for (int s = 0; s < HK::KS; ++s) {
    auto koff = [&](int k) {
      if (k >= HK::K) return kZeroK;
      const int tap = k / CIN, ci = k % CIN;
      return (tap / 3) * hp + (tap % 3 - 1) * CIN + ci;
    };
    ok0[s] = koff(8 * s + tig);
    ok1[s] = koff(8 * s + tig + 4);
  }
  float s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
  int r0[2], f0[2];  // tile row and column of the lane's first two rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = 16 * warp + gid + 8 * hh;
    r0[hh] = p / f_len;
    f0[hh] = p - r0[hh] * f_len;
  }

  int it = 0;
  if ((int)blockIdx.x < n_tiles) load_halo(blockIdx.x, 0);
  cp_async_commit();
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile's halo landed; the last tile's planes are read
    const int nxt = tile + gridDim.x;
    if (nxt < n_tiles) load_halo(nxt, (it + 1) & 1);
    cp_async_commit();
    const float* src = raw + (it & 1) * halo_n;
    for (int i = 4 * threadIdx.x; i < halo_n; i += 4 * kThreads)  // the split
      store_split_tf32(hi + i, lo + i,
                       *reinterpret_cast<const float4*>(src + i));
    __syncthreads();
    const int t0 = tile * tt;
    const int valid = min(tt, t_len - t0) * f_len;  // positions in the array
    float* out_t = out + ((size_t)b * t_len + t0) * f_len * C0 + 8 * tig;
    // warp w: m16 tiles w, w + 8, …; rows gid and gid + 8 of each at tile
    // row r[hh], column f[hh], carried from one m16 tile to the next
    int r[2] = {r0[0], r0[1]}, f[2] = {f0[0], f0[1]};
#pragma unroll 1
    for (int m = warp; m < mtiles; m += kWarps) {
      int base[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ok[hh] = 16 * m + gid + 8 * hh < valid;
        base[hh] = ok[hh] ? r[hh] * hp + P0 + f[hh] * CIN : P0;
        for (f[hh] += 16 * kWarps; f[hh] >= f_len; f[hh] -= f_len) ++r[hh];
      }
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
#pragma unroll
      for (int s = 0; s < HK::KS; ++s) {
        uint32_t ah[4], al[4];
        const int o[4] = {base[0] + ok0[s], base[1] + ok0[s],
                          base[0] + ok1[s], base[1] + ok1[s]};
        const bool z[4] = {ok0[s] == kZeroK, ok0[s] == kZeroK,
                           ok1[s] == kZeroK, ok1[s] == kZeroK};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[j] = z[j] ? 0u : __float_as_uint(hi[o[j]]);
          al[j] = z[j] ? 0u : __float_as_uint(lo[o[j]]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32x3(acc[nt], ah, al, bh[s][nt], bl[s][nt]);
      }
      // + bias, statistics, stores: lane (gid, tig) writes channels
      // 8·tig … 8·tig + 7 of its two positions as two 16-byte words
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[2 * nt + e] = __fadd_rn(acc[nt][2 * hh + e], bs[nt][e]);
            if (ok[hh]) {
              s1[2 * nt + e] += v[2 * nt + e];
              s2[2 * nt + e] += v[2 * nt + e] * v[2 * nt + e];
            }
          }
        if (ok[hh]) {
          float* dst = out_t + (size_t)(16 * m + gid + 8 * hh) * C0;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
  if (stats == nullptr) return;
  // One partial a block: over the quad columns by shuffles, then over the
  // warps in order.
  sum_over_gid(s1);
  sum_over_gid(s2);
  if (gid == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[(warp * 2) * C0 + 8 * tig + k] = s1[k];
      red[(warp * 2 + 1) * C0 + 8 * tig + k] = s2[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C0) {
    const int which = threadIdx.x / C0, c = threadIdx.x % C0;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[(wi * 2 + which) * C0 + c];
    stats[((size_t)b * gridDim.x + blockIdx.x) * 2 * C0 + which * C0 + c] = v;
  }
}

// Eight bf16 sums of two 16-byte words, each the exact sum rounded once
// (bf16x2 additions), which is the fp32 sum rounded to bf16.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  uint4 s;
  const uint32_t* x = &a.x;
  const uint32_t* y = &b.x;
  uint32_t* d = &s.x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 t =
        __hadd2(*reinterpret_cast<const __nv_bfloat162*>(x + k),
                *reinterpret_cast<const __nv_bfloat162*>(y + k));
    d[k] = *reinterpret_cast<const uint32_t*>(&t);
  }
  return s;
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, 1)
    conv_tail_mma_kernel(const __nv_bfloat16* __restrict__ h,
                         const __nv_bfloat16* __restrict__ res,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int t_len,
                         int f_len, int c0, int band) {
  using B16 = __nv_bfloat16;
  constexpr int NT = (3 * COUT + 7) / 8, NP = 8 * NT, S = kTailStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y;
  const int fp = (f_len + 15) / 16 * 16;  // positions of a v row (m16 tiles)
  const int vp = c0 + 8;                  // v row pitch: ldmatrix rows in
                                          // distinct banks
  const int kp = 3 * c0 + 8;              // weight row pitch
  const int pp = fp + 4;                  // P column pitch: 4 mod 32 words
  const int row = f_len * c0;             // elements of an input row
  extern __shared__ __align__(16) unsigned char smem[];
  B16* vring = reinterpret_cast<B16*>(smem);  // [3][fp][vp]
  B16* raw = vring + 3 * fp * vp;             // [S][h, residual][row]
  float* P = reinterpret_cast<float*>(raw + S * 2 * row);  // [NP][pp]
  B16* ws = reinterpret_cast<B16*>(P + NP * pp);          // [NP][kp]

  // B[(dt, ci)][(df, co)] = w[dt, df, ci, co], stored [(df, co)][(dt, ci)]
  for (int i = threadIdx.x; i < NP * 3 * c0; i += kThreads) {
    const int n = i / (3 * c0), k = i % (3 * c0);
    const int df = n / COUT, co = n % COUT, dt = k / c0, ci = k % c0;
    ws[n * kp + k] = n < 3 * COUT
                         ? w[((size_t)(dt * 3 + df) * c0 + ci) * COUT + co]
                         : __float2bfloat16(0.f);
  }
  // v rows' positions F … fp − 1 (the last m16 tile's) stay zero
  const int pad = (fp - f_len) * vp;
  for (int i = threadIdx.x; i < 3 * pad; i += kThreads)
    vring[(i / pad) * fp * vp + f_len * vp + i % pad] = __float2bfloat16(0.f);
  float bv[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) bv[co] = bias[co];

  // The band: output rows r0 … r1 − 1 from input rows r0 − 1 … r1 (j = 0 …
  // n_in − 1); input row j sits in raw slot j % S, then in v slot j % 3.
  const int r0 = blockIdx.x * band, r1 = min(t_len, r0 + band);
  const int n_in = r1 - r0 + 2;
  const size_t plane = (size_t)t_len * row;
  const B16* hb = h + b * plane;
  const B16* rb = res != nullptr ? res + b * plane : nullptr;
  auto load_raw = [&](int j) {
    const int u = r0 - 1 + j;
    if (j >= n_in || u < 0 || u >= t_len) return;
    B16* dst = raw + (j % S) * 2 * row;
    const size_t off = (size_t)u * row;
    for (int i = threadIdx.x; i < row / 8; i += kThreads) {
      cp_async16(dst + 8 * i, hb + off + 8 * i);
      if (rb != nullptr) cp_async16(dst + row + 8 * i, rb + off + 8 * i);
    }
  };
  // P[(df, co)][p] of the output row whose inputs are j − 2, j − 1, j: warp
  // w owns m16 tiles w, w + 8, …; A by ldmatrix from the v rows, B from ws.
  auto mma_row = [&](int j) {
    const int kc_n = c0 / 16;
#pragma unroll 1
    for (int m = warp; m < fp / 16; m += kWarps) {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const B16* vs = vring + ((j - 2 + dt) % 3) * fp * vp;
        const uint32_t a_base =
            smem_u32(vs + (16 * m + (lane & 15)) * vp + (lane >> 4) * 8);
#pragma unroll 2
        for (int kc = 0; kc < kc_n; ++kc) {
          uint32_t a[4];
          ldsm_x4(a, a_base + kc * 32);
          const int k0 = (dt * kc_n + kc) * 16 + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const B16* wr = ws + (8 * nt + gid) * kp + k0;
            mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(wr),
                     *reinterpret_cast<const uint32_t*>(wr + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 16 * m + gid + 8 * hh, n = 8 * nt + 2 * tig;
          P[n * pp + p] = acc[nt][2 * hh];
          P[(n + 1) * pp + p] = acc[nt][2 * hh + 1];
        }
    }
  };
  // out[t, f, co] = bias[co] + P[(0, co)][f − 1] + P[(1, co)][f]
  // + P[(2, co)][f + 1], P outside 0 … F − 1 zero; a thread forms positions
  // 4i … 4i + 3 and stores their 4·Cout values as one vector where F % 4 == 0.
  auto epilogue = [&](int t) {
    B16* orow = out + ((size_t)b * t_len + t) * f_len * COUT;
    for (int i = threadIdx.x; 4 * i < f_len; i += kThreads) {
      const int f0 = 4 * i;
      float v[4][COUT];
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        const float4 l = *reinterpret_cast<const float4*>(P + co * pp + f0);
        const float4 c =
            *reinterpret_cast<const float4*>(P + (COUT + co) * pp + f0);
        const float4 r =
            *reinterpret_cast<const float4*>(P + (2 * COUT + co) * pp + f0);
        const float prev = f0 > 0 ? P[co * pp + f0 - 1] : 0.f;
        const float next =
            f0 + 4 < f_len ? P[(2 * COUT + co) * pp + f0 + 4] : 0.f;
        const float lv[4] = {prev, l.x, l.y, l.z};
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float rv[4] = {r.y, r.z, r.w, next};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k][co] = ((bv[co] + lv[k]) + cv[k]) +
                     (f0 + k + 1 < f_len ? rv[k] : 0.f);
      }
      if (f_len % 4 == 0) {
        uint32_t wd[2 * COUT];
#pragma unroll
        for (int q = 0; q < 2 * COUT; ++q)
          wd[q] = pack_bf16x2(v[(2 * q) / COUT][(2 * q) % COUT],
                              v[(2 * q + 1) / COUT][(2 * q + 1) % COUT]);
        B16* dst = orow + f0 * COUT;
        if constexpr (COUT == 1) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        } else {
#pragma unroll
          for (int q = 0; q < COUT / 2; ++q)
            *reinterpret_cast<uint4*>(dst + 8 * q) =
                make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2],
                           wd[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (f0 + k < f_len)
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              orow[(f0 + k) * COUT + co] = __float2bfloat16(v[k][co]);
      }
    }
  };

#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    load_raw(j);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n_in; ++j) {
    cp_async_wait<S - 1>();  // input row j has landed
    __syncthreads();
    {  // v row j = bf16(h + residual), zero outside the array
      const int u = r0 - 1 + j, cq = c0 / 8;
      const bool inside = u >= 0 && u < t_len;
      B16* vs = vring + (j % 3) * fp * vp;
      const B16* rs = raw + (j % S) * 2 * row;
      for (int i = threadIdx.x; i < row / 8; i += kThreads) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (inside) {
          v = *reinterpret_cast<const uint4*>(rs + 8 * i);
          if (rb != nullptr)
            v = add_bf16x8(v, *reinterpret_cast<const uint4*>(rs + row + 8 * i));
        }
        *reinterpret_cast<uint4*>(vs + (i / cq) * vp + 8 * (i % cq)) = v;
      }
    }
    if (j >= 3) epilogue(r0 + j - 3);  // the row MMA'd last iteration
    __syncthreads();
    load_raw(j + S);
    cp_async_commit();
    if (j >= 2) mma_row(j);
  }
  __syncthreads();
  epilogue(r1 - 1);
}

template <int CIN>
cudaError_t launch_head_mma(const TilePlan& p, const void* x, const void* w,
                            const float* bias, void* out, float* stats,
                            int batch, int t_len, int f_len, cudaStream_t s) {
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_head_mma_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  using T = __nv_bfloat16;
  conv_head_mma_kernel<CIN><<<dim3(p.tiles, batch), kThreads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), stats, t_len, f_len, p.tile_t);
  return cudaGetLastError();
}

template <int CIN>
cudaError_t launch_head_tf32(const TilePlan& p, const void* x, const void* w,
                             const float* bias, void* out, float* stats,
                             int batch, int t_len, int f_len, cudaStream_t s) {
  static int raised = 48 * 1024;  // per instantiation; one card per process
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_head_tf32_kernel<CIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    raised = p.smem;
  }
  conv_head_tf32_kernel<CIN>
      <<<dim3(p.tiles, batch), kThreads, p.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), stats, t_len, f_len, p.tile_t);
  return cudaGetLastError();
}

template <int COUT>
cudaError_t launch_tail_mma(const TilePlan& p, const void* h, const void* res,
                            const void* w, const float* bias, void* out,
                            int batch, int t_len, int f_len, int c0,
                            cudaStream_t s) {
  static bool raised = false;  // per instantiation; one card per process
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_tail_mma_kernel<COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  using T = __nv_bfloat16;
  conv_tail_mma_kernel<COUT><<<dim3(p.tiles, batch), kThreads, p.smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(res),
      static_cast<const T*>(w), bias, static_cast<T*>(out), t_len, f_len, c0,
      p.tile_t);
  return cudaGetLastError();
}

// The CUDA-core tail (fp32).
cudaError_t launch_tail(const void* h, const void* res, const void* w,
                        const float* bias, void* out, int batch, int t_len,
                        int f_len, int c0, int c_out, cudaStream_t s) {
  const dim3 grid(((t_len + kTailTt - 1) / kTailTt) *
                      ((f_len + kTailFt - 1) / kTailFt),
                  batch);
  const float* hp = static_cast<const float*>(h);
  const float* rp = static_cast<const float*>(res);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  switch (c_out) {
    case 1:
      conv_tail_kernel<float, 1><<<grid, kThreads, 0, s>>>(
          hp, rp, wp, bias, op, t_len, f_len, c0);
      break;
    case 2:
      conv_tail_kernel<float, 2><<<grid, kThreads, 0, s>>>(
          hp, rp, wp, bias, op, t_len, f_len, c0);
      break;
    case 4:
      conv_tail_kernel<float, 4><<<grid, kThreads, 0, s>>>(
          hp, rp, wp, bias, op, t_len, f_len, c0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace ddim

extern "C" {

// x: [B, T, F, Cin], out: [B, T, F, C0] (fp32 or bf16, as `bf16` says);
// w: [3, 3, Cin, C0] in the same dtype; bias: [C0] fp32; stats:
// [B, tiles, 2, C0] fp32 or null, tiles = conv_head_plan(...).tiles
// (ddim_conv_head_plan). Cin <= 4; every pointer 16-byte aligned.
int ddim_conv_head(const void* x, const void* w, const float* bias, void* out,
                   float* stats, int batch, int t_len, int f_len, int c_in,
                   int c0, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_head_plan(t_len, f_len, c_in, c0, bf16, batch);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma) {
    switch (c_in) {
      case 1:
        return static_cast<int>(launch_head_mma<1>(p, x, w, bias, out, stats,
                                                   batch, t_len, f_len, s));
      case 2:
        return static_cast<int>(launch_head_mma<2>(p, x, w, bias, out, stats,
                                                   batch, t_len, f_len, s));
      case 3:
        return static_cast<int>(launch_head_mma<3>(p, x, w, bias, out, stats,
                                                   batch, t_len, f_len, s));
      case 4:
        return static_cast<int>(launch_head_mma<4>(p, x, w, bias, out, stats,
                                                   batch, t_len, f_len, s));
    }
  }
  if (p.variant == kVariantTf32) {
    switch (c_in) {
      case 1:
        return static_cast<int>(launch_head_tf32<1>(p, x, w, bias, out, stats,
                                                    batch, t_len, f_len, s));
      case 2:
        return static_cast<int>(launch_head_tf32<2>(p, x, w, bias, out, stats,
                                                    batch, t_len, f_len, s));
      case 3:
        return static_cast<int>(launch_head_tf32<3>(p, x, w, bias, out, stats,
                                                    batch, t_len, f_len, s));
      case 4:
        return static_cast<int>(launch_head_tf32<4>(p, x, w, bias, out, stats,
                                                    batch, t_len, f_len, s));
    }
  }
  if (p.variant != kVariantFma) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.tiles, batch, (c0 + kCoTile - 1) / kCoTile);
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
// {1, 2, 4}; every pointer 16-byte aligned (h and res are read 16 bytes at
// a time).
int ddim_conv_tail(const void* h, const void* res, const void* w,
                   const float* bias, void* out, int batch, int t_len,
                   int f_len, int c0, int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_tail_plan(t_len, f_len, c0, c_out, bf16, batch);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p.variant == kVariantMma) {
    switch (c_out) {
      case 1:
        return static_cast<int>(launch_tail_mma<1>(
            p, h, res, w, bias, out, batch, t_len, f_len, c0, s));
      case 2:
        return static_cast<int>(launch_tail_mma<2>(
            p, h, res, w, bias, out, batch, t_len, f_len, c0, s));
      case 4:
        return static_cast<int>(launch_tail_mma<4>(
            p, h, res, w, bias, out, batch, t_len, f_len, c0, s));
    }
  }
  if (p.variant != kVariantFma) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tail(h, res, w, bias, out, batch, t_len,
                                      f_len, c0, c_out, s));
}

}  // extern "C"
