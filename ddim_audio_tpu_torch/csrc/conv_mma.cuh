// Pieces of the tensor-core conv kernels (conv3x3.cu, conv3x3_store.cu,
// conv_strided.cu up and down; conv3x3_int8.cu and conv_strided_int8.cu take
// the copies, ldmatrix, the int8 items and requant and the statistics):
// cp.async staging, ldmatrix fragment loads, mma.sync.m16n8k16 bf16 → fp32
// and m16n8k8 split TF32 → fp32 (the split at staging or in the registers,
// the fold of a step's sum, the K split's sum over a cluster, the cluster
// launch), the register
// epilogue's quad transpose and statistics, and the conv3x3 block's weight
// ring and tap steps (Conv3x3Mma), which the float-tap and the int8-storage
// conv3x3 share.
//
// Warp tile: MT m16 tiles (16·MT positions, one per A-fragment row) × 4 n8
// tiles (32 output channels). A rows are positions of the staged halo, read
// with ldmatrix at each position's own address, so no im2col copy exists;
// B is a weight stage [32 ci][n co] (co contiguous as in HWIO) read with
// ldmatrix.trans, so no repack exists either.
#pragma once

#include <cooperative_groups.h>

#include "conv_common.cuh"

namespace ddim {

constexpr int kMT = 2;  // m16 tiles per warp of conv3x3 (up: a parameter)
constexpr int kNT = 4;  // n8 tiles per warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// As cp_async16, but writes 16 zero bytes (reading nothing) unless `inside`.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Eight bf16 values (one 16-byte load) widened to fp32.
__device__ __forceinline__ Vec8 unpack8(uint4 raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out.v[2 * k] = f.x;
    out.v[2 * k + 1] = f.y;
  }
  return out;
}

// silu with the fast exponential and division (a few ulp of fp32): the
// bf16 tensor-core kernels round its result to bf16 or hold it to a bf16
// tolerance, so they need not spend the instruction sequence of the IEEE
// division in conv_common.cuh's silu, twice a value in conv3x3.
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A·B, A 16×16 (row), B 16×8 (col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 (cvt.rna: round to nearest, ties away from zero, onto 10 explicit
// mantissa bits; the low 13 bits zero) of an fp32 value.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 of |v|: hi its TF32 rounding, lo the TF32
// rounding of the (exact) remainder. Zero splits into two zeros.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// D += A·B, A 16×8 (row), B 8×8 (col), TF32 operands, fp32 accumulators.
// Fragments: a0 (row gid, k tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
// a3 (gid + 8, tig + 4); b0 (k tig, n gid), b1 (k tig + 4, n gid); D as
// mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A·B in split TF32: lo·hi + hi·lo + hi·hi, the small products first
// (lo·lo, about 2^-22 of the product, is left out).
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// A fragment (m16n8k8 TF32) at ldmatrix address addr, split in the
// registers into its hi and lo halves.
__device__ __forceinline__ void split_a_tf32(uint32_t (&ah)[4],
                                             uint32_t (&al)[4],
                                             uint32_t addr) {
  uint32_t r[4];
  ldsm_x4(r, addr);
#pragma unroll
  for (int k = 0; k < 4; ++k) split_tf32(__uint_as_float(r[k]), ah[k], al[k]);
}

// Four staged values into the hi and lo planes of a split-TF32 halo chunk.
// The conv3x3 and up kernels split each halo value once, at staging (it
// feeds 9 taps in conv3x3, 4 in the up conv), and ldmatrix reads the planes
// as they are; a split of each A fragment in the registers after its
// ldmatrix, as the down conv does, measured 9-10% slower summed over the
// training shapes on an H100 (PERF.md).
__device__ __forceinline__ void store_split_tf32(float* hi, float* lo,
                                                 float4 v) {
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// A fragments (hi, lo) of MT m16 tiles from the planes: the lane's
// ldmatrix addresses a[mt] in the hi plane, the lo plane lo_off bytes on.
template <int MT>
__device__ __forceinline__ void load_a_tf32(uint32_t (&ah)[MT][4],
                                            uint32_t (&al)[MT][4],
                                            const uint32_t (&a)[MT],
                                            uint32_t lo_off) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    ldsm_x4(ah[mt], a[mt]);
    ldsm_x4(al[mt], a[mt] + lo_off);
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
}

// acc += part by IEEE fp32 additions: the tensor cores' fp32 accumulation
// is not round-to-nearest, so a split-TF32 kernel sums each ring step into
// accumulators of its own (part) and folds them in here.
template <int MT>
__device__ __forceinline__ void fold_acc(float (&acc)[MT][kNT][4],
                                         const float (&part)[MT][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[mt][nt][k] = __fadd_rn(acc[mt][nt][k], part[mt][nt][k]);
}

// The K split's sum over a thread block cluster: each rank leaves its sums
// in its own shared memory (`scratch`, free by then: MT·kNT·kThreads
// float4s, [fragment][thread]), and rank 0 adds the ranks' sums in rank
// order over distributed shared memory, so the result does not depend on
// which block finishes first. Every thread of every rank calls it; returns
// true in rank 0, which goes on to the epilogue.
template <int MT>
__device__ __forceinline__ bool cluster_sum(float (&acc)[MT][kNT][4],
                                            void* scratch, int ksplit) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float4* part = reinterpret_cast<float4*>(scratch);
  __syncthreads();  // every warp is done with the shared memory
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      part[(mt * kNT + nt) * kThreads + threadIdx.x] = make_float4(
          acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3]);
  cluster.sync();  // every rank's sums are visible to the cluster
  const bool first = cluster.block_rank() == 0;
  if (first) {
    zero_acc(acc);
    for (int r = 0; r < ksplit; ++r) {
      const float4* src = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float4 v = src[(mt * kNT + nt) * kThreads + threadIdx.x];
          acc[mt][nt][0] = __fadd_rn(acc[mt][nt][0], v.x);
          acc[mt][nt][1] = __fadd_rn(acc[mt][nt][1], v.y);
          acc[mt][nt][2] = __fadd_rn(acc[mt][nt][2], v.z);
          acc[mt][nt][3] = __fadd_rn(acc[mt][nt][3], v.w);
        }
    }
  }
  cluster.sync();  // rank 0 has read every rank's shared memory
  return first;
}

// cudaLaunchKernelEx of a split-TF32 kernel on the plan's grid (tiles,
// batch, split): the K split's blocks of a (tile, group), split / groups of
// them, form one cluster along z.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster_z(Kernel kernel, const TilePlan& p, int batch,
                             cudaStream_t s, Args... args) {
  const int ksplit = p.split / p.groups;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, batch, p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = ksplit > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One k16 step of a warp tile of MT m16 tiles: A rows at a_addr[mt] (byte
// addresses in shared memory of lane l's row l % 16, k half l / 16), B from
// a stage at b_addr (lane l's k row and n half, see below).
template <int MT>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][kNT][4],
                                             const uint32_t (&a_addr)[MT],
                                             uint32_t b_addr, int b_np_stride) {
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], a_addr[mt]);
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, b_addr + np * b_np_stride);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
      mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
    }
  }
}

// Byte offset, within a weight stage row block, of lane l's ldmatrix.trans
// row: matrix l / 8 covers k rows 8·(m & 1) … +7 and n columns 8·(m >> 1)
// … +7 of a k16 × n16 block, so the four results are (b0, b1) of n tile
// 2·np and (b0, b1) of n tile 2·np + 1.
__device__ __forceinline__ int b_lane_offset(int lane, int wp) {
  const int m = lane >> 3;
  return (((lane & 7) + 8 * (m & 1)) * wp + 8 * (m >> 1)) * 2;
}

__device__ __forceinline__ float2 pick4(const float2 (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// The accumulators of one row of an m16 tile (r = 0: row gid, r = 1: row
// gid + 8) hold, in lane tig, channels 8·nt + 2·tig + {0, 1} of the four n8
// tiles. A 4 × 4 transpose across the quad (three xor-shuffle rounds, fixed
// order) gives lane tig the eight consecutive channels 8·tig … 8·tig + 7,
// which the epilogue reads and writes as one 16-byte vector.
__device__ __forceinline__ Vec8 quad_gather(const float (&acc)[kNT][4], int r,
                                            int tig) {
  float2 a[4], b[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    a[nt] = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    b[nt] = a[nt];
  }
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int p = tig ^ k;
    const float2 send = pick4(a, p);
    float2 got;
    got.x = __shfl_xor_sync(0xffffffffu, send.x, k);
    got.y = __shfl_xor_sync(0xffffffffu, send.y, k);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s == p) b[s] = got;
  }
  return {{b[0].x, b[0].y, b[1].x, b[1].y, b[2].x, b[2].y, b[3].x, b[3].y}};
}

// Eight values of T as they sit in memory (one or two 16-byte words): the
// int8-tap kernels hold a staged item in registers across the group's amax
// reduction and requantise it from there.
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ static Raw8 load(const __nv_bfloat16* p) {
    return {*reinterpret_cast<const uint4*>(p)};
  }
  __device__ __forceinline__ Vec8 vec() const { return unpack8(w); }
  // x + r rounded to bf16, as bf16x2 additions: the exact sum rounded once,
  // which is the fp32 sum rounded to bf16 (the twin's x + residual in bf16)
  __device__ __forceinline__ Vec8 plus(const Raw8& r) const {
    uint4 s;
    const uint32_t* a = &w.x;
    const uint32_t* b = &r.w.x;
    uint32_t* d = &s.x;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 t =
          __hadd2(*reinterpret_cast<const __nv_bfloat162*>(a + k),
                  *reinterpret_cast<const __nv_bfloat162*>(b + k));
      d[k] = *reinterpret_cast<const uint32_t*>(&t);
    }
    return unpack8(s);
  }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ static Raw8 load(const float* p) {
    return {*reinterpret_cast<const float4*>(p),
            *reinterpret_cast<const float4*>(p + 4)};
  }
  __device__ __forceinline__ Vec8 vec() const {
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  }
  __device__ __forceinline__ Vec8 plus(const Raw8& r) const {
    Vec8 v = vec();
    const Vec8 u = r.vec();
#pragma unroll
    for (int k = 0; k < 8; ++k) v.v[k] += u.v[k];
    return v;
  }
};

// clip(rint(v · inv), −127, 127) of four values, packed as int8 bytes. The
// values v never exceed amax in magnitude, so |v · inv| ≤ 127 (to within
// two fp32 roundings) and the clip never acts; adding 1.5·2^23 to the
// rounded product rounds it to the nearest integer, ties to even, into the
// low mantissa bits, whose low byte is the int8 value: a full-rate add in
// place of a float-to-int conversion, which runs at a quarter of the rate
// on an H100.
__device__ __forceinline__ uint32_t quant4(const float* v, float inv) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = __float_as_uint(__fadd_rn(__fmul_rn(v[k], inv), 12582912.0f));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// Sum over the 8 lanes of one quad column (same tig, gid = 0 … 7) in a fixed
// butterfly order: afterwards every lane holds its column's total.
__device__ __forceinline__ void sum_over_gid(float (&v)[8]) {
#pragma unroll
  for (int m = 4; m < 32; m <<= 1)
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], m);
}

// The column sums of s1 and s2 (16 values a lane) over the 8 lanes of one
// quad column, reduced and scattered in 8 + 4 + 2 shuffles (a butterfly of
// each value takes 48): at each round a lane keeps half its values and
// sends the other half to the partner on gid bit r, then adds. Afterwards
// lane gid holds the totals of values j = 8·b0 + 4·b1 + 2·b2 + {0, 1}
// (b: gid's bits; values 0-7 are s1, 8-15 s2) in out[0], out[1]. A fixed
// order: the same bits run to run.
__device__ __forceinline__ void reduce_scatter_gid(const float (&s1)[8],
                                                   const float (&s2)[8],
                                                   float (&out)[2]) {
  const int gid = (threadIdx.x & 31) >> 2;
  float a[8], b[4];
  const bool b0 = gid & 1, b1 = gid & 2, b2 = gid & 4;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float got = __shfl_xor_sync(0xffffffffu, b0 ? s1[k] : s2[k], 4);
    a[k] = (b0 ? s2[k] : s1[k]) + got;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float got = __shfl_xor_sync(0xffffffffu, b1 ? a[k] : a[4 + k], 8);
    b[k] = (b1 ? a[4 + k] : a[k]) + got;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float got = __shfl_xor_sync(0xffffffffu, b2 ? b[k] : b[2 + k], 16);
    out[k] = (b2 ? b[2 + k] : b[k]) + got;
  }
}

// Block statistics of one output-channel group of nb channels from
// red[warp_m][2][nb] (each warp's column totals): sums over warp_m in order,
// writes dst[0 … nb) (sum) and dst[c … c + nb) (sum²). All threads call it.
__device__ __forceinline__ void finish_group_stats(const float* red,
                                                   int warps_m, int nb,
                                                   float* dst, int c) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    const int which = i / nb, ch = i % nb;
    float s = 0.f;
    for (int wm = 0; wm < warps_m; ++wm) s += red[(wm * 2 + which) * nb + ch];
    dst[which * c + ch] = s;
  }
}

// Block statistics of one output-channel group from the lanes' column sums
// s1, s2 (channels wn·32 + 8·tig … of the group's nb, the warp's positions):
// over the quad columns, then over the warps_m warps wm that share the
// channels, into dst[0 … nb) and dst[c …). All threads call it.
__device__ __forceinline__ void group_stats(float (&s1)[8], float (&s2)[8],
                                            float* red, int wm, int wn,
                                            int warps_m, int nb, float* dst,
                                            int c) {
  sum_over_gid(s1);
  sum_over_gid(s2);
  const int lane = threadIdx.x & 31;
  if (lane < 4) {  // gid 0: lane = tig
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[(wm * 2) * nb + wn * 32 + 8 * lane + k] = s1[k];
      red[(wm * 2 + 1) * nb + wn * 32 + 8 * lane + k] = s2[k];
    }
  }
  finish_group_stats(red, warps_m, nb, dst, c);
}

// The conv3x3 tensor-core block (conv3x3.cu, conv3x3_store.cu): WN warps
// share a tile's positions across NB = 32·WN output channels, each warp
// owning 32 positions (kMT m16 tiles); the prologue-applied halo [hn][C + 8]
// (bf16) and a kConvStages-deep ring of weight stages sit in dynamic shared
// memory. A block walks steps s = 0 … nsteps − 1: output-channel group
// z + (s / group_steps)·split, tap row dt, 32-channel chunk kc, with
// group_steps = 3·C/32; a stage holds the tap row's three taps × 32 input
// channels × NB output channels, HWIO rows as they lie in the weights.
template <int WN>
struct Conv3x3Mma {
  static constexpr int kWarpsM = 8 / WN;
  static constexpr int kM = 32 * kWarpsM;     // positions per block
  static constexpr int kNB = 32 * WN;         // output channels per group
  static constexpr int kWP = kNB + 8;         // stage pitch (elements)
  static constexpr int kTap = kMmaK * kWP;    // one tap's 32 ci × NB
  static constexpr int kStage = 3 * kTap;     // a tap row (df = 0 … 2)

  // Steps of the block in grid.z slice z of split.
  static __device__ __forceinline__ int steps(int c, int z, int split) {
    return (c / kNB - z + split - 1) / split * 3 * (c / kMmaK);
  }

  // cp.async of step s's weight stage into its ring slot.
  static __device__ __forceinline__ void load_stage(
      __nv_bfloat16* ring, const __nv_bfloat16* __restrict__ w, int s,
      int z, int split, int c) {
    const int kc_n = c / kMmaK, group_steps = 3 * kc_n;
    const int rem = s % group_steps, dt = rem / kc_n, kc = rem % kc_n;
    const int g = z + (s / group_steps) * split;
    __nv_bfloat16* dst = ring + (s % kConvStages) * kStage;
    for (int i = threadIdx.x; i < 3 * kMmaK * kNB / 8; i += kThreads) {
      const int q = i % (kNB / 8), r = (i / (kNB / 8)) % kMmaK;
      const int df = i / (kMmaK * kNB / 8);
      cp_async16(dst + df * kTap + r * kWP + 8 * q,
                 w + ((size_t)(dt * 3 + df) * c + kc * kMmaK + r) * c +
                     g * kNB + 8 * q);
    }
  }

  // The lane's A rows (its positions in the halo at tap (0, 0), tiles of
  // ft columns) and its B offset in the ring.
  static __device__ __forceinline__ void bases(uint32_t (&a_base)[kMT],
                                               uint32_t& b_base,
                                               const __nv_bfloat16* halo,
                                               const __nv_bfloat16* ring,
                                               int ft, int hw, int pitch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % kWarpsM, wn = warp / kWarpsM;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int p = wm * 32 + mt * 16 + (lane & 15);
      a_base[mt] =
          smem_u32(halo + ((p / ft) * hw + p % ft) * pitch + (lane >> 4) * 8);
    }
    b_base = smem_u32(ring) + b_lane_offset(lane, kWP) + wn * 32 * 2;
  }

  // The MMAs of step s: tap row dt's three taps over chunk kc.
  static __device__ __forceinline__ void step(float (&acc)[kMT][kNT][4],
                                              const uint32_t (&a_base)[kMT],
                                              uint32_t b_base, int s, int c,
                                              int hw, int pitch) {
    const int kc_n = c / kMmaK, rem = s % (3 * kc_n);
    const int dt = rem / kc_n, kc = rem % kc_n;
    const uint32_t a_row = ((dt * hw) * pitch + kc * kMmaK) * 2;
    const uint32_t b_stage = b_base + (s % kConvStages) * kStage * 2;
#pragma unroll
    for (int df = 0; df < 3; ++df)
#pragma unroll
      for (int kk = 0; kk < kMmaK / 16; ++kk) {
        uint32_t aa[kMT];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          aa[mt] = a_base[mt] + a_row + df * pitch * 2 + kk * 32;
        warp_mma_k16(acc, aa, b_stage + (df * kTap + kk * 16 * kWP) * 2, 32);
      }
  }
};

}  // namespace ddim
