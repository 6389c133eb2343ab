// Tile plans of the conv kernels: which variant a call takes, how its grid
// cuts the positions and channels, and the shared memory it asks for.
//
// Plain C++ with no CUDA header, so that the host compiler can build
// conv_plan.cu on its own: the port's Python model of these plans
// (ddim_audio_tpu_torch/ops/tile_plan.py), which the wrappers use to size
// the statistics partials, is held against this file by the CPU tests.
#pragma once

#if defined(__CUDACC__)
#define DDIM_HD __host__ __device__ __forceinline__
#else
#define DDIM_HD inline
#endif

namespace ddim {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPos = 64;       // output positions per block (CUDA-core kernels)

// CUDA-core tile geometry shared by the kernels and the host-side tile count:
// FT = 16 frequency columns when the output is at least that wide, else 8.
DDIM_HD int tile_f(int f_out) { return f_out >= 16 ? 16 : 8; }
DDIM_HD int tile_t(int f_out) { return kPos / tile_f(f_out); }
DDIM_HD int cdiv(int a, int b) { return (a + b - 1) / b; }
DDIM_HD int num_tiles(int t_out, int f_out) {
  return cdiv(t_out, tile_t(f_out)) * cdiv(f_out, tile_f(f_out));
}

// ---------------------------------------------- tensor-core (mma.sync) --
//
// Variants: 0 = CUDA cores (fp32 and bf16 where channels are no multiple
// of 32), 1 = tensor cores (mma.sync.m16n8k16 bf16, fp32 accumulation),
// 2 = tensor cores in split TF32 (fp32 operands as hi + lo TF32 pairs, three
// mma.sync.m16n8k8 products: the fp32 conv3x3, up and down convs).
constexpr int kVariantNone = -1;  // no kernel takes the shape (the call raises)
constexpr int kVariantFma = 0;
constexpr int kVariantMma = 1;
constexpr int kVariantTf32 = 2;
constexpr int kMmaK = 32;         // input channels per weight stage
// cp.async ring depth; a conv3x3 stage holds a tap row (3 taps), an up
// stage one tap of each of the four parity classes
constexpr int kConvStages = 3;
constexpr int kUpStages = 3;
// conv_down ring: a stage holds kDownTaps taps (a tap row) × 32 ci × NB co
constexpr int kDownStages = 3;
constexpr int kDownTaps = 4;
// split-TF32 kernels: the halo streams through in chunks of kTf32K input
// channels (kTf32Pitch floats a position: 80 bytes, so the 8 rows of an
// ldmatrix fall in distinct banks), the weights through a kTf32Stages-deep
// ring (down: a tap row, kDownTaps taps × kTf32K ci × NB co a stage;
// conv3x3: a tap row of 3 taps; up: kUpTf32Offs tap offsets of the four
// parity classes). The down conv stages each chunk into one of two halo buffers;
// conv3x3 and up copy a chunk raw into one buffer and split it once, with
// conv3x3's prologue, into a TF32 hi and a lo plane.
constexpr int kTf32K = 16;
constexpr int kTf32Pitch = kTf32K + 4;
constexpr int kTf32Stages = 3;
constexpr int kMmaRed = 2048;     // bytes of the statistics scratch
constexpr int kSmemLimit = 232448;
constexpr int kSmemPerSm = 233472;  // shared memory of an SM, bytes
// Blocks the grid should reach before the halo is staged more than once:
// two resident blocks on each of the H100's 132 SMs.
constexpr int kSMs = 132;  // an H100's SMs
constexpr int kFillBlocks = 2 * kSMs;
// the split-TF32 kernels' K split, at most (blocks of a cluster)
constexpr int kTf32MaxSplit = 8;
// input positions a block of the split-TF32 up conv (4 × 16 or 8 × 8), and
// the tap offsets (a, b) a stage of its ring holds (two ring steps a chunk)
constexpr int kUpTf32Pos = 64;
constexpr int kUpTf32Offs = 2;

struct TilePlan {
  int variant;
  int tile_t, tile_f;  // a block's spatial tile (conv_up: input positions)
  int tiles;           // spatial tiles per sample (the partials' dimension)
  int groups;          // output-channel groups
  int split;           // grid.z: blocks that share a tile's groups
  int smem;            // dynamic shared memory per block, bytes
  int grid = 0;        // persistent kernels: blocks along grid.x (else 0)
};

// Output-channel groups go to separate blocks (grid.z, each re-staging the
// tile) only as far as the spatial grid alone falls short of kFillBlocks,
// in a split that divides the groups evenly.
DDIM_HD int fill_split(int tiles, int batch, int groups) {
  const int have = tiles * batch;
  int split = have >= kFillBlocks ? 1 : cdiv(kFillBlocks, have);
  while (split < groups && groups % split != 0) ++split;
  return split < groups ? split : groups;
}

// Resident blocks per SM that conv3x3's registers are bounded for
// (__launch_bounds__): 3 (80 registers a thread) at C <= 64, where a block's
// work is mostly staging and epilogue and more resident blocks hide its
// latency, 2 (128, no spills) from C = 96 on, where the MMAs dominate.
DDIM_HD int conv3x3_min_blocks(int c) { return c <= 64 ? 3 : 2; }

// conv3x3: a warp owns 32 positions × 32 output channels; two warps share
// a tile's positions across 64 channels when C is a multiple of 64 from 128
// on (128 positions a block), else one (256 positions a block).
DDIM_HD int conv3x3_warps_n(int c) { return c >= 128 && c % 64 == 0 ? 2 : 1; }

// The K split of a split-TF32 kernel: where a sample's grid of `blocks`
// does not reach one block an SM, the input channels' kTf32K-channel chunks
// split over up to kTf32MaxSplit blocks of a cluster, two chunks a block at
// least.
DDIM_HD int tf32_ksplit(int blocks, int c_in) {
  const int half = c_in / kTf32K / 2;
  int ksplit = blocks >= kSMs ? 1 : kSMs / blocks;
  if (ksplit > half) ksplit = half;
  if (ksplit > kTf32MaxSplit) ksplit = kTf32MaxSplit;
  return ksplit < 1 ? 1 : ksplit;
}

// conv3x3 in split TF32 (conv3x3_tf32_kernel): two warps across 64 output
// channels wherever C is a multiple of 64 (each chunk's prologue and split
// serve 64 channels), else one across 32; MT = 2 m16 tiles a warp (128
// positions at WN = 2) where its shared memory leaves room for two blocks
// an SM and one sample's grid reaches kFillBlocks, else MT = 1 (128 or 64
// positions); one output-channel group a block and the K split over a
// cluster (grid.z = split = groups · the K split). Shared memory: the raw
// chunk of x and of the residual, the hi and lo planes of the
// prologue-applied chunk and the ring of tap rows.
DDIM_HD int conv3x3_tf32_warps_n(int c) { return c % 64 == 0 ? 2 : 1; }

DDIM_HD int conv3x3_tf32_smem(int tt, int ft, int nb) {
  const int hn = (tt + 2) * (ft + 2);
  return 4 * (2 * hn * kTf32K + 2 * hn * kTf32Pitch +
              kTf32Stages * 3 * kTf32K * (nb + 8)) +
         kMmaRed;
}

DDIM_HD TilePlan conv3x3_plan(int t, int f, int c, int bf16, int batch) {
  TilePlan p;
  if (!bf16 && c % 32 == 0) {
    const int wn = conv3x3_tf32_warps_n(c), nb = 32 * wn;
    p.variant = kVariantTf32;
    p.tile_f = f >= 16 ? 16 : 8;
    p.tile_t = 16 * 2 * (8 / wn) / p.tile_f;  // MT = 2
    p.groups = c / nb;
    p.tiles = cdiv(t, p.tile_t) * cdiv(f, p.tile_f);
    if (2 * (conv3x3_tf32_smem(p.tile_t, p.tile_f, nb) + 1024) > kSmemPerSm ||
        p.tiles * p.groups < kFillBlocks) {  // MT = 1
      p.tile_t /= 2;
      p.tiles = cdiv(t, p.tile_t) * cdiv(f, p.tile_f);
    }
    p.split = p.groups * tf32_ksplit(p.tiles * p.groups, c);
    p.smem = conv3x3_tf32_smem(p.tile_t, p.tile_f, nb);
    return p;
  }
  if (bf16 && c % 32 == 0) {
    const int wn = conv3x3_warps_n(c), m = 32 * (8 / wn), nb = 32 * wn;
    p.variant = kVariantMma;
    p.tile_f = f >= 16 ? 16 : 8;
    p.tile_t = m / p.tile_f;
    p.tiles = cdiv(t, p.tile_t) * cdiv(f, p.tile_f);
    p.groups = c / nb;
    p.split = fill_split(p.tiles, batch, p.groups);
    p.smem = 2 * ((p.tile_t + 2) * (p.tile_f + 2) * (c + 8) +
                  kConvStages * 3 * kMmaK * (nb + 8)) +
             kMmaRed;
    if (p.smem <= kSmemLimit) return p;
  }
  p.variant = kVariantFma;
  p.tile_f = tile_f(f);
  p.tile_t = tile_t(f);
  p.tiles = num_tiles(t, f);
  p.groups = cdiv(c, 32);
  p.split = p.groups;
  p.smem = 0;
  return p;
}

// conv_up: a block owns 128 input positions and their 512 outputs; warp w
// computes output parity class w % 4 of input positions 64·(w / 4) … +63
// for one group of 32 output channels.
//
// In split TF32 (conv_up_tf32_kernel) a block owns kUpTf32Pos input
// positions and one group of 32 output channels; warp w computes class w % 4
// of input positions 32·(w / 4) … +31 (MT = 2), and the K split takes a
// cluster where a sample's grid does not reach one block an SM. Shared
// memory: the raw chunk, its hi and lo planes and the ring.
DDIM_HD int conv_up_tf32_smem(int tt, int ft) {
  const int hn = (tt + 2) * (ft + 2);
  return 4 * (hn * kTf32K + 2 * hn * kTf32Pitch +
              kTf32Stages * kUpTf32Offs * 4 * kTf32K * (32 + 8)) +
         kMmaRed;
}

DDIM_HD TilePlan conv_up_plan(int t_in, int f_in, int c_in, int c_out,
                              int bf16, int batch) {
  TilePlan p;
  if (!bf16 && c_in % 32 == 0 && c_out % 32 == 0) {
    p.variant = kVariantTf32;
    p.tile_f = f_in >= 16 ? 16 : 8;
    p.tile_t = kUpTf32Pos / p.tile_f;
    p.tiles = cdiv(t_in, p.tile_t) * cdiv(f_in, p.tile_f);
    p.groups = c_out / 32;
    p.split = p.groups * tf32_ksplit(p.tiles * p.groups, c_in);
    p.smem = conv_up_tf32_smem(p.tile_t, p.tile_f);
    return p;
  }
  if (bf16 && c_in % 32 == 0 && c_out % 32 == 0) {
    p.variant = kVariantMma;
    p.tile_f = f_in >= 16 ? 16 : 8;
    p.tile_t = 128 / p.tile_f;
    p.tiles = cdiv(t_in, p.tile_t) * cdiv(f_in, p.tile_f);
    p.groups = c_out / 32;
    p.split = fill_split(p.tiles, batch, p.groups);
    p.smem = 2 * ((p.tile_t + 2) * (p.tile_f + 2) * (c_in + 8) +
                  kUpStages * 4 * kMmaK * (32 + 8)) +
             kMmaRed;
    if (p.smem <= kSmemLimit) return p;
  }
  p.variant = kVariantFma;
  p.tile_f = tile_f(2 * f_in);
  p.tile_t = tile_t(2 * f_in);
  p.tiles = num_tiles(2 * t_in, 2 * f_in);
  p.groups = cdiv(c_out, 32);
  p.split = p.groups;
  p.smem = 0;
  return p;
}

// conv_down (k4 s2 p1): a block owns TT × FT output positions and stages
// their (2TT + 2) × (2FT + 2) input halo once, all C_in channels; WM × WN
// warps of MT m16 tiles × 32 output channels each, so NB = 32·WN output
// channels a group (64 where C_out allows, else 32) and 16·MT·WM positions
// a block. MT = 2 (128 or 256 positions) wherever its shared memory fits,
// else MT = 1 (64 or 128): the halo of a stride-2 tile is 4.8 times its
// output, so at 192→256 only the smaller tile fits. From 64→96 on that
// means one block an SM: a thicker warp tile rather than a second resident
// block with thinner ones (PERF.md).
DDIM_HD int conv_down_warps_n(int c_out) { return c_out % 64 == 0 ? 2 : 1; }

DDIM_HD int conv_down_smem(int tt, int ft, int c_in, int nb) {
  return 2 * ((2 * tt + 2) * (2 * ft + 2) * (c_in + 8) +
              kDownStages * kDownTaps * kMmaK * (nb + 8)) +
         kMmaRed;
}

// The fp32 down conv in split TF32 (conv_down_tf32_kernel): the bf16
// kernel's warps (WM × WN, MT m16 tiles × 32 channels a warp) and
// parity-split halo, but one output-channel group a block (grid.z: the
// halo streams through in kTf32K-channel chunks, re-read from L2 per group,
// 0.3·C_in bytes an output against its 48·C_in tensor-core products), MT = 2
// (128 or 256 positions) where one sample's grid reaches kFillBlocks, else
// MT = 1 (so that the tiles, the partials' dimension, do not depend on the
// batch; training runs microbatches of one). Where a sample's grid stays
// under kSMs blocks, the chunks split over up to kTf32MaxSplit blocks (a
// cluster; grid.z = split = groups · the K split).
DDIM_HD int conv_down_tf32_smem(int tt, int ft, int nb) {
  return 4 * (2 * (2 * tt + 2) * (2 * ft + 2) * kTf32Pitch +
              kTf32Stages * kDownTaps * kTf32K * (nb + 8)) +
         kMmaRed;
}

DDIM_HD TilePlan conv_down_plan(int t_in, int f_in, int c_in, int c_out,
                                int bf16, int batch) {
  const int t_out = t_in / 2, f_out = f_in / 2;
  TilePlan p;
  if (!bf16 && c_in % 32 == 0 && c_out % 32 == 0) {
    const int wn = conv_down_warps_n(c_out), nb = 32 * wn;
    p.variant = kVariantTf32;
    p.tile_f = f_out >= 16 ? 16 : 8;
    p.tile_t = 16 * 2 * (8 / wn) / p.tile_f;  // MT = 2
    p.groups = c_out / nb;
    p.tiles = cdiv(t_out, p.tile_t) * cdiv(f_out, p.tile_f);
    if (p.tiles * p.groups < kFillBlocks) {  // MT = 1 (a sample's grid)
      p.tile_t /= 2;
      p.tiles = cdiv(t_out, p.tile_t) * cdiv(f_out, p.tile_f);
    }
    p.split = p.groups * tf32_ksplit(p.tiles * p.groups, c_in);
    p.smem = conv_down_tf32_smem(p.tile_t, p.tile_f, nb);
    return p;
  }
  if (bf16 && c_in % kMmaK == 0 && c_out % 32 == 0) {
    const int wn = conv_down_warps_n(c_out), nb = 32 * wn;
    p.variant = kVariantMma;
    p.tile_f = f_out >= 16 ? 16 : 8;
    p.tile_t = 16 * 2 * (8 / wn) / p.tile_f;  // MT = 2
    p.smem = conv_down_smem(p.tile_t, p.tile_f, c_in, nb);
    if (p.smem > kSmemLimit) {  // MT = 1
      p.tile_t /= 2;
      p.smem = conv_down_smem(p.tile_t, p.tile_f, c_in, nb);
    }
    p.tiles = cdiv(t_out, p.tile_t) * cdiv(f_out, p.tile_f);
    p.groups = c_out / nb;
    p.split = fill_split(p.tiles, batch, p.groups);
    if (p.smem <= kSmemLimit) return p;
  }
  p.variant = kVariantFma;
  p.tile_f = tile_f(f_out);
  p.tile_t = tile_t(f_out);
  p.tiles = num_tiles(t_out, f_out);
  p.groups = cdiv(c_out, 32);
  p.split = p.groups;
  p.smem = 0;
  return p;
}

// conv3x3 with int8 taps: the quantisation group is an 8 × 16 output tile
// with its 1-position halo, all C channels, one scale. A persistent block
// walks groups (grid: as many blocks as stay resident, at most one a
// group); it stages the nine taps' int8 weights [tap][co][ci] once, and for
// each group its raw input halo (bf16: the residual's too), its int8 halo
// and the statistics scratch [WM][2][C]. WN = C / 32 warps across the
// channels (32 each) and WM across the positions: 256 threads a block at
// C = 32 and 64, 384 at C = 96.
constexpr int kTtQ = 8, kFtQ = 16;  // output tile = quantisation group
constexpr int kHaloQ = (kTtQ + 2) * (kFtQ + 2);

DDIM_HD constexpr int conv3x3_int8_threads(int c) { return c == 96 ? 384 : 256; }
DDIM_HD constexpr int conv3x3_int8_warps_n(int c) { return c / 32; }
// bytes of an int8 row (position or output channel) in shared memory: 16
// past C keeps the 8 rows of an ldmatrix in distinct banks
DDIM_HD constexpr int int8_pitch(int c) { return c + 16; }

DDIM_HD constexpr int conv3x3_int8_smem(int c, int bf16) {
  return 9 * c * int8_pitch(c) + kHaloQ * int8_pitch(c) +
         kHaloQ * c * 4 +  // raw x in fp32, or raw x and residual in bf16
         4 * (conv3x3_int8_threads(c) / 32 / conv3x3_int8_warps_n(c)) * 2 *
             c +
         4 * 16;
}

// The int8-tap up conv (conv_up_int8_kernel): the quantisation group of the
// int8 strided kernels (an 8 × 16 output tile, its 4 × 8 input tile and a
// 1-position halo: 6 × 10 input positions, all C_in, one scale), walked by
// persistent blocks of kUpI8Co output channels each (grid.z = C_out /
// kUpI8Co). A block stages all 16 taps' int8 weights [tap][co][ci] once,
// and per group the raw halo (in x's dtype), the int8 halo and the
// statistics and amax scratch. `tiles` is the partials' second dimension
// (one a group); grid.x is as many blocks as stay resident.
constexpr int kUpI8Co = 32;
constexpr int kUpI8Halo = (kTtQ / 2 + 2) * (kFtQ / 2 + 2);

DDIM_HD constexpr int conv_up_int8_smem(int c_in, int bf16) {
  return 16 * kUpI8Co * int8_pitch(c_in) +
         (kUpI8Halo * int8_pitch(c_in) + 15) / 16 * 16 +
         kUpI8Halo * c_in * (bf16 ? 2 : 4) + 4 * (8 * 2 * kUpI8Co + 8);
}

DDIM_HD TilePlan conv_up_int8_plan(int t_in, int f_in, int c_in, int c_out,
                                   int bf16, int batch) {
  TilePlan p;
  p.tile_t = kTtQ;
  p.tile_f = kFtQ;
  p.tiles = cdiv(2 * t_in, kTtQ) * cdiv(2 * f_in, kFtQ);
  p.groups = cdiv(c_out, kUpI8Co);
  p.split = p.groups;
  p.smem = conv_up_int8_smem(c_in, bf16);
  const bool ok = c_in > 0 && c_in % 32 == 0 && c_in <= 256 && c_out > 0 &&
                  c_out % kUpI8Co == 0 && p.smem <= kSmemLimit;
  p.variant = ok ? kVariantMma : kVariantNone;
  if (!ok) p.smem = 0;
  (void)batch;
  return p;
}

// The int8-tap down conv (conv_down_int8_kernel): the strided kernels'
// quantisation group (an 8 × 16 output tile, its 16 × 32 input tile and a
// 1-position halo: 18 × 34 input positions, all C_in, one scale), walked by
// persistent blocks of CO output channels each (64 where C_out allows and
// it fits, else 32; grid.z = C_out / CO). A block stages all 16 taps' int8
// weights once, [tap][16-channel plane][co][16 bytes], and per group the raw
// halo (in x's dtype), the int8 halo [16-channel plane][position][16 bytes]
// and the statistics and amax scratch: 16-byte rows in 16-byte-wide planes,
// so that the 8 rows of an ldmatrix are 128 contiguous bytes and no pad is
// needed. C_in is 32 or 64 (every int8 down transition that
// strided_int8_transition picks). Resident blocks an SM: as many as the
// shared memory leaves room for, at most kDownI8MaxBlocks (the registers'
// bound); grid.x: that many blocks on each SM, shared by the z groups, at
// most one a group. C_in from 96 to 256, whose raw halo does not fit, takes
// the two-pass kernel (`grid` 0): a block a group × CO output channels
// (tiles × B × groups), the int8 halo [position][C_in + 16] and a weight
// stage [16][CO][kWPitchI8] (at the end the fp32 output tile [128][CO + 8]).
constexpr int kDownI8Halo = (2 * kTtQ + 2) * (2 * kFtQ + 2);
constexpr int kDownI8MaxBlocks = 2;
constexpr int kWPitchI8 = 32 + 16;

DDIM_HD constexpr int down_int8_two_pass_smem(int c_in, int co) {
  return (kDownI8Halo * (c_in + 16) + 15) / 16 * 16 +
         (16 * co * kWPitchI8 > 128 * (co + 8) * 4 ? 16 * co * kWPitchI8
                                                   : 128 * (co + 8) * 4);
}

DDIM_HD constexpr int conv_down_int8_smem(int c_in, int co, int bf16) {
  return 16 * co * c_in + kDownI8Halo * c_in +
         kDownI8Halo * c_in * (bf16 ? 2 : 4) + 4 * (8 * 2 * co + 8);
}

DDIM_HD constexpr int down_int8_resident(int smem) {
  const int fit = kSmemPerSm / (smem + 1024);  // 1 KB reserved a block
  return fit < 1 ? 1 : fit > kDownI8MaxBlocks ? kDownI8MaxBlocks : fit;
}

DDIM_HD TilePlan conv_down_int8_plan(int t_in, int f_in, int c_in, int c_out,
                                     int bf16, int batch) {
  TilePlan p;
  p.tile_t = kTtQ;
  p.tile_f = kFtQ;
  p.tiles = cdiv(t_in / 2, kTtQ) * cdiv(f_in / 2, kFtQ);
  int co = c_out % 64 == 0 ? 64 : 32;
  if (conv_down_int8_smem(c_in, co, bf16) > kSmemLimit) co = 32;
  p.groups = c_out > 0 ? cdiv(c_out, co) : 0;
  p.split = p.groups;
  p.smem = conv_down_int8_smem(c_in, co, bf16);
  const bool ok = c_in > 0 && c_in % 32 == 0 && c_in <= 256 && c_out > 0 &&
                  c_out % 32 == 0;
  p.variant = ok ? kVariantMma : kVariantNone;
  if (!ok) {
    p.smem = 0;
    return p;
  }
  if ((c_in != 32 && c_in != 64) || p.smem > kSmemLimit) {  // two-pass
    co = c_out % 64 == 0 ? 64 : 32;
    p.groups = c_out / co;
    p.split = p.groups;
    p.smem = down_int8_two_pass_smem(c_in, co);
    return p;
  }
  const int per_z = down_int8_resident(p.smem) * kSMs / p.split;
  const int n = batch * p.tiles;
  p.grid = n < per_z ? n : per_z < 1 ? 1 : per_z;
  return p;
}

DDIM_HD TilePlan conv3x3_int8_plan(int t, int f, int c, int bf16, int batch) {
  TilePlan p;
  p.variant = c == 32 || c == 64 || c == 96 ? kVariantMma : kVariantNone;
  p.tile_t = kTtQ;
  p.tile_f = kFtQ;
  p.tiles = cdiv(t, kTtQ) * cdiv(f, kFtQ);
  p.groups = 1;  // one block computes all C output channels of a group
  p.split = 1;
  p.smem = p.variant == kVariantMma ? conv3x3_int8_smem(c, bf16) : 0;
  (void)batch;
  return p;
}

// ------------------------------------------------------ weight gradients --
//
// conv_dw.cu. The first kernels (all three modes; bf16 WMMA where its
// shapes allow, else CUDA cores) give a block one 32 × 32 (ci, co) tile of
// every tap and a share of the position tiles (64 base positions on CUDA
// cores, 4 or 8 rows of 16 with WMMA), aiming at kDwTargetBlocks blocks.
// fp32 at C_in % kDwTf32Ci == C_out % kDwTf32Co == 0 runs split TF32 on the
// tensor cores (conv_dw_tf32_kernel, variant 2), every mode: a block owns
// all the taps × kDwTf32Ci input channels × kDwTf32Co output channels
// (`groups` = such tiles) and a share of the position tiles of
// dw_tf32_pos(mode) base positions (16 columns wide where the base grid is,
// else 8; rows halved until kDwTf32Blocks blocks fit an SM's shared
// memory), `split` shares (grid.y: the partials' first dimension) sized so
// that groups · split stays within two blocks an SM. Shared memory: the
// tile's raw x halo and g tile and their TF32 hi and lo planes (pitch
// kDwTf32XP / kDwTf32GP floats a position: 8 mod 32, so the fragments'
// scalar loads are conflict-free); in mode 0 at least the scratch in which
// its K sets add their totals. Warps a block (dw_tf32_threads): modes 1 and
// 2 eight (a warp two taps × 32 output channels), mode 0 three a K set (a
// warp a tap row of three taps × 32 output channels), kDw3KSets sets.
constexpr int kDwCi = 32;             // first kernels: input channels a block
constexpr int kDwTargetBlocks = 528;  // first kernels: 4 blocks an SM
constexpr int kDwTf32Ci = 16, kDwTf32Co = 32;
constexpr int kDwTf32XP = kDwTf32Ci + 8, kDwTf32GP = kDwTf32Co + 8;
// base positions a tile aims at: modes 1 and 2, mode 0
constexpr int kDwTf32Pos = 64, kDw3Tf32Pos = 128;
constexpr int kDwTf32Blocks = 2;  // resident blocks an SM the plan keeps
constexpr int kDw3KSets = 2;      // mode 0: warp sets over a tile's k8 steps

DDIM_HD int dw_tf32_pos(int mode) {
  return mode == 0 ? kDw3Tf32Pos : kDwTf32Pos;
}

DDIM_HD constexpr int dw_tf32_threads(int mode) {
  return mode == 0 ? 3 * 32 * kDw3KSets : kThreads;
}

// The first kernels' tiles: base positions a CUDA-core tile, rows of 16 a
// WMMA tile.
DDIM_HD constexpr int dw_first_np(int mode) { return mode == 0 ? 64 : 32; }
DDIM_HD constexpr int dw_first_ttm(int mode) { return mode == 0 ? 8 : 4; }

// x halo positions and g positions of a tt × ft base tile, by mode: the
// 3×3 conv's halo at stride 1 and its g tile; the down conv's halo at
// stride 2 and g's tile; the up conv's halo at stride 1 and g's 2tt × 2ft.
DDIM_HD int dw_tf32_halo(int mode, int tt, int ft) {
  return mode == 1 ? (2 * tt + 2) * (2 * ft + 2) : (tt + 2) * (ft + 2);
}
DDIM_HD int dw_tf32_gpos(int mode, int tt, int ft) {
  return mode == 2 ? 4 * tt * ft : tt * ft;
}

DDIM_HD int dw_tf32_smem(int mode, int tt, int ft) {
  const int hx = dw_tf32_halo(mode, tt, ft), hg = dw_tf32_gpos(mode, tt, ft);
  const int stage = 4 * (hx * (kDwTf32Ci + 2 * kDwTf32XP) +
                         hg * (kDwTf32Co + 2 * kDwTf32GP));
  // mode 0: the K sets but the first leave their totals (a set's three
  // warps, each 3 taps × kDwTf32Ci × kDwTf32Co) for set 0 to add
  const int reduce =
      mode == 0 ? 4 * (kDw3KSets - 1) * 9 * kDwTf32Ci * kDwTf32Co : 0;
  return stage > reduce ? stage : reduce;
}

// The first kernels' plan, every mode: a base grid tb × fb, np base
// positions a CUDA-core tile, ttm rows of 16 a WMMA tile; `tiles` counts the
// whole batch's, `split` the position shares (grid.y).
DDIM_HD TilePlan dw_first_plan(int tb, int fb, int np, int ttm, int c_in,
                               int c_out, int bf16, int batch) {
  TilePlan p;
  const bool mma = bf16 && fb >= 16 && c_in % 32 == 0 && c_out % 32 == 0;
  p.variant = mma ? kVariantMma : kVariantFma;
  p.tile_f = mma ? 16 : tile_f(fb);
  p.tile_t = mma ? ttm : np / p.tile_f;
  p.tiles = batch * cdiv(tb, p.tile_t) * cdiv(fb, p.tile_f);
  p.groups = cdiv(c_in, kDwCi) * cdiv(c_out, 32);
  const int want = cdiv(kDwTargetBlocks, p.groups);
  const int per = cdiv(p.tiles, want) > 1 ? cdiv(p.tiles, want) : 1;
  p.split = cdiv(p.tiles, per);
  p.smem = 0;
  return p;
}

// The split-TF32 plan of a mode over its base grid tb × fb.
DDIM_HD TilePlan dw_tf32_plan(int mode, int tb, int fb, int c_in, int c_out,
                              int batch) {
  TilePlan p;
  p.variant = kVariantTf32;
  p.tile_f = fb >= 16 ? 16 : 8;
  p.tile_t = dw_tf32_pos(mode) / p.tile_f;
  while (p.tile_t > 1 &&
         kDwTf32Blocks * (dw_tf32_smem(mode, p.tile_t, p.tile_f) + 1024) >
             kSmemPerSm)
    p.tile_t /= 2;
  p.tiles = batch * cdiv(tb, p.tile_t) * cdiv(fb, p.tile_f);
  p.groups = (c_in / kDwTf32Ci) * (c_out / kDwTf32Co);
  p.smem = dw_tf32_smem(mode, p.tile_t, p.tile_f);
  const int want = kFillBlocks / p.groups > 1 ? kFillBlocks / p.groups : 1;
  const int per = cdiv(p.tiles, want) > 1 ? cdiv(p.tiles, want) : 1;
  p.split = cdiv(p.tiles, per);
  return p;
}

DDIM_HD bool dw_tf32_takes(int c_in, int c_out, int bf16) {
  return !bf16 && c_in > 0 && c_out > 0 && c_in % kDwTf32Ci == 0 &&
         c_out % kDwTf32Co == 0;
}

// The plans of ddim_conv_dw, each in x's geometry: mode 0 (the 3×3 conv;
// base grid T × F), mode 1 (the down conv; g's T/2 × F/2) and mode 2 (the
// up conv; x's T × F, g at 2T × 2F).
DDIM_HD TilePlan conv3x3_dw_plan(int t, int f, int c_in, int c_out, int bf16,
                                 int batch) {
  if (!dw_tf32_takes(c_in, c_out, bf16))
    return dw_first_plan(t, f, dw_first_np(0), dw_first_ttm(0), c_in, c_out,
                         bf16, batch);
  return dw_tf32_plan(0, t, f, c_in, c_out, batch);
}

DDIM_HD TilePlan conv_down_dw_plan(int t_in, int f_in, int c_in, int c_out,
                                   int bf16, int batch) {
  const int tb = t_in / 2, fb = f_in / 2;
  if (!dw_tf32_takes(c_in, c_out, bf16))
    return dw_first_plan(tb, fb, dw_first_np(1), dw_first_ttm(1), c_in, c_out,
                         bf16, batch);
  return dw_tf32_plan(1, tb, fb, c_in, c_out, batch);
}

DDIM_HD TilePlan conv_up_dw_plan(int t_in, int f_in, int c_in, int c_out,
                                 int bf16, int batch) {
  if (!dw_tf32_takes(c_in, c_out, bf16))
    return dw_first_plan(t_in, f_in, dw_first_np(2), dw_first_ttm(2), c_in,
                         c_out, bf16, batch);
  return dw_tf32_plan(2, t_in, f_in, c_in, c_out, batch);
}

// ------------------------------------------------------- head and tail --
//
// conv_head_tail.cu. The head (Cin -> C0, 3x3) is a persistent tensor-core
// kernel in bf16 at C0 = 32: a tile is TT = kHeadPos / F whole time rows
// (at least one, at most kHeadRows), grid.x = min(tiles, kFillBlocks / B)
// blocks a sample, each walking tiles blockIdx.x, + gridDim.x, ...; a block
// keeps its statistics in registers across its tiles and writes one
// partial, so `tiles` is the partials' second dimension. Shared memory:
// kHeadStages output staging tiles (M positions, TT x F rounded up to
// kHeadMU m16 tiles, x C0 bf16, stored by the bulk-copy engine), two
// Cin-wide halos of TT + 2 rows and the statistics scratch.
// The tail (C0 -> Cout) in bf16: a block owns a band of `tile_t` whole
// output rows and slides down it, one input row at a time (h and residual
// staged kTailStages rows ahead by cp.async); `tiles` is grid.x. The fp32
// tail, the head at another C0 and an fp32 head whose rows do not fit run
// the CUDA-core kernels; a bf16 shape whose rows do not fit in shared
// memory has no kernel.
constexpr int kHeadMaxCin = 4;   // input channels of the head kernels, at most
constexpr int kHeadPos = 512;    // positions a head tile aims at,
constexpr int kHeadRows = 64;    // in at most this many rows
constexpr int kHeadC0 = 32;      // output channels of the tensor-core head
constexpr int kHeadMU = 2;       // m16 tiles a head warp computes at once
constexpr int kHeadStages = 2;   // head: output staging tiles
constexpr int kTailStages = 1;   // tail: input rows in flight
constexpr int kTailTt = 8, kTailFt = 16;  // CUDA-core tail block: 8 x 16

// The fp32 head at C0 = 32 (Cin <= 4) runs the same persistent block in
// split TF32 (conv_head_tf32_kernel): tiles of TT = kHead32Pos / F whole
// rows (at least one, at most kHeadRows); the raw halo double-buffered for
// cp.async and split once a tile into a TF32 hi and a lo plane (four
// planes of TT + 2 rows of head32_halo_pitch floats); each lane stores its
// outputs straight to global memory (no staging tile: staged for the
// bulk-copy engine as the bf16 head's, they took 35% longer on an H100).
// Two blocks an SM (the kernel's registers). An fp32 shape whose rows do
// not fit takes the CUDA-core kernel.
constexpr int kHead32Pos = 256;  // positions an fp32 head tile aims at
constexpr int kHead32Pad = 4;    // floats before position 0 of a halo row

// Elements of a head halo row: Cin-wide positions -1 ... F with 8 elements
// of pad before position 0 (16-byte aligned copies) and a pitch of 32 mod 64
// elements (16 mod 32 words), so that rows dt and dt + 1 of an im2col read
// fall in distinct banks.
DDIM_HD int head_halo_pitch(int f, int c_in) {
  return (f * c_in + 16 + 63) / 64 * 64 + 32;
}

// Floats of an fp32 head halo row: kHead32Pad floats of pad, positions
// -1 ... F, rounded up to 32 words and 20 more (20 mod 32), so that the
// A fragment reads of a warp that span two halo rows (taps 2 and 3 at
// Cin = 2) fall in distinct banks.
DDIM_HD int head32_halo_pitch(int f, int c_in) {
  return (kHead32Pad + (f + 1) * c_in + 31) / 32 * 32 + 20;
}

DDIM_HD int head_tile_rows(int f, int pos) {
  return f >= pos ? 1 : f * kHeadRows >= pos ? pos / f : kHeadRows;
}

DDIM_HD TilePlan conv_head_plan(int t, int f, int c_in, int c0, int bf16,
                                int batch) {
  // The batch does not enter the persistent grid: a sample's blocks walk
  // the same tiles at any batch, so its statistics partials are the same
  // sums and a clip's result does not depend on the batch it runs in.
  (void)batch;
  TilePlan p;
  const bool ok = c_in >= 1 && c_in <= kHeadMaxCin;
  if (ok && !bf16 && c0 == kHeadC0) {
    const int tt = head_tile_rows(f, kHead32Pos);
    p.tile_t = tt;
    p.tile_f = f;
    const int tiles = cdiv(t, tt), cap = kFillBlocks;
    p.tiles = tiles < cap ? tiles : cap;
    p.groups = 1;
    p.split = 1;
    p.smem = 4 * (tt + 2) * head32_halo_pitch(f, c_in) * 4 + kMmaRed;
    p.variant = kVariantTf32;
    if (p.smem <= kSmemLimit) return p;  // else rows too wide: CUDA cores
    p = TilePlan();
  }
  if (ok && bf16 && c0 == kHeadC0) {
    const int tt = head_tile_rows(f, kHeadPos);
    const int m = cdiv(tt * f, 16 * kHeadMU) * 16 * kHeadMU;
    p.variant = kVariantMma;
    p.tile_t = tt;
    p.tile_f = f;
    const int tiles = cdiv(t, tt), cap = kFillBlocks;
    p.tiles = tiles < cap ? tiles : cap;
    p.groups = 1;
    p.split = 1;
    p.smem = kHeadStages * m * c0 * 2 +
             2 * (tt + 2) * head_halo_pitch(f, c_in) * 2 + kMmaRed;
    if (p.smem > kSmemLimit) p.variant = kVariantNone;  // rows too wide
    return p;
  }
  p.variant = ok ? kVariantFma : kVariantNone;
  p.tile_f = tile_f(f);
  p.tile_t = tile_t(f);
  p.tiles = num_tiles(t, f);
  p.groups = cdiv(c0, 32);
  p.split = p.groups;
  p.smem = 0;
  return p;
}

// Tail: P columns (df, co) padded to whole n8 tiles.
DDIM_HD int tail_n_tiles(int c_out) { return cdiv(3 * c_out, 8); }

DDIM_HD int conv_tail_smem(int f, int c0, int c_out) {
  const int fp = cdiv(f, 16) * 16, np = 8 * tail_n_tiles(c_out);
  return 2 * 3 * fp * (c0 + 8)                 // v rows t-1, t, t+1
         + 2 * kTailStages * 2 * f * c0        // raw h and residual rows
         + 4 * np * (fp + 4)                   // partials P[(df, co)][f]
         + 2 * np * (3 * c0 + 8);              // weights [(df, co)][(dt, ci)]
}

DDIM_HD TilePlan conv_tail_plan(int t, int f, int c0, int c_out, int bf16,
                                int batch) {
  TilePlan p;
  const bool ok = c0 > 0 && c0 % 32 == 0 &&
                  (c_out == 1 || c_out == 2 || c_out == 4);
  p.groups = 1;
  p.split = 1;
  if (ok && bf16) {
    p.smem = conv_tail_smem(f, c0, c_out);
    const int per_sm = 2 * (p.smem + 1024) <= kSmemPerSm ? 2 : 1;
    const int band = cdiv(t, cdiv(kSMs * per_sm, batch));
    p.variant = p.smem <= kSmemLimit ? kVariantMma : kVariantNone;
    p.tile_t = band;
    p.tile_f = f;
    p.tiles = cdiv(t, band);
    return p;
  }
  p.variant = ok ? kVariantFma : kVariantNone;
  p.tile_t = kTailTt;
  p.tile_f = kTailFt;
  p.tiles = cdiv(t, kTailTt) * cdiv(f, kTailFt);
  p.smem = 0;
  return p;
}

// ----------------------------------------------- int8 activation storage --
//
// One fp32 scale per storage group of kTtS time rows × kFtS frequency
// columns × one channel, scales laid out [B, ceil(T/kTtS), ceil(F/kFtS), C]
// (conv3x3_store.cu, residual_affine.cu, and the twins' STORE_GROUP).
constexpr int kTtS = 8, kFtS = 16;

DDIM_HD int store_tiles(int t_len, int f_len) {
  return cdiv(t_len, kTtS) * cdiv(f_len, kFtS);
}

// residual_affine.cu: persistent blocks of kResThreads threads, each on
// one sample (grid.y) and one group of 32 channels (grid.z), walking the
// sample's storage groups (kTtS × kFtS positions × those 32 channels, a
// "unit") blockIdx.x, + gridDim.x, …, the next kResStages − 1 units' x, s
// and scale rows in flight by cp.async. A stage holds one unit of x and s
// (32 channels a position at their operand widths: kind 0 fp32, 1 bf16,
// 2 int8) and both scale rows; kResRed bytes take the amax exchange and
// the statistics. grid.x is as many blocks as stay resident on the card
// (at most kResBlocks an SM, which the kernel's registers are bounded
// for), spread over the batch and channel groups; each block writes one
// statistics partial, so `tiles` = `grid` is the partials' second
// dimension. Variant 0 (CUDA cores) at C % 32 == 0, else none.
constexpr int kResThreads = 128;  // four warps: a unit's 16 columns
constexpr int kResStages = 3;     // units a block has staged or in flight
constexpr int kResBlocks = 4;     // resident blocks an SM, at most
constexpr int kResRed = 1024;     // bytes of the amax and statistics scratch

DDIM_HD int res_kind_bytes(int kind) {
  return kind == 0 ? 4 : kind == 1 ? 2 : 1;
}

DDIM_HD int residual_affine_stage(int x_kind, int s_kind) {
  return kTtS * kFtS * 32 * (res_kind_bytes(x_kind) + res_kind_bytes(s_kind)) +
         2 * 32 * 4;
}

DDIM_HD TilePlan residual_affine_plan(int t, int f, int c, int x_kind,
                                      int s_kind, int batch) {
  // The batch does not enter the persistent grid (as conv_head_plan): a
  // sample's blocks walk the same units at any batch, so its statistics
  // partials are the same sums; at B > 1 the grid runs in more waves.
  (void)batch;
  TilePlan p;
  p.variant = c > 0 && c % 32 == 0 ? kVariantFma : kVariantNone;
  p.tile_t = kTtS;
  p.tile_f = kFtS;
  p.groups = cdiv(c, 32);
  p.split = p.groups;
  p.smem = kResStages * residual_affine_stage(x_kind, s_kind) + kResRed;
  int per_sm = kSmemPerSm / (p.smem + 1024);
  if (per_sm > kResBlocks) per_sm = kResBlocks;
  const int units = store_tiles(t, f);
  const int cap = cdiv(per_sm * kSMs, p.groups);
  p.grid = units < cap ? units : cap;
  p.tiles = p.grid;
  return p;
}

// Storage groups whose scales a conv3x3 tile of tile_t × kFtS positions
// stages for its halo: group rows t0/kTtS − 1 … t0/kTtS + tile_t/kTtS and
// columns f0/kFtS − 1 … f0/kFtS + 1.
DDIM_HD int store_halo_groups(int tile_t) { return (tile_t / kTtS + 2) * 3; }

// conv3x3 with int8 activation storage: the conv3x3 tensor-core block
// (conv3x3_plan's warps, groups and weight ring) with its tile always
// kFtS = 16 columns wide, so that every tile is a union of whole storage
// groups (16 × 16 at C <= 96, 8 × 16 from C = 128 on, where two warps share
// the positions) and each group's amax is reduced inside one block; the
// 32 × 8 tile conv3x3_plan takes at F < 16 is refused (such a tile is
// 16 columns wide here, half of them masked). Its shared memory adds the
// staged scale rows of the `scaled` int8 operands (x, residual: 0 … 2).
// fp32 takes the CUDA-core kernel (one storage group × 32 output channels
// a block, kThreads threads); bf16 whose halo does not fit has no kernel.
DDIM_HD TilePlan conv3x3_store_plan(int t, int f, int c, int bf16, int batch,
                                    int scaled) {
  TilePlan p;
  p.tile_f = kFtS;
  if (bf16) {
    const int wn = conv3x3_warps_n(c), nb = 32 * wn;
    p.variant = c % 32 == 0 ? kVariantMma : kVariantNone;
    p.tile_t = 32 * (8 / wn) / kFtS;
    p.tiles = cdiv(t, p.tile_t) * cdiv(f, kFtS);
    p.groups = c / nb;
    p.split = fill_split(p.tiles, batch, p.groups);
    p.smem = 2 * ((p.tile_t + 2) * (kFtS + 2) * (c + 8) +
                  kConvStages * 3 * kMmaK * (nb + 8)) +
             kMmaRed + 4 * scaled * store_halo_groups(p.tile_t) * c;
    if (p.variant == kVariantMma && p.smem <= kSmemLimit) return p;
    p.variant = kVariantNone;
    p.smem = 0;
    return p;
  }
  p.variant = c % 32 == 0 ? kVariantFma : kVariantNone;
  p.tile_t = kTtS;
  p.tiles = store_tiles(t, f);
  p.groups = cdiv(c, 32);
  p.split = p.groups;
  p.smem = 0;
  (void)batch;
  return p;
}

}  // namespace ddim
