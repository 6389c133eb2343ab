// The strided stage transitions with int8 × int8 → int32 taps on the tensor
// cores, over channels-last activations. Replace the `mxu_i8` branches of the
// TPU kernels ddim_audio_tpu/ops/pallas/conv_strided.py `_down_kernel`
// (wrapper `conv_down_flat(mxu_int8=True)`) and `_up_kernel`
// (`conv_up_flat(mxu_int8=True)`), weights from `pack_down_weights_int8` /
// `pack_up_weights_int8` (here quantize_strided_weights_int8, HWIO; both
// kernels read them laid out [4, 4, Cout, Cin], `wq_t`):
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
// The group: an output tile of kTtI × kFtI positions reads the input tile
// 2kTtI × 2kFtI (down) or kTtI/2 × kFtI/2 (up) and a 1-position halo
// around it, staged whole; ddim_strided_int8_geometry reports the output
// tile and the halo to the plain twin. In the TPU kernel the down conv's two
// time-parity streams share one scale; here the block stages both parities
// together, so they do too. Both kernels repeat the twin's arithmetic
// operation for operation, so their outputs equal the twin's bit for bit.
//
// down (conv_down_int8_kernel). On an H100 the int8 down conv is bound by
// bytes (16·Cin·Cout MACs an output position; at 32→64, B = 1, 134 MB of x
// and 67 MB of out: 0.060 ms at 3.35 TB/s). The two-pass kernel before this
// design took 0.351 ms there (cuDNN's bf16 conv 0.187): each of its 4,096
// blocks read its 18 × 34 × Cin halo from global memory twice (amax, then
// requant), restaged all 16 taps' weights through 4-byte loads and byte
// transposes, read A fragments as scalar 32-bit loads and took its
// epilogue through an fp32 tile in shared memory (an H100 80GB HBM3 at
// 700 W, PERF.md); it stays for C_in 96 … 256, whose raw halo does not fit
// (conv_down_int8_two_pass_kernel). At C_in 32 and 64 (every int8 down
// transition the model picks) this one takes the up kernel's pieces:
// * persistent: per group of CO output channels (grid.z) as many blocks as
//   stay resident (conv_down_int8_plan: two an SM at 32→64 in bf16), each
//   walking quantisation groups blockIdx.x, + gridDim.x, …;
// * the 16 taps' weights staged once a block by cp.async from the
//   [4, 4, Cout, Cin] copy `wq_t`, and the int8 halo, both in planes of 16
//   channels whose 16-byte rows (one output channel, one halo position) lie
//   back to back: the 8 rows an ldmatrix reads are 128 contiguous bytes;
// * the raw halo (18 × 34 positions × Cin, zero outside) copied once from
//   global memory by cp.async; the amax and the requant read it from shared
//   memory, and the next group's copy is issued right after the requant, so
//   that it lands while this group's taps and epilogue run. (Holding the
//   halo in registers across the amax, so that the copy could be issued
//   right after the amax reduction, measured slower on the same card: B = 1
//   0.191 against 0.169 ms, B = 2 0.363 against 0.308: 128 registers and a
//   spill at two blocks an SM; PERF.md);
// * A fragments by ldmatrix: each halo row holds its even columns, then its
//   odd ones (in the raw halo too, so that the requant's reads and writes
//   run over consecutive slots), so the 16 stride-2 input columns of a tap
//   (output row = warp, columns 0 … 15) are 16 consecutive rows of the
//   plane;
// * the epilogue from the registers after the quad transpose: 16-byte
//   stores, the statistics by a reduce-scatter over the lanes
//   (reduce_scatter_gid) and one block scratch a group, finished at the
//   next group's first barrier.
//
// up (conv_up_int8_kernel). On an H100 the int8 up conv is bound by bytes
// (4·Cin·Cout MACs an output position; at 64→32, B = 1, 67 MB of x, 134 MB
// of residual and 134 MB of out: 0.100 ms at 3.35 TB/s). The kernel before
// this design took 0.454 ms there: every one of its 16,384 blocks a sample
// restaged all 16 taps' weights from L2 through 4-byte loads and byte
// transposes, read its input twice from global memory (amax, then
// requant), ran three barriers a 32-channel chunk with nothing in flight
// and took its epilogue through an fp32 tile in shared memory to a
// lane-per-channel loop of 2-byte loads and stores; without that epilogue
// it ran 0.254 ms, without its residual 0.325 (an H100 80GB HBM3 at 700 W,
// tools/conv_ablation.py, PERF.md). This one, as conv3x3_int8.cu's:
// * is persistent: per group of kUpI8Co output channels (grid.z) as many
//   blocks as stay resident, each walking quantisation groups blockIdx.x,
//   + gridDim.x, …; each group is computed by one block in a fixed order;
// * stages the 16 taps' int8 weights of its channels once, by cp.async,
//   from the [4, 4, Cout, Cin] copy `wq_t` (K contiguous, as the B operand
//   of mma.sync.m16n8k32.s8 wants);
// * stages a group's raw input halo (6 × 10 positions × Cin, in x's dtype,
//   zero outside) by cp.async, reads it once into registers for the amax
//   and issues the next group's copy into the same buffer right after the
//   amax reduction, so that it lands while this group's requant, MMAs and
//   epilogue run; the requant goes from the registers to the int8 halo;
//   Cin is a template argument, so the copies' and items' index arithmetic
//   divides by constants;
// * reads A and B fragments by ldmatrix: warp w owns parity class (py, px) =
//   (w >> 2, (w >> 1) & 1) of the up conv's sub-pixel form (conv_strided.cu)
//   for input rows 2·(w & 1), +1 of the tile × 8 columns (one m16 tile) ×
//   32 output channels, over the class's four taps;
// * loads the lane's residual into registers before the taps, so that it
//   arrives while they run;
// * finishes a group's statistics at the next group's first barrier, so a
//   group costs three block barriers;
// * runs the epilogue from the registers after a quad transpose of the
//   (exactly converted) accumulators: each lane holds 8 consecutive channels
//   of one output position, so residual reads and output stores move 16
//   bytes (bf16), and the statistics reduce by shuffles and one block
//   scratch a group.
// On the same card it takes 0.293 ms at 64→32 (B = 1; cuDNN's bf16
// transposed conv 0.202) and 0.027 ms at 256→192, held by each group's
// phases in series at three blocks an SM, not by its bytes (PERF.md).
#include "conv_mma.cuh"

namespace ddim {

constexpr int kTtI = 8, kFtI = 16;         // output tile (the group's)
constexpr int kHwDI = 2 * kFtI + 2;        // down: 34 staged input columns
constexpr int kHaloDI = (2 * kTtI + 2) * kHwDI;
constexpr int kHwUI = kFtI / 2 + 2;        // up: 10 staged input columns
constexpr int kWPitch = kWPitchI8;         // two-pass down: a weight row
static_assert(kTtI == kTtQ && kFtI == kFtQ &&
                  (kTtI / 2 + 2) * kHwUI == kUpI8Halo &&
                  kHaloDI == kDownI8Halo,
              "the kernels' groups are conv_plan.h's");

// The two-pass down kernel, for C_in (96 … 256) whose raw halo does not fit
// beside the persistent kernel's int8 halo and weights: a block a group × CO
// output channels (grid: tiles × B × C_out / CO). Pass 1 reads the staged
// input once for its amax (one block reduction), pass 2 reads it again
// (from L2) and stores it requantised into shared memory [halo position]
// [Cin + 16] (the pad keeps fragment reads off one bank). Per 32-channel K
// chunk all 16 taps' weights of the block's output channels are staged
// transposed to [tap][co][ci] from the HWIO weights (4×4-byte blocks
// through __byte_perm), because mma.sync.m16n8k32.s8 wants K contiguous in
// both operands. Each warp owns one output row of 16 positions (its A rows
// are the stride-2 input columns of the tap, read at their own addresses).
// The epilogue goes through an fp32 tile in shared memory, one lane an
// output channel.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads) conv_down_int8_two_pass_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ w_scale, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stats, int t_in, int f_in,
    int c_in, int c_out) {
  constexpr int kHw = kHwDI;
  constexpr int kHalo = kHaloDI;
  constexpr int kAccPitch = CO + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = c_in + 16;
  unsigned char* qbuf = smem;                                  // [halo][pitch]
  unsigned char* wbuf = smem + (kHaloDI * pitch + 15) / 16 * 16;  // [16][CO][48]
  float* accs = reinterpret_cast<float*>(wbuf);  // [128][kAccPitch] at the end
  __shared__ float red[2 * kThreads];

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int b = blockIdx.y;
  const int tiles_f = (f_out + kFtI - 1) / kFtI;
  const int t0 = (blockIdx.x / tiles_f) * kTtI;
  const int f0 = (blockIdx.x % tiles_f) * kFtI;
  const int cz0 = blockIdx.z * CO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // first staged input row and column (halo 1 around the input tile)
  const int ti0 = 2 * t0 - 1, fi0 = 2 * f0 - 1;
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
  // the warp's positions: output row warp, columns 0 … 15

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

#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      // output column m reads input column 2m + df of halo row 2w + dt
      const unsigned char* arow =
          qbuf + ((2 * warp + (tap >> 2)) * kHw + 2 * gid + (tap & 3)) * pitch +
          kc + tig * 4;
      const int step = 16 * pitch;  // bytes from A row gid to A row gid + 8
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
      const int t = t0 + warp, f = f0 + m;
      if (t < t_out && f < f_out) {
        const size_t off = ob + ((size_t)t * f_out + f) * c_out + co;
        const float o = __fadd_rn(
            accs[(warp * 16 + m) * kAccPitch + g * 32 + lane], bv);
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


template <typename T, int CI, int CO>
__global__ void __launch_bounds__(
    kThreads, down_int8_resident(conv_down_int8_smem(CI, CO, sizeof(T) == 2)))
    conv_down_int8_kernel(const T* __restrict__ x,
                          const int8_t* __restrict__ wq_t,
                          const float* __restrict__ w_scale,
                          const float* __restrict__ bias, T* __restrict__ out,
                          float* __restrict__ stats, int batch, int t_in,
                          int f_in, int c_out) {
  constexpr int kHalo = kDownI8Halo, kHw = kHwDI;  // 18 × 34 positions
  constexpr int V = 16 / sizeof(T);                // elements a 16-byte copy
  constexpr int NP = CI / 16;                      // 16-channel planes
  constexpr int NT = CO / 8;                       // n8 tiles a warp
  constexpr int kItems = kHalo * CI / 8;  // 8-channel items of the raw halo
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);  // [16 taps][NP][CO][16]
  int8_t* qbuf = wbuf + 16 * CO * CI;              // [NP][kHalo][16]
  T* raw = reinterpret_cast<T*>(qbuf + kHalo * CI);         // [kHalo][CI]
  float* red = reinterpret_cast<float*>(raw + kHalo * CI);  // [8][2][CO]
  float* red_amax = red + kWarps * 2 * CO;                   // [8]
  // Both halos hold halo position (r, c) at slot r·34 + (c & 1)·17 + c / 2:
  // each row's even columns, then its odd ones.
  auto slot_of = [](int hp) {
    const int c = hp % kHw;
    return (hp - c) + (c & 1) * (kHw / 2) + (c >> 1);
  };

  const int t_out = t_in / 2, f_out = f_in / 2;
  const int tiles_f = (f_out + kFtI - 1) / kFtI;
  const int tiles = ((t_out + kTtI - 1) / kTtI) * tiles_f;
  const int n_groups = batch * tiles;
  const int z = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // The 16 taps' weights of output channels CO·z …, once for the block:
  // row (tap·NP + p)·CO + co of wbuf is wq_t[tap][CO·z + co][16p … +15].
  for (int i = threadIdx.x; i < 16 * CO * NP; i += kThreads) {
    const int pl = i % NP, r = i / NP, tap = r / CO, co = r % CO;
    cp_async16(wbuf + ((tap * NP + pl) * CO + co) * 16,
               wq_t + ((size_t)tap * c_out + z * CO + co) * CI + 16 * pl);
  }
  // a group's raw halo: input rows 16·(tile row) − 1 …, columns 32·(tile
  // column) − 1 …, all Cin channels, zero outside
  auto load_raw = [&](int grp) {
    const int b = grp / tiles, tile = grp % tiles;
    const int i0 = (tile / tiles_f) * 2 * kTtI - 1;
    const int j0 = (tile % tiles_f) * 2 * kFtI - 1;
    const T* xb = x + (size_t)b * t_in * f_in * CI;
    for (int i = threadIdx.x; i < kHalo * (CI / V); i += kThreads) {
      const int hp = i / (CI / V), q = i % (CI / V);
      const int t = i0 + hp / kHw, f = j0 + hp % kHw;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      const T* src = inside ? xb + ((size_t)t * f_in + f) * CI + V * q : x;
      cp_async16_zfill(raw + slot_of(hp) * CI + V * q, src, inside);
    }
  };
  if (blockIdx.x < n_groups) load_raw(blockIdx.x);
  cp_async_commit();
  // The statistics of a group are finished at the next group's first
  // barrier (or after the walk): threads < 2·CO sum red over the warps.
  auto flush_stats = [&](int grp) {
    float* dst = stats + (size_t)grp * 2 * c_out + z * CO;  // (b, tile)
    for (int i = threadIdx.x; i < 2 * CO; i += kThreads) {
      const int which = i / CO, ch = i % CO;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[(w * 2 + which) * CO + ch];
      dst[which * c_out + ch] = sum;
    }
  };
  // Item i (channels 8·(i % (CI / 8)) … of slot i / (CI / 8)) requantised
  // into its plane of the int8 halo.
  auto put_q = [&](int i, const Vec8& e, float inv) {
    const int sl = i / (CI / 8), c8 = i % (CI / 8);
    *reinterpret_cast<uint2*>(qbuf + ((c8 >> 1) * kHalo + sl) * 16 +
                              (c8 & 1) * 8) =
        make_uint2(quant4(e.v, inv), quant4(e.v + 4, inv));
  };

  // The lane's ldmatrix rows: A at output column lane & 15 of the warp's
  // output row (halo row 2·warp + dt, tap (0, 0)), plane lane / 16 of a
  // 32-channel chunk; B at output channel (m / 2)·8 + lane % 8 of an n8
  // pair, plane m % 2 of the chunk (m = lane / 8).
  const int m = lane >> 3;
  const uint32_t a_base = smem_u32(
      qbuf + ((lane >> 4) * kHalo + 2 * warp * kHw + (lane & 15)) * 16);
  const uint32_t b_base =
      smem_u32(wbuf + ((m & 1) * CO + (m >> 1) * 8 + (lane & 7)) * 16);

  int it = 0;  // the block's groups so far
#pragma unroll 1
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++it) {
    const int b = grp / tiles, tile = grp % tiles;
    const int t0 = (tile / tiles_f) * kTtI, f0 = (tile % tiles_f) * kFtI;
    const bool more = grp + gridDim.x < n_groups;
    cp_async_wait<0>();
    __syncthreads();  // this group's raw halo (the first time, the weights)
    if (stats != nullptr && it > 0) flush_stats(grp - gridDim.x);

    // 1. The raw halo's amax.
    float am = 0.f;
    for (int i = threadIdx.x; i < kItems; i += kThreads) {
      const Vec8 e = Raw8<T>::load(raw + 8 * i).vec();
#pragma unroll
      for (int k = 0; k < 8; ++k) am = fmaxf(am, fabsf(e.v[k]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    if (lane == 0) red_amax[warp] = am;
    __syncthreads();
    am = red_amax[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) am = fmaxf(am, red_amax[k]);
    const float amax = fmaxf(am, 1e-30f);
    const float inv = 127.0f / amax;
    const float s_q = amax * (1.0f / 127.0f);

    // 2. The requant into the int8 halo; then the next group's raw halo
    // lands while this one's taps and epilogue run.
    for (int i = threadIdx.x; i < kItems; i += kThreads)
      put_q(i, Raw8<T>::load(raw + 8 * i).vec(), inv);
    __syncthreads();  // the int8 halo is complete and the raw halo read
    if (more) load_raw(grp + gridDim.x);
    cp_async_commit();

    // 3. The 16 taps: output (t0 + warp, f0 + m) += x[2(t0 + warp) + dt − 1,
    // 2(f0 + m) + df − 1] · w[dt, df], mma.sync.m16n8k32 s8 → s32.
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0;
#pragma unroll
    for (int tap = 0; tap < 16; ++tap) {
      const int dt = tap >> 2, df = tap & 3;
      const uint32_t a_tap =
          a_base + (dt * kHw + (df & 1) * (kHw / 2) + (df >> 1)) * 16;
      const uint32_t b_tap = b_base + tap * NP * CO * 16;
#pragma unroll
      for (int kc = 0; kc < CI / 32; ++kc) {
        uint32_t fa[4];
        ldsm_x4(fa, a_tap + 2 * kc * kHalo * 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t fb[4];
          ldsm_x4(fb, b_tap + (2 * kc * CO + np * 16) * 16);
          mma_s8(acc[2 * np], fa, fb[0], fb[1]);
          mma_s8(acc[2 * np + 1], fa, fb[2], fb[3]);
        }
      }
    }

    // 4. Dequantise, bias, statistics and stores from the registers, the
    // twin's operations in its order (float(acc) is exact: |acc| <=
    // 127²·16·Cin < 2^24), 32 channels at a time.
    const int t = t0 + warp;
#pragma unroll
    for (int h = 0; h < CO / 32; ++h) {
      const int co = z * CO + 32 * h + 8 * tig;
      float sc[8], s1[8], s2[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sc[k] = __fmul_rn(s_q, __ldg(w_scale + co + k));
        s1[k] = s2[k] = 0.f;
      }
      float accf[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) accf[nt][k] = (float)acc[4 * h + nt][k];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Vec8 o = quad_gather(accf, r, tig);
        const int f = f0 + gid + 8 * r;
        if (t < t_out && f < f_out) {  // the lane's 8 channels
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float e =
                __fadd_rn(__fmul_rn(o.v[k], sc[k]), __ldg(bias + co + k));
            s1[k] += e;
            s2[k] += e * e;
            o.v[k] = e;
          }
          store8(out + (((size_t)b * t_out + t) * f_out + f) * c_out + co, o);
        }
      }
      if (stats != nullptr) {  // the warp's column sums, finished later
        float tot[2];
        reduce_scatter_gid(s1, s2, tot);
        const int j = 2 * (((gid & 1) << 2) | (gid & 2) | ((gid >> 2) & 1));
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(warp * 2 + ((j + e) >> 3)) * CO + 32 * h + 8 * tig +
              ((j + e) & 7)] = tot[e];
      }
    }
  }
  if (stats != nullptr && it > 0) {
    __syncthreads();
    flush_stats(blockIdx.x + (it - 1) * gridDim.x);
  }
}

// Resident blocks an SM the up kernel's registers are bounded for: 3 where
// the raw halo is at most two items a thread (Cin <= 64: 55 KB of shared
// memory a block at 64→32), else 1 (256→192: 180 KB in bf16).
__host__ __device__ constexpr int up_int8_min_blocks(int ci) {
  return (kUpI8Halo * ci / 8 + kThreads - 1) / kThreads <= 2 ? 3 : 1;
}

// CI: the input channels (a multiple of 32, at most 256), a template
// argument so that the index arithmetic of the group's copies and items
// divides by constants.
template <typename T, int CI>
__global__ void __launch_bounds__(kThreads, up_int8_min_blocks(CI))
    conv_up_int8_kernel(const T* __restrict__ x,
                        const int8_t* __restrict__ wq_t,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ bias,
                        const T* __restrict__ res, T* __restrict__ out,
                        float* __restrict__ stats, int batch, int t_in,
                        int f_in, int c_out) {
  constexpr int CO = kUpI8Co;
  constexpr int kHalo = kUpI8Halo;  // 6 × kHwUI staged input positions
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int QP = int8_pitch(CI);
  constexpr int kItems = kHalo * CI / 8;  // 8-channel items of the raw halo
  constexpr int KI = (kItems + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem);  // [16 taps][CO][QP]
  int8_t* qbuf = wbuf + 16 * CO * QP;              // [kHalo][QP]
  T* raw = reinterpret_cast<T*>(qbuf + (kHalo * QP + 15) / 16 * 16);
  float* red = reinterpret_cast<float*>(raw + kHalo * CI);  // [8][2][CO]
  float* red_amax = red + kWarps * 2 * CO;                   // [8]

  const int t_out = 2 * t_in, f_out = 2 * f_in;
  const int tiles_f = (f_out + kFtI - 1) / kFtI;
  const int tiles = ((t_out + kTtI - 1) / kTtI) * tiles_f;
  const int n_groups = batch * tiles;
  const int z = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // The 16 taps' weights of output channels CO·z …, once for the block:
  // row tap·CO + co of wbuf is wq_t[tap][CO·z + co][0 … Cin).
  for (int i = threadIdx.x; i < 16 * CO * (CI / 16); i += kThreads) {
    const int r = i / (CI / 16), q = i % (CI / 16);
    cp_async16(wbuf + r * QP + 16 * q,
               wq_t + ((size_t)(r / CO) * c_out + z * CO + r % CO) * CI +
                   16 * q);
  }
  // a group's raw halo: input rows 4·(tile row) − 1 …, columns 8·(tile
  // column) − 1 …, all Cin channels, zero outside
  auto load_raw = [&](int grp) {
    const int b = grp / tiles, tile = grp % tiles;
    const int i0 = (tile / tiles_f) * (kTtI / 2) - 1;
    const int j0 = (tile % tiles_f) * (kFtI / 2) - 1;
    const T* xb = x + (size_t)b * t_in * f_in * CI;
    for (int i = threadIdx.x; i < kHalo * (CI / V); i += kThreads) {
      const int hp = i / (CI / V), q = i % (CI / V);
      const int t = i0 + hp / kHwUI, f = j0 + hp % kHwUI;
      const bool inside = t >= 0 && t < t_in && f >= 0 && f < f_in;
      const T* src = inside ? xb + ((size_t)t * f_in + f) * CI + V * q : x;
      cp_async16_zfill(raw + hp * CI + V * q, src, inside);
    }
  };
  if (blockIdx.x < n_groups) load_raw(blockIdx.x);
  cp_async_commit();
  // The statistics of a group are finished at the next group's first
  // barrier (or after the walk): threads < 2·CO sum red over the warps.
  auto flush_stats = [&](int grp) {
    float* dst = stats + (size_t)grp * 2 * c_out + z * CO;  // (b, tile)
    for (int i = threadIdx.x; i < 2 * CO; i += kThreads) {
      const int which = i / CO, ch = i % CO;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[(w * 2 + which) * CO + ch];
      dst[which * c_out + ch] = sum;
    }
  };

  // The warp's class (py, px) and input rows 2hh, 2hh + 1 of the tile; the
  // lane's ldmatrix rows: A at input position (2hh + (lane & 15) / 8,
  // lane & 7) of the tile, its tap (0, 0) halo slot, k half lane / 16; B at
  // output channel (m / 2)·8 + lane % 8 of an n8 pair, k half m % 2
  // (m = lane / 8).
  const int py = warp >> 2, px = (warp >> 1) & 1, hh = warp & 1;
  const int m = lane >> 3;
  const uint32_t a_base = smem_u32(
      qbuf + ((2 * hh + ((lane & 15) >> 3) + py) * kHwUI + (lane & 7) + px) * QP +
      (lane >> 4) * 16);
  const uint32_t b_base =
      smem_u32(wbuf + ((m >> 1) * 8 + (lane & 7)) * QP + (m & 1) * 16);
  // after the quad transpose the lane holds channels co … co + 7
  const int co = z * CO + 8 * tig;

  int it = 0;  // the block's groups so far
#pragma unroll 1
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++it) {
    const int b = grp / tiles, tile = grp % tiles;
    const int t0 = (tile / tiles_f) * kTtI, f0 = (tile % tiles_f) * kFtI;
    cp_async_wait<0>();
    __syncthreads();  // this group's raw halo (the first time, the weights)
    if (stats != nullptr && it > 0) flush_stats(grp - gridDim.x);

    // 1. The raw halo into registers, and its amax.
    Raw8<T> v[KI];
    float am = 0.f;
#pragma unroll
    for (int u = 0; u < KI; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kItems) {
        v[u] = Raw8<T>::load(raw + 8 * i);
        const Vec8 e = v[u].vec();
#pragma unroll
        for (int k = 0; k < 8; ++k) am = fmaxf(am, fabsf(e.v[k]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    if (lane == 0) red_amax[warp] = am;
    __syncthreads();  // also: every thread has read the raw halo
    am = red_amax[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) am = fmaxf(am, red_amax[k]);
    const float amax = fmaxf(am, 1e-30f);
    const float inv = 127.0f / amax;
    const float s_q = amax * (1.0f / 127.0f);

    // The next group's raw halo lands while this one computes.
    if (grp + gridDim.x < n_groups) load_raw(grp + gridDim.x);
    cp_async_commit();

    // 2. Requantise from the registers into the int8 halo (item i: halo
    // position i / (CI / 8), channels 8·(i % (CI / 8)) …).
#pragma unroll
    for (int u = 0; u < KI; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kItems) {  // requantise
        const Vec8 e = v[u].vec();
        *reinterpret_cast<uint2*>(qbuf + (i / (CI / 8)) * QP +
                                  8 * (i % (CI / 8))) =
            make_uint2(quant4(e.v, inv), quant4(e.v + 4, inv));
      }
    }
    __syncthreads();  // the int8 halo is complete

    // The lane's residual (its two output positions × 8 channels), loaded
    // now so that it arrives while the taps run. Row r of the m16 tile
    // (gid + 8r) is input position (2hh + r, gid) of the tile.
    Raw8<T> rr[2] = {};
    size_t off[2];
    bool ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 2 * (2 * hh + r) + py, f = f0 + 2 * gid + px;
      ok[r] = t < t_out && f < f_out;
      off[r] = (((size_t)b * t_out + t) * f_out + f) * c_out + co;
      if (ok[r] && res != nullptr) rr[r] = Raw8<T>::load(res + off[r]);
    }

    // 3. The class's four taps: out(2i + py, 2j + px) += x[i + py − 1 + a,
    // j + px − 1 + bb] · w[py + 2a, px + 2bb], mma.sync.m16n8k32 s8 → s32.
    int acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0;
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
      const int a = ab >> 1, bb = ab & 1;
      const int tap = (py + 2 * a) * 4 + px + 2 * bb;
      const uint32_t a_tap = a_base + (a * kHwUI + bb) * QP;
      const uint32_t b_tap = b_base + tap * CO * QP;
#pragma unroll
      for (int kc = 0; kc < CI; kc += 32) {
        uint32_t fa[4];
        ldsm_x4(fa, a_tap + kc);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t fb[4];
          ldsm_x4(fb, b_tap + np * 16 * QP + kc);
          mma_s8(acc[2 * np], fa, fb[0], fb[1]);
          mma_s8(acc[2 * np + 1], fa, fb[2], fb[3]);
        }
      }
    }

    // 4. Dequantise, bias, residual, statistics and stores from the
    // registers, the twin's operations in its order (float(acc) is exact:
    // |acc| <= 127²·4·Cin < 2^24). (w_scale and bias are read here, from
    // L1, which keeps the registers under the kernel's bound.)
    float sc[8], s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sc[k] = __fmul_rn(s_q, __ldg(w_scale + co + k));
      s1[k] = s2[k] = 0.f;
    }
    float accf[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) accf[nt][k] = (float)acc[nt][k];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Vec8 o = quad_gather(accf, r, tig);
      if (ok[r]) {  // the lane's 8 channels
        const Vec8 rv = rr[r].vec();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float e = __fadd_rn(__fmul_rn(o.v[k], sc[k]), __ldg(bias + co + k));
          if (res != nullptr) e = __fadd_rn(e, rv.v[k]);
          s1[k] += e;
          s2[k] += e * e;
          o.v[k] = e;
        }
        store8(out + off[r], o);
      }
    }
    if (stats != nullptr) {  // the warp's column sums, finished later
      sum_over_gid(s1);
      sum_over_gid(s2);
      if (gid == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[(warp * 2) * CO + 8 * tig + k] = s1[k];
          red[(warp * 2 + 1) * CO + 8 * tig + k] = s2[k];
        }
      }
    }
  }
  if (stats != nullptr && it > 0) {
    __syncthreads();
    flush_stats(blockIdx.x + (it - 1) * gridDim.x);
  }
}

template <typename T, int CI, int CO>
cudaError_t launch_down_int8(const TilePlan& p, const void* x,
                             const int8_t* wq_t, const float* w_scale,
                             const float* bias, void* out, float* stats,
                             int batch, int t_in, int f_in, int c_out,
                             cudaStream_t s) {
  // once per instantiation; one card per process
  static int raised = 48 * 1024;
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_down_int8_kernel<T, CI, CO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    raised = p.smem;
  }
  // The plan's grid is its resident blocks on every SM: the card must
  // keep that many resident, or the walk would not be persistent.
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, conv_down_int8_kernel<T, CI, CO>, kThreads, p.smem);
    if (err != cudaSuccess) return err;
  }
  if (resident < down_int8_resident(p.smem))
    return cudaErrorInvalidConfiguration;
  if (p.grid == 0) return cudaSuccess;
  conv_down_int8_kernel<T, CI, CO>
      <<<dim3(p.grid, 1, p.split), kThreads, p.smem, s>>>(
          static_cast<const T*>(x), wq_t, w_scale, bias, static_cast<T*>(out),
          stats, batch, t_in, f_in, c_out);
  return cudaGetLastError();
}

template <typename T, int CO>
cudaError_t launch_down_int8_two_pass(const TilePlan& p, const void* x,
                                      const int8_t* wq, const float* w_scale,
                                      const float* bias, void* out,
                                      float* stats, int batch, int t_in,
                                      int f_in, int c_in, int c_out,
                                      cudaStream_t s) {
  static int raised = 48 * 1024;  // per instantiation; one card per process
  if (p.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_down_int8_two_pass_kernel<T, CO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    raised = p.smem;
  }
  conv_down_int8_two_pass_kernel<T, CO>
      <<<dim3(p.tiles, batch, p.split), kThreads, p.smem, s>>>(
          static_cast<const T*>(x), wq, w_scale, bias, static_cast<T*>(out),
          stats, t_in, f_in, c_in, c_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_down_int8(const TilePlan& p, const void* x,
                               const int8_t* wq, const int8_t* wq_t,
                               const float* w_scale, const float* bias,
                               void* out, float* stats, int batch, int t_in,
                               int f_in, int c_in, int c_out, cudaStream_t s) {
  const bool wide = c_out / p.groups == 64;  // CO: conv_down_int8_plan
  if (p.grid == 0)  // the two-pass kernel
    return (wide ? launch_down_int8_two_pass<T, 64>
                 : launch_down_int8_two_pass<T, 32>)(
        p, x, wq, w_scale, bias, out, stats, batch, t_in, f_in, c_in, c_out,
        s);
  if (c_in == 32)
    return (wide ? launch_down_int8<T, 32, 64> : launch_down_int8<T, 32, 32>)(
        p, x, wq_t, w_scale, bias, out, stats, batch, t_in, f_in, c_out, s);
  return (wide ? launch_down_int8<T, 64, 64> : launch_down_int8<T, 64, 32>)(
      p, x, wq_t, w_scale, bias, out, stats, batch, t_in, f_in, c_out, s);
}

template <typename T, int CI>
cudaError_t launch_up_int8(const TilePlan& p, const void* x,
                           const int8_t* wq_t, const float* w_scale,
                           const float* bias, const void* res, void* out,
                           float* stats, int batch, int t_in, int f_in,
                           int c_out, cudaStream_t s) {
  // resident blocks × SMs, once per instantiation; one card per process
  static bool raised = false;
  static int grid_cap = 0;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_up_int8_kernel<T, CI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_up_int8_kernel<T, CI>, kThreads, p.smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_cap = per_sm * sms;
  }
  const int n_groups = batch * p.tiles;
  if (n_groups == 0) return cudaSuccess;
  // per output-channel group (grid.z) a share of the resident blocks
  const int per_z = grid_cap / p.split > 0 ? grid_cap / p.split : 1;
  const int gx = n_groups < per_z ? n_groups : per_z;
  conv_up_int8_kernel<T, CI><<<dim3(gx, 1, p.split), kThreads, p.smem, s>>>(
      static_cast<const T*>(x), wq_t, w_scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), stats, batch, t_in,
      f_in, c_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_up_int8(const TilePlan& p, const void* x,
                             const int8_t* wq_t, const float* w_scale,
                             const float* bias, const void* res, void* out,
                             float* stats, int batch, int t_in, int f_in,
                             int c_in, int c_out, cudaStream_t s) {
  using Launch = cudaError_t (*)(const TilePlan&, const void*, const int8_t*,
                                 const float*, const float*, const void*,
                                 void*, float*, int, int, int, int,
                                 cudaStream_t);
  Launch launch;
  switch (c_in) {  // conv_up_int8_plan: a multiple of 32, at most 256
    case 32: launch = launch_up_int8<T, 32>; break;
    case 64: launch = launch_up_int8<T, 64>; break;
    case 96: launch = launch_up_int8<T, 96>; break;
    case 128: launch = launch_up_int8<T, 128>; break;
    case 160: launch = launch_up_int8<T, 160>; break;
    case 192: launch = launch_up_int8<T, 192>; break;
    case 224: launch = launch_up_int8<T, 224>; break;
    case 256: launch = launch_up_int8<T, 256>; break;
    default: return cudaErrorInvalidValue;
  }
  return launch(p, x, wq_t, w_scale, bias, res, out, stats, batch, t_in, f_in,
                c_out, s);
}

}  // namespace ddim

extern "C" {

// The quantisation group: i = 0, 1 → the output tile's rows, columns;
// i = 2, 3 → the input halo rows, columns staged around its input tile.
int ddim_strided_int8_geometry(int i) {
  const int g[4] = {ddim::kTtI, ddim::kFtI, 1, 1};
  return i >= 0 && i < 4 ? g[i] : -1;
}

// x: [B, T, F, Cin] (fp32 or bf16, as `bf16` says); wq: [4, 4, Cin, Cout]
// int8 HWIO and wq_t the same laid out [4, 4, Cout, Cin] (the persistent
// kernel reads wq_t, the two-pass one wq); w_scale, bias: [Cout] fp32; out:
// [B, T/2, F/2, Cout] in x's dtype; stats: [B, ddim_conv_down_int8_plan(...)
// .tiles, 2, Cout] fp32 or null. Cin and Cout multiples of 32 (Cin <= 256);
// every pointer 16-byte aligned.
int ddim_conv_down_int8(const void* x, const void* wq, const void* wq_t,
                        const float* w_scale, const float* bias, void* out,
                        float* stats, int batch, int t_in, int f_in, int c_in,
                        int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p =
      conv_down_int8_plan(t_in, f_in, c_in, c_out, bf16, batch);
  if (p.variant != kVariantMma) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const int8_t* w8t = static_cast<const int8_t*>(wq_t);
  const cudaError_t err =
      bf16 ? dispatch_down_int8<__nv_bfloat16>(p, x, w8, w8t, w_scale, bias,
                                               out, stats, batch, t_in, f_in,
                                               c_in, c_out, s)
           : dispatch_down_int8<float>(p, x, w8, w8t, w_scale, bias, out,
                                       stats, batch, t_in, f_in, c_in, c_out,
                                       s);
  return static_cast<int>(err);
}

// x: [B, T, F, Cin] (fp32 or bf16, as `bf16` says); wq_t: [4, 4, Cout, Cin]
// int8 (the stored equivalent-forward kernel's HWIO int8 weights with the
// last two axes swapped); w_scale, bias: [Cout] fp32; res (or null), out:
// [B, 2T, 2F, Cout] in x's dtype; stats: [B, ddim_conv_up_int8_plan(...)
// .tiles, 2, Cout] fp32 or null. Cin and Cout multiples of 32 (Cin ≤ 256);
// every pointer 16-byte aligned.
int ddim_conv_up_int8(const void* x, const void* wq_t, const float* w_scale,
                      const float* bias, const void* res, void* out,
                      float* stats, int batch, int t_in, int f_in, int c_in,
                      int c_out, int bf16, void* stream) {
  using namespace ddim;
  const TilePlan p = conv_up_int8_plan(t_in, f_in, c_in, c_out, bf16, batch);
  if (p.variant != kVariantMma) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq_t);
  const cudaError_t err =
      bf16 ? dispatch_up_int8<__nv_bfloat16>(p, x, w8, w_scale, bias, res,
                                             out, stats, batch, t_in, f_in,
                                             c_in, c_out, s)
           : dispatch_up_int8<float>(p, x, w8, w_scale, bias, res, out, stats,
                                     batch, t_in, f_in, c_in, c_out, s);
  return static_cast<int>(err);
}

}  // extern "C"
