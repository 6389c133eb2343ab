// The training step's update as one multi-tensor pass over the whole
// parameter tree (ops/train_update.py): the gradients' division by the
// microbatch count, the global-norm clip, each group's AdaBelief or Adam /
// AdamW rule, p + u and the moving average (EMA), where the per-leaf torch
// code launches about 33 small kernels a leaf (12,903 a step at audio.yml's
// 388 leaves). It ports no TPU kernel: XLA fuses the JAX package's optax
// update.
//
// Bound: memory. The update reads g, p, the two moments and the EMA, writes
// p, the moments and the EMA, and the norm reads g once more: 10 fp32
// values an element, 1.89 GB a step at audio.yml's 47,155,266 parameters,
// 0.56 ms at 3.35 TB/s. A few divisions and a square root an element are far
// below the card's rate.
//
// Design. Block b takes chunk b of the tree: up to kChunk elements of one
// leaf (the chunk table, made once per tree and device, holds its leaf, its
// first element, its length and its place in the flat outputs), 16 bytes a
// thread where the leaf's pointers allow. The leaves' pointers ride in the
// launch's parameters (32,764 bytes from CUDA 12.1 on), so a tree has at most
// kMaxLeaves leaves (audio.yml: 388). A step is four launches:
//   1. norm_kernel: each chunk's sum of squares of g / count;
//   2. norm_finish_kernel (one block): each clip group's norm, the chunks'
//      partials summed in chunk order, and the norm of all (grad_norm);
//   3. apply_kernel: per element the clip, the group's rule, p + u and the
//      EMA, into fresh flat outputs; each chunk's sum of u²;
//   4. finish_kernel (one block): each leaf's update norm and each
//      AdaBelief group's mean of them (update_norm).
// Every sum is a fixed tree or a loop in a fixed order: the same bits run to
// run, with no atomics.
//
// Rounding. Each operation is the IEEE fp32 operation that the per-leaf
// torch op performs on the card (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn: never contracted into an FMA), with the constants
// rounded from Python's doubles as torch rounds a scalar, and g / count as
// torch runs a division by a Python number on the card: g · (1 / count). So
// with the clip not engaged the outputs equal the per-leaf route's bit for
// bit; the norms sum in another order than torch's reductions.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "train_update.cu needs CUDA 12.1 or later (32 KB kernel parameters)"
#endif
constexpr int kMaxLeaves = 760;  // MAX_LEAVES of ops/train_update.py
constexpr int kParamBytes = 32764;
constexpr int kMaxGroups = 4;
constexpr int kMaxClips = 4;
constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kChunk = 8192;  // elements a block: 8 float4 a thread

// One parameter group's rule (mirrored by ops/train_update.py's _Rule).
struct Rule {
  int kind;   // 0 AdaBelief, 1 Adam
  int decay;  // 0 none, 1 into the gradient (Adam's L2), 2 decoupled
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, from doubles
  // −lr, lr·wd, bc1, bc2: a 0-d fp32 tensor on the card, or (null) host[k]
  const float* dev[4];
  float host[4];
};

struct Config {
  int n_groups, n_clips, divide, has_ema;
  float inv_count, ema_keep, ema_rate, pad;  // 1 / count; 1 − mu, mu
  int clip_on[kMaxClips];
  float clip_max[kMaxClips];
  Rule rules[kMaxGroups];
};
static_assert(sizeof(Rule) == 80, "Rule must match ops/train_update.py");
static_assert(sizeof(Config) == 384, "Config must match ops/train_update.py");

struct NormArgs {
  const float* g[kMaxLeaves];
  const int4* chunks;  // leaf, start, length, start in the flat outputs
  float* partials;     // a chunk's sum of squares
  int divide;
  float inv_count;
};

struct ApplyArgs {
  const float* g[kMaxLeaves];
  const float* p[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  const float* e[kMaxLeaves];
  const int4* chunks;
  const int4* leaf_meta;  // group, clip group, first chunk, end chunk
  float *p_out, *m_out, *v_out, *e_out;  // flat, whole tree
  const float* norms;  // [clips + 1] from norm_finish_kernel
  float* partials;     // a chunk's sum of u²
  Config cfg;
};
static_assert(sizeof(NormArgs) <= kParamBytes, "NormArgs too large");
static_assert(sizeof(ApplyArgs) <= kParamBytes, "ApplyArgs too large");

// The sum of every thread's s, in thread 0 (a fixed order: xor shuffles in a
// warp, then the warps' sums in order).
template <int kBlock>
__device__ float block_sum(float s) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // a previous call's readers are done
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBlock / 32; ++w) t += warp_sums[w];
  return t;
}

__device__ __forceinline__ bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
    norm_kernel(const __grid_constant__ NormArgs a) {
  const int4 c = a.chunks[blockIdx.x];
  const float* g = a.g[c.x] + c.y;
  const int n = c.z;
  float s = 0.0f;
  auto add = [&](float x) {
    if (a.divide) x = __fmul_rn(x, a.inv_count);
    s = fmaf(x, x, s);
  };
  int i0 = 0;
  if (aligned16(g)) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int n4 = n >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 x = __ldg(g4 + i);
      add(x.x), add(x.y), add(x.z), add(x.w);
    }
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) add(g[i]);
  s = block_sum<kThreads>(s);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kFinishThreads)
    norm_finish_kernel(const float* __restrict__ partials,
                       const int4* __restrict__ chunks,
                       const int4* __restrict__ leaf_meta, int n_chunks,
                       const Config cfg, float* __restrict__ norms) {
  float s[kMaxClips] = {};
  for (int c = threadIdx.x; c < n_chunks; c += kFinishThreads) {
    const int k = leaf_meta[chunks[c].x].y;
    const float v = partials[c];
#pragma unroll
    for (int j = 0; j < kMaxClips; ++j)
      if (j == k) s[j] += v;
  }
  float all = 0.0f;
  for (int j = 0; j < cfg.n_clips; ++j) {
    const float t = block_sum<kFinishThreads>(s[j]);
    if (threadIdx.x == 0) {
      norms[j] = __fsqrt_rn(t);
      all += t;
    }
  }
  if (threadIdx.x == 0) norms[cfg.n_clips] = __fsqrt_rn(all);
}

struct Scalars {
  float neg_lr, lr_wd, bc1, bc2;
};

// The new moments of one element, as the per-leaf ops compute them.
__device__ __forceinline__ void moments(const Rule& r, float g, float p,
                                        float m, float v, float& m_new,
                                        float& v_new) {
  if (r.kind == 0) {  // b1·m + (1 − b1)·g; b2·s + (1 − b2)·(g − m)² + eps
    m_new = __fadd_rn(__fmul_rn(r.b1, m), __fmul_rn(r.omb1, g));
    const float d = __fsub_rn(g, m_new);
    v_new = __fadd_rn(
        __fadd_rn(__fmul_rn(r.b2, v), __fmul_rn(r.omb2, __fmul_rn(d, d))),
        r.eps);
    return;
  }
  if (r.decay == 1) g = __fadd_rn(g, __fmul_rn(r.wd, p));  // Adam's L2
  m_new = __fadd_rn(__fmul_rn(r.omb1, g), __fmul_rn(r.b1, m));
  v_new = __fadd_rn(__fmul_rn(r.omb2, __fmul_rn(g, g)), __fmul_rn(r.b2, v));
}

// The update u from the new moments.
__device__ __forceinline__ float step_of(const Rule& r, const Scalars& k,
                                         float m_new, float v_new, float p) {
  float x = __fdiv_rn(__fdiv_rn(m_new, k.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, k.bc2)), r.eps));
  if (r.kind == 0) {  // −lr·x − (lr·wd)·p
    const float u = __fmul_rn(k.neg_lr, x);
    return r.decay ? __fsub_rn(u, __fmul_rn(k.lr_wd, p)) : u;
  }
  if (r.decay == 2) x = __fadd_rn(x, __fmul_rn(r.wd, p));  // AdamW
  return __fmul_rn(k.neg_lr, x);
}

__device__ __forceinline__ float scalar_of(const Rule& r, int j) {
  return r.dev[j] ? *r.dev[j] : r.host[j];
}

__global__ void __launch_bounds__(kThreads)
    apply_kernel(const __grid_constant__ ApplyArgs a) {
  const int4 c = a.chunks[blockIdx.x];
  const int leaf = c.x;
  const int4 meta = a.leaf_meta[leaf];
  const Rule& r = a.cfg.rules[meta.x];
  const Scalars k{scalar_of(r, 0), scalar_of(r, 1), scalar_of(r, 2),
                  scalar_of(r, 3)};
  // optax's rule: unchanged when norm < max_norm, else (g / norm)·max_norm
  bool clip = false;
  float norm = 1.0f, max_norm = 1.0f;
  if (a.cfg.clip_on[meta.y]) {
    norm = a.norms[meta.y];
    max_norm = a.cfg.clip_max[meta.y];
    clip = !(norm < max_norm);
  }
  const bool ema = a.cfg.has_ema;
  const float keep = a.cfg.ema_keep, rate = a.cfg.ema_rate;
  const float* g = a.g[leaf] + c.y;
  const float* p = a.p[leaf] + c.y;
  const float* m = a.m[leaf] + c.y;
  const float* v = a.v[leaf] + c.y;
  const float* e = ema ? a.e[leaf] + c.y : nullptr;
  float* po = a.p_out + c.w;
  float* mo = a.m_out + c.w;
  float* vo = a.v_out + c.w;
  float* eo = ema ? a.e_out + c.w : nullptr;
  const int n = c.z;
  float s = 0.0f;

  // one element: its new moments, parameter and average, and u² summed
  auto one = [&](float gg, float pp, float mm, float vv, float ee, float& mn,
                 float& vn, float& pn, float& en) {
    if (a.cfg.divide) gg = __fmul_rn(gg, a.cfg.inv_count);
    if (clip) gg = __fmul_rn(__fdiv_rn(gg, norm), max_norm);
    moments(r, gg, pp, mm, vv, mn, vn);
    const float u = step_of(r, k, mn, vn, pp);
    s = fmaf(u, u, s);
    pn = __fadd_rn(pp, u);
    en = ema ? __fadd_rn(__fmul_rn(keep, pn), __fmul_rn(rate, ee)) : 0.0f;
  };

  int i0 = 0;
  if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) &&
      (!ema || aligned16(e))) {
    const int n4 = n >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      const float4 p4 = reinterpret_cast<const float4*>(p)[i];
      const float4 m4 = reinterpret_cast<const float4*>(m)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      const float4 e4 = ema ? reinterpret_cast<const float4*>(e)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 mn, vn, pn, en;
      one(g4.x, p4.x, m4.x, v4.x, e4.x, mn.x, vn.x, pn.x, en.x);
      one(g4.y, p4.y, m4.y, v4.y, e4.y, mn.y, vn.y, pn.y, en.y);
      one(g4.z, p4.z, m4.z, v4.z, e4.z, mn.z, vn.z, pn.z, en.z);
      one(g4.w, p4.w, m4.w, v4.w, e4.w, mn.w, vn.w, pn.w, en.w);
      reinterpret_cast<float4*>(mo)[i] = mn;
      reinterpret_cast<float4*>(vo)[i] = vn;
      reinterpret_cast<float4*>(po)[i] = pn;
      if (ema) reinterpret_cast<float4*>(eo)[i] = en;
    }
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) {
    float mn, vn, pn, en;
    one(g[i], p[i], m[i], v[i], ema ? e[i] : 0.0f, mn, vn, pn, en);
    mo[i] = mn, vo[i] = vn, po[i] = pn;
    if (ema) eo[i] = en;
  }
  s = block_sum<kThreads>(s);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = s;
}

// Each leaf's norm of u, then each AdaBelief group's update_norm, the mean
// of its leaves' norms.
__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(const float* __restrict__ partials,
                  const int4* __restrict__ leaf_meta, int n_leaves,
                  const Config cfg, float* __restrict__ leaf_norms,
                  float* __restrict__ update_norms) {
  for (int l = threadIdx.x; l < n_leaves; l += kFinishThreads) {
    const int4 m = leaf_meta[l];
    float s = 0.0f;
    for (int c = m.z; c < m.w; ++c) s += partials[c];
    leaf_norms[l] = __fsqrt_rn(s);
  }
  __syncthreads();
  const int grp = threadIdx.x;
  if (grp < cfg.n_groups && cfg.rules[grp].kind == 0) {
    float s = 0.0f;
    int count = 0;
    for (int l = 0; l < n_leaves; ++l)
      if (leaf_meta[l].x == grp) s = __fadd_rn(s, leaf_norms[l]), ++count;
    update_norms[grp] = __fdiv_rn(s, static_cast<float>(count));
  }
}

void fill(const float** dst, const uint64_t* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = reinterpret_cast<const float*>(src[i]);
}

}  // namespace

extern "C" {

// out[5]: leaves a tree, elements a chunk, groups, clip groups, and
// sizeof(Config) (the wrapper checks its mirror against it).
int ddim_train_update_limits(int* out) {
  out[0] = kMaxLeaves;
  out[1] = kChunk;
  out[2] = kMaxGroups;
  out[3] = kMaxClips;
  out[4] = static_cast<int>(sizeof(Config));
  return 0;
}

// grads: n_leaves pointers; chunks, partials: n_chunks entries.
int ddim_train_update_norm(const uint64_t* grads, int n_leaves,
                           const void* chunks, int n_chunks,
                           const void* config, float* partials, void* stream) {
  const Config* cfg = static_cast<const Config*>(config);
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NormArgs a;
  memset(&a, 0, sizeof(a));
  fill(a.g, grads, n_leaves);
  a.chunks = static_cast<const int4*>(chunks);
  a.partials = partials;
  a.divide = cfg->divide;
  a.inv_count = cfg->inv_count;
  norm_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// partials, chunks: n_chunks entries; norms: [n_clips + 1].
int ddim_train_update_norm_finish(const float* partials, const void* chunks,
                                  const void* leaf_meta, int n_chunks,
                                  const void* config, float* norms,
                                  void* stream) {
  const Config* cfg = static_cast<const Config*>(config);
  if (n_chunks <= 0 || cfg->n_clips <= 0 || cfg->n_clips > kMaxClips)
    return static_cast<int>(cudaErrorInvalidValue);
  norm_finish_kernel<<<1, kFinishThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      partials, static_cast<const int4*>(chunks),
      static_cast<const int4*>(leaf_meta), n_chunks, *cfg, norms);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: [5, n_leaves] pointers (g, p, first moment, second moment, EMA or
// 0); chunks, partials: n_chunks entries; outs: p, first moment, second
// moment, EMA (or null) flat.
int ddim_train_update_apply(const uint64_t* ptrs, int n_leaves,
                            const void* chunks, int n_chunks,
                            const void* leaf_meta, const void* config,
                            float* p_out, float* m_out, float* v_out,
                            float* e_out, const float* norms, float* partials,
                            void* stream) {
  const Config* cfg = static_cast<const Config*>(config);
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_chunks <= 0 ||
      cfg->n_groups <= 0 || cfg->n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  ApplyArgs a;
  memset(&a, 0, sizeof(a));
  fill(a.g, ptrs, n_leaves);
  fill(a.p, ptrs + n_leaves, n_leaves);
  fill(a.m, ptrs + 2 * n_leaves, n_leaves);
  fill(a.v, ptrs + 3 * n_leaves, n_leaves);
  fill(a.e, ptrs + 4 * n_leaves, n_leaves);
  a.chunks = static_cast<const int4*>(chunks);
  a.leaf_meta = static_cast<const int4*>(leaf_meta);
  a.p_out = p_out, a.m_out = m_out, a.v_out = v_out, a.e_out = e_out;
  a.norms = norms, a.partials = partials;
  a.cfg = *cfg;
  apply_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// partials: all chunks; leaf_meta, leaf_norms: n_leaves; update_norms:
// [n_groups].
int ddim_train_update_finish(const float* partials, const void* leaf_meta,
                             int n_leaves, const void* config,
                             float* leaf_norms, float* update_norms,
                             void* stream) {
  const Config* cfg = static_cast<const Config*>(config);
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || cfg->n_groups <= 0 ||
      cfg->n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, static_cast<const int4*>(leaf_meta), n_leaves, *cfg,
      leaf_norms, update_norms);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
