// Sums over the middle axis of [B, N, K], in an order that does not depend on
// B: the statistics partials of the conv kernels ([B, tiles, 2·C], the
// wrappers' second half of the GroupNorm statistics) and the glue's
// per-channel (sum, sum²) of an activation ([B, T·F, C]).
//
//   out[b, s, k] = Σ_n f_s(x[b, n, k]),  f_0(v) = v,  f_1(v) = v²  (squares)
//
// torch's one reduction over a batch picks how it splits the work from the
// number of its outputs, so a sample's sum takes other last bits at B = 2
// than alone (an H100 read it for the [2, 8192, 2, 32] partials of the first
// stage): a clip's result then depends on its batch. Here block (kx, chunk,
// b) sums rows [chunk·rows, (chunk + 1)·rows) of a 32-column slab of sample
// b: each thread a strided run of those rows in order, then a tree over the
// threads in a fixed order, fp32 throughout. The grid's z axis is the batch
// and nothing else depends on it, so every sample's additions are the same
// at any B, and the same run to run (no atomics). More than one chunk
// writes partials [B, chunks, S·K] that the wrapper sums again with the same
// kernel (ops/sums.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns a block, one per lane
constexpr int kRowThreads = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool kSquares>
__global__ void __launch_bounds__(kCols * kRowThreads)
    batch_sums_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                      int k, int rows) {
  __shared__ float red[kSquares ? 2 : 1][kRowThreads][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int n0 = chunk * rows, n1 = min(n, n0 + rows);
  float s1 = 0.0f, s2 = 0.0f;
  if (col < k) {
    const T* xb = x + (static_cast<size_t>(b) * n) * k + col;
    for (int r = n0 + ty; r < n1; r += kRowThreads) {
      const float v = widen(xb[static_cast<size_t>(r) * k]);
      s1 += v;
      if constexpr (kSquares) s2 = fmaf(v, v, s2);
    }
  }
  red[0][ty][tx] = s1;
  if constexpr (kSquares) red[1][ty][tx] = s2;
  __syncthreads();
#pragma unroll
  for (int h = kRowThreads / 2; h > 0; h >>= 1) {
    if (ty < h) {
      red[0][ty][tx] += red[0][ty + h][tx];
      if constexpr (kSquares) red[1][ty][tx] += red[1][ty + h][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && col < k) {
    constexpr int kS = kSquares ? 2 : 1;
    float* o = out + (static_cast<size_t>(b) * gridDim.y + chunk) * kS * k;
    o[col] = red[0][0][tx];
    if constexpr (kSquares) o[k + col] = red[1][0][tx];
  }
}

template <typename T>
cudaError_t launch(const void* x, float* out, int batch, int n, int k,
                   int squares, int rows, cudaStream_t stream) {
  const dim3 grid((k + kCols - 1) / kCols, (n + rows - 1) / rows, batch);
  const dim3 block(kCols, kRowThreads);
  const T* xt = static_cast<const T*>(x);
  if (squares)
    batch_sums_kernel<T, true><<<grid, block, 0, stream>>>(xt, out, n, k, rows);
  else
    batch_sums_kernel<T, false><<<grid, block, 0, stream>>>(xt, out, n, k, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, N, K] contiguous, fp32 (bf16 = 0) or bf16; out: [B, ceil(N / rows),
// 1 + squares, K] fp32. 0 < N, 0 < K, 0 < rows, B <= 65535, N / rows <= 65535.
int ddim_batch_sums(const void* x, float* out, int batch, int n, int k,
                    int squares, int bf16, int rows, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0 || rows <= 0 || batch > 65535 ||
      (n + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, out, batch, n, k, squares, rows, s)
           : launch<float>(x, out, batch, n, k, squares, rows, s);
  return static_cast<int>(err);
}

}  // extern "C"
