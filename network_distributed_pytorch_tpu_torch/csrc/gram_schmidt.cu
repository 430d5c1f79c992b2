// Sequential-column Gram-Schmidt for PowerSGD's P factors, batched over a
// shape group: in (g, n, r) fp32 row-major -> out (g, n, r).
//
// Replaces network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py
// (_gram_schmidt_kernel, called by orthogonalize_pallas). The recurrence is
// the reference one, column by column:
//     col_i <- col_i / (sqrt(sum col_i^2) + eps)
//     col_j <- col_j - <col_i, col_j> col_i        for every LATER j > i
// Columns before i are never touched again. This is not QR: QR differs in
// column signs and rounding, and PowerSGD's P-hat depends on this order.
//
// Design (simple and right first):
//   * one thread block per matrix of the group (blockIdx.x = matrix);
//   * every thread owns the rows k = tid, tid + blockDim.x, ... for the whole
//     kernel, so a row is only ever read and written by one thread and the
//     only cross-thread traffic is the block-wide reductions in shared memory;
//   * per column: one block reduction for the norm, one for the projections
//     onto up to kChunk later columns at a time (so any r works), then the
//     row update;
//   * the matrix is worked on in place in `out` (device memory). Nothing
//     assumes n * r fits in shared memory: rank 32 at n = 4608 is fine.
//
// What bounds it on an H100: bytes. The least traffic is one read and one
// write of P, 2 * n * r * 4 bytes per matrix; at PowerSGD's shapes
// (n <= 4608, r = 4) that is at most ~150 KB per matrix, which lives in L2,
// so a launch costs about its launch latency. The r sequential columns and
// the 2 * r block barriers per column are the critical path. Staging P in
// shared memory, several blocks per matrix and wgmma are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // later columns projected per reduction round

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gram_schmidt_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int n, int r, float eps) {
  __shared__ float red[kChunk][kWarps];
  __shared__ float bcast[kChunk];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * r;
  const float* src = in + base;
  float* x = out + base;

  for (int k = tid; k < n; k += kThreads)
    for (int j = 0; j < r; ++j) x[k * r + j] = src[k * r + j];

  for (int i = 0; i < r; ++i) {
    // norm of column i: sqrt(sum c^2) + eps (not rsqrt(sum + eps))
    float s = 0.f;
    for (int k = tid; k < n; k += kThreads) {
      const float c = x[k * r + i];
      s += c * c;
    }
    s = warp_sum(s);
    if (lane == 0) red[0][warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[0][w];
      bcast[0] = sqrtf(t) + eps;
    }
    __syncthreads();
    const float norm = bcast[0];
    __syncthreads();  // bcast is reused below

    // normalise column i in place
    for (int k = tid; k < n; k += kThreads) x[k * r + i] = x[k * r + i] / norm;

    // remove its projection from the later columns, kChunk at a time
    for (int j0 = i + 1; j0 < r; j0 += kChunk) {
      const int cnt = min(kChunk, r - j0);
      float acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;
      for (int k = tid; k < n; k += kThreads) {
        const float ci = x[k * r + i];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c < cnt) acc[c] += ci * x[k * r + j0 + c];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float v = warp_sum(acc[c]);
        if (lane == 0) red[c][warp] = v;
      }
      __syncthreads();
      if (tid < cnt) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += red[tid][w];
        bcast[tid] = t;
      }
      __syncthreads();
      for (int k = tid; k < n; k += kThreads) {
        const float ci = x[k * r + i];
        for (int c = 0; c < cnt; ++c) x[k * r + j0 + c] -= bcast[c] * ci;
      }
      __syncthreads();  // red and bcast are reused by the next round
    }
  }
}

}  // namespace

// C entry, loaded with ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported at once.
extern "C" int gram_schmidt_f32(const float* in, float* out, int g, int n,
                                int r, float eps, void* stream) {
  if (g > 0 && n > 0 && r > 0) {
    gram_schmidt_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, out, n, r, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
