// K1's per-CTA device code, shared by csrc/gram_schmidt.cu (K1 itself) and
// csrc/powersgd.cu (K3, which runs the same recurrence on P in its own
// shared memory). Both translation units include this header, so K3's
// P-hat is computed by the very instructions K1 runs at a cluster of one
// CTA, and equals K1's output bit for bit wherever K1 takes one CTA.
//
// The recurrence and its Hopper layout are described at the top of
// csrc/gram_schmidt.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gs_cta {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr size_t kOnChipTarget = 128 * 1024;  // bytes of P per CTA that K1's cluster size aims at

// Sums each of v[0 .. N) over a group of L neighbouring lanes (L a power of
// two up to 32) with N - 1 + log2(L / N) shuffles where N <= L (a
// reduce-scatter, not N full reductions). On return, where N <= L, v[0]
// holds the sum of value (lane % L) / (L / N) and the lanes of one value
// agree bitwise; where N > L, v[0 .. N / L) hold the sums of values
// (lane % L) * (N / L) onwards.
template <int N, int L = 32>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  int width = N;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    if (width > 1) {
      const bool upper = lane & off;  // keeps the upper half, sends the lower
      const int half = width / 2;
#pragma unroll
      for (int c = 0; c < N / 2; ++c) {
        if (c < half) {
          const float send = upper ? v[c] : v[c + half];
          const float keep = upper ? v[c + half] : v[c];
          v[c] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      width = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

// P in: `rows` rows of r floats from `src` into the CTA's working copy,
// every load in flight at once and a warp on consecutive floats. On chip,
// by cp.async into the column-major tile x (column j of row k at
// x[j * ld + k]), element idx = k r + j going to column j of row k ((k, j)
// stepped without a division); else a flat copy to `dst`, unrolled. The
// caller synchronises the CTA before reading.
template <bool kOnChip>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, float* x,
                                          int rows, int ld, int r) {
  const int tid = threadIdx.x;
  const int count = rows * r, dk = kThreads / r, dj = kThreads % r;
  if constexpr (kOnChip) {
    int k = tid / r, j = tid % r;
    for (int idx = tid; idx < count; idx += kThreads) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(&x[j * ld + k]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + idx));
      k += dk;
      j += dj;
      if (j >= r) j -= r, ++k;
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    const bool vec4 = (r & 3) == 0 &&
                      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
    if (vec4) {
#pragma unroll 8
      for (int idx = tid; idx < count / 4; idx += kThreads)
        reinterpret_cast<float4*>(dst)[idx] = reinterpret_cast<const float4*>(src)[idx];
    } else {
#pragma unroll 8
      for (int idx = tid; idx < count; idx += kThreads) dst[idx] = src[idx];
    }
  }
}

// P-hat out from the column-major tile x to row-major `dst`, a warp on
// consecutive floats. The caller synchronises the CTA before.
__device__ __forceinline__ void store_rows(const float* x, float* __restrict__ dst, int rows, int ld,
                                           int r) {
  const int tid = threadIdx.x;
  const int count = rows * r, dk = kThreads / r, dj = kThreads % r;
  int k = tid / r, j = tid % r;
  for (int idx = tid; idx < count; idx += kThreads) {
    dst[idx] = x[j * ld + k];
    k += dk;
    j += dj;
    if (j >= r) j -= r, ++k;
  }
}

// The recurrence over the CTA's `rows` rows of an (n, r) matrix split over
// the n_cta CTAs of the cluster:
//     col_i <- col_i / (sqrt(sum col_i^2) + eps)
//     col_j <- col_j - <col_i, col_j> col_i        for every LATER j > i
// Each thread owns the rows tid, tid + kThreads, ... of the CTA. x holds the
// rows (kOnChip: column-major in shared memory with leading dimension ld;
// else row-major in device memory); coef is r floats of shared memory.
// RC: columns whose partial sums a thread carries per round (r <= RC is one
// round per column). With n_cta == 1 no cluster barrier or distributed
// shared memory is touched, so the kernel need not be a cluster launch.
// On return every row is final in x; the caller synchronises.
template <int RC, bool kOnChip>
__device__ __forceinline__ void gram_schmidt_rows(float* x, float* coef, int rows, int ld, int r,
                                                  float eps, int n_cta) {
  __shared__ float red[kWarps][RC];
  __shared__ float part[2][RC];  // this CTA's partials, double-buffered by round

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool clustered = n_cta > 1;
  // column j of the CTA's row k (n r < 2^31, so int offsets)
  auto at = [&](int j, int k) -> float& { return kOnChip ? x[j * ld + k] : x[k * r + j]; };

  // column p's update on row k: coef[p] holds its norm, coef[j > p] the
  // projections <c_p, c_j> / norm; cf holds coef[0 .. RC) in registers
  float cf[RC];
  auto update = [&](int p, int k) {
    // every load of the row before any store: a store might alias a later
    // load, so loads and stores interleaved would each wait in turn
    float old[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) old[j] = j > p && j < r ? at(j, k) : 0.f;
    const float cp = at(p, k) / coef[p];
    at(p, k) = cp;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      if (j > p && j < r) at(j, k) = old[j] - cf[j] * cp;
    for (int j = max(p + 1, RC); j < r; ++j) at(j, k) -= coef[j] * cp;
  };

  int round = 0;
  for (int i = 0; i < r; ++i) {
    for (int j0 = i; j0 < r; j0 += RC, ++round) {
      if (i > 0 && j0 == i) {
#pragma unroll
        for (int j = 0; j < RC; ++j) cf[j] = j < r ? coef[j] : 0.f;
      }
      float acc[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[c] = 0.f;
      for (int k = tid; k < rows; k += kThreads) {
        if (i > 0 && j0 == i) update(i - 1, k);
        const float ci = at(i, k);
#pragma unroll
        for (int c = 0; c < RC; ++c)
          if (j0 + c < r) acc[c] += ci * at(j0 + c, k);
      }
      warp_reduce_scatter(acc);
      if ((lane & (32 / RC - 1)) == 0) red[warp][lane / (32 / RC)] = acc[0];
      __syncthreads();
      const int buf = round & 1;
      if (tid < RC) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][tid];
        part[buf][tid] = s;
      }
      // every CTA's partials are complete and visible across the cluster;
      // part[buf] is rewritten two rounds on, after the next barrier, by
      // which time every CTA has read this round's
      if (clustered) cg::this_cluster().sync();
      else __syncthreads();
      if (tid < RC && j0 + tid < r) {
        // every load in flight at once, summed in rank order
        float mine[kMaxCluster], first[kMaxCluster];
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < n_cta) {
            const float* remote =
                clustered ? cg::this_cluster().map_shared_rank(&part[buf][0], c) : &part[buf][0];
            mine[c] = remote[tid];
            first[c] = remote[0];
          }
        }
        float s = 0.f, s0 = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < n_cta) {
            s += mine[c];
            s0 += first[c];
          }
        }
        const float norm = j0 == i ? sqrtf(s0) + eps : coef[i];
        coef[j0 + tid] = j0 + tid == i ? norm : s / norm;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < RC; ++j) cf[j] = j < r ? coef[j] : 0.f;
  for (int k = tid; k < rows; k += kThreads) update(r - 1, k);
}

// The column-round width RC that K1 takes for r factor columns.
inline int round_width(int r) { return r <= 4 ? 4 : r <= 8 ? 8 : r <= 16 ? 16 : 32; }

// Whether K1 keeps one matrix of n x r in one CTA (cluster size 1, P on
// chip): its share, with the r coefficients, fits the on-chip target.
inline bool one_cta(int n, int r) {
  return sizeof(float) * (static_cast<size_t>(n) * r + r) <= kOnChipTarget;
}

// A launch of `g` rows of `cluster` CTAs of kThreads threads, as a
// thread-block cluster of (cluster, 1, 1).
inline cudaLaunchConfig_t launch_config(int cluster, int g, size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, g, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace gs_cta
