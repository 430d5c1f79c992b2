// The fused PowerSGD compress pipeline, batched over a shape group's
// (g, n, m) stack of fp32 row-major matrices. Three kernels behind four C
// entry points, loaded with ctypes by ops/powersgd.py.
//
// Replaces network_distributed_pytorch_tpu/ops/pallas_powersgd.py:
//   K2a ef_compress_f32, e given     <- _ef_compress_kernel (fused_ef_compress)
//   K2b ef_compress_f32, e == null   <- _compress_kernel (fused_ef_compress, residuals=None)
//   K3  orthogonalize_project_f32    <- _orthogonalize_project_kernel
//   K4  decompress_residual_f32      <- _decompress_residual_kernel
// Each Pallas kernel held one whole (n, m) matrix in VMEM per grid step. A
// Hopper block has at most 227 KB of shared memory, so here M streams
// through registers and only the small factors are staged on chip: Q for
// K2, P-hat for K3, 32-row tiles of P-hat and Q for K4.
//
// What bounds them on an H100: bytes. At PowerSGD's ranks each element of M
// costs 2r flops against 4 to 12 bytes moved (K2a reads G and E and writes
// M; K2b and K3 read M; K4 reads M and writes out and mem), far below the
// ~20 flop per byte where fp32 arithmetic would be the limit. So each kernel
// touches every element of M once, with coalesced accesses, and keeps the
// r-wide sums in registers. Simple and right first: plain loads, fp32 FMA;
// TMA, wgmma and reading the torch layout in place are later work.
//
// No float atomics: every sum runs in a fixed order, so the same inputs give
// the same bits on every run.

#include <cuda_runtime.h>

// K1, the first launch of K3's two-launch route (csrc/gram_schmidt.cu)
extern "C" int gram_schmidt_f32(const float* in, float* out, int g, int n, int r, float eps,
                                int* route, int* cluster, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;           // Gram-Schmidt: later columns per reduction round
constexpr int kMaxRank = 32;        // factor columns summed in registers per pass
constexpr int kRowsPerBlock = 64;   // K2: rows of M per block, 8 per warp
constexpr int kTile = 32;           // K4: a block covers a 32 x 32 tile of (n, m)
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The reference recurrence of K1 (csrc/gram_schmidt.cu) on one (n, r)
// matrix in shared memory at x, in place, by a whole block of kThreads
// threads:
//     col_i <- col_i / (sqrt(sum col_i^2) + eps)
//     col_j <- col_j - <col_i, col_j> col_i        for every LATER j > i
// Thread tid owns rows tid, tid + kThreads, ..., which it must have written
// itself. This is K1's first, one-block design: it normalises a column
// before it forms the projections and sums in another order than K1's
// cluster kernel, so K3's one-launch route agrees with K1 to fp32 rounding
// (1e-5), not bit for bit. The caller synchronises before other threads
// read x.
__device__ void gram_schmidt_block(float* x, int n, int r, float eps) {
  __shared__ float red[kChunk][kWarps];
  __shared__ float bcast[kChunk];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = 0; i < r; ++i) {
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
    __syncthreads();

    for (int k = tid; k < n; k += kThreads) x[k * r + i] = x[k * r + i] / norm;

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
      __syncthreads();
    }
  }
}

// ---- K2a / K2b: M = G (+ E), P[:, c0:c0+rc] = M Q[:, c0:c0+rc] -------------
//
// grid (g, blocks of kRowsPerBlock rows); a warp per row of M, its lanes
// striding over the m columns, so reads of G and E are coalesced. Each lane
// keeps kRC fp32 partial sums, reduced across the warp with shuffles. Q's
// rc columns sit transposed in shared memory (qs[c * m + j]: neighbouring
// lanes, neighbouring banks) when kQShared, else they are read from device
// memory, where L2 holds them. With e == null (K2b) G is M itself; m_out ==
// null skips the write of M (K2b, and the later passes when r > kMaxRank).
template <int kRC, bool kQShared>
__global__ void __launch_bounds__(kThreads)
ef_compress_kernel(const float* __restrict__ g, const float* __restrict__ e,
                   const float* __restrict__ q, float* __restrict__ m_out,
                   float* __restrict__ p, int n, int mm, int r, int c0, int rc) {
  extern __shared__ float qs[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* gb = g + b * n * mm;
  const float* eb = e == nullptr ? nullptr : e + b * n * mm;
  float* mb = m_out == nullptr ? nullptr : m_out + b * n * mm;
  const float* qb = q + b * mm * r;
  float* pb = p + b * n * r;

  if (kQShared) {
    for (int t = tid; t < mm * rc; t += kThreads) {
      const int j = t / rc;
      const int c = t - j * rc;
      qs[c * mm + j] = qb[static_cast<size_t>(j) * r + c0 + c];
    }
    __syncthreads();
  }

  for (int row0 = blockIdx.y * kRowsPerBlock; row0 < n; row0 += gridDim.y * kRowsPerBlock) {
    const int row_end = min(n, row0 + kRowsPerBlock);
    for (int row = row0 + warp; row < row_end; row += kWarps) {
      const size_t off = static_cast<size_t>(row) * mm;
      float acc[kRC];
#pragma unroll
      for (int c = 0; c < kRC; ++c) acc[c] = 0.f;
      for (int j = lane; j < mm; j += 32) {
        float v = gb[off + j];
        if (eb != nullptr) {
          v = v + eb[off + j];  // the error-feedback add, rounded once as in G + E
          if (mb != nullptr) mb[off + j] = v;
        }
#pragma unroll
        for (int c = 0; c < kRC; ++c) {
          if (c < rc) {
            const float qv = kQShared ? qs[c * mm + j] : qb[static_cast<size_t>(j) * r + c0 + c];
            acc[c] += v * qv;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kRC; ++c)
        if (c < rc) acc[c] = warp_sum(acc[c]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kRC; ++c)
          if (c < rc) pb[static_cast<size_t>(row) * r + c0 + c] = acc[c];
      }
    }
  }
}

// ---- K3: P-hat = Gram-Schmidt(P), Q = M^T P-hat -----------------------------
//
// grid (g, tiles of 32 columns of M); block kThreads. With kInShared (the
// one-launch route) the block copies P of its matrix into shared memory and
// runs gram_schmidt_block there: every column tile repeats it, which is
// cheap next to reading M; the first tile writes P-hat out. Without it (the
// two-launch route, when n r floats do not fit) P-hat was written to device
// memory by K1 itself (gram_schmidt_f32, linked from csrc/gram_schmidt.cu,
// so that route's P-hat has K1's bits) and is read from there. Then the
// projection: lane l of every warp owns column tile * 32 + l, so the warp
// reads 32 neighbouring floats of a row of M; the kWarps warps split the n
// rows, and their partial sums are added in warp order through shared
// memory, kRC factor columns per pass.
template <int kRC, bool kInShared>
__global__ void __launch_bounds__(kThreads)
orthogonalize_project_kernel(const float* __restrict__ p, const float* __restrict__ mat,
                             float* phat, float* __restrict__ q, int n, int mm, int r,
                             float eps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* mb = mat + b * n * mm;
  float* qb = q + b * mm * r;
  float* phat_b = phat + b * n * r;

  const float* x = phat_b;
  float* part = smem;  // [kWarps][kRC][32]
  if constexpr (kInShared) {
    float* xs = smem;
    part = smem + static_cast<size_t>(n) * r;
    const float* src = p + b * n * r;
    for (int k = tid; k < n; k += kThreads)
      for (int j = 0; j < r; ++j) xs[k * r + j] = src[k * r + j];
    gram_schmidt_block(xs, n, r, eps);
    __syncthreads();
    if (blockIdx.y == 0)
      for (int t = tid; t < n * r; t += kThreads) phat_b[t] = xs[t];
    x = xs;
  }

  for (int tile = blockIdx.y; tile * 32 < mm; tile += gridDim.y) {
    const int col = tile * 32 + lane;
    for (int c0 = 0; c0 < r; c0 += kRC) {
      const int rc = min(kRC, r - c0);
      float acc[kRC];
#pragma unroll
      for (int c = 0; c < kRC; ++c) acc[c] = 0.f;
      if (col < mm) {
        for (int k = warp; k < n; k += kWarps) {
          const float v = mb[static_cast<size_t>(k) * mm + col];
          const float* xr = x + static_cast<size_t>(k) * r + c0;
#pragma unroll
          for (int c = 0; c < kRC; ++c)
            if (c < rc) acc[c] += v * xr[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kRC; ++c) part[(warp * kRC + c) * 32 + lane] = acc[c];
      __syncthreads();
      for (int t = tid; t < rc * 32; t += kThreads) {
        const int c = t >> 5;
        const int l = t & 31;
        const int j = tile * 32 + l;
        if (j < mm) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += part[(w * kRC + c) * 32 + l];
          qb[static_cast<size_t>(j) * r + c0 + c] = s;
        }
      }
      __syncthreads();  // part is reused by the next pass
    }
  }
}

// ---- K4: out = P-hat Q^T, mem = M - out -------------------------------------
//
// grid (tiles of 32 columns, tiles of 32 rows, g); block (32, 8). Thread
// (tx, ty) owns column tile_m * 32 + tx of rows tile_n * 32 + ty + 8 t,
// t < 4: reads of M and writes of out and mem are coalesced across tx. The
// tile's 32 rows of P-hat and 32 rows of Q are staged in shared memory,
// kMaxRank columns at a time (padded rows: no bank conflicts). Each output
// is an fp32 sum over c in ascending order, and mem = M - out is formed in
// fp32 and written once.
__global__ void __launch_bounds__(kThreads)
decompress_residual_kernel(const float* __restrict__ p, const float* __restrict__ q,
                           const float* __restrict__ mat, float* __restrict__ out,
                           float* __restrict__ mem, int n, int mm, int r) {
  __shared__ float ps[kTile][kMaxRank + 1];
  __shared__ float qs[kTile][kMaxRank + 1];
  constexpr int kRowsPerThread = kTile / (kThreads / 32);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const size_t b = blockIdx.z;
  const float* pb = p + b * n * r;
  const float* qb = q + b * mm * r;
  const size_t base = b * n * mm;
  const int j0 = blockIdx.x * kTile;
  const int j = j0 + tx;

  for (int i0 = blockIdx.y * kTile; i0 < n; i0 += gridDim.y * kTile) {
    float acc[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) acc[t] = 0.f;
    for (int c0 = 0; c0 < r; c0 += kMaxRank) {
      const int rc = min(kMaxRank, r - c0);
      for (int t = tid; t < kTile * rc; t += kThreads) {
        const int row = t / rc;
        const int c = t - row * rc;
        ps[row][c] = i0 + row < n ? pb[static_cast<size_t>(i0 + row) * r + c0 + c] : 0.f;
        qs[row][c] = j0 + row < mm ? qb[static_cast<size_t>(j0 + row) * r + c0 + c] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < rc; ++c) {
        const float qv = qs[tx][c];
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t) acc[t] += ps[ty + 8 * t][c] * qv;
      }
      __syncthreads();  // ps and qs are reused by the next pass
    }
    if (j < mm) {
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) {
        const int i = i0 + ty + 8 * t;
        if (i < n) {
          const size_t o = base + static_cast<size_t>(i) * mm + j;
          out[o] = acc[t];
          mem[o] = mat[o] - acc[t];
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

int smem_optin() {
  int dev = 0;
  int bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Above 48 KB a block gets dynamic shared memory only once the kernel is
// allowed it.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The register width for rc factor columns: the smallest of 1, 2, 4, 8, 16
// and 32 that holds them.
#define WITH_RANK_WIDTH(rc, fn, ...)                                          \
  ((rc) <= 1 ? fn<1>(__VA_ARGS__) : (rc) <= 2 ? fn<2>(__VA_ARGS__)            \
   : (rc) <= 4 ? fn<4>(__VA_ARGS__) : (rc) <= 8 ? fn<8>(__VA_ARGS__)          \
   : (rc) <= 16 ? fn<16>(__VA_ARGS__) : fn<32>(__VA_ARGS__))

template <int kRC>
cudaError_t launch_ef_compress(const float* g, const float* e, const float* q, float* m_out,
                               float* p, int count, int n, int mm, int r, int c0, int rc,
                               cudaStream_t stream) {
  const dim3 grid(count, min((n + kRowsPerBlock - 1) / kRowsPerBlock, kMaxGridY));
  const size_t q_bytes = sizeof(float) * static_cast<size_t>(mm) * rc;
  if (q_bytes <= static_cast<size_t>(smem_optin())) {
    auto kernel = ef_compress_kernel<kRC, true>;
    const cudaError_t err = allow_smem(kernel, q_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, q_bytes, stream>>>(g, e, q, m_out, p, n, mm, r, c0, rc);
  } else {
    ef_compress_kernel<kRC, false><<<grid, kThreads, 0, stream>>>(g, e, q, m_out, p, n, mm,
                                                                  r, c0, rc);
  }
  return cudaGetLastError();
}

template <int kRC>
cudaError_t launch_orthogonalize_project(const float* p, const float* mat, float* phat,
                                         float* q, int count, int n, int mm, int r,
                                         float eps, int* route, cudaStream_t stream) {
  const dim3 grid(count, min((mm + 31) / 32, kMaxGridY));
  const size_t part_bytes = sizeof(float) * kWarps * kRC * 32;
  const size_t one_launch_bytes = sizeof(float) * static_cast<size_t>(n) * r + part_bytes;
  auto one_launch = orthogonalize_project_kernel<kRC, true>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, one_launch);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + one_launch_bytes <= static_cast<size_t>(smem_optin())) {
    *route = 1;
    err = allow_smem(one_launch, one_launch_bytes);
    if (err != cudaSuccess) return err;
    one_launch<<<grid, kThreads, one_launch_bytes, stream>>>(p, mat, phat, q, n, mm, r, eps);
    return cudaGetLastError();
  }
  *route = 2;
  int k1_route = 0, k1_cluster = 0;
  err = static_cast<cudaError_t>(
      gram_schmidt_f32(p, phat, count, n, r, eps, &k1_route, &k1_cluster, stream));
  if (err != cudaSuccess) return err;
  orthogonalize_project_kernel<kRC, false><<<grid, kThreads, part_bytes, stream>>>(
      p, mat, phat, q, n, mm, r, eps);
  return cudaGetLastError();
}

}  // namespace

// C entries, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported at once. Shapes: g, e, m_out, mat, out, mem (count, n, mm);
// p, phat (count, n, r); q (count, mm, r); all fp32, contiguous.

// K2a (e given): m_out = g + e and p = m_out q. K2b (e and m_out null): p = g q.
extern "C" int ef_compress_f32(const float* g, const float* e, const float* q, float* m_out,
                               float* p, int count, int n, int mm, int r, void* stream) {
  if (count <= 0 || n <= 0 || mm <= 0 || r <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < r; c0 += kMaxRank) {
    const int rc = min(kMaxRank, r - c0);
    float* m_write = c0 == 0 ? m_out : nullptr;  // M is written by the first pass only
    const cudaError_t err =
        WITH_RANK_WIDTH(rc, launch_ef_compress, g, e, q, m_write, p, count, n, mm, r, c0, rc, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K3: phat = Gram-Schmidt(p), q = mat^T phat. *route is 1 for the one-launch
// route (P-hat in shared memory) and 2 for the two-launch route.
extern "C" int orthogonalize_project_f32(const float* p, const float* mat, float* phat,
                                         float* q, int count, int n, int mm, int r,
                                         float eps, int* route, void* stream) {
  *route = 0;
  if (count <= 0 || n <= 0 || mm <= 0 || r <= 0) return 0;
  const int width = min(r, kMaxRank);
  return static_cast<int>(WITH_RANK_WIDTH(width, launch_orthogonalize_project, p, mat, phat,
                                          q, count, n, mm, r, eps, route,
                                          static_cast<cudaStream_t>(stream)));
}

// K4: out = p q^T, mem = mat - out. count must be at most 65535 (grid.z).
extern "C" int decompress_residual_f32(const float* p, const float* q, const float* mat,
                                       float* out, float* mem, int count, int n, int mm,
                                       int r, void* stream) {
  if (count <= 0 || n <= 0 || mm <= 0) return 0;
  if (count > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((mm + kTile - 1) / kTile, min((n + kTile - 1) / kTile, kMaxGridY), count);
  decompress_residual_kernel<<<grid, dim3(32, kThreads / 32), 0,
                               static_cast<cudaStream_t>(stream)>>>(p, q, mat, out, mem, n,
                                                                    mm, r);
  return static_cast<int>(cudaGetLastError());
}
