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
// touches every element of M once and keeps the r-wide sums in registers.
// A bytes-bound stream needs many loads in flight on every SM:
//   * K2 is a tall-skinny product P = M Q. A group of L lanes takes a row
//     (L from 4 to 32, the fewest that cover the row in one batch of four
//     loads a lane), each lane issuing the 16-byte loads of its float4 of
//     the row before its FMAs; Q sits in shared memory
//     transposed, so one float4 of a factor column pairs with one float4 of
//     M. The lanes' r partial sums are reduced by a reduce-scatter across
//     the group, not r full reductions. The grid is sized to the card's
//     resident blocks and each block walks a contiguous run of (matrix, row
//     tile) pairs, reloading Q only when the matrix changes. The E and
//     write-M modes are template parameters; m % 4 != 0 or a base pointer
//     that is not 16-byte aligned takes the scalar loads.
//   * K3 computes P-hat = GS(P) with K1's own device code
//     (gram_schmidt_cta.cuh) and Q = M^T P-hat with the rows of M split over
//     a thread-block cluster of C CTAs per matrix (C the largest at which
//     all the group's clusters are resident at once, so the recurrence's
//     latency is paid in one wave). Where K1 keeps P in one CTA, every CTA
//     of the cluster runs that recurrence on the whole P in its shared
//     memory while its rows of M are prefetched to L2, so P-hat is K1's bit
//     for bit and the launch is one; elsewhere K1 runs first (two launches)
//     and the projection reads its P-hat. Each CTA
//     reads whole rows of M with float4 loads, sums its rows' products in
//     shared memory, and after one cluster barrier sums the C partials of
//     its share of Q in rank order through distributed shared memory.
//   * K4 is the first, simple version: 32 x 32 tiles of (n, m), plain loads.
//
// No float atomics: every sum runs in a fixed order, so the same inputs give
// the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "gram_schmidt_cta.cuh"

// K1, the first launch of K3's two-launch route (csrc/gram_schmidt.cu)
extern "C" int gram_schmidt_f32(const float* in, float* out, int g, int n, int r, float eps,
                                int* route, int* cluster, void* stream);

namespace {

namespace cg = gs_cta::cg;
using gs_cta::kMaxCluster;
using gs_cta::kThreads;
using gs_cta::kWarps;

constexpr int kMaxRank = 32;     // K2 and K4: factor columns per pass
constexpr int kUnroll = 4;       // K2: float4 of a row loaded before the FMAs
constexpr int kProjCols = 8;     // K3: factor columns per projection pass
constexpr int kProjUnroll = 8;   // K3: rows of M a thread loads before the FMAs
constexpr size_t kPrefetchBytes = 32u << 20;  // K3: M prefetched to L2 during Gram-Schmidt, over all CTAs
constexpr size_t kStaticSmem = 2048;  // K3: room for the recurrence's own shared arrays
constexpr int kTile = 32;        // K4: a block covers a 32 x 32 tile of (n, m)
constexpr int kMaxGridY = 65535;

// ---- K2a / K2b: M = G (+ E), P[:, c0:c0+rc] = M Q[:, c0:c0+rc] -------------
//
// A tile is kWarps * (32 / L) consecutive rows of one matrix; block b walks
// tiles [b * per_block, (b + 1) * per_block) of the flattened (matrix, tile)
// order. The L lanes of a group own one row of the tile; lane l reads the
// row's float4 l, l + L, ... (kVec) or floats l, l + L, ... and keeps kRC
// partial sums, in column order, then the group's reduce-scatter leaves
// each sum on L / kRC lanes (or kRC / L sums on each lane). Q's rc columns
// sit in shared memory as qs[c * m + j] (kQShared), reloaded when the tile's
// matrix changes; where even one column does not fit (m > 58K), a pass of
// one column reads Q from device memory. kEF: G + E is formed, rounded once,
// and written to m_out, then multiplied; else G is M.
template <int kRC, int L, bool kEF, bool kVec, bool kQShared>
__global__ void __launch_bounds__(kThreads)
ef_compress_kernel(const float* __restrict__ g, const float* __restrict__ e,
                   const float* __restrict__ q, float* __restrict__ m_out,
                   float* __restrict__ p, int n, int mm, int r, int c0, int rc,
                   int tiles_per_matrix, int total_tiles, int per_block) {
  extern __shared__ __align__(16) float qs[];
  constexpr int kGroups = 32 / L;
  constexpr int kRowsPerTile = kWarps * kGroups;
  constexpr int kHeld = kRC > L ? kRC / L : 1;     // sums a lane holds after the reduction
  constexpr int kSpread = kRC < L ? L / kRC : 1;   // lanes that hold one sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = lane & (L - 1), grp = lane / L;
  const int t_begin = blockIdx.x * per_block;
  const int t_end = min(total_tiles, t_begin + per_block);
  int cur = -1;
  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / tiles_per_matrix;
    const int row = (t - b * tiles_per_matrix) * kRowsPerTile + warp * kGroups + grp;
    const float* qb = q + static_cast<size_t>(b) * mm * r + c0;
    if (kQShared && b != cur) {
      __syncthreads();  // every warp is done with the previous matrix's Q
      for (int i = tid; i < mm * rc; i += kThreads) {
        const int j = i / rc;
        const int c = i - j * rc;
        qs[c * mm + j] = qb[static_cast<size_t>(j) * r + c];
      }
      __syncthreads();
      cur = b;
    }
    const bool active = row < n;
    const size_t off = (static_cast<size_t>(b) * n + (active ? row : 0)) * mm;
    float acc[kRC];
#pragma unroll
    for (int c = 0; c < kRC; ++c) acc[c] = 0.f;
    if constexpr (kVec) {
      const float4* g4 = reinterpret_cast<const float4*>(g + off);
      const float4* e4 = reinterpret_cast<const float4*>(e + off);
      float4* m4 = reinterpret_cast<float4*>(m_out + off);
      const int nv = active ? mm / 4 : 0;
      for (int j0 = sl; j0 < nv; j0 += L * kUnroll) {
        float4 v[kUnroll], ev[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * L;
          v[u] = j < nv ? g4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kEF) ev[u] = j < nv ? e4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * L;
          if (j >= nv) break;
          if constexpr (kEF) {  // the error-feedback add, rounded once as in G + E
            v[u] = make_float4(v[u].x + ev[u].x, v[u].y + ev[u].y, v[u].z + ev[u].z, v[u].w + ev[u].w);
            m4[j] = v[u];
          }
#pragma unroll
          for (int c = 0; c < kRC; ++c) {
            if (c < rc) {
              float4 qv;
              if constexpr (kQShared) {
                qv = *reinterpret_cast<const float4*>(qs + c * mm + 4 * j);
              } else {
                const float* qj = qb + static_cast<size_t>(4 * j) * r + c;
                qv = make_float4(qj[0], qj[r], qj[2 * r], qj[3 * r]);
              }
              acc[c] += v[u].x * qv.x;
              acc[c] += v[u].y * qv.y;
              acc[c] += v[u].z * qv.z;
              acc[c] += v[u].w * qv.w;
            }
          }
        }
      }
    } else {
      const float* gr = g + off;
      const float* er = e + off;
      float* mr = m_out + off;
      const int nj = active ? mm : 0;
      for (int j0 = sl; j0 < nj; j0 += L * kUnroll) {
        float v[kUnroll], ev[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * L;
          v[u] = j < nj ? gr[j] : 0.f;
          if constexpr (kEF) ev[u] = j < nj ? er[j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * L;
          if (j >= nj) break;
          if constexpr (kEF) {
            v[u] = v[u] + ev[u];
            mr[j] = v[u];
          }
#pragma unroll
          for (int c = 0; c < kRC; ++c) {
            if (c < rc) {
              const float qv = kQShared ? qs[c * mm + j] : qb[static_cast<size_t>(j) * r + c];
              acc[c] += v[u] * qv;
            }
          }
        }
      }
    }
    gs_cta::warp_reduce_scatter<kRC, L>(acc);
    if (active && sl % kSpread == 0) {
      const int first = kRC < L ? sl / kSpread : sl * kHeld;
      float* prow = p + (static_cast<size_t>(b) * n + row) * r + c0;
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (first + k < rc) prow[first + k] = acc[k];
    }
  }
}

// ---- K3: P-hat = Gram-Schmidt(P), Q = M^T P-hat -----------------------------
//
// grid (C, g), a cluster of the C CTAs of a matrix; CTA `rank` owns rows
// [rank * ceil(n / C), ...) of M. kGS (the one-launch route): each CTA
// copies the whole P into shared memory (column-major, as K1 keeps it) and
// runs gs_cta::gram_schmidt_rows for one CTA, the code and the order of K1
// at a cluster of one, so every CTA holds K1's P-hat; rank 0 writes it out.
// Meanwhile the CTA's rows of M are on their way to L2, as much of them as
// gives all CTAs together kPrefetchBytes. Without kGS (the two-launch route) K1 has written P-hat, and
// it is read from there.
// The projection: tr threads (a power of two, tr >= the row's float4s where
// that is below kThreads) cover a chunk of tr float4 (kVec) or floats of a
// row, and the kThreads / tr groups of them walk the CTA's rows, group grp
// taking rows row0 + grp, row0 + grp + groups, ... in ascending order, each
// thread the kProjUnroll rows' loads before their FMAs. Per pass of kPC
// factor columns and chunk: the groups' partials are added in group order
// in shared memory, then after a cluster barrier each CTA sums its share of
// the chunk's (column, factor) entries over the C CTAs in rank order and
// writes that share of Q; a second barrier frees the buffer.
// One column unit of a row of M into v: a float4 (kVec) or one float.
template <bool kVec>
__device__ __forceinline__ void load_unit(const float* __restrict__ at, float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    const float4 t = *reinterpret_cast<const float4*>(at);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *at;
  }
}

template <int GSRC, int kPC, bool kGS, bool kVec>
__global__ void __launch_bounds__(kThreads, GSRC <= 8 ? 2 : 1)
orthogonalize_project_kernel(const float* __restrict__ p, const float* __restrict__ mat,
                             float* phat, float* __restrict__ q, int n, int mm, int r,
                             float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const size_t b = blockIdx.y;
  const float* mb = mat + b * n * mm;
  float* qb = q + b * mm * r;
  float* phat_b = phat + b * n * r;
  const int rows_cta = (n + n_cta - 1) / n_cta;
  const int row0 = min(n, rank * rows_cta);
  const int row1 = min(n, row0 + rows_cta);

  float* x = smem;  // kGS: P-hat, n x r column-major, then r coefficients
  float* red = smem + (kGS ? (static_cast<size_t>(n) * r + r + 3) / 4 * 4 : 0);
  if constexpr (kGS) {
    const char* first = reinterpret_cast<const char*>(mb + static_cast<size_t>(row0) * mm);
    const size_t share = static_cast<size_t>(row1 - row0) * mm * sizeof(float);
    const size_t budget = kPrefetchBytes / (static_cast<size_t>(gridDim.x) * gridDim.y);
    const size_t span = share < budget ? share : budget;
    for (size_t o = static_cast<size_t>(tid) * 128; o < span; o += kThreads * 128)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(first + o));
    gs_cta::load_rows<true>(p + b * n * r, nullptr, x, n, n, r);
    __syncthreads();
    gs_cta::gram_schmidt_rows<GSRC, true>(x, x + static_cast<size_t>(n) * r, n, n, r, eps, 1);
    __syncthreads();
    if (rank == 0) gs_cta::store_rows(x, phat_b, n, n, r);
  }

  // P-hat's column c of row k, 0 past the last column
  auto phat_at = [=](int c, int k) -> float {
    if (c >= r) return 0.f;
    return kGS ? x[c * n + k] : phat_b[static_cast<size_t>(k) * r + c];
  };
  constexpr int E = kVec ? 4 : 1;  // floats per column unit
  const int units = mm / E;
  int tr = 1;
  while (tr < units && tr < kThreads) tr <<= 1;
  const int groups = kThreads / tr;
  const int grp = tid / tr, ci = tid % tr;
  const int width = tr * E * kPC;  // (float, factor) entries of a chunk's partial

  for (int ch = 0; ch * tr < units; ++ch) {
    const int unit = ch * tr + ci;
    for (int c0 = 0; c0 < r; c0 += kPC) {
      float acc[E][kPC];
#pragma unroll
      for (int f = 0; f < E; ++f)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[f][c] = 0.f;
      if (unit < units) {
        const float* col = mb + static_cast<size_t>(unit) * E;
        int k = row0 + grp;
        for (; k + (kProjUnroll - 1) * groups < row1; k += kProjUnroll * groups) {
          float v[kProjUnroll][E];
#pragma unroll
          for (int u = 0; u < kProjUnroll; ++u) load_unit<kVec>(col + static_cast<size_t>(k + u * groups) * mm, v[u]);
#pragma unroll
          for (int u = 0; u < kProjUnroll; ++u) {
#pragma unroll
            for (int c = 0; c < kPC; ++c) {
              const float pc = phat_at(c0 + c, k + u * groups);
#pragma unroll
              for (int f = 0; f < E; ++f) acc[f][c] += v[u][f] * pc;
            }
          }
        }
        for (; k < row1; k += groups) {
          float v[E];
          load_unit<kVec>(col + static_cast<size_t>(k) * mm, v);
#pragma unroll
          for (int c = 0; c < kPC; ++c) {
            const float pc = phat_at(c0 + c, k);
#pragma unroll
            for (int f = 0; f < E; ++f) acc[f][c] += v[f] * pc;
          }
        }
      }
      float* mine = red + static_cast<size_t>(grp) * width;
#pragma unroll
      for (int f = 0; f < E; ++f)
#pragma unroll
        for (int c = 0; c < kPC; ++c) mine[(ci * E + f) * kPC + c] = acc[f][c];
      __syncthreads();
      for (int i = tid; i < width; i += kThreads) {  // the groups in order, into group 0's slots
        float s = red[i];
        for (int gi = 1; gi < groups; ++gi) s += red[static_cast<size_t>(gi) * width + i];
        red[i] = s;
      }
      // every CTA's partial of this chunk is complete and visible
      if (n_cta > 1) cluster.sync();
      else __syncthreads();
      const int share = (width + n_cta - 1) / n_cta;
      const int i_end = min(width, (rank + 1) * share);
      for (int i = rank * share + tid; i < i_end; i += kThreads) {
        float parts[kMaxCluster];
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc)
          if (cc < n_cta) parts[cc] = n_cta > 1 ? cluster.map_shared_rank(red, cc)[i] : red[i];
        float s = 0.f;
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc)
          if (cc < n_cta) s += parts[cc];
        const int el = i / kPC;
        const int c = i - el * kPC;
        const int j = ch * tr * E + el;
        if (j < mm && c0 + c < r) qb[static_cast<size_t>(j) * r + c0 + c] = s;
      }
      // no CTA rewrites its buffer, or leaves, while another may read it
      if (n_cta > 1) cluster.sync();
      else __syncthreads();
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

std::mutex g_mutex;
// (device, kernel, dynamic shared bytes) -> resident blocks per SM (K2)
std::map<std::tuple<int, const void*, size_t>, int> g_blocks_per_sm;
// (device, kernel) -> attributes set (K3)
std::map<std::tuple<int, const void*>, bool> g_prepared;
// (device, kernel, cluster size, shared bytes) -> cudaOccupancyMaxActiveClusters (K3)
std::map<std::tuple<int, const void*, int, size_t>, int> g_clusters;

struct Device {
  int id = 0;
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t current_device(Device* d) {
  cudaError_t err = cudaGetDevice(&d->id);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, d->id);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d->id);
  return err;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Above 48 KB a block gets dynamic shared memory only once the kernel is
// allowed it.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kRC, int L, bool kEF, bool kVec, bool kQShared>
cudaError_t launch_ef_compress(const Device& dev, const float* g, const float* e, const float* q,
                               float* m_out, float* p, int count, int n, int mm, int r, int c0,
                               int rc, cudaStream_t stream) {
  auto kernel = ef_compress_kernel<kRC, L, kEF, kVec, kQShared>;
  const size_t q_bytes = kQShared ? sizeof(float) * static_cast<size_t>(mm) * rc : 0;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    const auto key = std::make_tuple(dev.id, reinterpret_cast<const void*>(kernel), q_bytes);
    auto it = g_blocks_per_sm.find(key);
    if (it == g_blocks_per_sm.end()) {
      // the kernel's whole allowance, so that no later, larger Q is refused
      cudaError_t err = allow_smem(kernel, q_bytes > 48 * 1024 ? dev.smem_optin : q_bytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, q_bytes);
      if (err != cudaSuccess) return err;
      it = g_blocks_per_sm.emplace(key, per_sm).first;
    }
    per_sm = max(it->second, 1);
  }
  constexpr int kRowsPerTile = kWarps * (32 / L);
  const long long tiles_per_matrix = (n + kRowsPerTile - 1) / kRowsPerTile;
  const long long total = tiles_per_matrix * count;
  if (total >= (1ll << 31)) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(dev.sms) * per_sm;
  const int per_block = static_cast<int>((total + slots - 1) / slots);
  const int grid = static_cast<int>((total + per_block - 1) / per_block);
  kernel<<<grid, kThreads, q_bytes, stream>>>(g, e, q, m_out, p, n, mm, r, c0, rc,
                                              static_cast<int>(tiles_per_matrix),
                                              static_cast<int>(total), per_block);
  return cudaGetLastError();
}

// One pass of K2 with kRC registers of sums: the lane group, mode, load
// width and home of Q picked at run time.
template <int kRC>
cudaError_t ef_compress_pass(const Device& dev, const float* g, const float* e, const float* q,
                             float* m_out, float* p, int count, int n, int mm, int r, int c0,
                             int rc, bool q_shared, cudaStream_t s) {
  const bool ef = e != nullptr;
  const bool vec = mm % 4 == 0 && aligned16(g) && (!ef || (aligned16(e) && aligned16(m_out)));
#define K2_LAUNCH(L, EF, VEC, QS) \
  launch_ef_compress<kRC, L, EF, VEC, QS>(dev, g, e, q, m_out, p, count, n, mm, r, c0, rc, s)
#define K2_MODES(L, QS)                                              \
  (ef ? (vec ? K2_LAUNCH(L, true, true, QS) : K2_LAUNCH(L, true, false, QS)) \
      : (vec ? K2_LAUNCH(L, false, true, QS) : K2_LAUNCH(L, false, false, QS)))
  // L: the fewest lanes (4 to 32) that take a row in one batch of kUnroll loads
  const int units = vec ? mm / 4 : mm;
  const int lanes = units <= 4 * kUnroll ? 4 : units <= 8 * kUnroll ? 8 : units <= 16 * kUnroll ? 16 : 32;
#define K2_LANES(QS)                                                                  \
  (lanes == 4 ? K2_MODES(4, QS) : lanes == 8 ? K2_MODES(8, QS)                        \
   : lanes == 16 ? K2_MODES(16, QS) : K2_MODES(32, QS))
  if constexpr (kRC == 1) {
    if (!q_shared) return K2_LANES(false);
  }
  return K2_LANES(true);
#undef K2_LANES
#undef K2_MODES
#undef K2_LAUNCH
}

// The register width for rc factor columns: the smallest of 1, 2, 4, 8, 16
// and 32 that holds them.
#define WITH_RANK_WIDTH(rc, fn, ...)                                          \
  ((rc) <= 1 ? fn<1>(__VA_ARGS__) : (rc) <= 2 ? fn<2>(__VA_ARGS__)            \
   : (rc) <= 4 ? fn<4>(__VA_ARGS__) : (rc) <= 8 ? fn<8>(__VA_ARGS__)          \
   : (rc) <= 16 ? fn<16>(__VA_ARGS__) : fn<32>(__VA_ARGS__))

// Launches K3's kernel `fn` over g matrices with `smem` bytes. The cluster
// size C is the largest (up to 16, and at most one CTA per 32 rows) at which
// all g clusters are resident at once, so the Gram-Schmidt's latency is
// paid in one wave; 1 where even single CTAs take several waves.
template <typename Kernel>
cudaError_t launch_projection(const Device& dev, Kernel* fn, size_t smem,
                              cudaStream_t stream, const float* p, const float* mat, float* phat,
                              float* q, int g, int n, int mm, int r, float eps) {
  const void* key_fn = reinterpret_cast<const void*>(fn);
  int cluster = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!g_prepared.count(std::make_tuple(dev.id, key_fn))) {
      cudaFuncAttributes attr;
      cudaError_t err = cudaFuncGetAttributes(&attr, fn);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dev.smem_optin - static_cast<int>(attr.sharedSizeBytes));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      g_prepared[std::make_tuple(dev.id, key_fn)] = true;
    }
    const int most = max(1, min(kMaxCluster, n / 32));
    for (int c = most; c >= 1 && cluster == 0; --c) {
      const auto key = std::make_tuple(dev.id, key_fn, c, smem);
      auto it = g_clusters.find(key);
      if (it == g_clusters.end()) {
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = gs_cta::launch_config(c, g, smem, stream, &attr);
        int active = 0;
        if (cudaOccupancyMaxActiveClusters(&active, key_fn, &cfg) != cudaSuccess) {
          cudaGetLastError();  // a refused query is a "no", not a sticky error
          active = 0;
        }
        it = g_clusters.emplace(key, active).first;
      }
      if (it->second >= g || (c == 1 && it->second > 0)) cluster = c;
    }
  }
  if (cluster == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = gs_cta::launch_config(cluster, g, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, p, mat, phat, q, n, mm, r, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int GSRC, int kPC, bool kGS>
cudaError_t launch_orthogonalize_project(const Device& dev, const float* p, const float* mat,
                                         float* phat, float* q, int g, int n, int mm, int r,
                                         float eps, cudaStream_t stream) {
  const bool vec = mm % 4 == 0 && aligned16(mat);
  const int e = vec ? 4 : 1;
  const size_t gs_floats = kGS ? (static_cast<size_t>(n) * r + r + 3) / 4 * 4 : 0;
  const size_t smem = sizeof(float) * (gs_floats + static_cast<size_t>(kThreads) * e * kPC);
  if (vec)
    return launch_projection(dev, orthogonalize_project_kernel<GSRC, kPC, kGS, true>, smem, stream,
                             p, mat, phat, q, g, n, mm, r, eps);
  return launch_projection(dev, orthogonalize_project_kernel<GSRC, kPC, kGS, false>, smem, stream,
                           p, mat, phat, q, g, n, mm, r, eps);
}

// The projection's factor columns per pass: the smallest of 1, 2, 4 and
// kProjCols that holds min(r, kProjCols).
#define WITH_PROJ_WIDTH(r, fn, ...)                                              \
  ((r) <= 1 ? fn<1>(__VA_ARGS__) : (r) <= 2 ? fn<2>(__VA_ARGS__)                 \
   : (r) <= 4 ? fn<4>(__VA_ARGS__) : fn<kProjCols>(__VA_ARGS__))

template <int kPC>
cudaError_t two_launch_projection(const Device& dev, const float* p, const float* mat, float* phat,
                                  float* q, int g, int n, int mm, int r, float eps,
                                  cudaStream_t s) {
  return launch_orthogonalize_project<4, kPC, false>(dev, p, mat, phat, q, g, n, mm, r, eps, s);
}

template <int kPC>
cudaError_t one_launch_r4(const Device& dev, const float* p, const float* mat, float* phat,
                          float* q, int g, int n, int mm, int r, float eps, cudaStream_t s) {
  return launch_orthogonalize_project<4, kPC, true>(dev, p, mat, phat, q, g, n, mm, r, eps, s);
}

}  // namespace

// C entries, loaded with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported at once. Shapes: g, e, m_out, mat, out, mem (count, n, mm);
// p, phat (count, n, r); q (count, mm, r); all fp32, contiguous.

// K2a (e given): m_out = g + e and p = m_out q. K2b (e and m_out null): p = g q.
// Passes of up to kMaxRank factor columns, as many as Q's slice fits shared
// memory; K2a's first pass writes M and the later passes read it back.
extern "C" int ef_compress_f32(const float* g, const float* e, const float* q, float* m_out,
                               float* p, int count, int n, int mm, int r, void* stream) {
  if (count <= 0 || n <= 0 || mm <= 0 || r <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Device dev;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int pass = kMaxRank;
  while (pass > 1 && sizeof(float) * static_cast<size_t>(mm) * pass > static_cast<size_t>(dev.smem_optin))
    pass /= 2;
  const bool q_shared = sizeof(float) * static_cast<size_t>(mm) * pass <= static_cast<size_t>(dev.smem_optin);
  for (int c0 = 0; c0 < r; c0 += pass) {
    const int rc = min(pass, r - c0);
    const bool first = c0 == 0;
    const float* src = first || e == nullptr ? g : m_out;
    err = WITH_RANK_WIDTH(rc, ef_compress_pass, dev, src, first ? e : nullptr, q,
                          first ? m_out : nullptr, p, count, n, mm, r, c0, rc, q_shared, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K3: phat = Gram-Schmidt(p), q = mat^T phat. *route is 1 for the one-launch
// route (where K1 keeps a matrix's P in one CTA: its recurrence in every CTA
// of K3's clusters) and 2 for the two-launch route (K1, then the projection).
extern "C" int orthogonalize_project_f32(const float* p, const float* mat, float* phat,
                                         float* q, int count, int n, int mm, int r,
                                         float eps, int* route, void* stream) {
  *route = 0;
  if (count <= 0 || n <= 0 || mm <= 0 || r <= 0) return 0;
  if (count > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Device dev;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t one_launch_bytes =
      sizeof(float) * ((static_cast<size_t>(n) * r + r + 3) / 4 * 4 + static_cast<size_t>(kThreads) * 4 * kProjCols);
  if (gs_cta::one_cta(n, r) && one_launch_bytes + kStaticSmem <= static_cast<size_t>(dev.smem_optin)) {
    *route = 1;
    const int width = gs_cta::round_width(r);
    if (width == 4)
      err = WITH_PROJ_WIDTH(r, one_launch_r4, dev, p, mat, phat, q, count, n, mm, r, eps, s);
    else if (width == 8)
      err = launch_orthogonalize_project<8, kProjCols, true>(dev, p, mat, phat, q, count, n, mm, r, eps, s);
    else if (width == 16)
      err = launch_orthogonalize_project<16, kProjCols, true>(dev, p, mat, phat, q, count, n, mm, r, eps, s);
    else
      err = launch_orthogonalize_project<32, kProjCols, true>(dev, p, mat, phat, q, count, n, mm, r, eps, s);
    return static_cast<int>(err);
  }
  *route = 2;
  int k1_route = 0, k1_cluster = 0;
  err = static_cast<cudaError_t>(
      gram_schmidt_f32(p, phat, count, n, r, eps, &k1_route, &k1_cluster, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      WITH_PROJ_WIDTH(r, two_launch_projection, dev, p, mat, phat, q, count, n, mm, r, eps, s));
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
