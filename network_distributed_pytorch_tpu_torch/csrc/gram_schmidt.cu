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
// The projection is formed as <c_i, c_j> / norm from the column before its
// normalisation, the same quantity as <c_i / norm, c_j> with other
// rounding, so that one reduction per column yields the norm and every
// projection at once.
//
// Design for Hopper:
//   * a matrix gets a thread-block cluster of C CTAs (grid (C, g), cluster
//     (C, 1, 1)); CTA c owns a contiguous range of about n / C rows, and each
//     thread owns the rows tid, tid + 256, ... of that range for the whole
//     kernel, so no row is ever shared between threads;
//   * per column, one pass over the rows applies the previous column's
//     update (normalise it, subtract its projections) and sums the partial
//     <c_i, c_j> for j >= i, up to RC columns per round (one round for
//     r <= 32); a reduce-scatter over the warp's lanes (RC - 1 + log2(32 / RC)
//     shuffles) and shared memory reduce them within the CTA, and each CTA
//     reads every CTA's partials through distributed shared memory after one
//     cluster barrier (a CTA barrier where C = 1), all loads in flight at
//     once and summed in rank order, so that every CTA derives bitwise the
//     same norm and projections;
//   * route "on_chip": the CTA's rows live in shared memory, column-major
//     (a column is contiguous, as in the Pallas kernel's transpose), brought
//     in by cp.async; P is read from and written to device memory once. Route "streaming": where
//     a share of n r floats does not fit a CTA even at C = 16 (r = 32 at
//     n = 30522), the same kernel works in place in `out`, its rows coming
//     from L2 on every pass;
//   * C is the fewest CTAs (1, 2, 4, 8, 16) whose share fits 128 KB, else the
//     fewest that fit at all, among the sizes that cudaOccupancyMaxActiveClusters
//     says can be scheduled; the streaming route takes the most that can;
//   * the per-CTA code (P in, the recurrence, P-hat out) is in
//     gram_schmidt_cta.cuh, which K3 (csrc/powersgd.cu) includes as well.
//
// What bounds it on an H100: neither bytes nor operations. P is at most a
// few MB (one read and one write: 2 n r 4 bytes, 3.9 us for the 1.95 MB word
// table at 3.35 TB/s) and the arithmetic is about 2 n r^2 operations. The r
// sequential columns are the critical path: each costs a pass over the
// CTA's rows and one cluster barrier. Latency sets both: 8 warps a CTA hide
// little of a row's chain of shared-memory loads, and the reductions and
// barriers of a column are serial, so on an H100 a column takes about 1 us
// plus 0.7 us per row a thread owns at r = 16 (PERF.md).

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "gram_schmidt_cta.cuh"

namespace {

namespace cg = gs_cta::cg;
using gs_cta::kMaxCluster;
using gs_cta::kOnChipTarget;
using gs_cta::kThreads;
using gs_cta::launch_config;

enum Route { kOnChipRoute = 1, kStreamingRoute = 2 };

// RC: columns whose partial sums a thread carries per round (r <= RC is one
// round per column). kOnChip: the CTA's rows in shared memory, else in `out`.
// The body is gs_cta::gram_schmidt_rows, which K3 (csrc/powersgd.cu) runs too.
template <int RC, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1)
gram_schmidt_kernel(const float* __restrict__ in, float* out, int n, int r, float eps) {
  extern __shared__ __align__(16) float smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows_cta = (n + n_cta - 1) / n_cta;
  const int row0 = min(n, rank * rows_cta);
  const int rows = min(n, row0 + rows_cta) - row0;
  const size_t offset = (static_cast<size_t>(blockIdx.y) * n + row0) * r;
  const float* src = in + offset;
  float* dst = out + offset;
  // on chip: rows_cta x r column-major, then coef; streaming: coef only
  float* x = kOnChip ? smem : dst;
  float* coef = kOnChip ? smem + static_cast<size_t>(rows_cta) * r : smem;

  gs_cta::load_rows<kOnChip>(src, dst, x, rows, rows_cta, r);
  __syncthreads();
  gs_cta::gram_schmidt_rows<RC, kOnChip>(x, coef, rows, rows_cta, r, eps, n_cta);
  if constexpr (kOnChip) {  // P out, a warp on consecutive floats
    __syncthreads();
    gs_cta::store_rows(x, dst, rows, rows_cta, r);
  }
  // no CTA may leave while another can still read its shared memory
  if (n_cta > 1) cluster.sync();
}

using KernelFn = void (*)(const float*, float*, int, int, float);

template <int RC>
KernelFn kernel_for(bool on_chip) {
  return on_chip ? gram_schmidt_kernel<RC, true> : gram_schmidt_kernel<RC, false>;
}

KernelFn pick_kernel(int r, bool on_chip) {
  if (r <= 4) return kernel_for<4>(on_chip);
  if (r <= 8) return kernel_for<8>(on_chip);
  if (r <= 16) return kernel_for<16>(on_chip);
  return kernel_for<32>(on_chip);
}

std::mutex g_mutex;
// (device, kernel) -> the dynamic shared memory it may use; attributes set
std::map<std::tuple<int, KernelFn>, int> g_prepared;
// (device, kernel, cluster size, shared bytes) -> cudaOccupancyMaxActiveClusters
std::map<std::tuple<int, KernelFn, int, size_t>, int> g_fits;

// The dynamic shared memory `fn` may use on `dev`, after raising its limit
// and allowing clusters of 16; -1 on a CUDA error.
int prepare(int dev, KernelFn fn) {
  const auto key = std::make_tuple(dev, fn);
  auto it = g_prepared.find(key);
  if (it != g_prepared.end()) return it->second;
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, fn) != cudaSuccess)
    return -1;
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
    return -1;
  g_prepared[key] = dyn;
  return dyn;
}

// Whether a cluster of `cluster` CTAs of `fn` with `smem` bytes each can be
// scheduled on `dev`.
bool fits(int dev, KernelFn fn, int cluster, size_t smem, int g, cudaStream_t stream) {
  const auto key = std::make_tuple(dev, fn, cluster, smem);
  auto it = g_fits.find(key);
  if (it == g_fits.end()) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cluster, g, smem, stream, &attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(fn), &cfg) != cudaSuccess) {
      cudaGetLastError();  // a refused query is a "no", not a sticky error
      active = 0;
    }
    it = g_fits.emplace(key, active).first;
  }
  return it->second > 0;
}

}  // namespace

// C entry, loaded with ctypes. Picks the route and the cluster size (written
// to *route: 1 on chip, 2 streaming; *cluster: CTAs per matrix), launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (cudaErrorInvalidConfiguration where no cluster size can be scheduled).
extern "C" int gram_schmidt_f32(const float* in, float* out, int g, int n, int r, float eps,
                                int* route, int* cluster, void* stream) {
  *route = 0;
  *cluster = 0;
  if (g <= 0 || n <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  std::lock_guard<std::mutex> lock(g_mutex);
  KernelFn fn = nullptr;
  size_t smem = 0;
  const size_t coef_bytes = sizeof(float) * r;
  const KernelFn on_chip = pick_kernel(r, true);
  const int on_chip_dyn = prepare(dev, on_chip);
  if (on_chip_dyn < 0) return static_cast<int>(cudaGetLastError());
  // on chip: the fewest CTAs whose share fits the target, else the fewest that fit
  for (size_t limit : {kOnChipTarget, static_cast<size_t>(on_chip_dyn)}) {
    for (int c = 1; c <= kMaxCluster && !fn; c *= 2) {
      const size_t rows = (static_cast<size_t>(n) + c - 1) / c;
      const size_t bytes = sizeof(float) * rows * r + coef_bytes;
      if (bytes <= limit && bytes <= static_cast<size_t>(on_chip_dyn) && fits(dev, on_chip, c, bytes, g, s)) {
        fn = on_chip;
        smem = bytes;
        *cluster = c;
        *route = kOnChipRoute;
      }
    }
    if (fn) break;
  }
  // streaming: the most CTAs that can be scheduled
  if (!fn) {
    const KernelFn streaming = pick_kernel(r, false);
    if (prepare(dev, streaming) < 0) return static_cast<int>(cudaGetLastError());
    for (int c = kMaxCluster; c >= 1 && !fn; c /= 2) {
      if (fits(dev, streaming, c, coef_bytes, g, s)) {
        fn = streaming;
        smem = coef_bytes;
        *cluster = c;
        *route = kStreamingRoute;
      }
    }
  }
  if (!fn) return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(*cluster, g, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, fn, in, out, n, r, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
