// Flash attention forward for Hopper: exact softmax attention over folded
// (BH, T, D) fp32 heads with an additive (B, T) key mask, never building the
// (T, T) score matrix in device memory. Writes out (BH, T, D) and the per-row
// log-sum-exp lse (BH, T).
//
// Replaces network_distributed_pytorch_tpu/ops/flash_attention.py
// (_flash_kernel, called by flash_attention). The arithmetic is the Pallas
// kernel's, tile by tile:
//   q <- q * scale                         (scale = 1/sqrt(D), before q.k)
//   s  = q.k + mask[key]
//   valid = mask[key] > -1e29  (and q_pos >= k_pos when causal)
//   m' = max(m, max over valid s);  c = exp(m - m')
//   p  = valid ? exp(s - m') : 0       (the flag, never exp underflow, drops
//                                       padding: a mask of -1e30 or
//                                       finfo(f32).min gives no inf - inf)
//   l  = l c + sum p;  acc = acc c + p.v
//   out = acc / max(l, 1e-37);  lse = l > 0 ? m + log(l) : 1e30
// A fully masked row keeps l = 0 and acc = 0, so its out is exactly 0.
//
// Design (simple and right first):
//   * one block of 256 threads per (head, tile of 64 q rows); a loop over
//     tiles of 64 keys, each staged in shared memory (Q, K, V, the mask
//     tile and its validity flags, the 64 x 64 scores);
//   * a 16 x 16 thread grid: thread (rg, cg) computes the scores of q rows
//     4 rg .. 4 rg + 3 against keys cg + 16 j, and owns the output columns
//     cg + 16 j of the same rows, in registers; four threads per row run the
//     online max / normaliser update;
//   * fp32 FMA only, no tensor cores (TF32 would miss the 1e-5 the plain
//     version is held to); causal mode ends the key loop at the diagonal;
//   * any T (the ragged last tile is masked), D up to 128.
//
// What bounds it on an H100: operations. At DistilBERT's width (BH = 192,
// T = 256, D = 64) one launch does 4 BH T^2 D = 3.2 GFLOP against ~50 MB of
// traffic: 0.048 ms at 67 TFLOP/s fp32 against 0.015 ms at 3.35 TB/s. This
// version feeds each FMA from shared memory (about one load per two FMAs),
// so shared-memory bandwidth, not the FMA units, sets its speed; register
// tiles fed by wgmma, and skipping key tiles that are all padding, are
// later work (PERF.md has the measured times).

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // running-max start (finite: m - m' stays finite)
constexpr float kMaskPad = -1e29f;  // mask values at or below this are padding
constexpr float kLseEmpty = 1e30f;  // lse of a fully masked row

size_t smem_bytes(int d) {
  const int ds = d + 1;
  return sizeof(float) * (static_cast<size_t>(kBQ) * ds + kBK * ds + kBK * d +
                          kBQ * (kBK + 1) + 2 * kBK + 3 * kBQ);
}

// DJ: output columns per thread, D <= 16 * DJ
template <int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int T, int D,
                 int H, int causal, float scale) {
  extern __shared__ float smem[];
  const int ds = D + 1;                 // padded row stride of the Q and K tiles
  float* qs = smem;                     // kBQ x ds, pre-scaled
  float* ks = qs + kBQ * ds;            // kBK x ds
  float* vs = ks + kBK * ds;            // kBK x D
  float* ss = vs + kBK * D;             // kBQ x (kBK + 1): scores, then p
  float* mk = ss + kBQ * (kBK + 1);     // kBK mask values
  float* ok = mk + kBK;                 // kBK: 1 where the key is not padding
  float* m_s = ok + kBK;                // kBQ running max
  float* l_s = m_s + kBQ;               // kBQ running normaliser
  float* c_s = l_s + kBQ;               // kBQ correction of the current tile

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int t = q0 + r;
    qs[r * ds + c] = t < T ? qh[static_cast<size_t>(t) * D + c] * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ + kBK - 1) / kBK);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const int t = k0 + r;
      const bool in = t < T;
      ks[r * ds + c] = in ? kh[static_cast<size_t>(t) * D + c] : 0.f;
      vs[r * D + c] = in ? vh[static_cast<size_t>(t) * D + c] : 0.f;
    }
    if (tid < kBK) {
      const int t = k0 + tid;
      const float mv = t < T ? mrow[t] : kNegInf;
      mk[tid] = mv;
      ok[tid] = (t < T && mv > kMaskPad) ? 1.f : 0.f;
    }
    __syncthreads();

    // s = (q * scale) . k + mask, causal-masked to -1e30 as the JAX kernel does
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(rg * 4 + i) * ds + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(cg + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        float x = s[i][j] + mk[c];
        if (causal && q0 + r < k0 + c) x = kNegInf;
        ss[r * (kBK + 1) + c] = x;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      const int qpos = q0 + r;
      float* srow = ss + r * (kBK + 1) + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = part * 16 + c;
        const bool valid = ok[col] != 0.f && (!causal || qpos >= k0 + col);
        if (valid) mx = fmaxf(mx, srow[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = part * 16 + c;
        const bool valid = ok[col] != 0.f && (!causal || qpos >= k0 + col);
        const float p = valid ? expf(srow[c] - m_new) : 0.f;
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * c + p . v
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) corr[i] = c_s[rg * 4 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr[i];
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(rg * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = cg + 16 * j;
        const float vv = c < D ? vs[kk * D + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int t = q0 + r;
    if (t >= T) continue;
    const float l = l_s[r];
    const float denom = fmaxf(l, 1e-37f);
    float* orow = out + head + static_cast<size_t>(t) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cg + 16 * j;
      if (c < D) orow[c] = acc[i][j] / denom;
    }
    if (cg == 0)
      lse[static_cast<size_t>(bh) * T + t] = l > 0.f ? m_s[r] + logf(denom) : kLseEmpty;
  }
}

template <int DJ>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* out, float* lse, int bh, int T, int D, int H, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (T + kBQ - 1) / kBQ);
  flash_fwd_kernel<DJ><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse,
                                                         T, D, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, loaded with ctypes. q, k, v, out: (bh, T, D) fp32 contiguous;
// mask: (bh / H, T) fp32; lse: (bh, T) fp32. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is
// reported at once.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, const float* mask,
                                       float* out, float* lse, int bh, int T,
                                       int D, int H, int causal, float scale,
                                       void* stream) {
  if (bh <= 0 || T <= 0) return 0;
  if (D < 1 || D > kMaxD || H < 1 || bh % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<4>(q, k, v, mask, out, lse, bh, T, D, H, causal, scale, s);
  return launch<8>(q, k, v, mask, out, lse, bh, T, D, H, causal, scale, s);
}
