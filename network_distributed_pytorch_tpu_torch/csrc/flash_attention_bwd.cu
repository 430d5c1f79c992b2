// Flash attention backward for Hopper: the gradients of
// csrc/flash_attention.cu's forward in q, k, v and (when asked) the additive
// key mask, over folded (BH, T, D) heads of fp32 or bf16, from the forward's
// out and fp32 lse and the cotangent dO, never building the (T, T) score
// matrix in device memory.
//
// Replaces network_distributed_pytorch_tpu/ops/flash_attention.py
// (_flash_bwd_chunked, the custom_vjp backward of flash_attention: an XLA
// lax.scan over key blocks, not a Pallas kernel). The arithmetic is its:
//   Dr = rowsum(dO * out)                                     (fp32)
//   s  = scale q.k + mask[key];  P = valid ? exp(s - lse) : 0
//   valid = mask[key] > -1e29 (and q_pos >= k_pos when causal): the forward's
//     flag, never exp underflow (a fully masked row has lse = 1e30, so its P
//     is 0 too)
//   dP = dO.V^T;  dS = P * (dP - Dr)
//   dV = P^T.dO;  dQ = scale dS.K;  dK = scale dS^T.Q
//   dmask[b, key] = sum over heads and q rows of dS
// Every product accumulates in fp32; dq, dk and dv are rounded to the heads'
// dtype once, at the end; the mask's gradient stays fp32.
//
// Design: three launches behind one C entry per dtype, no atomics, so two
// calls give the same bits.
//   (i)   a pre-pass writes Dr (BH, T) in fp32, one warp a row (eight
//         threads a row on bf16 heads with 16-byte rows);
//   (ii)  dK and dV: one block of 4 warps per (head, tile of 64 keys), each
//         warp owning 16 keys. K and V stay in shared memory; tiles of q
//         rows of Q and dO (with their lse and Dr) arrive by cp.async into a
//         double-buffered ring. The block computes S^T = K.Q^T and
//         dP^T = V.dO^T directly, so the key axis is the products' M axis and
//         P^T and dS^T are, in their accumulator fragments, the A operands of
//         dV += P^T.dO and dK += dS^T.Q, with no trip through shared memory.
//         It walks the q tiles from the diagonal (causal) or from 0, and
//         writes dK and dV once. With the mask's gradient asked for, it also
//         writes each key's sum of dS over q (per head) to a (BH, T) fp32
//         scratch, which the wrapper sums over heads. A key tile whose every
//         key is padding is neither loaded nor multiplied: its dK and dV are
//         written as zeros, which is what the reference gives for finite
//         inputs (P = 0 there);
//   (iii) dQ: one block of 4 warps per (head, tile of 64 q rows), each warp
//         owning 16 rows, Q and dO in shared memory, tiles of 64 keys of K, V
//         and the mask in a double-buffered ring, all-padding tiles skipped
//         by the forward's warp vote, the walk ending at the diagonal when
//         causal. S, dP and dS are recomputed; dS's fragments are the A
//         operand of dQ += dS.K.
// Both kernels flag the ragged rows past T invalid (their shared rows are
// zero-filled), take exp as ex2 of a log2(e)-scaled argument formed in
// fmas, skip the per-element flag on a tile whose every (q row, key) pair is
// valid, and reverse the causal walk's block order where the longest walks
// would otherwise start last.
//
// Products, by dtype and head dimension:
//   * fp32 heads, D <= 64 (GPT-2's and DistilBERT's 64): warpgroup
//     products in 3xTF32 (wgmma m64n64k8, csrc/wgmma_tf32.cuh), one
//     warpgroup a block, one block an SM (224 KB of shared memory for
//     dK/dV, 194 KB for dQ), every tile a swizzled 64 x 64 fp32 tile. The
//     tensor cores take an fp32 operand's top 19 bits (TF32; its low 13 are
//     ignored), so a tile as it arrives is its own hi part; each walked tile
//     is split once by the warps into its lo part and, for the products
//     whose depth is the walk (dQ += dS.K, dV += P^T.dO, dK += dS^T.Q: a
//     TF32 wgmma reads B K-major only), its transpose's hi and lo parts.
//     S and dP are SS products (lo.hi, hi.lo, hi.hi) in one chain of 24
//     passes; P and dS are split in registers and are the RS A operand of
//     dV, dK and dQ as they stand, each a fresh partial a tile added to its
//     running sum in fp32 (see below on the accumulators' truncation);
//   * fp32 heads, 64 < D <= 128: mma.sync m16n8k8 in 3xTF32
//     (csrc/flash_attention_mma.cuh, F32Route), every operand split into
//     TF32 hi and lo as it is read (about 22 bits of each product);
//   * bf16 heads, D <= 64 (GPT-2's and DistilBERT's 64): warpgroup products
//     (wgmma m64n64k16, csrc/wgmma_bf16.cuh), one warpgroup a block, every
//     tile in shared memory in the 128-byte swizzled layout that wgmma
//     reads. S and dP are exact bf16 products in one pass each, the walked
//     tile K-major as B; A is K or V in registers, loaded once by ldmatrix
//     (dK/dV, RS), or Q or dO in shared memory (dQ, SS). P and dS are fp32;
//     each is split in registers into bf16 hi and lo (16 bits), whose
//     accumulator fragments are the register A operand (RS) of dV, dK and
//     dQ, two passes each against the walked tile as an MN-major B (the
//     descriptor's transpose bit). The tensor cores read B once for the
//     warpgroup, not once a warp as mma.sync does, and run while the warps
//     work (P while dP runs, dS while dV runs);
//   * bf16 heads, 64 < D <= 128: mma.sync m16n8k16 from ldmatrix, the same
//     arithmetic (the accumulators of dK and dV at D = 128 would not fit
//     beside the m64 tiles).
//
// What bounds it on an H100: GPT-2's causal heads (BH = 192, T = 1024,
// D = 64) need five products of 2 D FLOP over T (T + 1) / 2 pairs a head:
// 64.5 GFLOP a launch, 0.065 ms at the bf16 peak, 0.39 ms at 3xTF32's
// 495/3 TFLOP/s; q, k, v, out, dO read and dq, dk, dv written are 202 MB in
// bf16 (0.060 ms), 403 MB in fp32. The kernels recompute S and dP in both
// passes (ten bf16 passes a pair in all, twenty-one TF32 passes in fp32) on
// whole 64 x 64 tiles, diagonal ones included. At D = 64 a warpgroup's
// 64 x 64 products are short (32 cycles each at the peak, bf16 k16 or TF32
// k8), so the loop's own instructions (copies, exp, the splits, the waits)
// set its pace more than the tensor cores do, and in fp32 one block an SM
// leaves nothing to fill the tensor cores' gaps. Both stay well above
// those bounds.

#include "flash_attention_mma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kWarps = 4;  // 16 rows (keys or q rows) each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // keys a dK/dV block owns, q rows a dQ block owns
constexpr int kMaxD = 128;
constexpr int kGroup = 4;  // independent mma chains interleaved (fp32)

// The warp's products for each element type. Shared tiles are row-major
// with row stride LD; DT is D padded to 8 DT columns (zeros past D).
//   nt: c (16 x 8 NT) += A (16 x D) . B^T, A and B both stored as rows
//       of length D (B's rows are C's columns);
//   nn: c (16 x 8 DT) += A (16 x 8 KT) . B, A given as fp32 accumulator
//       fragments a[0 .. KT), B stored as KT * 8 rows of length D.
//
// fp32 (F32Route): the tensor cores truncate as they accumulate, so a
// chain of mma into one register drifts towards zero by up to an ulp of it
// an mma. A walk of T = 1024 q rows is 384 mma into each dK and dV
// fragment: a drift of order 384 ulp, about 2e-5 of the largest values,
// past the 1e-5 tolerance. Over D = 64, dP is 24 mma, and dS = P (dP - Dr)
// passes dP's error on whole where dP and Dr nearly cancel. So nt sums each
// k step's three passes, and nn each call's KT k steps, into a fresh
// fragment, added to the result in fp32 with rounding to nearest.
struct F32Route {
  using Elt = float;

  template <int NT, int DT>
  __device__ static void nt(float (*c)[4], const float* a, const float* b, int ld, int D) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (8 * kk >= D) break;
      uint32_t ah[4], al[4];
      split(a[g * ld + 8 * kk + t], ah[0], al[0]);
      split(a[(g + 8) * ld + 8 * kk + t], ah[1], al[1]);
      split(a[g * ld + 8 * kk + t + 4], ah[2], al[2]);
      split(a[(g + 8) * ld + 8 * kk + t + 4], ah[3], al[3]);
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += kGroup) {
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          split(b[(8 * (n0 + n) + g) * ld + 8 * kk + t], bh[n][0], bl[n][0]);
          split(b[(8 * (n0 + n) + g) * ld + 8 * kk + t + 4], bh[n][1], bl[n][1]);
        }
        float part[kGroup][4] = {};
        mma_3xtf32<kGroup>(part, ah, al, bh, bl);
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n0 + n][e] += part[n][e];
      }
    }
  }

  // a[j] covers columns 8 j .. 8 j + 7 of A; as an m16n8k8 A fragment its k
  // index t stands for column 8 j + 2 t and t + 4 for 8 j + 2 t + 1, and B's
  // rows are read in that order. Each call sums its KT * 3 products into a
  // fresh fragment and adds that to c in fp32 (see F32Route on truncation)
  template <int KT, int DT>
  __device__ static void nn(float (*c)[4], const float (*a)[4], const float* b, int ld, int D) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n0 = 0; n0 < DT; n0 += kGroup) {
      if (8 * n0 >= D) break;
      float part[kGroup][4] = {};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t ah[4], al[4];
        split(a[j][0], ah[0], al[0]);
        split(a[j][2], ah[1], al[1]);
        split(a[j][1], ah[2], al[2]);
        split(a[j][3], ah[3], al[3]);
        const float* b0 = b + (8 * j + 2 * t) * ld + 8 * n0 + g;
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          split(b0[8 * n], bh[n][0], bl[n][0]);
          split(b0[ld + 8 * n], bh[n][1], bl[n][1]);
        }
        mma_3xtf32<kGroup>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n0 + n][e] += part[n][e];
    }
  }
};

struct Bf16Route {
  using Elt = __nv_bfloat16;

  template <int NT, int DT>
  __device__ static void nt(float (*c)[4], const Elt* a, const Elt* b, int ld, int D) {
#pragma unroll
    for (int kk = 0; kk < DT / 2; ++kk) {
      if (16 * kk >= D) break;
      uint32_t af[4];
      ldmatrix_a(af, a, ld, 16 * kk);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_b_rows(bf, b + 16 * np * ld, ld, 16 * kk);
        mma_bf16(c[2 * np], af, bf[0], bf[1]);
        mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }

  // A split into bf16 hi and lo, lo's pass first
  template <int KT, int DT>
  __device__ static void nn(float (*c)[4], const float (*a)[4], const Elt* b, int ld, int D) {
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t ah[4], al[4];
      c_to_a_bf16(a[2 * kk], a[2 * kk + 1], ah, al);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        if (16 * np >= D) break;
        uint32_t bf[4];
        ldmatrix_b_trans(bf, b + 16 * kk * ld, ld, 16 * np);
        mma_bf16(c[2 * np], al, bf[0], bf[1]);
        mma_bf16(c[2 * np + 1], al, bf[2], bf[3]);
        mma_bf16(c[2 * np], ah, bf[0], bf[1]);
        mma_bf16(c[2 * np + 1], ah, bf[2], bf[3]);
      }
    }
  }
};

template <int DT>
__device__ __forceinline__ void zero_acc(float (&c)[DT][4]) {
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// rows (entries 0, 1: row g; 2, 3: row g + 8) of a warp's 16 x 8 DT
// accumulator times `mul` into a (T, D) head at row r0, rows < T only
template <typename Elt, int DT>
__device__ __forceinline__ void store_rows(const float (&c)[DT][4], float mul, Elt* head, int r0, int T, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= T) continue;
    Elt* row = head + static_cast<size_t>(r) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) row[col] = narrow<Elt>(c[n][2 * h] * mul);
      if (col + 1 < D) row[col + 1] = narrow<Elt>(c[n][2 * h + 1] * mul);
    }
  }
}

// (i) Dr[row] = sum over d of dO[row][d] * out[row][d], in fp32
template <typename Elt>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Elt* __restrict__ out,
                                                              const Elt* __restrict__ dout,
                                                              float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += widen(dout[base + c]) * widen(out[base + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// q rows a dK/dV block walks at a time: 64, or 32 at D = 128 (registers)
template <int DT>
constexpr int kBQ = DT == 8 ? 64 : 32;

template <typename Elt, int DT>
constexpr size_t dkdv_smem() {
  // K and V (kRows each), two stages of Q and dO (kBQ each); two stages of
  // lse and Dr, and the key tile's mask
  return sizeof(Elt) * row_stride<Elt>(8 * DT) * (2 * kRows + 4 * kBQ<DT>) + sizeof(float) * (4 * kBQ<DT> + kRows);
}

template <typename Elt, int DT>
constexpr size_t dq_smem() {
  // Q and dO (kRows each), two stages of K and V (kBK each); lse and Dr of
  // the block's rows, and two stages of the key tile's mask
  return sizeof(Elt) * row_stride<Elt>(8 * DT) * (2 * kRows + 4 * kBK) + sizeof(float) * (2 * kRows + 2 * kBK);
}

// (ii) dK, dV and the per-head column sums of dS
template <typename R, int DT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const typename R::Elt* __restrict__ q, const typename R::Elt* __restrict__ k,
                      const typename R::Elt* __restrict__ v, const float* __restrict__ mask,
                      const float* __restrict__ lse, const typename R::Elt* __restrict__ dout,
                      const float* __restrict__ delta, typename R::Elt* __restrict__ dk,
                      typename R::Elt* __restrict__ dv, float* __restrict__ dmask_part, int T, int D, int H,
                      int causal, float scale) {
  using Elt = typename R::Elt;
  constexpr int DP = 8 * DT;
  constexpr int LD = row_stride<Elt>(DP);
  constexpr int BQ = kBQ<DT>;
  constexpr int NQ = BQ / 8;  // n8 tiles of q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* ks = reinterpret_cast<Elt*>(smem_raw);  // kRows x LD
  Elt* vs = ks + kRows * LD;
  Elt* ring = vs + kRows * LD;  // two stages of (Q tile, dO tile), BQ x LD each
  float* lse_s = reinterpret_cast<float*>(ring + 4 * BQ * LD);  // two stages of BQ
  float* delta_s = lse_s + 2 * BQ;                              // two stages of BQ
  float* mk = delta_s + 2 * BQ;                                 // kRows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  // a tile with no valid key: zeros, nothing read
  const bool key_valid = tid < kRows && k0 + tid < T && __ldg(mrow + k0 + tid) > kMaskPad;
  const bool all_keys = __syncthreads_and(key_valid || tid >= kRows);
  if (!__syncthreads_or(key_valid)) {
    const int n = min(kRows, T - k0) * D;
    for (int i = tid; i < n; i += kThreads) {
      dk[head + static_cast<size_t>(k0) * D + i] = narrow<Elt>(0.f);
      dv[head + static_cast<size_t>(k0) * D + i] = narrow<Elt>(0.f);
    }
    if (dmask_part && tid < kRows && k0 + tid < T) dmask_part[static_cast<size_t>(bh) * T + k0 + tid] = 0.f;
    return;
  }

  zero_padding<kThreads>(ks, LD, 2 * kRows + 4 * BQ, D, DP);  // K, V and the ring are contiguous
  const bool vec = rows_aligned<Elt>(D, q, k, v) && rows_aligned<Elt>(D, dout, dout, dout);
  load_rows<kThreads, DP>(ks, LD, k + head, k0, kRows, T, D, vec);
  load_rows<kThreads, DP>(vs, LD, v + head, k0, kRows, T, D, vec);
  load_floats<kThreads>(mk, mrow, k0, kRows, T);
  auto load_q = [&](int qt, int stage) {
    Elt* qs = ring + stage * 2 * BQ * LD;
    load_rows<kThreads, DP>(qs, LD, q + head, qt * BQ, BQ, T, D, vec);
    load_rows<kThreads, DP>(qs + BQ * LD, LD, dout + head, qt * BQ, BQ, T, D, vec);
    load_floats<kThreads>(lse_s + stage * BQ, lse + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
    load_floats<kThreads>(delta_s + stage * BQ, delta + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
  };
  const int first = causal ? k0 / BQ : 0;  // the diagonal's q tile
  const int end = (T + BQ - 1) / BQ;
  load_q(first, 0);
  cp_async_commit();

  // this thread's keys: ka (entries 0, 1), kb (2, 3)
  const int la = warp * 16 + g, lb = la + 8;
  const int ka = k0 + la, kb = k0 + lb;
  float dk_acc[DT][4], dv_acc[DT][4];
  zero_acc<DT>(dk_acc);
  zero_acc<DT>(dv_acc);
  float dsum[2] = {0.f, 0.f};

  int stage = 0;
  for (int qt = first; qt < end; ++qt) {
    if (qt + 1 < end) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Elt* qs = ring + stage * 2 * BQ * LD;
    const Elt* dos = qs + BQ * LD;
    const float* ls = lse_s + stage * BQ;
    const float* ds_ = delta_s + stage * BQ;

    float s[NQ][4], dp[NQ][4];  // S^T and dP^T: rows ka, kb; columns q rows 8 j + 2 t (+1)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    R::template nt<NQ, DT>(s, ks + warp * 16 * LD, qs, LD, D);
    R::template nt<NQ, DT>(dp, vs + warp * 16 * LD, dos, LD, D);
    const bool key_ok[2] = {ka < T && mk[la] > kMaskPad, kb < T && mk[lb] > kMaskPad};
    const float mask_log2[2] = {mk[la] * kLog2e, mk[lb] * kLog2e};
    // every (key, q row) pair of the tile valid: no flag to test
    const bool full = all_keys && (qt + 1) * BQ <= T && (!causal || qt * BQ >= k0 + kRows - 1);
    auto probabilities = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = 8 * j + 2 * t + (e & 1), qrow = qt * BQ + lq, key = e < 2 ? ka : kb;
          const bool valid = all_valid || (key_ok[e >> 1] && qrow < T && (!causal || qrow >= key));
          const float p = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(ls[lq], -kLog2e, mask_log2[e >> 1]))) : 0.f;
          const float ds = p * (dp[j][e] - ds_[lq]);
          s[j][e] = p;
          dp[j][e] = ds;
          dsum[e >> 1] += ds;
        }
    };
    if (full) {
      probabilities(std::true_type{});
    } else {
      probabilities(std::false_type{});
    }
    R::template nn<NQ, DT>(dv_acc, s, dos, LD, D);  // dV += P^T.dO
    R::template nn<NQ, DT>(dk_acc, dp, qs, LD, D);  // dK += dS^T.Q
    __syncthreads();  // the next copy overwrites this stage
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<Elt, DT>(dk_acc, scale, dk + head, k0 + warp * 16, T, D);
  store_rows<Elt, DT>(dv_acc, 1.f, dv + head, k0 + warp * 16, T, D);
  if (dmask_part) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = dsum[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int key = h ? kb : ka;
      if (t == 0 && key < T) dmask_part[static_cast<size_t>(bh) * T + key] = x;
    }
  }
}

// (iii) dQ
template <typename R, int DT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const typename R::Elt* __restrict__ q, const typename R::Elt* __restrict__ k,
                    const typename R::Elt* __restrict__ v, const float* __restrict__ mask,
                    const float* __restrict__ lse, const typename R::Elt* __restrict__ dout,
                    const float* __restrict__ delta, typename R::Elt* __restrict__ dq, int T, int D, int H,
                    int causal, float scale) {
  using Elt = typename R::Elt;
  constexpr int DP = 8 * DT;
  constexpr int LD = row_stride<Elt>(DP);
  constexpr int NK = kBK / 8;  // n8 tiles of keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* qs = reinterpret_cast<Elt*>(smem_raw);  // kRows x LD
  Elt* dos = qs + kRows * LD;
  Elt* ring = dos + kRows * LD;  // two stages of (K tile, V tile), kBK x LD each
  float* lse_s = reinterpret_cast<float*>(ring + 4 * kBK * LD);  // kRows
  float* delta_s = lse_s + kRows;                                 // kRows
  float* mk = delta_s + kRows;                                    // two stages of kBK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  // causal: the last q tile (the longest walk) first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  zero_padding<kThreads>(qs, LD, 2 * kRows + 4 * kBK, D, DP);
  const bool vec = rows_aligned<Elt>(D, q, k, v) && rows_aligned<Elt>(D, dout, dout, dout);
  auto load_k = [&](int tile, int stage) {
    Elt* kt = ring + stage * 2 * kBK * LD;
    load_rows<kThreads, DP>(kt, LD, k + head, tile * kBK, kBK, T, D, vec);
    load_rows<kThreads, DP>(kt + kBK * LD, LD, v + head, tile * kBK, kBK, T, D, vec);
    load_floats<kThreads>(mk + stage * kBK, mrow, tile * kBK, kBK, T);
  };
  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kRows + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  // Q, dO, lse and Dr travel with the first tile
  load_rows<kThreads, DP>(qs, LD, q + head, q0, kRows, T, D, vec);
  load_rows<kThreads, DP>(dos, LD, dout + head, q0, kRows, T, D, vec);
  load_floats<kThreads>(lse_s, lse + static_cast<size_t>(bh) * T, q0, kRows, T);
  load_floats<kThreads>(delta_s, delta + static_cast<size_t>(bh) * T, q0, kRows, T);
  if (tile < end) load_k(tile, 0);
  cp_async_commit();

  const int la = warp * 16 + g, lb = la + 8;
  const int qa = q0 + la, qb = q0 + lb;
  float dq_acc[DT][4];
  zero_acc<DT>(dq_acc);

  int stage = 0;
  while (tile < end) {
    const int next = next_tile(mrow, tile + 1, end, T);
    if (next < end) load_k(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Elt* kt = ring + stage * 2 * kBK * LD;
    const Elt* vt = kt + kBK * LD;
    const float* ms = mk + stage * kBK;
    const int k0 = tile * kBK;

    float s[NK][4], dp[NK][4];  // S and dP: rows qa, qb; columns keys 8 j + 2 t (+1)
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    R::template nt<NK, DT>(s, qs + warp * 16 * LD, kt, LD, D);
    R::template nt<NK, DT>(dp, dos + warp * 16 * LD, vt, LD, D);
    const float lse_log2[2] = {lse_s[la] * kLog2e, lse_s[lb] * kLog2e};
    const bool keys_valid = __all_sync(0xffffffffu, k0 + lane < T && ms[lane] > kMaskPad &&
                                                        k0 + lane + 32 < T && ms[lane + 32] > kMaskPad);
    // every (q row, key) pair of the warp's tile valid: no flag to test
    const bool full = keys_valid && q0 + kRows <= T && (!causal || k0 + kBK - 1 <= q0 + warp * 16);
    auto grads = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lk = 8 * j + 2 * t + (e & 1), key = k0 + lk;
          const int qrow = e < 2 ? qa : qb;
          const float mv = ms[lk];
          const bool valid = all_valid || (key < T && qrow < T && mv > kMaskPad && (!causal || qrow >= key));
          const float p = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(mv, kLog2e, -lse_log2[e >> 1]))) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_s[e < 2 ? la : lb]);
        }
    };
    if (full) {
      grads(std::true_type{});
    } else {
      grads(std::false_type{});
    }
    R::template nn<NK, DT>(dq_acc, dp, kt, LD, D);  // dQ += dS.K
    __syncthreads();
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<Elt, DT>(dq_acc, scale, dq + head, q0 + warp * 16, T, D);
}

template <typename R, int DT>
int launch_grads(const typename R::Elt* q, const typename R::Elt* k, const typename R::Elt* v, const float* mask,
                 const float* lse, const typename R::Elt* dout, const float* delta, typename R::Elt* dq,
                 typename R::Elt* dk, typename R::Elt* dv, float* dmask_part, int bh, int T, int D, int H,
                 int causal, float scale, cudaStream_t stream) {
  using Elt = typename R::Elt;
  constexpr size_t kv_smem = dkdv_smem<Elt, DT>(), q_smem = dq_smem<Elt, DT>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<R, DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<R, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (T + kRows - 1) / kRows);
  flash_bwd_dkdv_kernel<R, DT><<<grid, kThreads, kv_smem, stream>>>(q, k, v, mask, lse, dout, delta, dk, dv,
                                                                     dmask_part, T, D, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<R, DT><<<grid, kThreads, q_smem, stream>>>(q, k, v, mask, lse, dout, delta, dq, T, D, H,
                                                                   causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 heads, D <= 64: warpgroup products (csrc/wgmma_bf16.cuh) ----------
//
// One warpgroup (the block's 4 warps) per block, blocks of one head next to
// each other in the grid, so that the tiles they all read (Q and dO, or K
// and V) are shared in L2 by the blocks in flight; every shared tile is a
// swizzled 64 x 64 bf16 tile. The elementwise code between the products is
// the mma.sync kernels' own: warp w holds rows 16 w .. 16 w + 15 of each
// 64 x 64 accumulator in m16n8 C fragments. The products of a tile run
// while the warps work: S and dP are two commit groups, so P is formed
// while dP is still in the tensor cores, and dV (dK/dV) runs while dS is
// formed. A tile's last products are waited for before the loop's back
// edge: with a product in flight across it, the compiler serialises every
// product of the loop (ptxas warning C7515), which measured slower than
// the wait. The next tile's copy, issued as a tile starts into the stage
// the last tile left, runs under the whole tile.

using Bf16 = __nv_bfloat16;

// six swizzled tiles, and 1024 bytes to align them, before `floats` fp32
constexpr int wgmma_smem(int floats) { return 6 * kSwTileBytes + 1024 + 4 * floats; }

// S or dP (dQ): c = A.B^T over D padded to 64 (the padding's zeros add
// nothing), A and B K-major tiles
__device__ __forceinline__ void products_nt(float (&c)[8][4], const unsigned char* a, const unsigned char* b) {
  const uint64_t da = desc_k_major(a), db = desc_k_major(b);
  wgmma_ss<0, 0>(c, da, db);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_ss<0, 1>(c, da + kStepK * kk, db + kStepK * kk);
}

// S^T or dP^T (dK/dV): the same with A from registers, K or V held for the
// walk, so that the tensor cores read only B from shared memory
__device__ __forceinline__ void products_nt(float (&c)[8][4], const uint32_t (&a)[4][4], const unsigned char* b) {
  const uint64_t db = desc_k_major(b);
  wgmma_rs<0, 0>(c, a[0], db);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_rs<0>(c, a[kk], db + kStepK * kk);
}

// c += A.B over 64 keys (or q rows), A an fp32 accumulator split into bf16
// hi and lo (each k16 step's lo pass first), B an MN-major tile
__device__ __forceinline__ void products_nn(float (&c)[8][4], const uint32_t (&hi)[4][4], const uint32_t (&lo)[4][4],
                                            const unsigned char* b) {
  const uint64_t db = desc_mn_major(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<1>(c, lo[kk], db + kStepMN * kk);
    wgmma_rs<1>(c, hi[kk], db + kStepMN * kk);
  }
}

__device__ __forceinline__ void split_acc(const float (&c)[8][4], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) c_to_a_bf16(c[2 * kk], c[2 * kk + 1], hi[kk], lo[kk]);
}

// (i) on bf16 heads with 16-byte rows: Dr as flash_bwd_delta_kernel, eight
// threads a row, 8 elements (16 bytes) a thread at a time
__global__ void __launch_bounds__(256) flash_bwd_delta_bf16_kernel(const Bf16* __restrict__ out,
                                                                   const Bf16* __restrict__ dout,
                                                                   float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * 32 + (threadIdx.x >> 3), part = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = static_cast<size_t>(row) * D;
    for (int c = 8 * part; c < D; c += 64) {
      const uint4 a = *reinterpret_cast<const uint4*>(out + base + c);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + base + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
        acc = fmaf(y.x, x.x, acc);
        acc = fmaf(y.y, x.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

// (ii) dK, dV and the per-head column sums of dS: one warpgroup per (head,
// 64 keys), K and V as A of S^T = K.Q^T and dP^T = V.dO^T, tiles of 64 q
// rows of Q and dO in a two-stage cp.async ring as their K-major B and as
// the MN-major B of dV += P^T.dO and dK += dS^T.Q
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wgmma_kernel(const Bf16* __restrict__ q, const Bf16* __restrict__ k, const Bf16* __restrict__ v,
                            const float* __restrict__ mask, const float* __restrict__ lse,
                            const Bf16* __restrict__ dout, const float* __restrict__ delta, Bf16* __restrict__ dk,
                            Bf16* __restrict__ dv, float* __restrict__ dmask_part, int T, int D, int H, int causal,
                            float scale) {
  constexpr int BQ = 64;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* ks = align1024(wg_smem);
  unsigned char* vs = ks + kSwTileBytes;
  unsigned char* ring = vs + kSwTileBytes;  // two stages of (Q tile, dO tile)
  float* lse_s = reinterpret_cast<float*>(ring + 4 * kSwTileBytes);  // two stages of BQ
  float* delta_s = lse_s + 2 * BQ;                                    // two stages of BQ
  float* mk = delta_s + 2 * BQ;                                       // kRows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles;
  const int k0 = (blockIdx.x - bh * tiles) * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  // a tile with no valid key: zeros, nothing read
  const bool key_valid = tid < kRows && k0 + tid < T && __ldg(mrow + k0 + tid) > kMaskPad;
  const bool all_keys = __syncthreads_and(key_valid || tid >= kRows);
  if (!__syncthreads_or(key_valid)) {
    const int n = min(kRows, T - k0) * D;
    for (int i = tid; i < n; i += kThreads) {
      dk[head + static_cast<size_t>(k0) * D + i] = narrow<Bf16>(0.f);
      dv[head + static_cast<size_t>(k0) * D + i] = narrow<Bf16>(0.f);
    }
    if (dmask_part && tid < kRows && k0 + tid < T) dmask_part[static_cast<size_t>(bh) * T + k0 + tid] = 0.f;
    return;
  }

  if (D < 64) zero_padding_sw128<kThreads>(ks, 6, D);  // K, V and the ring are contiguous
  const bool vec = rows_aligned<Bf16>(D, q, k, v) && rows_aligned<Bf16>(D, dout, dout, dout);
  const TileCopy copy(D);
  auto load_tile = [&](unsigned char* tile, const Bf16* src, int row0) {
    if (vec) {
      copy(tile, src, row0, T, D);
    } else {
      load_rows_sw128<kThreads>(tile, src, row0, T, D);
    }
  };
  load_tile(ks, k + head, k0);
  load_tile(vs, v + head, k0);
  load_floats<kThreads>(mk, mrow, k0, kRows, T);
  cp_async_commit();
  auto load_q = [&](int qt, int stage) {
    unsigned char* qs = ring + stage * 2 * kSwTileBytes;
    load_tile(qs, q + head, qt * BQ);
    load_tile(qs + kSwTileBytes, dout + head, qt * BQ);
    load_floats<kThreads>(lse_s + stage * BQ, lse + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
    load_floats<kThreads>(delta_s + stage * BQ, delta + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
  };
  const int first = causal ? k0 / BQ : 0;  // the diagonal's q tile
  const int end = (T + BQ - 1) / BQ;
  load_q(first, 0);
  cp_async_commit();
  // K and V as A operands, held in registers for the walk
  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka_frag[4][4], va_frag[4][4];
  ldmatrix_a_sw128(ka_frag, ks);
  ldmatrix_a_sw128(va_frag, vs);

  // this thread's keys: ka (entries 0, 1), kb (2, 3)
  const int la = warp * 16 + g, lb = la + 8;
  const int ka = k0 + la, kb = k0 + lb;
  float dk_acc[8][4], dv_acc[8][4];
  zero_acc<8>(dk_acc);
  zero_acc<8>(dv_acc);
  float dsum[2] = {0.f, 0.f};

  int stage = 0;
  for (int qt = first; qt < end; ++qt) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // the tile is in for every thread, and every warp is past the last tile
    if (qt + 1 < end) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    const unsigned char* qs = ring + stage * 2 * kSwTileBytes;
    const unsigned char* dos = qs + kSwTileBytes;
    const float* ls = lse_s + stage * BQ;
    const float* ds_ = delta_s + stage * BQ;

    // S^T and dP^T (only the tensor cores write them), then P^T and dS^T:
    // rows ka, kb; columns q rows 8 j + 2 t (+1)
    float s[8][4], dp[8][4], p[8][4];
    wgmma_fence();
    products_nt(s, ka_frag, qs);
    wgmma_commit();
    products_nt(dp, va_frag, dos);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    reg_fence(s);
    const bool key_ok[2] = {ka < T && mk[la] > kMaskPad, kb < T && mk[lb] > kMaskPad};
    const float mask_log2[2] = {mk[la] * kLog2e, mk[lb] * kLog2e};
    // every (key, q row) pair of the tile valid: no flag to test
    const bool full = all_keys && (qt + 1) * BQ <= T && (!causal || qt * BQ >= k0 + kRows - 1);
    auto probabilities = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = 8 * j + 2 * t + (e & 1), qrow = qt * BQ + lq, key = e < 2 ? ka : kb;
          const bool valid = all_valid || (key_ok[e >> 1] && qrow < T && (!causal || qrow >= key));
          const float l = e & 1 ? l2.y : l2.x;
          p[j][e] = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(l, -kLog2e, mask_log2[e >> 1]))) : 0.f;
        }
      }
    };
    if (full) {
      probabilities(std::true_type{});
    } else {
      probabilities(std::false_type{});
    }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];  // the A operands of dV and dK
    split_acc(p, ph, pl);
    wgmma_fence();
    products_nn(dv_acc, ph, pl, dos);  // dV += P^T.dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(ds_ + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] *= dp[j][e] - (e & 1 ? d2.y : d2.x);  // dS^T
        dsum[e >> 1] += p[j][e];
      }
    }
    split_acc(p, dh, dl);
    wgmma_fence();
    products_nn(dk_acc, dh, dl, qs);  // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();  // dV and dK: nothing in flight across the back edge
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(ph);
    reg_fence(pl);
    reg_fence(dh);
    reg_fence(dl);
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<Bf16, 8>(dk_acc, scale, dk + head, k0 + warp * 16, T, D);
  store_rows<Bf16, 8>(dv_acc, 1.f, dv + head, k0 + warp * 16, T, D);
  if (dmask_part) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = dsum[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int key = h ? kb : ka;
      if (t == 0 && key < T) dmask_part[static_cast<size_t>(bh) * T + key] = x;
    }
  }
}

// (iii) dQ: one warpgroup per (head, 64 q rows), Q and dO as A of
// S = Q.K^T and dP = dO.V^T, tiles of 64 keys of K and V in a two-stage
// cp.async ring as their K-major B and (K) the MN-major B of dQ += dS.K
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wgmma_kernel(const Bf16* __restrict__ q, const Bf16* __restrict__ k, const Bf16* __restrict__ v,
                          const float* __restrict__ mask, const float* __restrict__ lse,
                          const Bf16* __restrict__ dout, const float* __restrict__ delta, Bf16* __restrict__ dq,
                          int T, int D, int H, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* qs = align1024(wg_smem);
  unsigned char* dos = qs + kSwTileBytes;
  unsigned char* ring = dos + kSwTileBytes;  // two stages of (K tile, V tile)
  float* lse_s = reinterpret_cast<float*>(ring + 4 * kSwTileBytes);  // kRows
  float* delta_s = lse_s + kRows;                                     // kRows
  float* mk = delta_s + kRows;                                        // two stages of kBK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles;
  const int yt = blockIdx.x - bh * tiles;
  // causal: each head's last q tile (the longest walk) first
  const int q0 = (causal ? tiles - 1 - yt : yt) * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  if (D < 64) zero_padding_sw128<kThreads>(qs, 6, D);
  const bool vec = rows_aligned<Bf16>(D, q, k, v) && rows_aligned<Bf16>(D, dout, dout, dout);
  const TileCopy copy(D);
  auto load_tile = [&](unsigned char* tile, const Bf16* src, int row0) {
    if (vec) {
      copy(tile, src, row0, T, D);
    } else {
      load_rows_sw128<kThreads>(tile, src, row0, T, D);
    }
  };
  auto load_k = [&](int tile, int stage) {
    unsigned char* kt = ring + stage * 2 * kSwTileBytes;
    load_tile(kt, k + head, tile * kBK);
    load_tile(kt + kSwTileBytes, v + head, tile * kBK);
    load_floats<kThreads>(mk + stage * kBK, mrow, tile * kBK, kBK, T);
  };
  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kRows + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  // Q, dO, lse and Dr travel with the first tile
  load_tile(qs, q + head, q0);
  load_tile(dos, dout + head, q0);
  load_floats<kThreads>(lse_s, lse + static_cast<size_t>(bh) * T, q0, kRows, T);
  load_floats<kThreads>(delta_s, delta + static_cast<size_t>(bh) * T, q0, kRows, T);
  if (tile < end) load_k(tile, 0);
  cp_async_commit();

  const int la = warp * 16 + g, lb = la + 8;
  const int qa = q0 + la, qb = q0 + lb;
  float dq_acc[8][4];
  zero_acc<8>(dq_acc);

  int stage = 0;
  while (tile < end) {
    const int next = next_tile(mrow, tile + 1, end, T);
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // the tile is in for every thread, and every warp is past the last tile
    if (next < end) load_k(next, stage ^ 1);
    cp_async_commit();
    const unsigned char* kt = ring + stage * 2 * kSwTileBytes;
    const unsigned char* vt = kt + kSwTileBytes;
    const float* ms = mk + stage * kBK;
    const int k0 = tile * kBK;

    // S and dP (only the tensor cores write them), then P and dS: rows qa,
    // qb; columns keys 8 j + 2 t (+1)
    float s[8][4], dp[8][4], p[8][4];
    wgmma_fence();
    products_nt(s, qs, kt);
    wgmma_commit();
    products_nt(dp, dos, vt);
    wgmma_commit();
    wgmma_wait<1>();  // S
    reg_fence(s);
    const float lse_log2[2] = {lse_s[la] * kLog2e, lse_s[lb] * kLog2e};
    const bool keys_valid = __all_sync(0xffffffffu, k0 + lane < T && ms[lane] > kMaskPad &&
                                                        k0 + lane + 32 < T && ms[lane + 32] > kMaskPad);
    // every (q row, key) pair of the warp's 16 rows valid: no flag to test
    const bool full = keys_valid && q0 + kRows <= T && (!causal || k0 + kBK - 1 <= q0 + warp * 16);
    auto probabilities = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qrow = e < 2 ? qa : qb;
          const float mv = e & 1 ? m2.y : m2.x;
          const bool valid = all_valid || (key < T && qrow < T && mv > kMaskPad && (!causal || qrow >= key));
          p[j][e] = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(mv, kLog2e, -lse_log2[e >> 1]))) : 0.f;
        }
      }
    };
    if (full) {
      probabilities(std::true_type{});
    } else {
      probabilities(std::false_type{});
    }
    wgmma_wait<0>();  // dP
    reg_fence(dp);
    const float dr[2] = {delta_s[la], delta_s[lb]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dr[e >> 1];  // dS
    uint32_t dh[4][4], dl[4][4];  // dQ's A operand
    split_acc(p, dh, dl);
    wgmma_fence();
    products_nn(dq_acc, dh, dl, kt);  // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();  // nothing in flight across the back edge
    reg_fence(dq_acc);
    reg_fence(dh);
    reg_fence(dl);
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<Bf16, 8>(dq_acc, scale, dq + head, q0 + warp * 16, T, D);
}

int launch_wgmma(const Bf16* q, const Bf16* k, const Bf16* v, const float* mask, const float* lse, const Bf16* dout,
                 const float* delta, Bf16* dq, Bf16* dk, Bf16* dv, float* dmask_part, int bh, int T, int D, int H,
                 int causal, float scale, cudaStream_t stream) {
  constexpr int kv_smem = wgmma_smem(5 * kRows), q_smem = wgmma_smem(4 * kRows);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = bh * ((T + kRows - 1) / kRows);  // (head, tile), a head's tiles together
  flash_bwd_dkdv_wgmma_kernel<<<blocks, kThreads, kv_smem, stream>>>(q, k, v, mask, lse, dout, delta, dk, dv,
                                                                      dmask_part, T, D, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<<<blocks, kThreads, q_smem, stream>>>(q, k, v, mask, lse, dout, delta, dq, T, D, H,
                                                                    causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 heads, D <= 64: 3xTF32 warpgroup products (csrc/wgmma_tf32.cuh) ----
//
// The bf16 kernels' walk, blocks and elementwise code, on fp32 tiles of 16
// KB with every product in three TF32 passes (lo.hi, hi.lo, then hi.hi).
// A TF32 wgmma reads both shared-memory operands K-major, so each walked
// tile, as it arrives, is split once by the warps (derive_tf32) into its lo
// part and, where a product's depth is the walk, into its transpose's hi
// and lo parts, in the permuted order that lets P's and dS's accumulator
// registers be the register A operand as they stand. The split takes about
// a fifth of each kernel's time (PERF.md); issuing S's and dP's first
// passes before it, to run while the warps split, measured no faster. Every
// product is one chain of 24 passes into one accumulator, the small passes
// first: S and dP whole (their drift stays within a few ulp: the
// self-test's chain readings, PERF.md), dV, dK and dQ as a fresh partial a
// tile, added to the running sums in fp32 with rounding to nearest, so that
// no accumulator takes a walk's 384 passes. One block an SM: 224 KB (dK/dV)
// and 194 KB (dQ) of shared memory.

// fp32 heads, D <= 64: fp32 tiles a block, and the bytes of `floats` fp32 and
// of the 1024-byte alignment beside them
constexpr int tf32_smem(int tiles, int floats) { return tiles * kSwTileF32Bytes + 1024 + 4 * floats; }

// one tile of a (T, D) fp32 head into a swizzled tile: by cp.async where
// every row is 16-byte aligned, else element by element
struct LoadTileF32 {
  TileCopyF32 copy;
  bool vec;
  __device__ __forceinline__ void operator()(unsigned char* tile, const float* head, int row0, int T, int D) const {
    if (vec) {
      copy(tile, head, row0, T, D);
    } else {
      load_rows_f32<kThreads>(tile, head, row0, T, D);
    }
  }
};

// (ii) dK, dV and the per-head column sums of dS, on fp32 heads: one
// warpgroup per (head, 64 keys). K and V (and their lo parts) are the A of
// S^T = K.Q^T and dP^T = V.dO^T; tiles of 64 q rows of Q and dO arrive in a
// two-stage cp.async ring and are split into Q lo and dO lo (the B lo of
// S^T and dP^T) and Q^T and dO^T, hi and lo (the B of dK += dS^T.Q and
// dV += P^T.dO). Registers: dK, dV, dP^T, the partial, P^T and its lo part
// (32 each) while dV's products run; dS^T is formed in P^T's registers once
// they are done (236 registers, no spill; forming it while they run, in a
// seventh array, spilled 32 bytes at the 255-register limit and was no
// faster)
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tf32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ mask,
                                 const float* __restrict__ lse, const float* __restrict__ dout,
                                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                                 float* __restrict__ dmask_part, int T, int D, int H, int causal, float scale) {
  constexpr int BQ = 64, F = kSwTileF32Bytes;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  // the tiles as they arrive (K, V, two stages of (Q, dO)), contiguous for
  // zero_padding_f32; then K's and V's lo parts and the walked tile's parts
  unsigned char* ks = align1024(wg_smem);
  unsigned char* vs = ks + F;
  unsigned char* ring = vs + F;
  unsigned char* klo = ring + 4 * F;
  unsigned char* vlo = klo + F;
  unsigned char* qlo = vlo + F;
  unsigned char* dolo = qlo + F;
  unsigned char* qth = dolo + F;  // Q^T hi, lo
  unsigned char* qtl = qth + F;
  unsigned char* doth = qtl + F;  // dO^T hi, lo
  unsigned char* dotl = doth + F;
  float* lse_s = reinterpret_cast<float*>(dotl + F);  // two stages of BQ
  float* delta_s = lse_s + 2 * BQ;                   // two stages of BQ
  float* mk = delta_s + 2 * BQ;                      // kRows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles;
  const int k0 = (blockIdx.x - bh * tiles) * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  // a tile with no valid key: zeros, nothing read
  const bool key_valid = tid < kRows && k0 + tid < T && __ldg(mrow + k0 + tid) > kMaskPad;
  const bool all_keys = __syncthreads_and(key_valid || tid >= kRows);
  if (!__syncthreads_or(key_valid)) {
    const int n = min(kRows, T - k0) * D;
    for (int i = tid; i < n; i += kThreads) {
      dk[head + static_cast<size_t>(k0) * D + i] = 0.f;
      dv[head + static_cast<size_t>(k0) * D + i] = 0.f;
    }
    if (dmask_part && tid < kRows && k0 + tid < T) dmask_part[static_cast<size_t>(bh) * T + k0 + tid] = 0.f;
    return;
  }

  if (D < 64) zero_padding_f32<kThreads>(ks, 6, D);
  const LoadTileF32 load_tile{TileCopyF32(D), rows_aligned<float>(D, q, k, v) && rows_aligned<float>(D, dout, dout, dout)};
  load_tile(ks, k + head, k0, T, D);
  load_tile(vs, v + head, k0, T, D);
  load_floats<kThreads>(mk, mrow, k0, kRows, T);
  cp_async_commit();
  auto load_q = [&](int qt, int stage) {
    unsigned char* qs = ring + stage * 2 * F;
    load_tile(qs, q + head, qt * BQ, T, D);
    load_tile(qs + F, dout + head, qt * BQ, T, D);
    load_floats<kThreads>(lse_s + stage * BQ, lse + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
    load_floats<kThreads>(delta_s + stage * BQ, delta + static_cast<size_t>(bh) * T, qt * BQ, BQ, T);
  };
  const int first = causal ? k0 / BQ : 0;  // the diagonal's q tile
  const int end = (T + BQ - 1) / BQ;
  load_q(first, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  derive_tf32<false>(ks, klo, nullptr, nullptr);
  derive_tf32<false>(vs, vlo, nullptr, nullptr);

  // this thread's keys: ka (entries 0, 1), kb (2, 3)
  const int la = warp * 16 + g, lb = la + 8;
  const int ka = k0 + la, kb = k0 + lb;
  float dk_acc[8][4], dv_acc[8][4];
  zero_acc<8>(dk_acc);
  zero_acc<8>(dv_acc);
  float dsum[2] = {0.f, 0.f};

  int stage = 0;
  for (int qt = first; qt < end; ++qt) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // the tile (and K's and V's lo parts) in for every thread, every warp past the last tile
    if (qt + 1 < end) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    const unsigned char* qs = ring + stage * 2 * F;
    const unsigned char* dos = qs + F;
    const float* ls = lse_s + stage * BQ;
    const float* ds_ = delta_s + stage * BQ;

    derive_tf32<true>(qs, qlo, qth, qtl);
    derive_tf32<true>(dos, dolo, doth, dotl);
    fence_async_shared();
    __syncthreads();
    // S^T and dP^T (only the tensor cores write them)
    float s[8][4], dp[8][4], p[8][4];
    wgmma_fence();
    products_nt_tf32<8>(s, ks, klo, qs, qlo);
    wgmma_commit();
    products_nt_tf32<8>(dp, vs, vlo, dos, dolo);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    reg_fence(s);
    const bool key_ok[2] = {ka < T && mk[la] > kMaskPad, kb < T && mk[lb] > kMaskPad};
    const float mask_log2[2] = {mk[la] * kLog2e, mk[lb] * kLog2e};
    // every (key, q row) pair of the tile valid: no flag to test
    const bool full = all_keys && (qt + 1) * BQ <= T && (!causal || qt * BQ >= k0 + kRows - 1);
    auto probabilities = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = 8 * j + 2 * t + (e & 1), qrow = qt * BQ + lq, key = e < 2 ? ka : kb;
          const bool valid = all_valid || (key_ok[e >> 1] && qrow < T && (!causal || qrow >= key));
          const float l = e & 1 ? l2.y : l2.x;
          p[j][e] = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(l, -kLog2e, mask_log2[e >> 1]))) : 0.f;
        }
      }
    };
    if (full) {
      probabilities(std::true_type{});
    } else {
      probabilities(std::false_type{});
    }
    float part[8][4];             // a tile's dV, then its dK
    uint32_t ah[8][4], al[8][4];  // P^T's parts, then dS^T's: the A of dV, then of dK
    split_acc_tf32(p, ah, al);
    wgmma_fence();
    products_nn_tf32(part, ah, al, doth, dotl);  // P^T.dO
    wgmma_commit();
    wgmma_wait<0>();  // dP^T and dV
    reg_fence(dp);
    reg_fence(part);
    reg_fence(ah);
    reg_fence(al);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[j][e] += part[j][e];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(ds_ + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] *= dp[j][e] - (e & 1 ? d2.y : d2.x);  // dS^T
        dsum[e >> 1] += p[j][e];
      }
    }
    split_acc_tf32(p, ah, al);
    wgmma_fence();
    products_nn_tf32(part, ah, al, qth, qtl);  // dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();  // nothing in flight across the back edge
    reg_fence(part);
    reg_fence(ah);
    reg_fence(al);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] += part[j][e];
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<float, 8>(dk_acc, scale, dk + head, k0 + warp * 16, T, D);
  store_rows<float, 8>(dv_acc, 1.f, dv + head, k0 + warp * 16, T, D);
  if (dmask_part) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = dsum[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int key = h ? kb : ka;
      if (t == 0 && key < T) dmask_part[static_cast<size_t>(bh) * T + key] = x;
    }
  }
}

// (iii) dQ on fp32 heads: one warpgroup per (head, 64 q rows). Q and dO
// (and their lo parts) are the A of S = Q.K^T and dP = dO.V^T; tiles of 64
// keys of K and V arrive in a two-stage cp.async ring and are split into K
// lo and V lo (the B lo of S and dP) and K^T, hi and lo (the B of
// dQ += dS.K)
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                               const float* __restrict__ mask, const float* __restrict__ lse,
                               const float* __restrict__ dout, const float* __restrict__ delta,
                               float* __restrict__ dq, int T, int D, int H, int causal, float scale) {
  constexpr int F = kSwTileF32Bytes;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  // the tiles as they arrive (Q, dO, two stages of (K, V)), contiguous for
  // zero_padding_f32; then Q's and dO's lo parts and the walked tile's parts
  unsigned char* qs = align1024(wg_smem);
  unsigned char* dos = qs + F;
  unsigned char* ring = dos + F;
  unsigned char* qlo = ring + 4 * F;
  unsigned char* dolo = qlo + F;
  unsigned char* klo = dolo + F;
  unsigned char* vlo = klo + F;
  unsigned char* kth = vlo + F;  // K^T hi, lo
  unsigned char* ktl = kth + F;
  float* lse_s = reinterpret_cast<float*>(ktl + F);  // kRows
  float* delta_s = lse_s + kRows;                    // kRows
  float* mk = delta_s + kRows;                       // two stages of kBK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles;
  const int yt = blockIdx.x - bh * tiles;
  // causal: each head's last q tile (the longest walk) first
  const int q0 = (causal ? tiles - 1 - yt : yt) * kRows;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  const float scale_log2 = scale * kLog2e;

  if (D < 64) zero_padding_f32<kThreads>(qs, 6, D);
  const LoadTileF32 load_tile{TileCopyF32(D), rows_aligned<float>(D, q, k, v) && rows_aligned<float>(D, dout, dout, dout)};
  auto load_k = [&](int tile, int stage) {
    unsigned char* kt = ring + stage * 2 * F;
    load_tile(kt, k + head, tile * kBK, T, D);
    load_tile(kt + F, v + head, tile * kBK, T, D);
    load_floats<kThreads>(mk + stage * kBK, mrow, tile * kBK, kBK, T);
  };
  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kRows + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  load_tile(qs, q + head, q0, T, D);
  load_tile(dos, dout + head, q0, T, D);
  load_floats<kThreads>(lse_s, lse + static_cast<size_t>(bh) * T, q0, kRows, T);
  load_floats<kThreads>(delta_s, delta + static_cast<size_t>(bh) * T, q0, kRows, T);
  cp_async_commit();
  if (tile < end) load_k(tile, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  derive_tf32<false>(qs, qlo, nullptr, nullptr);
  derive_tf32<false>(dos, dolo, nullptr, nullptr);

  const int la = warp * 16 + g, lb = la + 8;
  const int qa = q0 + la, qb = q0 + lb;
  float dq_acc[8][4];
  zero_acc<8>(dq_acc);

  int stage = 0;
  while (tile < end) {
    const int next = next_tile(mrow, tile + 1, end, T);
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // the tile (and Q's and dO's lo parts) in for every thread, every warp past the last tile
    if (next < end) load_k(next, stage ^ 1);
    cp_async_commit();
    const unsigned char* kt = ring + stage * 2 * F;
    const unsigned char* vt = kt + F;
    const float* ms = mk + stage * kBK;
    const int k0 = tile * kBK;

    derive_tf32<true>(kt, klo, kth, ktl);
    derive_tf32<false>(vt, vlo, nullptr, nullptr);
    fence_async_shared();
    __syncthreads();
    // S and dP (only the tensor cores write them)
    float s[8][4], dp[8][4], p[8][4];
    wgmma_fence();
    products_nt_tf32<8>(s, qs, qlo, kt, klo);
    wgmma_commit();
    products_nt_tf32<8>(dp, dos, dolo, vt, vlo);
    wgmma_commit();
    wgmma_wait<1>();  // S
    reg_fence(s);
    const float lse_log2[2] = {lse_s[la] * kLog2e, lse_s[lb] * kLog2e};
    const bool keys_valid = __all_sync(0xffffffffu, k0 + lane < T && ms[lane] > kMaskPad &&
                                                        k0 + lane + 32 < T && ms[lane + 32] > kMaskPad);
    // every (q row, key) pair of the warp's 16 rows valid: no flag to test
    const bool full = keys_valid && q0 + kRows <= T && (!causal || k0 + kBK - 1 <= q0 + warp * 16);
    auto probabilities = [&](auto all_valid_tag) {
      constexpr bool all_valid = decltype(all_valid_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qrow = e < 2 ? qa : qb;
          const float mv = e & 1 ? m2.y : m2.x;
          const bool valid = all_valid || (key < T && qrow < T && mv > kMaskPad && (!causal || qrow >= key));
          p[j][e] = valid ? ex2(fmaf(s[j][e], scale_log2, fmaf(mv, kLog2e, -lse_log2[e >> 1]))) : 0.f;
        }
      }
    };
    if (full) {
      probabilities(std::true_type{});
    } else {
      probabilities(std::false_type{});
    }
    wgmma_wait<0>();  // dP
    reg_fence(dp);
    const float dr[2] = {delta_s[la], delta_s[lb]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dr[e >> 1];  // dS
    float part[8][4];
    uint32_t ah[8][4], al[8][4];  // dQ's A operand
    split_acc_tf32(p, ah, al);
    wgmma_fence();
    products_nn_tf32(part, ah, al, kth, ktl);  // dS.K
    wgmma_commit();
    wgmma_wait<0>();  // nothing in flight across the back edge
    reg_fence(part);
    reg_fence(ah);
    reg_fence(al);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[j][e] += part[j][e];
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<float, 8>(dq_acc, scale, dq + head, q0 + warp * 16, T, D);
}

int launch_wgmma_tf32(const float* q, const float* k, const float* v, const float* mask, const float* lse,
                      const float* dout, const float* delta, float* dq, float* dk, float* dv, float* dmask_part,
                      int bh, int T, int D, int H, int causal, float scale, cudaStream_t stream) {
  constexpr int kv_smem = tf32_smem(14, 5 * kRows), q_smem = tf32_smem(12, 4 * kRows);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = bh * ((T + kRows - 1) / kRows);  // (head, tile), a head's tiles together
  flash_bwd_dkdv_tf32_wgmma_kernel<<<blocks, kThreads, kv_smem, stream>>>(q, k, v, mask, lse, dout, delta, dk, dv,
                                                                           dmask_part, T, D, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tf32_wgmma_kernel<<<blocks, kThreads, q_smem, stream>>>(q, k, v, mask, lse, dout, delta, dq, T, D, H,
                                                                         causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The TF32 products on one warpgroup, c = A.B (64 x 64, fp32, row-major)
// for A (64 x k) and B (k x 64) fp32, row-major:
//   mode 0: one pass a k8 step, A and B from shared memory as given (the
//           tensor cores' own TF32 of each value);
//   mode 1: the same with A from registers (its bits, the m16n8k8 layout);
//   mode 2 (k = 64): the kernels' products_nn_tf32: A read as fp32
//           accumulator fragments and split in registers, B copied as a
//           walked tile is (TileCopyF32) and split and transposed by
//           derive_tf32 into the permuted order;
//   mode 3 (k = 8, 32, 64 or 128): the kernels' products_nt_tf32, 3xTF32
//           in one accumulator, a chain of 3 k / 8 passes, the lo parts by
//           derive_tf32.
// It holds the layouts, descriptors and fragment orders that the fp32
// kernels above rely on, and what the tensor cores do with an fp32 value.
__global__ void __launch_bounds__(kThreads)
flash_bwd_wgmma_tf32_selftest_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                                     int k, int mode) {
  constexpr int F2 = 2 * kSwTileF32Bytes;  // a 64 x 128 tile
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* ah = align1024(wg_smem);
  unsigned char* al = ah + F2;
  unsigned char* bh = al + F2;
  unsigned char* bl = bh + F2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (mode == 2) {
    TileCopyF32(64)(al, b, 0, 64, 64);  // B as a walked tile arrives: rows k
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    derive_tf32<true>(al, ah, bh, bl);
  } else {
    // A as it stands and B transposed (rows n), zero past k
    for (int idx = tid; idx < 64 * 128; idx += kThreads) {
      const int r = idx >> 7, col = idx & 127;
      *reinterpret_cast<float*>(ah + sw128_f32_offset(r, col)) = col < k ? a[r * k + col] : 0.f;
      *reinterpret_cast<float*>(bh + sw128_f32_offset(r, col)) = col < k ? b[col * 64 + r] : 0.f;
    }
    __syncthreads();
    if (mode == 3) {
      for (int half = 0; half < 2; ++half) {
        derive_tf32<false>(ah + half * kSwTileF32Bytes, al + half * kSwTileF32Bytes, nullptr, nullptr);
        derive_tf32<false>(bh + half * kSwTileF32Bytes, bl + half * kSwTileF32Bytes, nullptr, nullptr);
      }
    }
  }
  fence_async_shared();
  __syncthreads();
  const int ra = 16 * warp + g;  // this thread's rows ra, ra + 8
  float acc[8][4];
  uint32_t hi[8][4], lo[8][4];
  zero_acc<8>(acc);
  wgmma_fence();
  if (mode == 0 || mode == 1) {
    const uint64_t da = desc_k_major(ah), db = desc_k_major(bh);
    for (int kk = 0; kk < k / 8; ++kk) {
      const uint32_t af[4] = {
          __float_as_uint(a[ra * k + 8 * kk + t]), __float_as_uint(a[(ra + 8) * k + 8 * kk + t]),
          __float_as_uint(a[ra * k + 8 * kk + t + 4]), __float_as_uint(a[(ra + 8) * k + 8 * kk + t + 4])};
      if (mode == 0) {
        wgmma_tf32_ss<1>(acc, step_tf32(da, kk), step_tf32(db, kk));
      } else {
        wgmma_tf32_rs<1>(acc, af, step_tf32(db, kk));
      }
    }
  } else if (mode == 2) {
    float af[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) af[j][e] = a[(ra + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)];
    split_acc_tf32(af, hi, lo);
    wgmma_fence();
    products_nn_tf32(acc, hi, lo, bh, bl);
  } else if (k == 8) {
    products_nt_tf32<1>(acc, ah, al, bh, bl);
  } else if (k == 32) {
    products_nt_tf32<4>(acc, ah, al, bh, bl);
  } else if (k == 64) {
    products_nt_tf32<8>(acc, ah, al, bh, bl);
  } else {
    products_nt_tf32<16>(acc, ah, al, bh, bl);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(hi);
  reg_fence(lo);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(ra + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = acc[j][e];
}

// One 64 x 64 x 64 product on one warpgroup, c = A.B in fp32 (row-major):
// A (row-major) from a swizzled tile (rs = 0) or from registers (rs = 1);
// B ([k][n], row-major) as a K-major tile whose rows are B's columns
// (trans_b = 0) or as it stands, MN-major (trans_b = 1). It holds the
// descriptors and fragment layouts that the kernels above rely on.
__global__ void __launch_bounds__(kThreads)
flash_bwd_wgmma_selftest_kernel(const Bf16* __restrict__ a, const Bf16* __restrict__ b, float* __restrict__ c,
                                int rs, int trans_b) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* as = align1024(wg_smem);
  unsigned char* bs = as + kSwTileBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TileCopy copy(64);
  copy(as, a, 0, 64, 64);
  if (trans_b) {
    copy(bs, b, 0, 64, 64);
  } else {
    for (int idx = tid; idx < 64 * 64; idx += kThreads)
      *reinterpret_cast<Bf16*>(bs + sw128_offset(idx >> 6, idx & 63)) = b[(idx & 63) * 64 + (idx >> 6)];
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  uint32_t af[4][4];
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      af[kk][e] = a32[((16 * warp + g + 8 * (e & 1)) * 64 + 16 * kk + 2 * t + 8 * (e >> 1)) / 2];
  float acc[8][4];
  zero_acc<8>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_k_major(as) + kStepK * kk;
    const uint64_t db = trans_b ? desc_mn_major(bs) + kStepMN * kk : desc_k_major(bs) + kStepK * kk;
    if (rs && trans_b) wgmma_rs<1>(acc, af[kk], db);
    if (rs && !trans_b) wgmma_rs<0>(acc, af[kk], db);
    if (!rs && trans_b) wgmma_ss<1, 1>(acc, da, db);
    if (!rs && !trans_b) wgmma_ss<0, 1>(acc, da, db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(af);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = acc[j][e];
}

template <typename R>
int dispatch(const void* q, const void* k, const void* v, const float* mask, const void* out, const float* lse,
             const void* dout, void* dq, void* dk, void* dv, float* delta, float* dmask_part, int bh, int T, int D,
             int H, int causal, float scale, void* stream) {
  using Elt = typename R::Elt;
  if (bh <= 0 || T <= 0) return 0;
  if (D < 1 || D > kMaxD || H < 1 || bh % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * T;
  if (std::is_same_v<R, Bf16Route> && D % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) & 15) == 0) {
    flash_bwd_delta_bf16_kernel<<<(rows + 31) / 32, 256, 0, s>>>(static_cast<const Bf16*>(out),
                                                                 static_cast<const Bf16*>(dout), delta, rows, D);
  } else {
    flash_bwd_delta_kernel<Elt><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const Elt*>(out),
                                                               static_cast<const Elt*>(dout), delta, rows, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto args = [&](auto launcher) {
    return launcher(static_cast<const Elt*>(q), static_cast<const Elt*>(k), static_cast<const Elt*>(v), mask, lse,
                    static_cast<const Elt*>(dout), delta, static_cast<Elt*>(dq), static_cast<Elt*>(dk),
                    static_cast<Elt*>(dv), dmask_part, bh, T, D, H, causal, scale, s);
  };
  if constexpr (std::is_same_v<R, Bf16Route>) {
    if (D <= 64) return args(launch_wgmma);
  } else {
    if (D <= 64) return args(launch_wgmma_tf32);
  }
  return args(launch_grads<R, 16>);
}

}  // namespace

// C entries, loaded with ctypes. q, k, v, out, dout, dq, dk, dv: (bh, T, D)
// contiguous, fp32 or bf16 by the entry's name; mask: (bh / H, T) fp32;
// lse: (bh, T) fp32 from the forward; delta: (bh, T) fp32 scratch;
// dmask_part: (bh, T) fp32, each key's sum of dS over q rows per head, or
// null where the mask needs no gradient. Each launches its three kernels on
// `stream`, does not synchronise, and returns cudaGetLastError() so a
// refused launch is reported at once.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const float* mask,
                                       const void* out, const float* lse, const void* dout, void* dq, void* dk,
                                       void* dv, float* delta, float* dmask_part, int bh, int T, int D, int H,
                                       int causal, float scale, void* stream) {
  return dispatch<F32Route>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, dmask_part, bh, T, D, H, causal,
                            scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                                        const void* out, const float* lse, const void* dout, void* dq, void* dk,
                                        void* dv, float* delta, float* dmask_part, int bh, int T, int D, int H,
                                        int causal, float scale, void* stream) {
  return dispatch<Bf16Route>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, dmask_part, bh, T, D, H, causal,
                             scale, stream);
}

// The warpgroup product's self-test (flash_bwd_wgmma_selftest_kernel): a, b
// (64, 64) bf16 and c (64, 64) fp32, contiguous on the card; rs and trans_b
// as the kernel's. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_bwd_wgmma_selftest(const void* a, const void* b, void* c, int rs, int trans_b, void* stream) {
  flash_bwd_wgmma_selftest_kernel<<<1, kThreads, 2 * kSwTileBytes + 1024, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bf16*>(a), static_cast<const Bf16*>(b), static_cast<float*>(c), rs, trans_b);
  return static_cast<int>(cudaGetLastError());
}

// The TF32 products' self-test (flash_bwd_wgmma_tf32_selftest_kernel): a
// (64, k) and b (k, 64) fp32, c (64, 64) fp32, contiguous on the card; k
// and mode as the kernel's. Returns cudaGetLastError() after the launch on
// `stream`, or the error of setting its shared memory.
extern "C" int flash_bwd_wgmma_tf32_selftest(const void* a, const void* b, void* c, int k, int mode, void* stream) {
  constexpr int smem = 8 * kSwTileF32Bytes + 1024;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma_tf32_selftest_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wgmma_tf32_selftest_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), k, mode);
  return static_cast<int>(cudaGetLastError());
}
