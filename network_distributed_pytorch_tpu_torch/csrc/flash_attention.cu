// Flash attention forward for Hopper: exact softmax attention over folded
// (BH, T, D) heads of fp32 or bf16 with an additive (B, T) fp32 key mask,
// never building the (T, T) score matrix in device memory. Writes out
// (BH, T, D) in the heads' dtype and the per-row log-sum-exp lse (BH, T) in
// fp32.
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
// With bf16 heads every value is widened to fp32 as it leaves shared memory
// (the Pallas kernel's astype(float32) of each tile), everything above runs
// in fp32, and out is rounded to bf16 once, at the end, as the Pallas
// kernel's o_ref store does.
//
// Design:
//   * one block of 8 warps per (head, tile of 128 q rows); each warp owns 16
//     q rows. Q sits in shared memory (scaled as its fragments are read);
//     tiles of 64 keys of K, V and the mask arrive by cp.async into a
//     double-buffered ring, the next tile's copy in flight while the current
//     one is used, so no thread ever waits on a load of its own;
//   * key tiles in which no key is valid are skipped: before a tile is
//     fetched, each warp reads its 64 mask values and votes (__any_sync),
//     and a tile with no valid key is neither loaded nor multiplied. This is
//     exact: such a tile leaves m' = m, c = 1, l += 0 and acc *= 1, so out
//     and lse are bitwise what walking it would give. A tile with one real
//     key anywhere is walked. In causal mode the walk ends at the diagonal;
//   * both products run on the tensor cores with mma.sync m16n8k8 TF32 and
//     the 3xTF32 split: each fp32 operand x becomes hi = tf32(x) and
//     lo = tf32(x - hi), and a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b,
//     accumulated in fp32. That keeps about 22 bits of each product, so the
//     kernel stays within the 1e-5 its plain version holds it to, where one
//     TF32 pass (11 bits) would not. A warp issues its products kGroup
//     output tiles at a time, pass by pass, so that an mma never waits on
//     the one just before it (the three passes into one tile are a chain);
//   * S = Q.K^T lands in the accumulator fragments and stays in registers:
//     the mask, the validity flag, the row max and sum (quad shuffles) and
//     exp run there, and the fragments are P's A operand for P.V as they
//     are, with V's B operand read in the matching key order. The
//     normaliser l is kept per thread and summed over the quad at the end;
//   * bf16 heads stay bf16 in shared memory, which halves the Q tile, the
//     K/V ring and the bytes each copy moves. A bf16 value has 8
//     significant bits, so it is exact in TF32: the lo half of k and of v is
//     0, and the bf16 kernel drops the hi_a.lo_b pass of both products
//     (2xTF32). The A operands, q * scale and the fp32 probabilities, keep
//     their split, so the products keep the fp32 path's 22 bits;
//   * shared rows are padded to D + 4 floats or D + 8 bf16 values, so every
//     fragment load is free of bank conflicts; any T (the ragged last tile
//     is zero-filled and flagged invalid), D up to 128 (padded to 64 or 128
//     with zeros).
//
// What bounds it on an H100: at DistilBERT's width (BH = 192, T = 256,
// D = 64) one launch moves 50 MB (q, k, v, out; 15 us at 3.35 TB/s) and does
// 4 BH T^2 D = 3.2 GFLOP over every key, three tensor-core passes of it at
// 495 TFLOP/s TF32: 20 us. With the synthetic-IMDb padding most key tiles
// are skipped, so bytes bound it; without a mask the three passes do. The
// fp32 split (two cvt and a subtract per operand element, repeated by each
// warp for K and V) and mma.sync, not wgmma, keep it above those bounds.
// GPT-2's causal heads (BH = 192, T = 1024, D = 64) take 2 T (T + 1) D
// products a head, 25.8 GFLOP a launch: operations bound them, in bf16 too,
// since the 2xTF32 passes still run at the TF32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;      // q rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 8;     // 16 q rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr int kGroup = 4;    // independent mma chains interleaved
constexpr float kNegInf = -1e30f;   // running-max start (finite: m - m' stays finite)
constexpr float kMaskPad = -1e29f;  // mask values at or below this are padding
constexpr float kLseEmpty = 1e30f;  // lse of a fully masked row

// What the kernel needs of the heads' element type: widening to fp32 and
// the one rounding of out (the cuda_bf16.h intrinsics for bf16), the row
// padding of the shared tiles, and whether a value is exact in TF32
template <typename Elt>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPad = 4;         // 16 bytes: rows stay 16-byte aligned
  static constexpr bool kTf32Exact = false;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
  __device__ static float zero() { return 0.f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr bool kTf32Exact = true;  // 8 significant bits of TF32's 11
  __device__ static float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 narrow(float x) { return __float2bfloat16_rn(x); }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
};

// row stride, in elements, of the shared Q, K and V tiles: D padded to DP,
// plus the element type's pad (a row stride of 4 banks mod 32 either way)
template <typename Elt>
__host__ __device__ constexpr int row_stride(int dp) { return dp + Elem<Elt>::kPad; }

template <typename Elt>
size_t smem_bytes(int dp) {
  return sizeof(Elt) * static_cast<size_t>(row_stride<Elt>(dp)) * (kBQ + 4 * kBK) + sizeof(float) * 2 * kBK;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (the low 13 bits of each are 0)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A B operand's hi and lo halves; where the value is exact in TF32 (bf16
// widened to fp32: its low 16 bits are 0) hi is the value and lo is 0
template <bool kExact>
__device__ __forceinline__ void split_b(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// d[n] += a.b[n] for kG independent products in 3xTF32, the two small terms
// first; pass by pass over the group, so that no mma waits on the one before.
// Where every b is exact in TF32 (kExactB) the hi_a.lo_b pass adds 0 and is
// dropped: 2xTF32, with the same 22 bits of each product
template <int kG, bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[kG][2], const uint32_t (&bl)[kG][2]) {
#pragma unroll
  for (int n = 0; n < kG; ++n) mma_tf32(d[n], al, bh[n]);
  if (!kExactB) {
#pragma unroll
    for (int n = 0; n < kG; ++n) mma_tf32(d[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < kG; ++n) mma_tf32(d[n], ah, bh[n]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first key tile at or after `from` (before `end`) that holds a valid
// key; `end` if none. Every warp scans for itself and finds the same tile.
__device__ __forceinline__ int next_tile(const float* mrow, int from, int end, int T) {
  const int lane = threadIdx.x & 31;
  for (int tile = from; tile < end; ++tile) {
    const int a = tile * kBK + lane, b = a + 32;
    const bool valid = (a < T && __ldg(mrow + a) > kMaskPad) || (b < T && __ldg(mrow + b) > kMaskPad);
    if (__any_sync(0xffffffffu, valid)) return tile;
  }
  return end;
}

// Elt: the heads' element type (float or __nv_bfloat16). DT: D padded to
// DP = 8 DT columns (8: D <= 64, 16: D <= 128). At D <= 64 two blocks share
// an SM (registers held to 128 a thread; 2 x 103 KB of shared memory in fp32),
// so one block's products overlap the other's waits.
template <typename Elt, int DT>
__global__ void __launch_bounds__(kThreads, DT == 8 ? 2 : 1)
flash_fwd_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                 const Elt* __restrict__ v, const float* __restrict__ mask,
                 Elt* __restrict__ out, float* __restrict__ lse, int T, int D,
                 int H, int causal, float scale) {
  using E = Elem<Elt>;
  constexpr bool kExactB = E::kTf32Exact;  // k and v as B operands
  constexpr int DP = 8 * DT;
  constexpr int LD = row_stride<Elt>(DP);
  constexpr int kVec = 16 / sizeof(Elt);  // elements in one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* qs = reinterpret_cast<Elt*>(smem_raw);  // kBQ x LD
  Elt* kv = qs + kBQ * LD;                   // two stages of (K tile, V tile), kBK x LD each
  float* mk = reinterpret_cast<float*>(kv + 4 * kBK * LD);  // two stages of the tile's kBK mask values

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const Elt* qh = q + head;
  const Elt* kh = k + head;
  const Elt* vh = v + head;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;

  // the copies fill columns [0, D) only: zero the padding of Q and of both
  // stages of K and V
  for (int idx = tid; idx < (kBQ + 4 * kBK) * (DP - D); idx += kThreads) {
    const int r = idx / (DP - D), c = D + idx - r * (DP - D);
    qs[r * LD + c] = E::zero();
  }

  // rows [row0, row0 + n) of a (T, D) head into a tile of stride LD; rows
  // past T are zero-filled. 16-byte cp.async where every row starts on 16
  // bytes; else 4-byte cp.async (fp32) or plain loads (bf16), which finish
  // before the __syncthreads that precedes the tile's use
  const bool vec = D % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  auto load_rows = [&](Elt* dst, const Elt* head_src, int row0, int n) {
    if (vec) {
      const int chunks = D / kVec;  // 16-byte pieces per row
      for (int idx = tid; idx < n * chunks; idx += kThreads) {
        const int r = idx / chunks, c = (idx - r * chunks) * kVec;
        const bool in = row0 + r < T;
        cp_async16(dst + r * LD + c, head_src + (in ? static_cast<size_t>(row0 + r) * D + c : 0), in);
      }
    } else {
      for (int idx = tid; idx < n * D; idx += kThreads) {
        const int r = idx / D, c = idx - r * D;
        const bool in = row0 + r < T;
        const Elt* src = head_src + (in ? static_cast<size_t>(row0 + r) * D + c : 0);
        if constexpr (sizeof(Elt) == 4) {
          cp_async4(reinterpret_cast<float*>(dst + r * LD + c), reinterpret_cast<const float*>(src), in);
        } else {
          dst[r * LD + c] = in ? *src : E::zero();
        }
      }
    }
  };
  auto load_tile = [&](int tile, int stage) {
    Elt* ks = kv + stage * 2 * kBK * LD;
    const int k0 = tile * kBK;
    load_rows(ks, kh, k0, kBK);
    load_rows(ks + kBK * LD, vh, k0, kBK);
    if (tid < kBK) {
      const bool in = k0 + tid < T;
      cp_async4(mk + stage * kBK + tid, mrow + (in ? k0 + tid : 0), in);
    }
  };

  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kBQ + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  load_rows(qs, qh, q0, kBQ);  // Q travels with the first tile
  if (tile < end) load_tile(tile, 0);
  cp_async_commit();

  // this thread's q rows (local): ra for fragment entries 0, 1; rb for 2, 3
  const int ra = warp * 16 + g, rb = ra + 8;
  const int qa = q0 + ra, qb = q0 + rb;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's sum is l
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int stage = 0;
  while (tile < end) {
    const int next = next_tile(mrow, tile + 1, end, T);
    if (next < end) load_tile(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();     // ... every thread's, and Q

    const Elt* ks = kv + stage * 2 * kBK * LD;
    const Elt* vs = ks + kBK * LD;
    const float* ms = mk + stage * kBK;
    const int k0 = tile * kBK;

    // S = (q * scale) . k over 8 groups of 8 keys: s[j] holds keys 8 j + 2 t
    // and 8 j + 2 t + 1 of rows ra (entries 0, 1) and rb (2, 3)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (8 * kk >= D) break;
      uint32_t ah[4], al[4];
      split(E::widen(qs[ra * LD + 8 * kk + t]) * scale, ah[0], al[0]);
      split(E::widen(qs[rb * LD + 8 * kk + t]) * scale, ah[1], al[1]);
      split(E::widen(qs[ra * LD + 8 * kk + t + 4]) * scale, ah[2], al[2]);
      split(E::widen(qs[rb * LD + 8 * kk + t + 4]) * scale, ah[3], al[3]);
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kGroup) {
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          split_b<kExactB>(E::widen(ks[(8 * (j0 + j) + g) * LD + 8 * kk + t]), bh[j][0], bl[j][0]);
          split_b<kExactB>(E::widen(ks[(8 * (j0 + j) + g) * LD + 8 * kk + t + 4]), bh[j][1], bl[j][1]);
        }
        mma_3xtf32<kGroup, kExactB>(s + j0, ah, al, bh, bl);
      }
    }

    // + mask, causal, validity, and the row max over valid keys
    uint32_t valid_bits = 0;  // bit 4 j + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        const float mv = ms[8 * j + 2 * t + c];  // 0 past T, where ok is false
        const bool ok = key < T && mv > kMaskPad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const bool keep = !causal || (h ? qb : qa) >= key;
          const float x = keep ? s[j][e] + mv : kNegInf;
          s[j][e] = x;
          if (ok && keep) {
            valid_bits |= 1u << (4 * j + e);
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (valid_bits >> (4 * j + e)) & 1u ? expf(s[j][e] - m_run[e >> 1]) : 0.f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // acc += P . V: s[kk] is P's A fragment for keys 8 kk .. 8 kk + 7 with
    // its k index t standing for key 2 t and t + 4 for key 2 t + 1; V's B
    // fragment is read in that order
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split(s[kk][0], ah[0], al[0]);
      split(s[kk][2], ah[1], al[1]);
      split(s[kk][1], ah[2], al[2]);
      split(s[kk][3], ah[3], al[3]);
      const Elt* v0 = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += kGroup) {
        if (8 * n0 >= D) break;  // the columns past D are zero
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          split_b<kExactB>(E::widen(v0[8 * (n0 + n)]), bh[n][0], bl[n][0]);
          split_b<kExactB>(E::widen(v0[LD + 8 * (n0 + n)]), bh[n][1], bl[n][1]);
        }
        mma_3xtf32<kGroup, kExactB>(o + n0, ah, al, bh, bl);
      }
    }
    __syncthreads();  // the next copy overwrites this stage
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int tq = h ? qb : qa;
    if (tq >= T) continue;
    const float denom = fmaxf(l, 1e-37f);
    Elt* orow = out + head + static_cast<size_t>(tq) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D) orow[c] = E::narrow(o[n][2 * h] / denom);
      if (c + 1 < D) orow[c + 1] = E::narrow(o[n][2 * h + 1] / denom);
    }
    if (t == 0)
      lse[static_cast<size_t>(bh) * T + tq] = l > 0.f ? m_run[h] + logf(denom) : kLseEmpty;
  }
}

template <typename Elt, int DT>
int launch(const Elt* q, const Elt* k, const Elt* v, const float* mask, Elt* out, float* lse,
           int bh, int T, int D, int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elt>(8 * DT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<Elt, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (T + kBQ - 1) / kBQ);
  flash_fwd_kernel<Elt, DT><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse,
                                                            T, D, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elt>
int dispatch(const void* q, const void* k, const void* v, const float* mask, void* out,
             float* lse, int bh, int T, int D, int H, int causal, float scale, void* stream) {
  if (bh <= 0 || T <= 0) return 0;
  if (D < 1 || D > kMaxD || H < 1 || bh % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Elt* qt = static_cast<const Elt*>(q);
  const Elt* kt = static_cast<const Elt*>(k);
  const Elt* vt = static_cast<const Elt*>(v);
  Elt* ot = static_cast<Elt*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<Elt, 8>(qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
  return launch<Elt, 16>(qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
}

}  // namespace

// C entries, loaded with ctypes. q, k, v, out: (bh, T, D) contiguous, fp32
// or bf16 by the entry's name; mask: (bh / H, T) fp32; lse: (bh, T) fp32.
// Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, float* lse, int bh,
                                       int T, int D, int H, int causal, float scale,
                                       void* stream) {
  return dispatch<float>(q, k, v, mask, out, lse, bh, T, D, H, causal, scale, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        const float* mask, void* out, float* lse, int bh,
                                        int T, int D, int H, int causal, float scale,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse, bh, T, D, H, causal, scale, stream);
}
