// Flash attention forward for Hopper: exact softmax attention over folded
// (BH, T, D) heads of fp32 or bf16 with an additive (B, T) fp32 key mask,
// never building the (T, T) score matrix in device memory. Writes out
// (BH, T, D) in the heads' dtype and the per-row log-sum-exp lse (BH, T) in
// fp32. The backward is csrc/flash_attention_bwd.cu; what both share is in
// csrc/flash_attention_mma.cuh.
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
// Design, common to both element types:
//   * one block of 8 warps per (head, tile of 128 q rows); each warp owns 16
//     q rows. Tiles of 64 keys of K, V and the mask arrive by cp.async into
//     a double-buffered ring, the next tile's copy in flight while the
//     current one is used, so no thread ever waits on a load of its own;
//   * key tiles in which no key is valid are skipped: before a tile is
//     fetched, each warp reads its 64 mask values and votes (__any_sync),
//     and a tile with no valid key is neither loaded nor multiplied. This is
//     exact: such a tile leaves m' = m, c = 1, l += 0 and acc *= 1, so out
//     and lse are bitwise what walking it would give. A tile with one real
//     key anywhere is walked. In causal mode the walk ends at the diagonal;
//   * S = Q.K^T lands in the accumulator fragments and stays in registers:
//     the mask, the validity flag, the row max and sum (quad shuffles) and
//     exp run there, and the fragments become P's A operand for P.V. The
//     normaliser l is kept per thread and summed over the quad at the end;
//   * shared rows are padded to D + 4 floats or D + 8 bf16 values, so every
//     fragment load is free of bank conflicts; any T (the ragged last tile
//     is zero-filled and flagged invalid), D up to 128 (padded to 64 or 128
//     with zeros).
//
// fp32 heads (flash_fwd_kernel): both products run with mma.sync m16n8k8
// TF32 and the 3xTF32 split (csrc/flash_attention_mma.cuh), which keeps
// about 22 bits of each product, so the kernel stays within the 1e-5 its
// plain version holds it to, where one TF32 pass (11 bits) would not. A
// warp issues its products kGroup output tiles at a time, pass by pass, so
// that an mma never waits on the one just before it. q is scaled as its
// fragments are read (the Pallas kernel's order); P's accumulator fragments
// are its A operand as they are, with V's B operand read in the matching
// key order.
//
// bf16 heads (flash_fwd_bf16_kernel) run on the bf16 tensor cores, mma.sync
// m16n8k16 with operands from ldmatrix:
//   * each warp loads its 16 rows of Q once, unscaled, as A fragments held
//     in registers across the whole key walk; K's B fragments come from the
//     bf16 ring by ldmatrix. A product of two bf16 values is exact in fp32,
//     so S is the fp32 dot product up to summation order, in one pass;
//   * scale is applied to S in fp32 after the product. The Pallas kernel
//     rounds q * scale first: at D = 64 (scale 1/8, a power of two) the two
//     orders agree up to summation order; at other D (40, 128) they differ
//     by an fp32 ulp or two of S;
//   * P stays fp32 in the accumulator fragments and is split in registers
//     into two bf16 A fragments, hi = bf16(p) and lo = bf16(p - hi), 16
//     significant bits (one bf16 P would keep 8: an error near 2^-9 of out,
//     far above the 1e-5 tolerance). The C fragments of two adjacent n8 key
//     tiles are the A fragment of one k16 step; V's B fragments come by
//     ldmatrix.trans. P.V is two passes, hi and lo;
//   * exp is ex2 of a log2(e)-scaled argument formed in one fma, and on a
//     tile whose every key is valid for every row of the warp (no padding,
//     below the causal diagonal) the per-element flag is not tested;
//   * causal blocks run from the last q tile to the first, so the blocks
//     with the longest walks start first;
//   * out is rounded to bf16 once, at the end, as the Pallas kernel's o_ref
//     store does; lse stays fp32.
//
// What bounds it on an H100: at DistilBERT's width (BH = 192, T = 256,
// D = 64) one launch moves 50 MB of fp32 (q, k, v, out; 15 us at 3.35 TB/s)
// and does 4 BH T^2 D = 3.2 GFLOP over every key, three tensor-core passes
// of it at 495 TFLOP/s TF32: 20 us. With the synthetic-IMDb padding most key
// tiles are skipped, so bytes bound it; without a mask the three passes do.
// The fp32 split (two cvt and a subtract per operand element, repeated by
// each warp for K and V) and mma.sync, not wgmma, keep it above those
// bounds. GPT-2's causal heads (BH = 192, T = 1024, D = 64) in bf16 move
// 101 MB (0.36 ms a step of 12 launches) and do 2 T (T + 1) D products a
// head, 25.8 GFLOP a launch; the bf16 route's three passes (S once, P.V
// twice) are 0.47 ms a step at 989 TFLOP/s. Each of the 8 warps of a block
// reads every K and V fragment of a tile from shared memory, and with the
// loop's copies, votes and barriers that holds the kernel at several times
// those bounds; two m-tiles a warp (half the reads) cost more in occupancy
// than they saved (chip_smoke.py's times are in PERF.md).

#include "flash_attention_mma.cuh"

namespace {

constexpr int kBQ = 128;      // q rows per block
constexpr int kWarps = 8;     // 16 q rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr int kGroup = 4;    // independent mma chains interleaved (fp32)

template <typename Elt>
size_t smem_bytes(int dp) {
  return sizeof(Elt) * static_cast<size_t>(row_stride<Elt>(dp)) * (kBQ + 4 * kBK) + sizeof(float) * 2 * kBK;
}

// The block's shared memory and the copies into it, for both kernels: Q
// (kBQ rows), two stages of (K tile, V tile) and two stages of the tile's
// kBK mask values
template <typename Elt, int DP>
struct Tiles {
  static constexpr int LD = row_stride<Elt>(DP);
  Elt* qs;
  Elt* kv;
  float* mk;
  const Elt* kh;
  const Elt* vh;
  const float* mrow;
  int T, D;
  bool vec;

  __device__ Tiles(unsigned char* smem, const Elt* k, const Elt* v, const float* mask_row, int T_, int D_,
                   bool vec_)
      : qs(reinterpret_cast<Elt*>(smem)), kv(qs + kBQ * LD),
        mk(reinterpret_cast<float*>(kv + 4 * kBK * LD)), kh(k), vh(v), mrow(mask_row), T(T_), D(D_), vec(vec_) {
    // the copies fill columns [0, D) only: zero the padding of Q and of
    // both stages of K and V
    zero_padding<kThreads>(qs, LD, kBQ + 4 * kBK, D, DP);
  }
  __device__ const Elt* k_tile(int stage) const { return kv + stage * 2 * kBK * LD; }
  __device__ const Elt* v_tile(int stage) const { return k_tile(stage) + kBK * LD; }
  __device__ const float* mask_tile(int stage) const { return mk + stage * kBK; }
  __device__ void load(int tile, int stage) {
    Elt* ks = kv + stage * 2 * kBK * LD;
    const int k0 = tile * kBK;
    load_rows<kThreads, DP>(ks, LD, kh, k0, kBK, T, D, vec);
    load_rows<kThreads, DP>(ks + kBK * LD, LD, vh, k0, kBK, T, D, vec);
    load_floats<kThreads>(mk + stage * kBK, mrow, k0, kBK, T);
  }
};

// The online-softmax step on one tile's scores, shared by both kernels: s
// holds keys 8 j + 2 t and 8 j + 2 t + 1 of rows ra (entries 0, 1) and rb
// (2, 3). Adds the mask, applies causality and the validity flag, updates
// the running max m_run and sum l_run, rescales o, and leaves P in s.
// fp32 kernel (kBf16 false): s is already scaled and exp is expf. bf16
// kernel: s is scaled here; exp(x - m) is ex2((x - m) log2 e) with the
// product and difference in one fma; where kFull (every key of the tile
// valid for every row of the warp: no padding, no key past T, below the
// causal diagonal) no flag is tested, which gives the values the flag
// would.
template <int DT, bool kBf16, bool kFull>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&o)[DT][4], float (&m_run)[2],
                                             float (&l_run)[2], const float* ms, int k0, int qa, int qb, int T,
                                             int causal, float scale) {
  const int t = threadIdx.x & 3;
  uint32_t valid_bits = 0;  // bit 4 j + e
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t + c;
      const float mv = ms[8 * j + 2 * t + c];  // 0 past T, where ok is false
      const bool ok = kFull || (key < T && mv > kMaskPad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + c;
        const bool keep = kFull || !causal || (h ? qb : qa) >= key;
        const float x = keep ? (kBf16 ? fmaf(s[j][e], scale, mv) : s[j][e] + mv) : kNegInf;
        s[j][e] = x;
        if (ok && keep) {
          valid_bits |= 1u << (4 * j + e);
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
  }
  float corr[2], m_log2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    corr[h] = kBf16 ? ex2((m_run[h] - m_new) * kLog2e) : expf(m_run[h] - m_new);
    m_run[h] = m_new;
    m_log2[h] = m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      const bool valid = kFull || ((valid_bits >> (4 * j + e)) & 1u);
      const float p = !valid ? 0.f : kBf16 ? ex2(fmaf(x, kLog2e, -m_log2[e >> 1])) : expf(x - m_run[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
}

// out = o / l and lse for this thread's rows qa (h = 0) and qb (h = 1)
template <typename Elt, int DT>
__device__ __forceinline__ void write_out(const float (&o)[DT][4], const float (&m_run)[2], const float (&l_run)[2],
                                          Elt* out_head, float* lse_row, int qa, int qb, int T, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int tq = h ? qb : qa;
    if (tq >= T) continue;
    const float denom = fmaxf(l, 1e-37f);
    Elt* orow = out_head + static_cast<size_t>(tq) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D) orow[c] = narrow<Elt>(o[n][2 * h] / denom);
      if (c + 1 < D) orow[c + 1] = narrow<Elt>(o[n][2 * h + 1] / denom);
    }
    if (t == 0) lse_row[tq] = l > 0.f ? m_run[h] + logf(denom) : kLseEmpty;
  }
}

// fp32 heads. DT: D padded to DP = 8 DT columns (8: D <= 64, 16: D <= 128).
// At D <= 64 two blocks share an SM (registers held to 128 a thread; 2 x
// 103 KB of shared memory), so one block's products overlap the other's
// waits.
template <int DT>
__global__ void __launch_bounds__(kThreads, DT == 8 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse, int T, int D,
                 int H, int causal, float scale) {
  constexpr int DP = 8 * DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  Tiles<float, DP> tiles(smem_raw, k + head, v + head, mrow, T, D, rows_aligned<float>(D, q, k, v));
  constexpr int LD = Tiles<float, DP>::LD;
  const float* qs = tiles.qs;

  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kBQ + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  load_rows<kThreads, DP>(tiles.qs, LD, q + head, q0, kBQ, T, D, tiles.vec);  // Q travels with the first tile
  if (tile < end) tiles.load(tile, 0);
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
    if (next < end) tiles.load(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();     // ... every thread's, and Q

    const float* ks = tiles.k_tile(stage);
    const float* vs = tiles.v_tile(stage);

    // S = (q * scale) . k over 8 groups of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (8 * kk >= D) break;
      uint32_t ah[4], al[4];
      split(qs[ra * LD + 8 * kk + t] * scale, ah[0], al[0]);
      split(qs[rb * LD + 8 * kk + t] * scale, ah[1], al[1]);
      split(qs[ra * LD + 8 * kk + t + 4] * scale, ah[2], al[2]);
      split(qs[rb * LD + 8 * kk + t + 4] * scale, ah[3], al[3]);
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kGroup) {
        uint32_t bh_[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          split(ks[(8 * (j0 + j) + g) * LD + 8 * kk + t], bh_[j][0], bl[j][0]);
          split(ks[(8 * (j0 + j) + g) * LD + 8 * kk + t + 4], bh_[j][1], bl[j][1]);
        }
        mma_3xtf32<kGroup>(s + j0, ah, al, bh_, bl);
      }
    }
    softmax_tile<DT, false, false>(s, o, m_run, l_run, tiles.mask_tile(stage), tile * kBK, qa, qb, T, causal, 1.f);

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
      const float* v0 = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += kGroup) {
        if (8 * n0 >= D) break;  // the columns past D are zero
        uint32_t bh_[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          split(v0[8 * (n0 + n)], bh_[n][0], bl[n][0]);
          split(v0[LD + 8 * (n0 + n)], bh_[n][1], bl[n][1]);
        }
        mma_3xtf32<kGroup>(o + n0, ah, al, bh_, bl);
      }
    }
    __syncthreads();  // the next copy overwrites this stage
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  write_out<float, DT>(o, m_run, l_run, out + head, lse + static_cast<size_t>(bh) * T, qa, qb, T, D);
}

// bf16 heads. DT as above; the Q tile, the ring and the copies are half the
// fp32 kernel's, so at D <= 64 two blocks share an SM with room to spare.
template <int DT>
__global__ void __launch_bounds__(kThreads, DT == 8 ? 2 : 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int D,
                      int H, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int DP = 8 * DT;
  constexpr int KS = DP / 16;  // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int bh = blockIdx.x;
  // causal: the last q tile (the longest walk) first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const size_t head = static_cast<size_t>(bh) * T * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * T;
  Tiles<bf16, DP> tiles(smem_raw, k + head, v + head, mrow, T, D, rows_aligned<bf16>(D, q, k, v));
  constexpr int LD = Tiles<bf16, DP>::LD;

  int end = (T + kBK - 1) / kBK;
  if (causal) end = min(end, (q0 + kBQ + kBK - 1) / kBK);
  int tile = next_tile(mrow, 0, end, T);
  load_rows<kThreads, DP>(tiles.qs, LD, q + head, q0, kBQ, T, D, tiles.vec);
  if (tile < end) tiles.load(tile, 0);
  cp_async_commit();

  const int ra = warp * 16 + g, rb = ra + 8;
  const int qa = q0 + ra, qb = q0 + rb;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[KS][4];  // this warp's 16 rows of Q, loaded at the first tile

  int stage = 0;
  bool have_q = false;
  while (tile < end) {
    const int next = next_tile(mrow, tile + 1, end, T);
    if (next < end) tiles.load(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (!have_q) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_a(qf[kk], tiles.qs + warp * 16 * LD, LD, 16 * kk);
      have_q = true;
    }
    const bf16* ks = tiles.k_tile(stage);
    const bf16* vs = tiles.v_tile(stage);

    // S = q . k in one bf16 pass: s[j] holds keys 8 j + 2 t, 8 j + 2 t + 1
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk >= D) break;  // the columns past D are zero
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_b_rows(b, ks + 16 * np * LD, LD, 16 * kk);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
    // every key of the tile valid (a vote over its mask values), and the
    // tile at or below the warp's first q row
    const float* ms = tiles.mask_tile(stage);
    const int k0 = tile * kBK;
    const bool keys_valid = __all_sync(0xffffffffu, k0 + lane < T && ms[lane] > kMaskPad &&
                                                        k0 + lane + 32 < T && ms[lane + 32] > kMaskPad);
    if (keys_valid && (!causal || k0 + kBK - 1 <= q0 + warp * 16)) {
      softmax_tile<DT, true, true>(s, o, m_run, l_run, ms, k0, qa, qb, T, causal, scale);
    } else {
      softmax_tile<DT, true, false>(s, o, m_run, l_run, ms, k0, qa, qb, T, causal, scale);
    }

    // acc += P . V: P split into bf16 hi and lo, lo's pass first
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      c_to_a_bf16(s[2 * kk], s[2 * kk + 1], ah, al);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        if (16 * np >= D) break;
        uint32_t b[4];
        ldmatrix_b_trans(b, vs + 16 * kk * LD, LD, 16 * np);
        mma_bf16(o[2 * np], al, b[0], b[1]);
        mma_bf16(o[2 * np + 1], al, b[2], b[3]);
        mma_bf16(o[2 * np], ah, b[0], b[1]);
        mma_bf16(o[2 * np + 1], ah, b[2], b[3]);
      }
    }
    __syncthreads();
    tile = next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  write_out<bf16, DT>(o, m_run, l_run, out + head, lse + static_cast<size_t>(bh) * T, qa, qb, T, D);
}

// DP: D padded to 64 or 128, as the kernel's DT = DP / 8
template <int DP, typename Elt, typename Kernel>
int launch(Kernel kernel, const Elt* q, const Elt* k, const Elt* v, const float* mask, Elt* out, float* lse,
           int bh, int T, int D, int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elt>(DP);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (T + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse, T, D, H, causal, scale);
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
  if constexpr (sizeof(Elt) == 4) {
    if (D <= 64) return launch<64>(flash_fwd_kernel<8>, qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
    return launch<128>(flash_fwd_kernel<16>, qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
  } else {
    if (D <= 64)
      return launch<64>(flash_fwd_bf16_kernel<8>, qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
    return launch<128>(flash_fwd_bf16_kernel<16>, qt, kt, vt, mask, ot, lse, bh, T, D, H, causal, scale, s);
  }
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
