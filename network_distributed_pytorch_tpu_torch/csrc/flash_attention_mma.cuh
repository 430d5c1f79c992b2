// What the flash-attention kernels share (csrc/flash_attention.cu, the
// forward, and csrc/flash_attention_bwd.cu, the backward): the constants of
// the mask convention, tensor-core products (3xTF32 m16n8k8 for fp32
// operands, bf16 m16n8k16 fed by ldmatrix), the split of an fp32 value into
// bf16 parts, exp by the special function unit, cp.async copies of (T, D)
// rows into padded shared tiles, and the warp vote that finds the next key
// tile holding a valid key.
//
// Fragment layouts (PTX ISA, mma.sync), with g = lane / 4 and t = lane % 4:
//   C and D (16 x 8, fp32): c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//     c3 = C[g+8][2t+1], for both shapes;
//   m16n8k8 TF32: A a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//     a3 = A[g+8][t+4]; B b0 = B[t][g], b1 = B[t+4][g];
//   m16n8k16 bf16 (two values a register, the lower column in the low half):
//     A a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//     a3 = A[g+8][2t+8..]; B b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g].
// So the C fragments of two adjacent n8 tiles are, value for value, the A
// fragment of one k16 step: a product's result feeds the next product from
// registers once it is rounded to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 64;             // keys per tile
constexpr float kNegInf = -1e30f;   // running-max start (finite: m - m' stays finite)
constexpr float kMaskPad = -1e29f;  // mask values at or below this are padding
constexpr float kLseEmpty = 1e30f;  // lse of a fully masked row
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special function unit (relative error about 2^-22; results
// below 2^-126 flush to 0). exp(x) is ex2(x log2 e), with the product and
// whatever is subtracted from it in one fma
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- TF32 -------------------------------------------------------------------

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

// d[n] += a.b[n] for kG independent products in 3xTF32, the two small terms
// first (a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, about 22 bits of each
// product); pass by pass over the group, so that no mma waits on the one
// before it
template <int kG>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[kG][2], const uint32_t (&bl)[kG][2]) {
#pragma unroll
  for (int n = 0; n < kG; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < kG; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < kG; ++n) mma_tf32(d[n], ah, bh[n]);
}

// ---- bf16 -------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// (x0, x1) = hi + lo + r with hi = bf16(x) and lo = bf16(x - hi), packed
// two to a register (x0 in the low half); |r| <= 2^-17 |x|: 16 significant
// bits, where hi alone keeps 8
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the A fragments (hi and lo parts) of one k16 step from the fp32 C
// fragments of the two n8 tiles c0 (columns 0-7 of the step) and c1 (8-15)
__device__ __forceinline__ void c_to_a_bf16(const float (&c0)[4], const float (&c1)[4], uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of a row of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// From a row-major bf16 tile of row stride ld: the A fragment of rows
// [0, 16) x columns [c0, c0 + 16)
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// the B fragments of two n8 tiles (b[0], b[1]: rows [0, 8); b[2], b[3]:
// rows [8, 16)) of a k16 step at columns [c0, c0 + 16), where B[k][n] is
// tile[n][k] (the tile holds B's columns as rows: K for Q.K^T)
__device__ __forceinline__ void ldmatrix_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + c0 + ((lane >> 3) & 1) * 8);
}

// the B fragments of a k16 step over rows [0, 16) for the two n8 tiles at
// columns [c0, c0 + 8) (b[0], b[1]) and [c0 + 8, c0 + 16) (b[2], b[3]),
// where B[k][n] is tile[k][n] (V for P.V)
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// ---- copies -------------------------------------------------------------------

// row stride, in elements, of a shared tile whose rows hold D padded to dp:
// 16 bytes more keep rows 16-byte aligned and the stride 4 banks mod 32, so
// fragment loads and ldmatrix are free of bank conflicts
template <typename Elt>
__host__ __device__ constexpr int row_stride(int dp) { return dp + 16 / static_cast<int>(sizeof(Elt)); }

// an element of the heads' type (float or __nv_bfloat16) from fp32, rounded
// to nearest, and back
template <typename Elt>
__device__ __forceinline__ Elt narrow(float x) {
  if constexpr (sizeof(Elt) == 4) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

template <typename Elt>
__device__ __forceinline__ float widen(Elt x) {
  if constexpr (sizeof(Elt) == 4) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether every row of the three (T, D) heads starts on 16 bytes, so that
// load_rows may copy 16 bytes at a time
template <typename Elt>
__device__ __forceinline__ bool rows_aligned(int D, const void* a, const void* b, const void* c) {
  return D % (16 / sizeof(Elt)) == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// rows [row0, row0 + n) of a (T, D) head into a shared tile of row stride
// ld, by the block's kThreads threads; rows past T are zero-filled and the
// columns [D, ld) are left as they are. 16-byte cp.async where `vec`, the
// row's pieces counted over D padded to DP (a power of two, so no thread
// divides), the pieces past D skipped; else 4-byte cp.async (fp32) or
// plain loads (bf16), which finish before the __syncthreads that precedes
// the tile's use
template <int kThreads, int DP, typename Elt>
__device__ __forceinline__ void load_rows(Elt* dst, int ld, const Elt* head, int row0, int n, int T, int D,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kVec = 16 / sizeof(Elt);  // elements in one 16-byte copy
    constexpr int kChunks = DP / kVec;
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * kVec;
      if (c >= D) continue;
      const bool in = row0 + r < T;
      cp_async16(dst + r * ld + c, head + (in ? static_cast<size_t>(row0 + r) * D + c : 0), in);
    }
  } else {
    for (int idx = tid; idx < n * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const bool in = row0 + r < T;
      const Elt* src = head + (in ? static_cast<size_t>(row0 + r) * D + c : 0);
      if constexpr (sizeof(Elt) == 4) {
        cp_async4(reinterpret_cast<float*>(dst + r * ld + c), reinterpret_cast<const float*>(src), in);
      } else {
        dst[r * ld + c] = in ? *src : narrow<Elt>(0.f);
      }
    }
  }
}

// n fp32 values from src[i0, i0 + n) into dst, zero past `end`
template <int kThreads>
__device__ __forceinline__ void load_floats(float* dst, const float* src, int i0, int n, int end) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = i0 + i < end;
    cp_async4(dst + i, src + (in ? i0 + i : 0), in);
  }
}

// zero the columns [D, dp) of `rows` rows of stride ld: the tiles' padding,
// which the copies never write and the products read as zeros
template <int kThreads, typename Elt>
__device__ __forceinline__ void zero_padding(Elt* tile, int ld, int rows, int D, int dp) {
  const int w = dp - D;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
    const int r = idx / w;
    tile[r * ld + D + idx - r * w] = narrow<Elt>(0.f);
  }
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

}  // namespace
