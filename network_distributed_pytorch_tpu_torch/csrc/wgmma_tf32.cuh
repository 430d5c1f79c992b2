// Hopper warpgroup products (wgmma) on fp32 64 x 64 tiles in 3xTF32, for
// K5's fp32 backward (csrc/flash_attention_bwd.cu): the 128-byte swizzled
// layout of an fp32 tile, cp.async copies of (T, D <= 64) rows into it, the
// pass that splits a tile into its TF32 parts (and transposes it), the
// m64n64k8 TF32 product with A from shared memory (SS) or registers (RS),
// and the 3xTF32 products the kernels chain from it.
//
// Layout. A tile is 64 rows of 64 fp32 (256 bytes), 16 KB, based on 1024
// bytes: two 8 KB columns, each 64 rows of 32 floats (128 bytes: one swizzle
// row) laid out as a bf16 tile of csrc/wgmma_bf16.cuh (the 16-byte chunk c
// of row r at chunk c ^ (r % 8)). A TF32 wgmma has no transpose bit: both of
// its shared-memory operands are K-major, rows along M or N and the depth K
// along the row. A k8 step is 32 bytes, as a bf16 k16 step: steps 0-3 lie in
// the first column at kStepK kk, steps 4-7 in the second, 8 KB on
// (step_tf32), with desc_k_major's SBO of 1024 bytes.
//
// TF32 parts. The tensor cores take the top 19 bits of an fp32 operand and
// ignore its low 13 (measured: flash_bwd_wgmma_tf32_selftest, mode 0 and 1).
// So a tile as it arrives is its own hi part, and lo = x - hi(x) is exact in
// fp32; the tensor cores take the top of lo in turn. x.y is lo_x.hi_y +
// hi_x.lo_y + hi_x.hi_y within about 2^-21 |x y| (lo_x.lo_y left out).
//
// Registers (PTX ISA, wgmma m64nNk8 .tf32): warp w of the warpgroup holds
// rows 16 w + g (+ 8) of the accumulator, columns 8 j + 2 t (+ 1) in
// c[j][0 .. 3], with g = lane / 4, t = lane % 4: an mma.sync m16n8 C
// fragment for each n8 block j. A register A operand is the m16n8k8 TF32 A
// fragment of those rows: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
// a3 = A[g + 8][t + 4]. Read as an A operand of k8 step j, the accumulator's
// c[j][0], c[j][2], c[j][1], c[j][3] give k index t the column 8 j + 2 t and
// k index t + 4 the column 8 j + 2 t + 1. A B operand whose k axis is that
// accumulator's columns (the walk's keys or q rows) is therefore stored
// with each group of 8 in that order: column 8 j + kappa of the transposed
// tile holds walk index 8 j + 2 (kappa % 4) + kappa / 4. Then P and dS feed
// the next product from their accumulator registers as they stand.
#pragma once

#include "wgmma_bf16.cuh"

namespace {

constexpr int kSwTileF32Bytes = 2 * kSwTileBytes;  // one swizzled 64 x 64 fp32 tile

// the byte offset of fp32 element (r, c) in a swizzled tile (c < 128 for
// the self-test's 64 x 128 tiles: two tiles side by side)
__device__ __forceinline__ int sw128_f32_offset(int r, int c) {
  return ((c >> 5) << 13) + r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// the descriptor of k8 step kk of a K-major fp32 tile from its step 0's
__device__ __forceinline__ uint64_t step_tf32(uint64_t d, int kk) {
  return d + (kSwTileBytes >> 4) * (kk >> 2) + kStepK * (kk & 3);
}

// the part of x below its TF32 value (the top 19 bits), exact in fp32
__device__ __forceinline__ float tf32_lo(float x) { return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u); }

#define TF32_C32(m)                                                                                            \
  m(c[0][0]), m(c[0][1]), m(c[0][2]), m(c[0][3]), m(c[1][0]), m(c[1][1]), m(c[1][2]), m(c[1][3]), m(c[2][0]),    \
      m(c[2][1]), m(c[2][2]), m(c[2][3]), m(c[3][0]), m(c[3][1]), m(c[3][2]), m(c[3][3]), m(c[4][0]), m(c[4][1]), \
      m(c[4][2]), m(c[4][3]), m(c[5][0]), m(c[5][1]), m(c[5][2]), m(c[5][3]), m(c[6][0]), m(c[6][1]), m(c[6][2]), \
      m(c[6][3]), m(c[7][0]), m(c[7][1]), m(c[7][2]), m(c[7][3])
#define TF32_D32                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TF32_RW(x) "+f"(x)
#define TF32_W(x) "=f"(x)

// c (64 x 64, fp32) = A.B + (kAccumulate ? c : 0) for one k8 step, A and B
// K-major from shared memory. Without kAccumulate c is output only
template <int kAccumulate>
__device__ __forceinline__ void wgmma_tf32_ss(float (&c)[8][4], uint64_t da, uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_D32 ", %32, %33, p, 1, 1;\n}\n"
        : TF32_C32(TF32_RW)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_D32 ", %32, %33, p, 1, 1;\n}\n"
        : TF32_C32(TF32_W)
        : "l"(da), "l"(db), "r"(0));
  }
}

// the same with A from registers (a0 .. a3 as the layout above)
template <int kAccumulate>
__device__ __forceinline__ void wgmma_tf32_rs(float (&c)[8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TF32_C32(TF32_RW)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TF32_C32(TF32_W)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  }
}

#undef TF32_RW
#undef TF32_W
#undef TF32_C32
#undef TF32_D32

// c = A.B^T in 3xTF32 over kSteps k8 steps, A and B K-major tiles given as
// hi (the tile as it arrived) and lo: A_lo.B_hi, A_hi.B_lo, then A_hi.B_hi,
// in one accumulator with the small passes first; c is output only
template <int kSteps>
__device__ __forceinline__ void products_nt_tf32(float (&c)[8][4], const unsigned char* ah, const unsigned char* al,
                                                 const unsigned char* bh, const unsigned char* bl) {
  const uint64_t dah = desc_k_major(ah), dal = desc_k_major(al), dbh = desc_k_major(bh), dbl = desc_k_major(bl);
  wgmma_tf32_ss<0>(c, dal, dbh);
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk) wgmma_tf32_ss<1>(c, step_tf32(dal, kk), step_tf32(dbh, kk));
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_tf32_ss<1>(c, step_tf32(dah, kk), step_tf32(dbl, kk));
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_tf32_ss<1>(c, step_tf32(dah, kk), step_tf32(dbh, kk));
}

// The register A operands of k8 steps j = 0 .. 7 from an fp32 accumulator:
// hi its bits, lo tf32_lo of it, each in the order c[j][0], c[j][2],
// c[j][1], c[j][3] (see Registers above)
__device__ __forceinline__ void split_acc_tf32(const float (&c)[8][4], uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = c[j][e == 1 ? 2 : e == 2 ? 1 : e];
      hi[j][e] = __float_as_uint(x);
      lo[j][e] = __float_as_uint(tf32_lo(x));
    }
}

// c = A.B in 3xTF32 over the 64-long walk (eight k8 steps), A in registers
// as split_acc_tf32 gives it and B a transposed tile's hi and lo parts, the
// small passes first; c is output only: a fresh partial
__device__ __forceinline__ void products_nn_tf32(float (&c)[8][4], const uint32_t (&hi)[8][4],
                                                 const uint32_t (&lo)[8][4], const unsigned char* bh,
                                                 const unsigned char* bl) {
  const uint64_t dh = desc_k_major(bh), dl = desc_k_major(bl);
  wgmma_tf32_rs<0>(c, lo[0], dh);
#pragma unroll
  for (int j = 1; j < 8; ++j) wgmma_tf32_rs<1>(c, lo[j], step_tf32(dh, j));
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_tf32_rs<1>(c, hi[j], step_tf32(dl, j));
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_tf32_rs<1>(c, hi[j], step_tf32(dh, j));
}

// From a tile x (rows the walk's 64 indices, columns d) as it arrived, by
// the block's 128 threads: its lo part into `lo` (the same layout) and,
// with kTrans, x transposed into th (hi: x's values) and tl (lo), rows d
// and the walk along the row in the permuted order of the Registers note.
// Each thread takes two blocks of 4 walk rows (8 j + h + 2 i, i < 4, one
// permuted group of 4 columns of the transposed tile) by 4 columns (one
// 16-byte chunk), loads them as four 16-byte chunks and stores four lo
// chunks and eight transposed ones. The 8 threads of each quarter warp take
// 8 chunk positions of a row that differ in every one of their loads and
// stores: no bank conflicts.
template <bool kTrans>
__device__ __forceinline__ void derive_tf32(const unsigned char* x, unsigned char* lo, unsigned char* th,
                                            unsigned char* tl) {
  const int p = threadIdx.x & 7, grp = (threadIdx.x >> 3) & 15;
  const int qp = (p & 4) | ((p & 1) << 1) | ((p >> 1) & 1);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int combo = 2 * grp + pass;
    const int rs = p + 8 * (combo & 1);                                 // the transposed tile's column chunk
    const int cc = ((qp ^ (combo >> 2)) & 7) + 8 * ((combo >> 1) & 1);  // x's column chunk
    const int base = ((cc >> 3) << 13) + (8 * (rs >> 1) + (rs & 1)) * 128;
    const int sw = (cc & 7) ^ (rs & 1);  // row 8 j + h + 2 i's chunk is sw ^ 2 i
    float v[4][4], l[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = base + 256 * i + (((sw ^ (2 * i)) & 7) << 4);
      const float4 f = *reinterpret_cast<const float4*>(x + off);
      v[i][0] = f.x;
      v[i][1] = f.y;
      v[i][2] = f.z;
      v[i][3] = f.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) l[i][e] = tf32_lo(v[i][e]);
      *reinterpret_cast<float4*>(lo + off) = make_float4(l[i][0], l[i][1], l[i][2], l[i][3]);
    }
    if constexpr (kTrans) {
      const int tbase = ((rs >> 3) << 13) + 4 * cc * 128;
      const int tsw = (rs & 7) ^ ((4 * cc) & 7);  // row 4 cc + e's chunk is tsw ^ e
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = tbase + 128 * e + (((tsw ^ e) & 7) << 4);
        *reinterpret_cast<float4*>(th + off) = make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
        *reinterpret_cast<float4*>(tl + off) = make_float4(l[0][e], l[1][e], l[2][e], l[3][e]);
      }
    }
  }
}

// zero the elements [D, 64) of each row of `n_tiles` consecutive fp32
// tiles: the copies never write them, and the products read them as zeros
template <int kThreads>
__device__ __forceinline__ void zero_padding_f32(unsigned char* tiles, int n_tiles, int D) {
  const int w = 64 - D;
  for (int idx = threadIdx.x; idx < n_tiles * 64 * w; idx += kThreads) {
    const int r = idx / w;
    *reinterpret_cast<float*>(tiles + (r >> 6) * kSwTileF32Bytes + sw128_f32_offset(r & 63, D + idx - r * w)) = 0.f;
  }
}

// One thread's share of the 16-byte cp.async copies of 64 rows of a (T, D)
// fp32 head whose rows are 16-byte aligned into a swizzled tile, for a block
// of 128 threads: chunk column tid % 16 (unless it lies past D) of rows
// tid / 16 + 8 i, i < 8, which share one swizzle pattern, so their shared
// offsets are fixed and 1024 bytes apart. Rows past T are zero-filled
struct TileCopyF32 {
  int r0, soff, goff;  // first row, its shared byte offset, its element offset in the tile's rows
  bool on;

  __device__ explicit TileCopyF32(int D)
      : r0(threadIdx.x >> 4),
        soff(sw128_f32_offset(threadIdx.x >> 4, (threadIdx.x & 15) * 4)),
        goff((threadIdx.x >> 4) * D + (threadIdx.x & 15) * 4),
        on((threadIdx.x & 15) * 4 < D) {}

  __device__ __forceinline__ void operator()(unsigned char* tile, const float* head, int row0, int T, int D) const {
    if (!on) return;
    const float* src = head + static_cast<size_t>(row0) * D + goff;
    if (row0 + 64 <= T) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cp_async16(tile + soff + 1024 * i, src + 8 * i * D, true);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = row0 + r0 + 8 * i < T;
        cp_async16(tile + soff + 1024 * i, in ? src + 8 * i * D : head, in);
      }
    }
  }
};

// rows [row0, row0 + 64) of a (T, D <= 64) fp32 head into a swizzled tile,
// element by element (rows of any alignment), rows past T zero-filled;
// plain stores, which finish before the __syncthreads that precedes the
// tile's use
template <int kThreads>
__device__ __forceinline__ void load_rows_f32(unsigned char* tile, const float* head, int row0, int T, int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    *reinterpret_cast<float*>(tile + sw128_f32_offset(r, c)) =
        row0 + r < T ? head[static_cast<size_t>(row0 + r) * D + c] : 0.f;
  }
}

}  // namespace
