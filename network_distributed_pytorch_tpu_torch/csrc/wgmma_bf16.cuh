// Hopper warpgroup products (wgmma) on bf16 64 x 64 tiles, for K5's bf16
// backward (csrc/flash_attention_bwd.cu): shared-memory descriptors of the
// 128-byte swizzled layout, the wgmma fence, commit and wait, the
// m64n64k16 product with A from shared memory (SS) or registers (RS), a
// tile's register A operands by ldmatrix, and copies of (T, D <= 64) rows
// into that layout.
//
// Layout. A tile is 64 rows of 64 bf16 (128 bytes: one swizzle row), 8 KB,
// based on 1024 bytes. The 16-byte chunk c of row r lies at chunk
// c ^ (r % 8) of the row: 8-row groups of 1024 bytes (the swizzle atom)
// follow each other. The same tile serves as either operand kind:
//   * K-major (rows along M or N, the depth K along the row): the rows of
//     A = Q, dO or of B = K, V, Q, dO for the products over D. A k16 step
//     kk starts 32 kk bytes into the rows; the 8-row groups are SBO = 1024
//     bytes apart (LBO is not used by a swizzled K-major operand: 16);
//   * MN-major (rows along K, N along the row, the transpose bit set): B =
//     K, Q, dO for the products whose depth is keys or q rows. A k16 step kk
//     starts 16 rows (2048 bytes) in, its two 8-row groups SBO = 1024 bytes
//     apart; LBO, the step to a second 64-wide atom along N, is never taken
//     at N = 64 and is given SBO's value.
//
// Registers (PTX ISA, wgmma m64nNk16), g = lane / 4, t = lane % 4, warp w
// of the warpgroup: the accumulator's registers 4 j .. 4 j + 3 hold rows
// 16 w + g (+ 8) and columns 8 j + 2 t (+ 1), exactly an mma.sync m16n8 C
// fragment of the warp's 16 rows for each n8 block j; a register A
// operand's 4 registers are the m16n8k16 A fragment of those rows. So
// c[j][e] of a float c[8][4] is the warp's fragment of n8 block j, and
// c_to_a_bf16 (csrc/flash_attention_mma.cuh) of c[2 kk], c[2 kk + 1] is
// an RS A operand of k16 step kk.
#pragma once

#include "flash_attention_mma.cuh"

namespace {

constexpr int kSwTileBytes = 64 * 128;  // one swizzled 64 x 64 bf16 tile

// the byte offset of bf16 element (r, c) in a swizzled tile
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// the 64-bit descriptor (start address, LBO and SBO in 16-byte units,
// layout type 1: 128-byte swizzle; base offset 0, the atoms 1024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// a swizzled tile as a K-major operand at k16 step 0; step kk starts
// 32 kk bytes in: add kStepK * kk (the start address field cannot carry
// over: shared addresses stay below its 2^18 bytes)
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) { return sw128_desc(smem_addr(tile), 16, 1024); }
constexpr uint64_t kStepK = 32 >> 4;

// a swizzled tile as an MN-major (transposed) B operand at k16 step 0;
// step kk starts 16 rows (2048 bytes) in: add kStepMN * kk
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) { return sw128_desc(smem_addr(tile), 1024, 1024); }
constexpr uint64_t kStepMN = 2048 >> 4;

// the start of dynamic shared memory rounded up to 1024 bytes (the launch
// asks for 1024 bytes more than the kernel uses)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// makes this thread's shared-memory writes (stores and cp.async, the
// generic proxy) visible to the wgmma that read them (the async proxy);
// a barrier after it covers the block's writes
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties registers to the point of the call, so that the compiler neither
// reads an accumulator before the wait that completes it nor reuses an A
// operand's registers before then
__device__ __forceinline__ void reg_fence(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}

template <int K>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define WGMMA_C32(m)                                                                                           \
  m(c[0][0]), m(c[0][1]), m(c[0][2]), m(c[0][3]), m(c[1][0]), m(c[1][1]), m(c[1][2]), m(c[1][3]), m(c[2][0]),    \
      m(c[2][1]), m(c[2][2]), m(c[2][3]), m(c[3][0]), m(c[3][1]), m(c[3][2]), m(c[3][3]), m(c[4][0]), m(c[4][1]), \
      m(c[4][2]), m(c[4][3]), m(c[5][0]), m(c[5][1]), m(c[5][2]), m(c[5][3]), m(c[6][0]), m(c[6][1]), m(c[6][2]), \
      m(c[6][3]), m(c[7][0]), m(c[7][1]), m(c[7][2]), m(c[7][3])
#define WGMMA_D32                                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_RW(x) "+f"(x)
#define WGMMA_W(x) "=f"(x)

// c (64 x 64, fp32) = A.B + (kAccumulate ? c : 0) for one k16 step, A and
// B from shared memory; kTransB 1 takes B MN-major. Without kAccumulate c
// is output only: no instruction has to set it up before the product
template <int kTransB, int kAccumulate>
__device__ __forceinline__ void wgmma_ss(float (&c)[8][4], uint64_t da, uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WGMMA_C32(WGMMA_RW)
        : "l"(da), "l"(db), "r"(1), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WGMMA_C32(WGMMA_W)
        : "l"(da), "l"(db), "r"(0), "n"(kTransB));
  }
}

// c = A.B + (kAccumulate ? c : 0) for one k16 step, A from registers (an
// m16n8k16 A fragment of the warp's 16 rows), B from shared memory;
// kTransB and kAccumulate as wgmma_ss
template <int kTransB, int kAccumulate = 1>
__device__ __forceinline__ void wgmma_rs(float (&c)[8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WGMMA_C32(WGMMA_RW)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WGMMA_C32(WGMMA_W)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0), "n"(kTransB));
  }
}

#undef WGMMA_RW
#undef WGMMA_W
#undef WGMMA_C32
#undef WGMMA_D32

// The register A operands of a swizzled tile, as the warp's 16 rows
// (16 w .. 16 w + 15 of the warpgroup's 64) for each k16 step, by ldmatrix:
// lane l reads row l % 16 of the warp's rows at chunk 2 kk + l / 16
__device__ __forceinline__ void ldmatrix_a_sw128(uint32_t (&a)[4][4], const unsigned char* tile) {
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], reinterpret_cast<const __nv_bfloat16*>(tile + sw128_offset(r, 8 * (2 * kk + (lane >> 4)))));
}

// zero the elements [D, 64) of each row of `tiles` consecutive swizzled
// tiles: the copies never write them, and the products read them as zeros
template <int kThreads>
__device__ __forceinline__ void zero_padding_sw128(unsigned char* tiles, int n_tiles, int D) {
  const int w = 64 - D;
  for (int idx = threadIdx.x; idx < n_tiles * 64 * w; idx += kThreads) {
    const int r = idx / w;
    *reinterpret_cast<__nv_bfloat16*>(tiles + (r >> 6) * kSwTileBytes + sw128_offset(r & 63, D + idx - r * w)) =
        __float2bfloat16_rn(0.f);
  }
}

// One thread's share of the 16-byte cp.async copies of 64 rows of a (T, D)
// bf16 head whose rows are 16-byte aligned into a swizzled tile, for a block
// of 128 threads: chunk column tid % 8 (unless it lies past D) of rows
// tid / 8 + 16 i, i < 4, which share one swizzle pattern, so their shared
// offsets are fixed and 2048 bytes apart. Rows past T are zero-filled
struct TileCopy {
  int r0, soff, goff;  // first row, its shared byte offset, its element offset in the tile's rows
  bool on;

  __device__ explicit TileCopy(int D)
      : r0(threadIdx.x >> 3),
        soff(sw128_offset(threadIdx.x >> 3, (threadIdx.x & 7) * 8)),
        goff((threadIdx.x >> 3) * D + (threadIdx.x & 7) * 8),
        on((threadIdx.x & 7) * 8 < D) {}

  __device__ __forceinline__ void operator()(unsigned char* tile, const __nv_bfloat16* head, int row0, int T,
                                             int D) const {
    if (!on) return;
    const __nv_bfloat16* src = head + static_cast<size_t>(row0) * D + goff;
    if (row0 + 64 <= T) {
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async16(tile + soff + 2048 * i, src + 16 * i * D, true);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = row0 + r0 + 16 * i < T;
        cp_async16(tile + soff + 2048 * i, in ? src + 16 * i * D : head, in);
      }
    }
  }
};

// rows [row0, row0 + 64) of a (T, D <= 64) bf16 head into a swizzled tile,
// element by element (rows of any alignment), rows past T zero-filled;
// plain stores, which finish before the __syncthreads that precedes the
// tile's use
template <int kThreads>
__device__ __forceinline__ void load_rows_sw128(unsigned char* tile, const __nv_bfloat16* head, int row0, int T,
                                                int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const bool in = row0 + r < T;
    *reinterpret_cast<__nv_bfloat16*>(tile + sw128_offset(r, c)) =
        in ? head[static_cast<size_t>(row0 + r) * D + c] : __float2bfloat16_rn(0.f);
  }
}

}  // namespace
