// Register-level building blocks for tensor-core kernels on Hopper (sm_90a):
//
//   * `mma_bf16`: one mma.sync m16n8k16, bf16 inputs, fp32 sums kept in
//     registers (D = A * B + D);
//   * `ldmatrix_x4` / `ldmatrix_x4_trans`: four 8x8 bf16 matrices from
//     shared memory into the fragment layout `mma_bf16` takes;
//   * `cp_async_16` / `cp_async_4` with `cp_async_commit` and
//     `cp_async_wait<N>`: copies from global into shared memory that run
//     beside the math, zero-filled where the source row does not exist;
//   * `SwizzledTile`: a tile of rows of 16-byte chunks whose chunk index is
//     XORed with (row % 8) (rows of 32 bf16, 64 bytes, pair up into one
//     128-byte line swizzled by the line's index; rows of 16 bf16, 32
//     bytes, share a line four at a time, odd lines swizzled by one
//     chunk), so the eight row addresses of one ldmatrix (or one 8-thread
//     phase of cp.async) fall on distinct banks without padding;
//   * `acc_to_a`: two m16n8 fp32 accumulators (16 columns) rounded to bf16
//     as the A fragment of the next m16n8k16, so a product's result (P, dS)
//     feeds the next product without leaving registers.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16", lane = 4 * g + t):
//   A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                         a[2] = (g, 2t+8..),    a[3] = (g+8, 2t+8..)
//   B (16x8, "col"):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C (16x8, fp32):       c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D += A * B on one warp; a: 4 x bf16x2, b: 2 x bf16x2, d: 4 x fp32.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lanes 8i..8i+7 give the row addresses of matrix i; lane 4g+t receives
// (row g, columns 2t, 2t+1) of matrix i in r[i] (`.trans`: rows 2t, 2t+1
// of column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid (src is then
// not read, but must still be a valid pointer).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)),
                 "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (for fp32 vectors whose rows are not 16-byte
// aligned); zero when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(__cvta_generic_to_global(src)),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier over `threads` threads (whole warps) under id 1..15; id 0 is
// __syncthreads()'s.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Round two floats to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of columns 16k..16k+7 (c0) and 16k+8..16k+15 (c1) as
// the A fragment of k-step k, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A [ROWS][COLS] bf16 tile in shared memory, row-major. COLS is 16, 32 or
// a multiple of 64. With COLS a multiple of 64, 16-byte chunk c of row r is
// stored at chunk c ^ (r % 8). With COLS 32, rows 2l and 2l + 1 share the
// 128-byte line l, whose eight chunks are XORed with (l % 8): eight rows
// r0 .. r0 + 7 (r0 % 8 == 0) of one chunk column then fall on eight
// distinct 16-byte bank groups. With COLS 16, rows 4l .. 4l + 3 share line
// l, whose chunks are XORed with (l % 2): the eight rows of one chunk
// column sit at even chunks of an even line and odd chunks of the odd line
// after it, again eight distinct bank groups (and a swizzle that depends
// only on row % 8, so ldmatrix's per-lane masks stay constants).
template <int ROWS, int COLS>
struct SwizzledTile {
  static_assert(COLS == 16 || COLS == 32 || COLS % 64 == 0,
                "rows of 16 or 32 bf16 or of whole 8-chunk swizzle groups");
  static constexpr int kChunks = COLS / 8;
  static constexpr int kRowBytes = COLS * 2;
  static constexpr int kBytes = ROWS * kRowBytes;
  // row -> line, and the bits of the line index that swizzle it
  static constexpr int kLineShift = COLS == 16 ? 2 : COLS == 32 ? 1 : 0;
  static constexpr int kLineMask = COLS == 16 ? 1 : 7;

  // The swizzle XORs byte-address bits 4..6 only; below a row pitch that
  // is a multiple of 128 those bits hold the chunk, at pitch 64 bit 6
  // holds the row's half of its line, at pitch 32 bits 5..6 the row's
  // quarter.
  __device__ __forceinline__ static uint32_t offset(int row, int chunk) {
    return (row * kRowBytes + (chunk << 4)) ^
           (((row >> kLineShift) & kLineMask) << 4);
  }

  // Rows row0.. of a [n_rows, COLS] row-major global matrix into the tile
  // at `base`, as 16-byte cp.async copies by THREADS threads; rows at or
  // past n_rows are zero.
  template <int THREADS>
  __device__ __forceinline__ static void load_async(
      uint32_t base, const __nv_bfloat16* src, int row0, int n_rows,
      int tid) {
    load_async_strided<THREADS>(base, src, COLS, row0, n_rows, tid);
  }

  // The same for COLS columns of a wider row-major matrix: row r starts at
  // src + r * ld (src points at the block's first column; ld and the
  // column offset keep 16-byte alignment). Chunks at or past column
  // n_cols of the block are zero too (n_cols a multiple of 8).
  template <int THREADS>
  __device__ __forceinline__ static void load_async_strided(
      uint32_t base, const __nv_bfloat16* src, size_t ld, int row0,
      int n_rows, int tid, int n_cols = COLS) {
    constexpr int kTotal = ROWS * kChunks;
    static_assert(kTotal % THREADS == 0 || kTotal < THREADS,
                  "whole passes, or one pass by the first kTotal threads");
#pragma unroll
    for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      if (kTotal < THREADS && idx >= kTotal) break;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const bool valid = row0 + r < n_rows && c * 8 < n_cols;
      const __nv_bfloat16* p =
          valid ? src + (size_t)(row0 + r) * ld + c * 8 : src;
      cp_async_16(base + offset(r, c), p, valid);
    }
  }
};

// Per-lane constants of the ldmatrix addresses into a SwizzledTile
// (lane = threadIdx.x % 32). Tiles are addressed in 16-row, 16-column
// blocks (row0 % 16 == 0, col0 % 16 == 0), so the swizzle of every row a
// lane addresses is the lane's own:
//   * `a_row`, `a_x16`: the A operand of rows m0.. (row-major [m][k]) and
//     the B operand of a [k][n] row-major tile through `.trans`: lane l
//     addresses row m0 + l % 16, chunk k0 / 8 + l / 16;
//   * `b_row`, `b_x16`: the B operand of an [n][k] row-major tile (no
//     transpose), and the A operand of a [k][m] tile through `.trans`:
//     lane l addresses row n0 + l % 8 + 8 * (l / 16), chunk
//     k0 / 8 + (l / 8) % 2. One x4 load gives b[0], b[1] of n-tiles n0 and
//     n0 + 8 (or a[0..3] of the 16 x 16 A block at (m0, k0)).
// `*_x16` is the lane's chunk bit and its row's swizzle, folded into the
// XOR mask of byte-address bits 4..6, for a row pitch that is a multiple
// of 128 bytes; `*_x16n` is the same for the 64-byte rows of 32 bf16,
// `*_x16q` for the 32-byte rows of 16 bf16 (whose one 16-column block is
// col0 0: a column offset would carry into the row bits).
struct LaneAddr {
  int a_row, b_row;
  uint32_t a_x16, b_x16, a_x16n, b_x16n, a_x16q, b_x16q;
  __device__ __forceinline__ explicit LaneAddr(int lane)
      : a_row(lane & 15),
        b_row((lane & 7) | ((lane >> 4) << 3)),
        a_x16(((lane >> 4) ^ (lane & 7)) << 4),
        b_x16((((lane >> 3) & 1) ^ (lane & 7)) << 4),
        a_x16n(((lane >> 4) ^ ((lane & 15) >> 1)) << 4),
        b_x16n((((lane >> 3) & 1) ^ ((lane & 7) >> 1) ^
                ((lane >> 4) << 2)) << 4),
        a_x16q((((lane >> 4) ^ (lane >> 2)) & 1) << 4),
        b_x16q((((lane >> 3) ^ (lane >> 2)) & 1) << 4) {}
};

template <int ROW_BYTES>
__device__ __forceinline__ uint32_t a_mask(const LaneAddr& l) {
  return ROW_BYTES == 32 ? l.a_x16q : ROW_BYTES == 64 ? l.a_x16n : l.a_x16;
}

template <int ROW_BYTES>
__device__ __forceinline__ uint32_t b_mask(const LaneAddr& l) {
  return ROW_BYTES == 32 ? l.b_x16q : ROW_BYTES == 64 ? l.b_x16n : l.b_x16;
}

// The lane's ldmatrix row address for the 16x16 block at (row0, col0) of
// a SwizzledTile at shared address `tile` (a multiple of 128) with row
// pitch ROW_BYTES. The unswizzled address of the block's chunk has the
// lane's chunk bit (bit 4) clear and carries nothing out of bits 4..6, so
// the swizzle is one XOR after an add whose row0, col0 part is a constant.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t a_addr(const LaneAddr& l, uint32_t tile,
                                           int row0, int col0) {
  return (tile + (row0 + l.a_row) * ROW_BYTES + col0 * 2) ^
         a_mask<ROW_BYTES>(l);
}

template <int ROW_BYTES>
__device__ __forceinline__ uint32_t b_addr(const LaneAddr& l, uint32_t tile,
                                           int row0, int col0) {
  return (tile + (row0 + l.b_row) * ROW_BYTES + col0 * 2) ^
         b_mask<ROW_BYTES>(l);
}

}  // namespace mma
