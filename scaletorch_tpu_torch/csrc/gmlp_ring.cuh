// The pipelined grouped GEMM under the bf16 grouped-MLP kernels, on
// tensor-core mma.sync for Hopper (sm_90a, mma_sm90.cuh): K5's two
// launches (grouped_mlp_fwd.cu), and the grads pass, K6 and K7
// (grouped_mlp_bwd.cu).
//
//   * `Warps`: the warp grid over a BM x BN output tile.
//   * `Ring`: a STAGES-deep cp.async ring over k steps: the copies of step
//     s + STAGES - 1 run beside the products of step s, with one barrier a
//     step. What a stage holds is the caller's: its loader fills it.
//   * `Products`: one k step (64 deep) of a plan of products on the warp's
//     block, acc[acc_of(p)] += A[a_of(p)] * B[p], the fp32 sums in
//     registers. Several products may share an A operand (x Wg and x Wu)
//     or an accumulator (dG Wg^T + dU Wu^T). An A operand is a row-major
//     [BM][64] tile (ldmatrix), or, with the plan's kATrans, a [64][BM]
//     tile whose rows are the k dimension (ldmatrix.trans: x^T and s^T in
//     K7). A B operand is a row-major [64][BN] tile (ldmatrix.trans: the
//     weights in K5, dG / dU / dO in K7) or, with b_col(p), a [BN][64]
//     tile of a weight read transposed (ldmatrix: Wd^T in the grads pass,
//     Wg^T and Wu^T in K6). Every tile is a SwizzledTile; the callers load
//     rows at or past a fill count as zero-size copies, so they add 0.
//   * `for_each_pair`, `stage_tile`, `store_tile`, `store_warp_block`,
//     `store_zeros`: the epilogue. A warp's accumulator pairs go as bf16
//     into a swizzled [BM][BN] tile (a drained ring) and leave in 16-byte
//     stores, or, mid-loop (K7), into the warp's own block, which the warp
//     stores alone.
//
// A plan P is a struct of
//   kNA, kNP, kNAcc          A operands, products (= B operands), sums
//   kATrans                  the A tiles are [64][BM] (k rows)
//   a_of(p), acc_of(p)       product p's A operand and accumulator
//   b_col(p)                 product p's B tile is [BN][64]

#pragma once

#include "grouped_mlp_common.cuh"
#include "mma_sm90.cuh"

namespace gring {

using bf16 = __nv_bfloat16;
constexpr int BK = 64;  // depth of one k step

template <int BM_, int BN_, int WM_, int WN_>
struct Warps {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WM = WM_;
  static constexpr int WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MW = BM / WM;  // rows of a warp
  static constexpr int NW = BN / WN;  // columns of a warp
  static constexpr int MT = MW / 16;  // its m-tiles
  static constexpr int NT = NW / 8;   // its n-tiles
  static_assert(MW % 16 == 0 && NW % 16 == 0, "whole 16 x 16 blocks");
  using OTile = mma::SwizzledTile<BM, BN>;  // the output tile, staged

  __device__ __forceinline__ static int m0() {
    return (threadIdx.x >> 5) / WN * MW;
  }
  __device__ __forceinline__ static int n0() {
    return (threadIdx.x >> 5) % WN * NW;
  }
};

template <int STAGES>
struct Ring {
  static_assert(STAGES >= 2, "a ring of at least two stages");

  // Steps 0 .. n-1: load(s, slot) issues step s's copies into ring slot
  // s % STAGES; compute(s, slot) runs once they have landed. Every thread
  // of the CTA calls run(). Copies issued before run() land with step 0's.
  // On return the ring is drained and every warp is done with it.
  template <typename Load, typename Compute>
  __device__ __forceinline__ static void run(int n, const Load& load,
                                             const Compute& compute) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n) load(s, s);
      mma::cp_async_commit();  // one group per step, empty or not
    }
    for (int s = 0; s < n; ++s) {
      mma::cp_async_wait<STAGES - 2>();  // step s
      __syncthreads();  // ... seen by all; step s - 1's slot is free
      if (s + STAGES - 1 < n) {
        load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      }
      mma::cp_async_commit();
      compute(s, s % STAGES);
    }
    mma::cp_async_wait<0>();
    __syncthreads();
  }
};

template <typename W, typename P>
struct Products {
  static constexpr int kARowBytes = P::kATrans ? W::BM * 2 : BK * 2;
  using Acc = float[P::kNAcc][W::MT][W::NT][4];

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < P::kNAcc; ++i) {
#pragma unroll
      for (int mt = 0; mt < W::MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < W::NT; ++nt) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][mt][nt][v] = 0.f;
        }
      }
    }
  }

  // One k step: a[i] is the shared address of A operand i's tile, b[p]
  // that of product p's B tile; (m0, n0) the warp's block.
  __device__ __forceinline__ static void step(Acc& acc,
                                              const uint32_t (&a)[P::kNA],
                                              const uint32_t (&b)[P::kNP],
                                              const mma::LaneAddr& la,
                                              int m0, int n0) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[P::kNA][W::MT][4];
#pragma unroll
      for (int i = 0; i < P::kNA; ++i) {
#pragma unroll
        for (int mt = 0; mt < W::MT; ++mt) {
          if constexpr (P::kATrans) {
            mma::ldmatrix_x4_trans(
                af[i][mt],
                mma::b_addr<kARowBytes>(la, a[i], kk * 16, m0 + mt * 16));
          } else {
            mma::ldmatrix_x4(
                af[i][mt],
                mma::a_addr<kARowBytes>(la, a[i], m0 + mt * 16, kk * 16));
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P::kNP; ++p) {
#pragma unroll
        for (int np = 0; np < W::NT / 2; ++np) {
          uint32_t bf[4];
          if (P::b_col(p)) {
            mma::ldmatrix_x4(
                bf, mma::b_addr<BK * 2>(la, b[p], n0 + np * 16, kk * 16));
          } else {
            mma::ldmatrix_x4_trans(
                bf, mma::a_addr<W::BN * 2>(la, b[p], kk * 16, n0 + np * 16));
          }
#pragma unroll
          for (int mt = 0; mt < W::MT; ++mt) {
            mma::mma_bf16(acc[P::acc_of(p)][mt][2 * np], af[P::a_of(p)][mt],
                          bf[0], bf[1]);
            mma::mma_bf16(acc[P::acc_of(p)][mt][2 * np + 1],
                          af[P::a_of(p)][mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
};

// f(row, col, mt, nt, x) for each accumulator pair this lane holds: the
// entries acc[.][mt][nt][2x], [2x + 1] at (row, col), (row, col + 1) of
// the BM x BN tile.
template <typename W, typename F>
__device__ __forceinline__ void for_each_pair(const F& f) {
  const int lane = threadIdx.x & 31;
  const int m0 = W::m0();
  const int n0 = W::n0();
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt) {
      const int col = n0 + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        f(m0 + mt * 16 + (lane >> 2) + 8 * x, col, mt, nt, x);
      }
    }
  }
}

// The byte offset of the pair at (row, col) in a staged output tile.
template <typename W>
__device__ __forceinline__ uint32_t pair_offset(int row, int col) {
  return W::OTile::offset(row, col / 8) + (col % 8) * 2;
}

// The warp's pairs f(row, mt, nt, x) (packed bf16x2) into the staged
// output tile at `tile`.
template <typename W, typename F>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const F& f) {
  for_each_pair<W>([&](int row, int col, int mt, int nt, int x) {
    *reinterpret_cast<uint32_t*>(tile + pair_offset<W>(row, col)) =
        f(row, mt, nt, x);
  });
}

// Rows < rows and columns < cols of the staged tile to dst (row stride
// ld), 16 bytes a copy.
template <typename W>
__device__ __forceinline__ void store_tile(const unsigned char* tile,
                                           bf16* dst, size_t ld, int rows,
                                           int cols = W::BN) {
  using O = typename W::OTile;
  for (int idx = threadIdx.x; idx < W::BM * O::kChunks; idx += W::kThreads) {
    const int r = idx / O::kChunks;
    const int c = idx % O::kChunks;
    if (r < rows && c * 8 < cols) {
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(tile + O::offset(r, c));
    }
  }
}

// The warp's own MW x NW block of the output, f(row, mt, nt, x) (packed
// bf16x2), staged in the warp's own swizzled tile at `tile` and stored by
// the warp alone, 16 bytes a copy, rows < rows of dst (row stride ld): no
// barrier across the CTA, so the other warps go on with their products.
template <typename W, typename F>
__device__ __forceinline__ void store_warp_block(unsigned char* tile,
                                                 bf16* dst, size_t ld,
                                                 int rows, const F& f) {
  using T = mma::SwizzledTile<W::MW, W::NW>;
  const int lane = threadIdx.x & 31;
  const int m0 = W::m0();
  const int n0 = W::n0();
  for_each_pair<W>([&](int row, int col, int mt, int nt, int x) {
    *reinterpret_cast<uint32_t*>(tile + T::offset(row - m0, (col - n0) / 8) +
                                 (col % 8) * 2) = f(row, mt, nt, x);
  });
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < W::MW * T::kChunks; idx += 32) {
    const int r = idx / T::kChunks;
    const int c = idx % T::kChunks;
    if (m0 + r < rows) {
      *reinterpret_cast<uint4*>(dst + (size_t)(m0 + r) * ld + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(tile + T::offset(r, c));
    }
  }
  __syncwarp();  // read before the warp stages its next block here
}

// Zeros into rows < rows and columns < cols of a BM x BN block of dst.
template <typename W>
__device__ __forceinline__ void store_zeros(bf16* dst, size_t ld, int rows,
                                            int cols = W::BN) {
  constexpr int kChunks = W::BN / 8;
  for (int idx = threadIdx.x; idx < W::BM * kChunks; idx += W::kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    if (r < rows && c * 8 < cols) {
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

}  // namespace gring
