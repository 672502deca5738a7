// Shared pieces of the grouped-MLP kernels (grouped_mlp_fwd.cu: K5,
// grouped_mlp_bwd.cu: K6 and K7): the tile sizes, a tile load from global
// into padded shared memory that zero-fills rows past a limit (the fill
// count), and a register accumulator for one BM x BN fp32 output tile.
//
// Every product of the three kernels is a sum over k steps of
// A[BM][BK] * B[BK][BN] with A and B staged in shared memory, each
// row-major or column-major as the caller says. bf16 tiles run on the
// tensor cores (wmma 16x16x16, fp32 accumulation, the fragments held in
// registers across the k loop); fp32 tiles run as plain fp32 FMAs (no
// TF32), each thread owning a 16-strided sub-grid of the output tile.

#pragma once

#include "flash_common.cuh"

namespace gmlp {

using flash::Cvt;
using flash::kThreads;
using flash::kWarps;
using flash::Pad;
using flash::round_up_128;

constexpr int BN = 64;  // output columns of one CTA
constexpr int BK = 64;  // depth of one k step (and rows of one dW step)
constexpr int BW = 64;  // dW output rows of one CTA

// counts outside [0, C] are clamped: a row past C does not exist
__device__ __forceinline__ int fill_count(const int* counts, int eg, int c) {
  return min(max(counts[eg], 0), c);
}

// Rows r0 .. r0+R-1 and columns c0 .. c0+CC-1 of the row-major matrix src
// (row stride ld_src elements) into dst[R][ld_dst]; rows at or past
// row_limit are zero. 16-byte vectors: c0 and ld_src keep them aligned.
template <typename T, int R, int CC>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* src,
                                          size_t ld_src, int r0, int c0,
                                          int row_limit) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = CC / kVec;
  static_assert(CC % kVec == 0, "tile width");
  for (int idx = threadIdx.x; idx < R * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < row_limit) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld_src + c0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = val;
  }
}

// fp32 accumulator of a BM x BN output tile, kept in registers.
//   mma<K, A_ROW, B_ROW>(a, lda, b, ldb): C += A[BM][K] * B[K][N] with
//     A(m, k) = a[m * lda + k] if A_ROW else a[m + k * lda]
//     B(k, n) = b[k * ldb + n] if B_ROW else b[k + n * ldb]
//   store(c, ldc): the tile into fp32 shared memory, row-major.
template <typename T, int BM, int BNT>
struct TileAcc;

template <int BM, int BNT>
struct TileAcc<float, BM, BNT> {
  static_assert(BM % 16 == 0 && BNT % 16 == 0, "tile shape");
  static constexpr int TM = BM / 16;
  static constexpr int TN = BNT / 16;
  float v[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
    }
  }

  template <int K, bool A_ROW, bool B_ROW>
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b,
                                      int ldb) {
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tr + 16 * i;
        av[i] = A_ROW ? a[m * lda + k] : a[m + k * lda];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tc + 16 * j;
        bv[j] = B_ROW ? b[k * ldb + n] : b[k + n * ldb];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) const {
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[(tr + 16 * i) * ldc + tc + 16 * j] = v[i][j];
      }
    }
  }
};

template <int BM, int BNT>
struct TileAcc<__nv_bfloat16, BM, BNT> {
  static_assert(BM % 16 == 0 && BNT % 16 == 0, "tile shape");
  static constexpr int FN = BNT / 16;
  static constexpr int NF = (BM / 16) * FN;
  static constexpr int PER = (NF + kWarps - 1) / kWarps;  // fragments a warp
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[PER];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < PER; ++j) nvcuda::wmma::fill_fragment(f[j], 0.f);
  }

  template <int K, bool A_ROW, bool B_ROW>
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda,
                                      const __nv_bfloat16* b, int ldb) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<A_ROW, wmma::row_major,
                                              wmma::col_major>::type;
    using BLayout = typename std::conditional<B_ROW, wmma::row_major,
                                              wmma::col_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = warp + j * kWarps;
      if (idx < NF) {  // warp-uniform
        const int fm = idx / FN;
        const int fn = idx % FN;
#pragma unroll
        for (int k = 0; k < K; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
          const __nv_bfloat16* ap =
              A_ROW ? a + fm * 16 * lda + k : a + fm * 16 + k * lda;
          const __nv_bfloat16* bp =
              B_ROW ? b + k * ldb + fn * 16 : b + k + fn * 16 * ldb;
          wmma::load_matrix_sync(af, ap, lda);
          wmma::load_matrix_sync(bf, bp, ldb);
          wmma::mma_sync(f[j], af, bf, f[j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = warp + j * kWarps;
      if (idx < NF) {
        nvcuda::wmma::store_matrix_sync(
            c + (idx / FN) * 16 * ldc + (idx % FN) * 16, f[j], ldc,
            nvcuda::wmma::mem_row_major);
      }
    }
  }
};

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// The entries' shape check: every width a multiple of the 64-wide tiles,
// the (expert, group) count within the grid's z limit.
inline bool shapes_ok(int e, int g, int c, int h, int i) {
  return e >= 1 && g >= 1 && c >= 1 && h >= 64 && i >= 64 && h % 64 == 0 &&
         i % 64 == 0 && (long long)e * g <= 65535 && c <= 65535 * 16;
}

}  // namespace gmlp
