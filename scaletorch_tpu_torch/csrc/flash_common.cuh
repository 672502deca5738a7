// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// element conversion, tile loads from global into padded shared memory,
// warp reductions, and one tile product C (+)= A * B over shared memory.
//
// Every product of the three kernels goes through `tile_gemm`: A and B are
// tiles in shared memory, each row-major or column-major as the caller says
// (so Q*K^T, P*V, P^T*dO and dS^T*Q are one routine), and C is an fp32 tile
// in shared memory. For bf16 tiles the product runs on the tensor cores
// (`wmma` 16x16x16, fp32 accumulation); for fp32 tiles it is a plain fp32
// FMA loop, so fp32 keeps full precision (no TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;  // the Pallas kernels' mask value

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ __forceinline__ static float to(float x) { return x; }
  __device__ __forceinline__ static float from(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as astype(bfloat16) rounds
  __device__ __forceinline__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};

// Padding of a row of a T tile in shared memory: 16 bytes, which keeps
// 16-byte vector stores aligned and the wmma tile pointers 32-byte aligned
// at every 16-row boundary, and spreads rows over the banks.
template <typename T>
struct Pad {
  static constexpr int value = 16 / sizeof(T);
};

__host__ __device__ constexpr int round_up_128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Rows row0 .. row0+ROWS-1 of a [n_rows, D] row-major T matrix into the
// shared tile dst[ROWS][ld]; rows at or past n_rows are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Entries row0 .. row0+ROWS-1 of an fp32 vector; past n_rows they are 0.
template <int ROWS>
__device__ __forceinline__ void load_vector(float* dst, const float* src,
                                            int row0, int n_rows) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    dst[r] = (row0 + r < n_rows) ? src[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// C[M][N] (fp32, row-major, ldc) = (ACC ? C : 0) + A[M][K] * B[K][N].
//   A(m, k) = a[m * lda + k] if A_ROW else a[m + k * lda]
//   B(k, n) = b[k * ldb + n] if B_ROW else b[k + n * ldb]
// All of a, b and c live in shared memory. The caller synchronises before
// (A, B and C written) and after (C read).
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void tile_gemm(const T* a, int lda, const T* b,
                                          int ldb, float* c, int ldc) {
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "tile shape");
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<A_ROW, wmma::row_major,
                                              wmma::col_major>::type;
    using BLayout = typename std::conditional<B_ROW, wmma::row_major,
                                              wmma::col_major>::type;
    constexpr int FN = N / 16;
    constexpr int NF = (M / 16) * FN;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < NF; f += kWarps) {
      const int fm = f / FN;
      const int fn = f % FN;
      float* cp = c + fm * 16 * ldc + fn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACC) {
        wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.f);
      }
#pragma unroll
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
        const T* ap = A_ROW ? a + fm * 16 * lda + k : a + fm * 16 + k * lda;
        const T* bp = B_ROW ? b + k * ldb + fn * 16 : b + k + fn * 16 * ldb;
        wmma::load_matrix_sync(af, ap, lda);
        wmma::load_matrix_sync(bf, bp, ldb);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // a 16 x 16 grid of threads, each owning (M/16) x (N/16) entries of C
    // strided by 16 rows and 16 columns
    constexpr int TM = M / 16;
    constexpr int TN = N / 16;
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = ACC ? c[(tr + 16 * i) * ldc + tc + 16 * j] : 0.f;
      }
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tr + 16 * i;
        av[i] = Cvt<T>::to(A_ROW ? a[m * lda + k] : a[m + k * lda]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tc + 16 * j;
        bv[j] = Cvt<T>::to(B_ROW ? b[k * ldb + n] : b[k + n * ldb]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[(tr + 16 * i) * ldc + tc + 16 * j] = acc[i][j];
      }
    }
  }
}

// Causal mask of the Pallas kernels (query row >= key column, both counted
// from 0 of their own sequence), plus the ragged edge: key columns at or
// past the key count do not exist.
__device__ __forceinline__ bool masked(bool causal, int row, int col,
                                       int n_keys) {
  return col >= n_keys || (causal && col > row);
}

}  // namespace flash

extern "C" const char* st_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
