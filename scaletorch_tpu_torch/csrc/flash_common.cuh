// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// element conversion, tile loads from global into padded shared memory,
// warp reductions, the fp32 paths' tile product C (+)= A * B over shared
// memory, and the launch helpers.
//
// The bf16 kernels run on mma.sync with register accumulators
// (mma_sm90.cuh). The fp32 kernels put every product through `tile_gemm`:
// A and B are tiles in shared memory, each row-major or column-major as the
// caller says (so Q*K^T, P*V, P^T*dO and dS^T*Q are one routine), and C is
// an fp32 tile in shared memory, summed as plain fp32 FMAs (no TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;  // the Pallas kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ __forceinline__ static float from(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
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
// (A, B and C written) and after (C read). A 16 x 16 grid of threads, each
// owning (M/16) x (N/16) entries of C strided by 16 rows and 16 columns.
template <int M, int N, int K, bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void tile_gemm(const float* a, int lda,
                                          const float* b, int ldb, float* c,
                                          int ldc) {
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "tile shape");
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

// Causal mask of the Pallas kernels (query row >= key column, both counted
// from 0 of their own sequence), plus the ragged edge: key columns at or
// past the key count do not exist.
__device__ __forceinline__ bool masked(bool causal, int row, int col,
                                       int n_keys) {
  return col >= n_keys || (causal && col > row);
}

// Let `kernel` take `bytes` of dynamic shared memory, with the SM's
// shared-memory carve-out at its largest.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A 1-D grid of tiles x heads x batch, or cudaErrorInvalidValue past 2^31.
inline cudaError_t grid_1d(int tiles, int heads, int batch, dim3* grid) {
  const long long n = (long long)tiles * heads * batch;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(n));
  return cudaSuccess;
}

}  // namespace flash

extern "C" const char* st_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
