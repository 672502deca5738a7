// Grouped per-expert SwiGLU MLP forward (K5), written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// scaletorch_tpu/ops/pallas/grouped_mlp.py (launched by `_forward`). Same
// function: for every (expert e, group g) with fill count n = counts[e, g]
// and every slot row c < n,
//   h[c]   = silu(x[c] Wg[e]) * (x[c] Wu[e])     fp32, rounded to x's dtype
//   out[c] = h[c] Wd[e]                          fp32 sum, written in x's dtype
// and out[c] = 0 for every row c >= n, in skipped tiles too.
// x [E, G, C, H], counts [E, G] int32, wg/wu [E, H, I], wd [E, I, H].
//
// What bounds it on the H100: bytes at the serving and training shapes
// (each expert with a filled slot reads 3 H I weights for a few dozen to a
// few hundred rows: 6 H I flops a row against 6 H I bytes an expert).
//
// Design. The TPU kernel keeps a [bc, H] fp32 accumulator across its I
// loop; at H = 2048 that is 512 KB for 64 rows, past the 227 KB a CTA can
// have. So K5 is two launches over an [E, G, C, I] workspace:
//   1. up:   one CTA per (64 I-columns, slot tile of BM rows, (e, g))
//            computes x Wg and x Wu over H, applies swiglu, and writes h
//            rounded to x's dtype (exactly the TPU kernel's rounding
//            before its down product);
//   2. down: one CTA per (64 H-columns, slot tile, (e, g)) computes h Wd
//            over I and writes out, zero past the fill count.
// A slot tile that starts at or past the fill count is skipped before any
// load: the up CTA returns, the down CTA writes its zeros. Rows of a
// partial tile past the count load as zeros and are written as zeros.
// BM is 16 when C <= 16 (decode: one slot a group) and 64 otherwise.
// What it leaves on the table: synchronous tile loads (no cp.async/TMA),
// wmma instead of wgmma, the h round trip through device memory, and one
// CTA per tile even where the tile is empty.
//
// The C entry returns the cudaError_t of cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape it was not built for). It
// launches on the caller's stream, allocates nothing, does not synchronise.

#include "grouped_mlp_common.cuh"

namespace {

using namespace gmlp;

template <typename T, int BM>
struct UpSmem {
  static constexpr int LDA = BK + Pad<T>::value;
  static constexpr int LDB = BN + Pad<T>::value;
  static constexpr int LDC = BN + 4;
  static constexpr int kA = 0;
  static constexpr int kBg = kA + round_up_128(BM * LDA * sizeof(T));
  static constexpr int kBu = kBg + round_up_128(BK * LDB * sizeof(T));
  static constexpr int kStage = kBu + round_up_128(BK * LDB * sizeof(T));
  // the fp32 epilogue tiles reuse the staging tiles after the k loop
  static constexpr int kCu = round_up_128(BM * LDC * 4);
  static constexpr int kEpi = 2 * kCu;
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gmlp_up_kernel(const T* __restrict__ x, const int* __restrict__ counts,
               const T* __restrict__ wg, const T* __restrict__ wu,
               T* __restrict__ h, int groups, int cap, int hid, int inter) {
  using L = UpSmem<T, BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int count = fill_count(counts, eg, cap);
  if (row0 >= count) return;  // nothing of this tile is read downstream
  const int e = eg / groups;
  const int n0 = blockIdx.x * BN;
  T* a_s = reinterpret_cast<T*>(smem + L::kA);
  T* bg_s = reinterpret_cast<T*>(smem + L::kBg);
  T* bu_s = reinterpret_cast<T*>(smem + L::kBu);
  float* cg_s = reinterpret_cast<float*>(smem);
  float* cu_s = reinterpret_cast<float*>(smem + L::kCu);

  const T* x_eg = x + (size_t)eg * cap * hid;
  const T* wg_e = wg + (size_t)e * hid * inter;
  const T* wu_e = wu + (size_t)e * hid * inter;
  TileAcc<T, BM, BN> acc_g, acc_u;
  acc_g.zero();
  acc_u.zero();
  for (int k0 = 0; k0 < hid; k0 += BK) {
    __syncthreads();  // the previous step is done with the tiles
    load_tile<T, BM, BK>(a_s, L::LDA, x_eg, hid, row0, k0, count);
    load_tile<T, BK, BN>(bg_s, L::LDB, wg_e, inter, k0, n0, hid);
    load_tile<T, BK, BN>(bu_s, L::LDB, wu_e, inter, k0, n0, hid);
    __syncthreads();
    acc_g.template mma<BK, true, true>(a_s, L::LDA, bg_s, L::LDB);
    acc_u.template mma<BK, true, true>(a_s, L::LDA, bu_s, L::LDB);
  }
  __syncthreads();
  acc_g.store(cg_s, L::LDC);
  acc_u.store(cu_s, L::LDC);
  __syncthreads();
  const int rows = min(BM, cap - row0);
  T* h_t = h + ((size_t)eg * cap + row0) * inter + n0;
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const float g = cg_s[r * L::LDC + c];
    const float u = cu_s[r * L::LDC + c];
    h_t[(size_t)r * inter + c] = Cvt<T>::from(g * sigmoid(g) * u);
  }
}

template <typename T, int BM>
struct DownSmem {
  static constexpr int LDA = BK + Pad<T>::value;
  static constexpr int LDB = BN + Pad<T>::value;
  static constexpr int LDC = BN + 4;
  static constexpr int kA = 0;
  static constexpr int kB = kA + round_up_128(BM * LDA * sizeof(T));
  static constexpr int kStage = kB + round_up_128(BK * LDB * sizeof(T));
  static constexpr int kEpi = round_up_128(BM * LDC * 4);
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gmlp_down_kernel(const T* __restrict__ h, const int* __restrict__ counts,
                 const T* __restrict__ wd, T* __restrict__ out, int groups,
                 int cap, int hid, int inter) {
  using L = DownSmem<T, BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int count = fill_count(counts, eg, cap);
  const int rows = min(BM, cap - row0);
  T* out_t = out + ((size_t)eg * cap + row0) * hid + n0;
  if (row0 >= count) {  // a tile past the fill count: structural zeros
    for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
      out_t[(size_t)(idx / BN) * hid + idx % BN] = Cvt<T>::from(0.f);
    }
    return;
  }
  const int e = eg / groups;
  T* a_s = reinterpret_cast<T*>(smem + L::kA);
  T* b_s = reinterpret_cast<T*>(smem + L::kB);
  float* c_s = reinterpret_cast<float*>(smem);

  const T* h_eg = h + (size_t)eg * cap * inter;
  const T* wd_e = wd + (size_t)e * inter * hid;
  TileAcc<T, BM, BN> acc;
  acc.zero();
  for (int k0 = 0; k0 < inter; k0 += BK) {
    __syncthreads();
    load_tile<T, BM, BK>(a_s, L::LDA, h_eg, inter, row0, k0, count);
    load_tile<T, BK, BN>(b_s, L::LDB, wd_e, hid, k0, n0, inter);
    __syncthreads();
    acc.template mma<BK, true, true>(a_s, L::LDA, b_s, L::LDB);
  }
  __syncthreads();
  acc.store(c_s, L::LDC);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const float v = (row0 + r < count) ? c_s[r * L::LDC + c] : 0.f;
    out_t[(size_t)r * hid + c] = Cvt<T>::from(v);
  }
}

struct Args {
  const void *x, *counts, *wg, *wu, *wd;
  void *h, *out;
  int experts, groups, cap, hid, inter;
  cudaStream_t stream;
};

template <typename T, int BM>
cudaError_t launch(const Args& a) {
  auto up = gmlp_up_kernel<T, BM>;
  auto down = gmlp_down_kernel<T, BM>;
  constexpr int up_bytes = UpSmem<T, BM>::kBytes;
  constexpr int down_bytes = DownSmem<T, BM>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, up_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      down, cudaFuncAttributeMaxDynamicSharedMemorySize, down_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.cap + BM - 1) / BM;
  const int eg = a.experts * a.groups;
  up<<<dim3(a.inter / BN, tiles, eg), kThreads, up_bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.wg), static_cast<const T*>(a.wu),
      static_cast<T*>(a.h), a.groups, a.cap, a.hid, a.inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<dim3(a.hid / BN, tiles, eg), kThreads, down_bytes, a.stream>>>(
      static_cast<const T*>(a.h), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.wd), static_cast<T*>(a.out), a.groups, a.cap,
      a.hid, a.inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const Args& a) {
  return a.cap <= 16 ? launch<T, 16>(a) : launch<T, 64>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, the weights, h and out share it).
// h is an [E, G, C, I] workspace the caller allocates; out is [E, G, C, H].
extern "C" int st_grouped_mlp_fwd(const void* x, const void* counts,
                                  const void* wg, const void* wu,
                                  const void* wd, void* h, void* out,
                                  int experts, int groups, int cap, int hid,
                                  int inter, int dtype, void* stream) {
  if (!shapes_ok(experts, groups, cap, hid, inter) || h == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Args a{x, counts, wg, wu, wd, h, out, experts, groups, cap, hid,
               inter, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_rows<float>(a);
    case 1: return dispatch_rows<__nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}
