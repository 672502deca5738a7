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
//
// bf16: a pipelined grouped GEMM on tensor-core mma.sync (the ring of
// gmlp_ring.cuh, shared with the backward's kernels).
//   * Each k step (64 deep) moves the A tile (x, then h) and the weight
//     tiles (Wg and Wu, then Wd) into XOR-swizzled shared memory through a
//     four-stage cp.async ring: three steps of weights (up to 48 KB a CTA,
//     two to five CTAs an SM) are in flight while one is multiplied,
//     which is what a byte-bound kernel needs to come near HBM bandwidth.
//     A rows past the fill count are zero-size copies.
//   * A comes in through ldmatrix, the row-major [k][n] weights through
//     ldmatrix.trans; the sums are m16n8k16 accumulators in registers.
//     At BM 64 the 4 warps split the 64 x 64 tile 2 x 2 (32 x 32 each);
//     at BM 16 they split N (16 x 16 each).
//   * up keeps x Wg and x Wu in registers and applies swiglu there; down
//     applies the count mask there. Both stage their tile through the free
//     ring so the stores to global are 16 bytes wide.
//   * BN = 64 for both launches: at the training shape (E 128, G 1, C 320,
//     H 2048, I 768) an expert with every slot filled has 12 x 5 up and
//     32 x 5 down CTAs, 7680 and 20480 in all, tens of waves on 132 SMs;
//     BN 128 would halve the A re-reads but needs H % 128 == 0 and, for up,
//     40 KB stages (one CTA an SM at four stages).
// What it still leaves: every 64-row slot tile of an expert reads that
// expert's weights again, and every 64-column tile its A rows again (from
// L2, whose bandwidth the training shape then leans on: a 64 x 64 output
// tile does 32-43 flops per byte it loads); the h round trip through
// device memory; mma.sync instead of wgmma + TMA.
// fp32: shared-memory tiles with the register accumulator's fp32
// FMA products (grouped_mlp_common.cuh, no TF32).
//
// The C entry returns the cudaError_t of cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a shape it was not built for). It
// launches on the caller's stream, allocates nothing, does not synchronise.

#include "gmlp_ring.cuh"

namespace {

using namespace gmlp;
using bf16 = __nv_bfloat16;

// ---- bf16 on mma.sync (gmlp_ring.cuh) ------------------------------------------------
namespace k5 {
constexpr int kStages = 4;  // ring depth
static_assert(BN == 64 && BK == gring::BK, "64 x 64 swizzled tiles");

// The warp grid over a BM x BN output tile: 2 x 2 warps of 32 x 32 at BM
// 64, 1 x 4 warps of 16 x 16 at BM 16.
template <int BM>
using Warps = gring::Warps<BM, BN, (BM >= 32 ? 2 : 1), (BM >= 32 ? 2 : 4)>;

// up: x Wg and x Wu, sharing x; down: h Wd
template <int NB>
struct Plan {
  static constexpr int kNA = 1, kNP = NB, kNAcc = NB;
  static constexpr bool kATrans = false;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int acc_of(int p) { return p; }
  __host__ __device__ static constexpr bool b_col(int) { return false; }
};

// A stage: the A tile [BM][BK], then NB weight tiles [BK][BN].
template <int BM, int NB>
struct Layout {
  using ATile = mma::SwizzledTile<BM, BK>;
  using BTile = mma::SwizzledTile<BK, BN>;
  static constexpr int kStageBytes = ATile::kBytes + NB * BTile::kBytes;
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(Warps<BM>::OTile::kBytes <= kBytes,
                "the output tile fits the ring");
};

// sum over k < depth of A[BM][k] * B_i[k][BN] for the NB weight matrices
// B_i, into acc[i] of this warp's block. a: the A matrix's row 0, column 0
// (row stride lda); A's rows at or past `count` load as zeros. b[i]: the
// weight matrix i's first column of this CTA (row stride ldb).
template <int BM, int NB>
__device__ __forceinline__ void ring_gemm(
    typename gring::Products<Warps<BM>, Plan<NB>>::Acc& acc, uint32_t base,
    const bf16* a, size_t lda, int row0, int count,
    const bf16* const (&b)[NB], size_t ldb, int depth) {
  using W = Warps<BM>;
  using L = Layout<BM, NB>;
  using Pr = gring::Products<W, Plan<NB>>;
  const int tid = threadIdx.x;
  const mma::LaneAddr la(tid & 31);
  const int m0 = W::m0();
  const int n0 = W::n0();
  Pr::zero(acc);
  gring::Ring<kStages>::run(
      depth / BK,
      [&](int kt, int slot) {
        const uint32_t dst = base + slot * L::kStageBytes;
        L::ATile::template load_async_strided<W::kThreads>(
            dst, a + kt * BK, lda, row0, count, tid);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          L::BTile::template load_async_strided<W::kThreads>(
              dst + L::ATile::kBytes + i * L::BTile::kBytes,
              b[i] + (size_t)kt * BK * ldb, ldb, 0, BK, tid);
        }
      },
      [&](int, int slot) {
        const uint32_t as = base + slot * L::kStageBytes;
        const uint32_t at[1] = {as};
        uint32_t bt[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          bt[i] = as + L::ATile::kBytes + i * L::BTile::kBytes;
        }
        Pr::step(acc, at, bt, la, m0, n0);
      });
}
}  // namespace k5

template <int BM>
__global__ void __launch_bounds__(k5::Warps<BM>::kThreads, 2)
gmlp_up_mma_kernel(const bf16* __restrict__ x, const int* __restrict__ counts,
                   const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                   bf16* __restrict__ h, int groups, int cap, int hid,
                   int inter) {
  using W = k5::Warps<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int count = fill_count(counts, eg, cap);
  if (row0 >= count) return;  // nothing of this tile is read downstream
  const int e = eg / groups;
  const int n0 = blockIdx.x * BN;
  const size_t w0 = (size_t)e * hid * inter + n0;
  const bf16* const b[2] = {wg + w0, wu + w0};
  typename gring::Products<W, k5::Plan<2>>::Acc acc;  // x Wg, x Wu
  k5::ring_gemm<BM, 2>(acc, mma::smem_u32(smem), x + (size_t)eg * cap * hid,
                       hid, row0, count, b, inter, hid);
  gring::stage_tile<W>(smem, [&](int, int mt, int nt, int xr) {
    float v[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const float g = acc[0][mt][nt][2 * xr + y];
      v[y] = g * sigmoid(g) * acc[1][mt][nt][2 * xr + y];
    }
    return mma::pack_bf16(v[0], v[1]);
  });
  __syncthreads();
  gring::store_tile<W>(smem, h + ((size_t)eg * cap + row0) * inter + n0,
                       inter, min(BM, cap - row0));
}

template <int BM>
__global__ void __launch_bounds__(k5::Warps<BM>::kThreads, 2)
gmlp_down_mma_kernel(const bf16* __restrict__ h,
                     const int* __restrict__ counts,
                     const bf16* __restrict__ wd, bf16* __restrict__ out,
                     int groups, int cap, int hid, int inter) {
  using W = k5::Warps<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int count = fill_count(counts, eg, cap);
  const int rows = min(BM, cap - row0);
  bf16* out_t = out + ((size_t)eg * cap + row0) * hid + n0;
  if (row0 >= count) {  // a tile past the fill count: structural zeros
    gring::store_zeros<W>(out_t, hid, rows);
    return;
  }
  const int e = eg / groups;
  const bf16* const b[1] = {wd + (size_t)e * inter * hid + n0};
  typename gring::Products<W, k5::Plan<1>>::Acc acc;
  k5::ring_gemm<BM, 1>(acc, mma::smem_u32(smem),
                       h + (size_t)eg * cap * inter, inter, row0, count, b,
                       hid, inter);
  gring::stage_tile<W>(smem, [&](int r, int mt, int nt, int xr) {
    const bool in = row0 + r < count;
    return mma::pack_bf16(in ? acc[0][mt][nt][2 * xr] : 0.f,
                          in ? acc[0][mt][nt][2 * xr + 1] : 0.f);
  });
  __syncthreads();
  gring::store_tile<W>(smem, out_t, hid, rows);
}

// ---- fp32: shared-memory tiles, FMA products ---------------------------------------
template <int BM>
struct UpSmem {
  using T = float;
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

template <int BM>
__global__ void __launch_bounds__(kThreads)
gmlp_up_fp32_kernel(const float* __restrict__ x,
                    const int* __restrict__ counts,
                    const float* __restrict__ wg,
                    const float* __restrict__ wu, float* __restrict__ h,
                    int groups, int cap, int hid, int inter) {
  using T = float;
  using L = UpSmem<BM>;
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
    h_t[(size_t)r * inter + c] = g * sigmoid(g) * u;
  }
}

template <int BM>
struct DownSmem {
  using T = float;
  static constexpr int LDA = BK + Pad<T>::value;
  static constexpr int LDB = BN + Pad<T>::value;
  static constexpr int LDC = BN + 4;
  static constexpr int kA = 0;
  static constexpr int kB = kA + round_up_128(BM * LDA * sizeof(T));
  static constexpr int kStage = kB + round_up_128(BK * LDB * sizeof(T));
  static constexpr int kEpi = round_up_128(BM * LDC * 4);
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

template <int BM>
__global__ void __launch_bounds__(kThreads)
gmlp_down_fp32_kernel(const float* __restrict__ h,
                      const int* __restrict__ counts,
                      const float* __restrict__ wd, float* __restrict__ out,
                      int groups, int cap, int hid, int inter) {
  using T = float;
  using L = DownSmem<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int count = fill_count(counts, eg, cap);
  const int rows = min(BM, cap - row0);
  T* out_t = out + ((size_t)eg * cap + row0) * hid + n0;
  if (row0 >= count) {  // a tile past the fill count: structural zeros
    for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
      out_t[(size_t)(idx / BN) * hid + idx % BN] = 0.f;
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
    out_t[(size_t)r * hid + c] = (row0 + r < count) ? c_s[r * L::LDC + c]
                                                    : 0.f;
  }
}

// ---- launches ------------------------------------------------------------------------
struct Args {
  const void *x, *counts, *wg, *wu, *wd;
  void *h, *out;
  int experts, groups, cap, hid, inter;
  cudaStream_t stream;
};

template <typename T, typename Up, typename Down>
cudaError_t launch_pair(const Args& a, Up up, Down down, int up_bytes,
                        int down_bytes, int threads, int bm) {
  cudaError_t err = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, up_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      down, cudaFuncAttributeMaxDynamicSharedMemorySize, down_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.cap + bm - 1) / bm;
  const int eg = a.experts * a.groups;
  up<<<dim3(a.inter / BN, tiles, eg), threads, up_bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.wg), static_cast<const T*>(a.wu),
      static_cast<T*>(a.h), a.groups, a.cap, a.hid, a.inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<dim3(a.hid / BN, tiles, eg), threads, down_bytes, a.stream>>>(
      static_cast<const T*>(a.h), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.wd), static_cast<T*>(a.out), a.groups, a.cap,
      a.hid, a.inter);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0:
      return launch_pair<float>(a, gmlp_up_fp32_kernel<BM>,
                                gmlp_down_fp32_kernel<BM>,
                                UpSmem<BM>::kBytes, DownSmem<BM>::kBytes,
                                kThreads, BM);
    case 1:
      return launch_pair<bf16>(a, gmlp_up_mma_kernel<BM>,
                               gmlp_down_mma_kernel<BM>,
                               k5::Layout<BM, 2>::kBytes,
                               k5::Layout<BM, 1>::kBytes,
                               k5::Warps<BM>::kThreads, BM);
    default: return cudaErrorInvalidValue;
  }
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
  return a.cap <= 16 ? launch<16>(dtype, a) : launch<64>(dtype, a);
}
