// Grouped per-expert SwiGLU MLP backward (K6: dx, K7: dWg, dWu, dWd),
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_dx_kernel` and `_dw_kernel` of
// scaletorch_tpu/ops/pallas/grouped_mlp.py (launched by `_backward`), and
// computes their shared per-tile math `_block_grads` once, in a pass of
// its own. For every (expert e, group g) with fill count n and row c < n,
// with dO masked to 0 on rows >= n:
//   g = x Wg, u = x Wu, dS = dO Wd^T                          (fp32)
//   s = silu(g) u,  dU = dS silu(g),  dG = dS u sig (1 + g (1 - sig))
//   grads pass: s, dG, dU rounded to x's dtype into [E, G, C, I] workspaces
//               (the TPU kernels cast them to that dtype before each product)
//   K6: dx = dG Wg^T + dU Wu^T (fp32 sum), 0 on every row >= n
//   K7: dWg[e] = sum over (g, c < n) of x^T dG, dWu[e] = x^T dU,
//       dWd[e] = s^T dO (fp32 sums, written in the weights' dtype; 0 for an
//       expert whose counts are all 0)
// x, dO [E, G, C, H], counts [E, G] int32, wg/wu [E, H, I], wd [E, I, H].
//
// What bounds them on the H100: at the training shape (E 128, G 1, C 320,
// H 2048, I 768, about 256 rows an expert) the bytes: the grads pass and
// K6 read the weights of every filled expert, K7 writes 3 H I gradients an
// expert; the flops (6, 4 and 6 H I a row) come close behind in bf16.
//
// Design. The TPU dx kernel keeps a [bc, H] fp32 accumulator across its I
// loop (512 KB at H 2048 for 64 rows): too big for a CTA. So the math is
// split at the tensors the TPU kernels round anyway:
//   grads: one CTA per (64 I-columns, slot tile of 64, (e, g)), the three
//          products over H, the elementwise gradient, three stores;
//   K6:    one CTA per (64 H-columns, slot tile, (e, g)), the two products
//          over I; a tile past the fill count writes its zeros and stops;
//   K7:    one CTA per (64 x 64 output tile, expert, kind: gate/up or
//          down) that loops over the groups and their slot tiles up to the
//          fill count in the CTA: no atomics, so the result is
//          deterministic. dO, x, s, dG, dU load as zeros past the count,
//          which is the dO mask of the TPU dW kernel.
// No CTA reads a tile at or past a fill count. What they leave on the
// table: synchronous tile loads, wmma instead of wgmma, the workspace
// round trip, K7's x / dG re-reads across output tiles (L2 hits mostly).
//
// Each C entry returns the cudaError_t of cudaGetLastError() after its
// launch (cudaErrorInvalidValue for a shape it was not built for). They
// launch on the caller's stream, allocate nothing, do not synchronise.

#include "grouped_mlp_common.cuh"

namespace {

using namespace gmlp;

constexpr int BM = 64;  // slot rows of one CTA (grads pass, K6)

// ---- the grads pass: s, dG, dU ---------------------------------------------------
template <typename T>
struct GradsSmem {
  static constexpr int LDA = BK + Pad<T>::value;  // [64][LDA] tiles
  static constexpr int LDB = BN + Pad<T>::value;  // [BK][LDB] tiles
  static constexpr int LDC = BN + 4;
  static constexpr int kTileA = round_up_128(BM * LDA * sizeof(T));
  static constexpr int kTileB = round_up_128(BK * LDB * sizeof(T));
  static constexpr int kX = 0;
  static constexpr int kDo = kX + kTileA;
  static constexpr int kWg = kDo + kTileA;
  static constexpr int kWu = kWg + kTileB;
  static constexpr int kWd = kWu + kTileB;  // [BN][LDA]: Wd rows, H columns
  static constexpr int kStage = kWd + round_up_128(BN * LDA * sizeof(T));
  static constexpr int kC = round_up_128(BM * LDC * 4);
  static constexpr int kEpi = 3 * kC;
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmlp_grads_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                  const T* __restrict__ wg, const T* __restrict__ wu,
                  const T* __restrict__ wd, const T* __restrict__ dout,
                  T* __restrict__ s_ws, T* __restrict__ dg_ws,
                  T* __restrict__ du_ws, int groups, int cap, int hid,
                  int inter) {
  using L = GradsSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int count = fill_count(counts, eg, cap);
  if (row0 >= count) return;  // K6 and K7 never read this tile
  const int e = eg / groups;
  const int n0 = blockIdx.x * BN;
  T* x_s = reinterpret_cast<T*>(smem + L::kX);
  T* do_s = reinterpret_cast<T*>(smem + L::kDo);
  T* wg_s = reinterpret_cast<T*>(smem + L::kWg);
  T* wu_s = reinterpret_cast<T*>(smem + L::kWu);
  T* wd_s = reinterpret_cast<T*>(smem + L::kWd);
  float* cg_s = reinterpret_cast<float*>(smem);
  float* cu_s = reinterpret_cast<float*>(smem + L::kC);
  float* cds_s = reinterpret_cast<float*>(smem + 2 * L::kC);

  const size_t row_base = (size_t)eg * cap;
  const T* wg_e = wg + (size_t)e * hid * inter;
  const T* wu_e = wu + (size_t)e * hid * inter;
  const T* wd_e = wd + (size_t)e * inter * hid;
  TileAcc<T, BM, BN> acc_g, acc_u, acc_ds;
  acc_g.zero();
  acc_u.zero();
  acc_ds.zero();
  for (int k0 = 0; k0 < hid; k0 += BK) {
    __syncthreads();
    load_tile<T, BM, BK>(x_s, L::LDA, x + row_base * hid, hid, row0, k0,
                         count);
    load_tile<T, BM, BK>(do_s, L::LDA, dout + row_base * hid, hid, row0, k0,
                         count);
    load_tile<T, BK, BN>(wg_s, L::LDB, wg_e, inter, k0, n0, hid);
    load_tile<T, BK, BN>(wu_s, L::LDB, wu_e, inter, k0, n0, hid);
    // Wd^T(k = h, n = i) = wd[i][h]: rows n0.. of wd, read column-major
    load_tile<T, BN, BK>(wd_s, L::LDA, wd_e, hid, n0, k0, inter);
    __syncthreads();
    acc_g.template mma<BK, true, true>(x_s, L::LDA, wg_s, L::LDB);
    acc_u.template mma<BK, true, true>(x_s, L::LDA, wu_s, L::LDB);
    acc_ds.template mma<BK, true, false>(do_s, L::LDA, wd_s, L::LDA);
  }
  __syncthreads();
  acc_g.store(cg_s, L::LDC);
  acc_u.store(cu_s, L::LDC);
  acc_ds.store(cds_s, L::LDC);
  __syncthreads();
  const int rows = min(BM, cap - row0);
  const size_t out0 = (row_base + row0) * inter + n0;
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int o = r * L::LDC + c;
    const float g = cg_s[o];
    const float u = cu_s[o];
    const float ds = cds_s[o];
    const float sig = sigmoid(g);
    const float silu = g * sig;
    const size_t w = out0 + (size_t)r * inter + c;
    s_ws[w] = Cvt<T>::from(silu * u);
    du_ws[w] = Cvt<T>::from(ds * silu);
    dg_ws[w] = Cvt<T>::from(ds * u * (sig * (1.f + g * (1.f - sig))));
  }
}

// ---- K6: dx ----------------------------------------------------------------------
template <typename T>
struct DxSmem {
  static constexpr int LDA = BK + Pad<T>::value;
  static constexpr int LDC = BN + 4;
  static constexpr int kTile = round_up_128(BM * LDA * sizeof(T));
  static constexpr int kDg = 0;
  static constexpr int kDu = kDg + kTile;
  static constexpr int kWg = kDu + kTile;  // [BN][LDA]: Wg rows (h), I columns
  static constexpr int kWu = kWg + round_up_128(BN * LDA * sizeof(T));
  static constexpr int kStage = kWu + round_up_128(BN * LDA * sizeof(T));
  static constexpr int kEpi = round_up_128(BM * LDC * 4);
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmlp_dx_kernel(const int* __restrict__ counts, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ dg_ws,
               const T* __restrict__ du_ws, T* __restrict__ dx, int groups,
               int cap, int hid, int inter) {
  using L = DxSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int count = fill_count(counts, eg, cap);
  const int rows = min(BM, cap - row0);
  T* dx_t = dx + ((size_t)eg * cap + row0) * hid + n0;
  if (row0 >= count) {
    for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
      dx_t[(size_t)(idx / BN) * hid + idx % BN] = Cvt<T>::from(0.f);
    }
    return;
  }
  const int e = eg / groups;
  T* dg_s = reinterpret_cast<T*>(smem + L::kDg);
  T* du_s = reinterpret_cast<T*>(smem + L::kDu);
  T* wg_s = reinterpret_cast<T*>(smem + L::kWg);
  T* wu_s = reinterpret_cast<T*>(smem + L::kWu);
  float* c_s = reinterpret_cast<float*>(smem);

  const size_t ws0 = (size_t)eg * cap * inter;
  const T* wg_e = wg + (size_t)e * hid * inter;
  const T* wu_e = wu + (size_t)e * hid * inter;
  TileAcc<T, BM, BN> acc;
  acc.zero();
  for (int k0 = 0; k0 < inter; k0 += BK) {
    __syncthreads();
    load_tile<T, BM, BK>(dg_s, L::LDA, dg_ws + ws0, inter, row0, k0, count);
    load_tile<T, BM, BK>(du_s, L::LDA, du_ws + ws0, inter, row0, k0, count);
    // Wg^T(k = i, n = h) = wg[h][i]: rows n0.. of wg, read column-major
    load_tile<T, BN, BK>(wg_s, L::LDA, wg_e, inter, n0, k0, hid);
    load_tile<T, BN, BK>(wu_s, L::LDA, wu_e, inter, n0, k0, hid);
    __syncthreads();
    acc.template mma<BK, true, false>(dg_s, L::LDA, wg_s, L::LDA);
    acc.template mma<BK, true, false>(du_s, L::LDA, wu_s, L::LDA);
  }
  __syncthreads();
  acc.store(c_s, L::LDC);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const float v = (row0 + r < count) ? c_s[r * L::LDC + c] : 0.f;
    dx_t[(size_t)r * hid + c] = Cvt<T>::from(v);
  }
}

// ---- K7: dWg, dWu, dWd -------------------------------------------------------------
template <typename T>
struct DwSmem {
  static constexpr int LDA = BW + Pad<T>::value;  // [BK][LDA]: rows x M
  static constexpr int LDB = BN + Pad<T>::value;  // [BK][LDB]: rows x N
  static constexpr int LDC = BN + 4;
  static constexpr int kA = 0;
  static constexpr int kB0 = kA + round_up_128(BK * LDA * sizeof(T));
  static constexpr int kB1 = kB0 + round_up_128(BK * LDB * sizeof(T));
  static constexpr int kStage = kB1 + round_up_128(BK * LDB * sizeof(T));
  static constexpr int kC = round_up_128(BW * LDC * 4);
  static constexpr int kEpi = 2 * kC;
  static constexpr int kBytes = kStage > kEpi ? kStage : kEpi;
};

// blockIdx.z = 0: dWg and dWu tile (M over H, N over I), sharing the x tile;
// blockIdx.z = 1: dWd tile (M over I, N over H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmlp_dw_kernel(const T* __restrict__ x, const int* __restrict__ counts,
               const T* __restrict__ dout, const T* __restrict__ s_ws,
               const T* __restrict__ dg_ws, const T* __restrict__ du_ws,
               T* __restrict__ dwg, T* __restrict__ dwu, T* __restrict__ dwd,
               int groups, int cap, int hid, int inter) {
  using L = DwSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.y;
  const bool down = blockIdx.z == 1;
  const int m_dim = down ? inter : hid;   // rows of the output
  const int n_dim = down ? hid : inter;   // columns of the output
  const int n_tiles = n_dim / BN;
  const int m0 = (blockIdx.x / n_tiles) * BW;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  T* a_s = reinterpret_cast<T*>(smem + L::kA);
  T* b0_s = reinterpret_cast<T*>(smem + L::kB0);
  T* b1_s = reinterpret_cast<T*>(smem + L::kB1);
  float* c0_s = reinterpret_cast<float*>(smem);
  float* c1_s = reinterpret_cast<float*>(smem + L::kC);

  TileAcc<T, BW, BN> acc0, acc1;
  acc0.zero();
  acc1.zero();
  for (int g = 0; g < groups; ++g) {
    const int eg = e * groups + g;
    const int count = fill_count(counts, eg, cap);
    const size_t row_base = (size_t)eg * cap;
    for (int r0 = 0; r0 < count; r0 += BK) {
      __syncthreads();
      if (down) {
        // dWd[i][h] += s[r][i] dO[r][h]: A = s^T (column-major), B = dO
        load_tile<T, BK, BW>(a_s, L::LDA, s_ws + row_base * inter, inter, r0,
                             m0, count);
        load_tile<T, BK, BN>(b0_s, L::LDB, dout + row_base * hid, hid, r0,
                             n0, count);
      } else {
        // dWg[h][i] += x[r][h] dG[r][i], dWu likewise with dU
        load_tile<T, BK, BW>(a_s, L::LDA, x + row_base * hid, hid, r0, m0,
                             count);
        load_tile<T, BK, BN>(b0_s, L::LDB, dg_ws + row_base * inter, inter,
                             r0, n0, count);
        load_tile<T, BK, BN>(b1_s, L::LDB, du_ws + row_base * inter, inter,
                             r0, n0, count);
      }
      __syncthreads();
      acc0.template mma<BK, false, true>(a_s, L::LDA, b0_s, L::LDB);
      if (!down) acc1.template mma<BK, false, true>(a_s, L::LDA, b1_s, L::LDB);
    }
  }
  __syncthreads();
  acc0.store(c0_s, L::LDC);
  if (!down) acc1.store(c1_s, L::LDC);
  __syncthreads();
  T* out0 = (down ? dwd : dwg) + (size_t)e * m_dim * n_dim;
  T* out1 = dwu + (size_t)e * m_dim * n_dim;
  for (int idx = threadIdx.x; idx < BW * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const size_t o = (size_t)(m0 + r) * n_dim + n0 + c;
    out0[o] = Cvt<T>::from(c0_s[r * L::LDC + c]);
    if (!down) out1[o] = Cvt<T>::from(c1_s[r * L::LDC + c]);
  }
}

struct Args {
  const void *x, *counts, *wg, *wu, *wd, *dout;
  void *s, *dg, *du;      // workspaces [E, G, C, I]
  void *dx, *dwg, *dwu, *dwd;
  int experts, groups, cap, hid, inter;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t launch_grads(const Args& a) {
  constexpr int bytes = GradsSmem<T>::kBytes;
  cudaError_t err = allow_smem(gmlp_grads_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.inter / BN, (a.cap + BM - 1) / BM, a.experts * a.groups);
  gmlp_grads_kernel<T><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.wg), static_cast<const T*>(a.wu),
      static_cast<const T*>(a.wd), static_cast<const T*>(a.dout),
      static_cast<T*>(a.s), static_cast<T*>(a.dg), static_cast<T*>(a.du),
      a.groups, a.cap, a.hid, a.inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const Args& a) {
  constexpr int bytes = DxSmem<T>::kBytes;
  cudaError_t err = allow_smem(gmlp_dx_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hid / BN, (a.cap + BM - 1) / BM, a.experts * a.groups);
  gmlp_dx_kernel<T><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const int*>(a.counts), static_cast<const T*>(a.wg),
      static_cast<const T*>(a.wu), static_cast<const T*>(a.dg),
      static_cast<const T*>(a.du), static_cast<T*>(a.dx), a.groups, a.cap,
      a.hid, a.inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const Args& a) {
  constexpr int bytes = DwSmem<T>::kBytes;
  cudaError_t err = allow_smem(gmlp_dw_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.hid / BW) * (a.inter / BN), a.experts, 2);
  gmlp_dw_kernel<T><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int*>(a.counts),
      static_cast<const T*>(a.dout), static_cast<const T*>(a.s),
      static_cast<const T*>(a.dg), static_cast<const T*>(a.du),
      static_cast<T*>(a.dwg), static_cast<T*>(a.dwu), static_cast<T*>(a.dwd),
      a.groups, a.cap, a.hid, a.inter);
  return cudaGetLastError();
}

enum Which { kGrads, kDx, kDw };

int dispatch(Which which, const Args& a, int dtype) {
  if (!shapes_ok(a.experts, a.groups, a.cap, a.hid, a.inter)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return which == kGrads ? launch_grads<float>(a)
             : which == kDx  ? launch_dx<float>(a)
                             : launch_dw<float>(a);
    case 1:
      return which == kGrads ? launch_grads<__nv_bfloat16>(a)
             : which == kDx  ? launch_dx<__nv_bfloat16>(a)
                             : launch_dw<__nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but counts shares it).
// s, dg, du are [E, G, C, I] workspaces the caller allocates.
extern "C" int st_grouped_mlp_bwd_grads(const void* x, const void* counts,
                                        const void* wg, const void* wu,
                                        const void* wd, const void* dout,
                                        void* s, void* dg, void* du,
                                        int experts, int groups, int cap,
                                        int hid, int inter, int dtype,
                                        void* stream) {
  const Args a{x, counts, wg, wu, wd, dout, s, dg, du, nullptr, nullptr,
               nullptr, nullptr, experts, groups, cap, hid, inter,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kGrads, a, dtype);
}

extern "C" int st_grouped_mlp_bwd_dx(const void* counts, const void* wg,
                                     const void* wu, const void* dg,
                                     const void* du, void* dx, int experts,
                                     int groups, int cap, int hid, int inter,
                                     int dtype, void* stream) {
  const Args a{nullptr, counts, wg, wu, nullptr, nullptr, nullptr,
               const_cast<void*>(dg), const_cast<void*>(du), dx, nullptr,
               nullptr, nullptr, experts, groups, cap, hid, inter,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDx, a, dtype);
}

extern "C" int st_grouped_mlp_bwd_dw(const void* x, const void* counts,
                                     const void* dout, const void* s,
                                     const void* dg, const void* du,
                                     void* dwg, void* dwu, void* dwd,
                                     int experts, int groups, int cap,
                                     int hid, int inter, int dtype,
                                     void* stream) {
  const Args a{x, counts, nullptr, nullptr, nullptr, dout,
               const_cast<void*>(s), const_cast<void*>(dg),
               const_cast<void*>(du), nullptr, dwg, dwu, dwd, experts,
               groups, cap, hid, inter, static_cast<cudaStream_t>(stream)};
  return dispatch(kDw, a, dtype);
}
