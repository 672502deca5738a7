// Flash-attention backward (K2: dQ, K3: dK and dV), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_dq_kernel` (K2,
// scaletorch_tpu/ops/pallas/flash.py:181, launched at :288) and
// `_dkv_kernel` (K3, flash.py:223, launched at :313), both called by
// `_flash_backward`. They compute the same functions, FlashAttention-2's
// backward from the saved LSE and delta = rowsum(dO * O) (computed by the
// caller):
//   P  = exp(scale * Q K^T (masked to -1e30) - LSE)
//   dS = P * (dO V^T - delta) * scale
//   (bf16 at head_dim 64 and 128: P = exp2(S * scale log2 e - LSE log2 e),
//   `bwd_prob`)
//   K2: dQ = sum over key tiles of dS K                (ds rounded to k's dtype)
//   K3: dV = sum of P^T dO, dK = sum of dS^T Q over the query tiles and
//       over the n_rep query heads of a KV head   (p rounded to dO's dtype,
//                                                   ds rounded to q's dtype)
// k and v stay unexpanded [B, Hkv, S, D]; query head h reads KV head
// h / n_rep, and K3 sums the n_rep heads h = hk * n_rep + r inside one CTA.
// Every sum is fp32 and each output is rounded once; no atomics, so the
// result is deterministic.
//
// What bounds them on the H100: operations (6 and 8 * B * Hq * D * S(S+1)/2
// flops for K2 and K3 causal, thousands of flops per byte at S = 8192).
//
// bf16: register accumulators on tensor-core mma.sync (mma_sm90.cuh).
//   * Every product is mma.sync m16n8k16 with its fp32 sum in registers.
//     S, dP (K2) and S^T, dP^T (K3) are formed in registers; P and dS are
//     rounded to bf16 straight into the A fragments of the next product
//     (`acc_to_a`) and never touch shared memory. dQ (K2) and dK, dV (K3)
//     stay in registers for the whole loop and are written once.
//   * Tiles stream through a two-stage cp.async ring (K2: K and V tiles;
//     K3: Q, dO, LSE and delta tiles), so the next tile's loads run beside
//     this tile's math, with one barrier per 64-row tile.
//   * Tiles sit in XOR-swizzled shared memory and are read by ldmatrix
//     (.trans for a B operand stored row-major), free of bank conflicts
//     without padding.
//   * K2: one CTA of 4 warps per (64-row query tile, q head, batch), each
//     warp owning 16 query rows whose Q and dO fragments it loads once;
//     ~96 KB of shared memory, two CTAs per SM. Longest causal rows first.
//   * K3: one CTA of 8 warps per (64-key tile, KV head, batch), as two
//     groups of 4 warps; each warp owns 16 keys. The groups take alternate
//     (head, query tile) steps of the loop over the n_rep heads and the
//     query tiles from the first that reaches the key tile (the Pallas
//     kernel's clamp_i), each through its own ring and named barrier, and
//     add their dK, dV partial sums in a fixed order at the end: the
//     longest key tile takes half the steps it would alone, which matters
//     when few key tiles fill the card (Hkv 4, S 4096: 256 CTAs).
//     Longest key tiles first.
// fp32: shared-memory tiles with `tile_gemm`'s fp32 FMA products (no
// TF32): K2 over 64-row query tiles, K3 over 32-row query steps.
// What they still leave: wgmma, TMA and warp specialisation (FA3); and the
// split itself: S and dP are computed in both kernels, 7 products where a
// fused backward with a deterministic dQ reduction computes 5.
//
// Each C entry returns the cudaError_t of cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it was not built for). They
// launch on the caller's stream, allocate nothing, do not synchronise.

#include "flash_common.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// bf16 P of a raw score s (Q K^T, unscaled) from its row's LSE (lse2 =
// LSE log2 e). At head_dim 32 and 16 a row of dQ has too few elements to
// average one dS that rounds to bf16 the other way, so there P is formed
// exactly as the plain versions form it: expf of the scaled score minus
// LSE, each step rounded apart. The wider heads keep the cheaper exp2f of
// a folded scale, one fma.
template <int D>
__device__ __forceinline__ float bwd_prob(float s, float scale, float scale2,
                                          float lse, float lse2) {
  if constexpr (D <= 32) {
    return expf(__fsub_rn(__fmul_rn(s, scale), lse));
  } else {
    return exp2f(fmaf(s, scale2, -lse2));
  }
}

// ---- bf16 K2: dQ on mma.sync ---------------------------------------------------
namespace k2 {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // query rows per CTA, 16 per warp
constexpr int BK = 64;           // keys per ring stage
constexpr int KC = 32;           // keys per register chunk

template <int D>
struct Layout {
  using QTile = mma::SwizzledTile<BQ, D>;  // Q, dO
  using KTile = mma::SwizzledTile<BK, D>;  // K, V
  static constexpr int kQ = 0;
  static constexpr int kDo = QTile::kBytes;
  static constexpr int kRing = 2 * QTile::kBytes;  // stage s: K, then V
  static constexpr int kStageBytes = 2 * KTile::kBytes;
  static constexpr int kBytes = kRing + 2 * kStageBytes;
};
}  // namespace k2

template <int D>
__global__ void __launch_bounds__(k2::kThreads, 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int batch, int hq, int hkv, int sq, int skv, float scale,
                    bool causal) {
  constexpr int kThreads = k2::kThreads;
  constexpr int BQ = k2::BQ;
  constexpr int BK = k2::BK;
  constexpr int KC = k2::KC;
  using L = k2::Layout<D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  constexpr int RB = KTile::kRowBytes;
  constexpr int KSTEPS = D / 16;  // k-steps over head_dim
  constexpr int NT = D / 8;       // n-tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_u32(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const mma::LaneAddr la(lane);

  // tile-major order: every head's longest causal rows first
  const int nq = (sq + BQ - 1) / BQ;
  const int nk = (skv + BK - 1) / BK;
  const int heads = hq * batch;
  const int blk = blockIdx.x;
  const int i = nq - 1 - blk / heads;
  const int h = blk % heads % hq;
  const int b = blk % heads / hq;
  const int hk = h / (hq / hkv);
  const size_t q_row0 = ((size_t)b * hq + h) * sq;
  const bf16* k_bh = k + ((size_t)b * hkv + hk) * skv * D;
  const bf16* v_bh = v + ((size_t)b * hkv + hk) * skv * D;
  const int last_j = causal ? min(nk - 1, (i * BQ + BQ - 1) / BK) : nk - 1;

  QTile::template load_async<kThreads>(base + L::kQ, q + q_row0 * D, i * BQ,
                                       sq, tid);
  QTile::template load_async<kThreads>(base + L::kDo, dout + q_row0 * D,
                                       i * BQ, sq, tid);
  mma::cp_async_commit();
  KTile::template load_async<kThreads>(base + L::kRing, k_bh, 0, skv, tid);
  KTile::template load_async<kThreads>(base + L::kRing + KTile::kBytes, v_bh,
                                       0, skv, tid);
  mma::cp_async_commit();

  // this thread's query rows: g and g + 8 of its warp's 16 (lane = 4g + t)
  const int warp_row0 = i * BQ + warp * 16;
  int row[2];
  float lse1[2], lse2[2], dlt[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    row[x] = warp_row0 + (lane >> 2) + 8 * x;
    const bool in = row[x] < sq;
    lse1[x] = in ? lse[q_row0 + row[x]] : 0.f;
    lse2[x] = lse1[x] * kLog2e;
    dlt[x] = in ? delta[q_row0 + row[x]] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  mma::cp_async_wait<1>();  // Q and dO
  __syncthreads();
  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma::ldmatrix_x4(qf[kk],
                     mma::a_addr<RB>(la, base + L::kQ, warp * 16, kk * 16));
    mma::ldmatrix_x4(dof[kk],
                     mma::a_addr<RB>(la, base + L::kDo, warp * 16, kk * 16));
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int j = 0; j <= last_j; ++j) {
    mma::cp_async_wait<0>();  // tile j
    __syncthreads();          // ... seen by all; tile j - 1's stage is free
    if (j < last_j) {
      const uint32_t nxt = base + L::kRing + ((j + 1) & 1) * L::kStageBytes;
      KTile::template load_async<kThreads>(nxt, k_bh, (j + 1) * BK, skv, tid);
      KTile::template load_async<kThreads>(nxt + KTile::kBytes, v_bh,
                                           (j + 1) * BK, skv, tid);
      mma::cp_async_commit();
    }
    const uint32_t ks = base + L::kRing + (j & 1) * L::kStageBytes;
    const uint32_t vs = ks + KTile::kBytes;
#pragma unroll 1  // one chunk's code: faster than two unrolled
    for (int c = 0; c < BK / KC; ++c) {
      const int key0 = j * BK + c * KC;
      // warp-uniform: no key of the chunk exists or is visible to its rows
      if (key0 >= skv || (causal && key0 > warp_row0 + 15)) continue;
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      // S = Q K^T, dP = dO V^T (B: K, V rows as [n][k], no transpose)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t bk[4], bv[4];
          mma::ldmatrix_x4(bk, mma::b_addr<RB>(la, ks, c * KC + np * 16,
                                               kk * 16));
          mma::ldmatrix_x4(bv, mma::b_addr<RB>(la, vs, c * KC + np * 16,
                                               kk * 16));
          mma::mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma::mma_bf16(dp[2 * np], dof[kk], bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
        }
      }
      // dS = P (dP - delta) scale, in place of dP
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          const int key = key0 + n * 8 + 2 * t + (e & 1);
          const bool off = masked(causal, row[x], key, skv);
          const float p =
              off ? 0.f
                  : bwd_prob<D>(s[n][e], scale, scale2, lse1[x], lse2[x]);
          dp[n][e] = p * (dp[n][e] - dlt[x]) * scale;
        }
      }
      // dQ += dS K (dS rounded to bf16 in registers; B: K rows as [k][n])
#pragma unroll
      for (int kc = 0; kc < KC / 16; ++kc) {
        uint32_t a[4];
        mma::acc_to_a(a, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bk[4];
          mma::ldmatrix_x4_trans(
              bk, mma::a_addr<RB>(la, ks, c * KC + kc * 16, dn * 16));
          mma::mma_bf16(acc[2 * dn], a, bk[0], bk[1]);
          mma::mma_bf16(acc[2 * dn + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] < sq) {
        *reinterpret_cast<uint32_t*>(dq + (q_row0 + row[x]) * D + col) =
            mma::pack_bf16(acc[n][2 * x], acc[n][2 * x + 1]);
      }
    }
  }
}

// ---- bf16 K3: dK, dV on mma.sync ------------------------------------------------
namespace k3 {
constexpr int kWarps = 8;  // two groups of 4
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupThreads = kThreads / 2;
constexpr int BK = 64;  // keys per CTA, 16 per warp of a group
constexpr int BQ = 64;  // query rows per ring stage
constexpr int QC = 32;  // query rows per register chunk

// a group's threads copy a stage's LSE and delta, one float each
static_assert(kGroupThreads == 2 * BQ, "one thread per LSE or delta row");

template <int D>
struct Layout {
  using KTile = mma::SwizzledTile<BK, D>;  // K, V
  using QTile = mma::SwizzledTile<BQ, D>;  // Q, dO
  static constexpr int kK = 0;
  static constexpr int kV = KTile::kBytes;
  static constexpr int kRing = 2 * KTile::kBytes;
  // a stage: Q, dO, then LSE and delta (BQ floats each); slots 2g, 2g + 1
  // belong to group g
  static constexpr int kStats = 2 * QTile::kBytes;
  static constexpr int kStageBytes = kStats + 2 * BQ * 4;
  static constexpr int kBytes = kRing + 4 * kStageBytes;
  // after the loop: group 1's dK, dV partial sums (D floats a thread)
  static_assert(kGroupThreads * D * 4 <= 4 * kStageBytes, "reduction fits");
};
}  // namespace k3

template <int D>
__global__ void __launch_bounds__(k3::kThreads, 1)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int batch, int hq, int hkv,
                     int sq, int skv, float scale, bool causal) {
  constexpr int kThreads = k3::kThreads;
  constexpr int kGroupThreads = k3::kGroupThreads;
  constexpr int BQ = k3::BQ;
  constexpr int BK = k3::BK;
  constexpr int QC = k3::QC;
  using L = k3::Layout<D>;
  using KTile = typename L::KTile;
  using QTile = typename L::QTile;
  constexpr int RB = KTile::kRowBytes;
  constexpr int KSTEPS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_u32(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = tid / kGroupThreads;
  const int gtid = tid % kGroupThreads;
  const int wg = gtid >> 5;  // warp within the group
  const int t = lane & 3;
  const mma::LaneAddr la(lane);

  // tile-major order: every head's longest key tiles (small jj) first
  const int nq = (sq + BQ - 1) / BQ;
  const int heads = hkv * batch;
  const int blk = blockIdx.x;
  const int jj = blk / heads;
  const int hk = blk % heads % hkv;
  const int b = blk % heads / hkv;
  const int n_rep = hq / hkv;
  const size_t kv_row0 = ((size_t)b * hkv + hk) * skv;
  // query tile i reaches key tile jj iff its last row sees jj's first key
  const int first_i = causal ? min((jj * BK) / BQ, nq) : 0;
  const int nqi = nq - first_i;
  const int stages = n_rep * nqi;  // (head r, query tile) steps

  KTile::template load_async<kThreads>(base + L::kK, k + kv_row0 * D,
                                       jj * BK, skv, tid);
  KTile::template load_async<kThreads>(base + L::kV, v + kv_row0 * D,
                                       jj * BK, skv, tid);
  // step st into ring slot `slot`, by this thread's group
  auto load_step = [&](int st, int slot) {
    const int i = first_i + st % nqi;
    const size_t q_row0 = ((size_t)b * hq + hk * n_rep + st / nqi) * sq;
    const uint32_t dst = base + L::kRing + slot * L::kStageBytes;
    QTile::template load_async<kGroupThreads>(dst, q + q_row0 * D, i * BQ,
                                              sq, gtid);
    QTile::template load_async<kGroupThreads>(dst + QTile::kBytes,
                                              dout + q_row0 * D, i * BQ, sq,
                                              gtid);
    // LSE (threads 0..63 of the group), delta (64..127)
    const int r = gtid % BQ;
    const bool valid = i * BQ + r < sq;
    const float* src = (gtid < BQ ? lse : delta) + q_row0 + i * BQ + r;
    mma::cp_async_4(dst + L::kStats + gtid * 4, valid ? src : lse, valid);
  };
  if (group < stages) load_step(group, 2 * group);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int key_w0 = jj * BK + wg * 16;  // this warp's first key
  int key[2];
  key[0] = key_w0 + (lane >> 2);
  key[1] = key[0] + 8;
  const float scale2 = scale * kLog2e;
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  int u = 0;  // this group's step count
  for (int st = group; st < stages; st += 2, ++u) {
    if (u > 0) {
      mma::cp_async_wait<0>();                 // step st
      mma::named_barrier(1 + group, kGroupThreads);  // its slot-mate is free
    }
    if (st + 2 < stages) {
      load_step(st + 2, 2 * group + ((u + 1) & 1));
      mma::cp_async_commit();
    }
    const int i = first_i + st % nqi;
    const int slot = 2 * group + (u & 1);
    const uint32_t qs = base + L::kRing + slot * L::kStageBytes;
    const uint32_t dos = qs + QTile::kBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        smem + L::kRing + slot * L::kStageBytes + L::kStats);
    const float* delta_s = lse_s + BQ;
#pragma unroll
    for (int c = 0; c < BQ / QC; ++c) {
      const int q0 = i * BQ + c * QC;
      // warp-uniform: no query of the chunk exists or sees this warp's keys
      if (q0 >= sq || (causal && q0 + QC - 1 < key_w0)) continue;
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      // S^T = K Q^T, dP^T = V dO^T (A: this warp's K, V rows; B: Q, dO
      // rows as [n][k], no transpose)
#pragma unroll 4  // unrolled fully, D = 128 spills at 255 registers
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        mma::ldmatrix_x4(ak,
                         mma::a_addr<RB>(la, base + L::kK, wg * 16, kk * 16));
        mma::ldmatrix_x4(av,
                         mma::a_addr<RB>(la, base + L::kV, wg * 16, kk * 16));
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t bq[4], bo[4];
          mma::ldmatrix_x4(bq, mma::b_addr<RB>(la, qs, c * QC + np * 16,
                                               kk * 16));
          mma::ldmatrix_x4(bo, mma::b_addr<RB>(la, dos, c * QC + np * 16,
                                               kk * 16));
          mma::mma_bf16(s[2 * np], ak, bq[0], bq[1]);
          mma::mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
          mma::mma_bf16(dp[2 * np], av, bo[0], bo[1]);
          mma::mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // P^T in place of S^T, dS^T in place of dP^T; LSE and delta by column
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        const int col = c * QC + n * 8 + 2 * t;  // query row in the stage
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i * BQ + col + (e & 1);
          const bool off = qi >= sq || masked(causal, qi, key[e >> 1], skv);
          const float lse_q = (e & 1) ? l2.y : l2.x;
          const float delta_q = (e & 1) ? d2.y : d2.x;
          const float p = off ? 0.f
                              : bwd_prob<D>(s[n][e], scale, scale2, lse_q,
                                            lse_q * kLog2e);
          dp[n][e] = p * (dp[n][e] - delta_q) * scale;
          s[n][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T Q (P^T, dS^T rounded to bf16 in registers;
      // B: dO, Q rows as [k][n], through .trans)
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        uint32_t pa[4], da[4];
        mma::acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
        mma::acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bo[4], bq[4];
          mma::ldmatrix_x4_trans(
              bo, mma::a_addr<RB>(la, dos, c * QC + kc * 16, dn * 16));
          mma::ldmatrix_x4_trans(
              bq, mma::a_addr<RB>(la, qs, c * QC + kc * 16, dn * 16));
          mma::mma_bf16(dva[2 * dn], pa, bo[0], bo[1]);
          mma::mma_bf16(dva[2 * dn + 1], pa, bo[2], bo[3]);
          mma::mma_bf16(dka[2 * dn], da, bq[0], bq[1]);
          mma::mma_bf16(dka[2 * dn + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  // group 0's sums + group 1's, in that order, through the free ring
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L::kRing);
  if (group == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(2 * (4 * n + e)) * kGroupThreads + gtid] = dka[n][e];
        red[(2 * (4 * n + e) + 1) * kGroupThreads + gtid] = dva[n][e];
      }
    }
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float sk[2], sv[2];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int e = 2 * x + y;
          sk[y] = dka[n][e] + red[(2 * (4 * n + e)) * kGroupThreads + gtid];
          sv[y] = dva[n][e] +
                  red[(2 * (4 * n + e) + 1) * kGroupThreads + gtid];
        }
        if (key[x] < skv) {
          const size_t o = (kv_row0 + key[x]) * D + col;
          *reinterpret_cast<uint32_t*>(dk + o) = mma::pack_bf16(sk[0], sk[1]);
          *reinterpret_cast<uint32_t*>(dv + o) = mma::pack_bf16(sv[0], sv[1]);
        }
      }
    }
  }
}

// ---- fp32: shared-memory tiles, FMA products ---------------------------------------
constexpr int BQ = 64;   // K2: query rows per CTA
constexpr int BK = 64;   // keys per tile (K2 loop step, K3 CTA)
constexpr int BQ3 = 32;  // K3: query rows per loop step

template <int D>
struct DqSmem {
  using T = float;
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr int kTile = round_up_128(BQ * LDT * sizeof(T));
  static constexpr int kScores = round_up_128(BQ * LDS * 4);
  static constexpr int kDs = round_up_128(BQ * LDP * sizeof(T));
  static constexpr int kAcc = round_up_128(BQ * LDO * 4);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTile;
  static constexpr int kK = kDo + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kS = kV + kTile;
  static constexpr int kDp = kS + kScores;
  static constexpr int kDsOff = kDp + kScores;
  static constexpr int kDq = kDsOff + kDs;
  static constexpr int kStats = kDq + kAcc;  // lse, delta: 2 x BQ floats
  static constexpr int kBytes = kStats + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int hq, int hkv, int sq, int skv, float scale,
                     bool causal) {
  using T = float;
  using L = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* do_s = reinterpret_cast<T*>(smem + L::kDo);
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDp);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDsOff);
  float* dq_s = reinterpret_cast<float*>(smem + L::kDq);
  float* lse_s = reinterpret_cast<float*>(smem + L::kStats);
  float* delta_s = lse_s + BQ;

  const int nq = (sq + BQ - 1) / BQ;
  const int nk = (skv + BK - 1) / BK;
  const int i = nq - 1 - blockIdx.x;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);

  const size_t q_row0 = ((size_t)b * hq + h) * sq;
  const T* k_bh = k + ((size_t)b * hkv + hk) * skv * D;
  const T* v_bh = v + ((size_t)b * hkv + hk) * skv * D;

  load_rows<T, D, BQ>(q_s, L::LDT, q + q_row0 * D, i * BQ, sq);
  load_rows<T, D, BQ>(do_s, L::LDT, dout + q_row0 * D, i * BQ, sq);
  load_vector<BQ>(lse_s, lse + q_row0, i * BQ, sq);
  load_vector<BQ>(delta_s, delta + q_row0, i * BQ, sq);
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    dq_s[(idx / D) * L::LDO + idx % D] = 0.f;
  }

  const int last_j = causal ? min(nk - 1, (i * BQ + BQ - 1) / BK) : nk - 1;
  for (int j = 0; j <= last_j; ++j) {
    __syncthreads();  // the previous step is done with K and dS
    load_rows<T, D, BK>(k_s, L::LDT, k_bh, j * BK, skv);
    load_rows<T, D, BK>(v_s, L::LDT, v_bh, j * BK, skv);
    __syncthreads();
    tile_gemm<BQ, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
                                             s_s, L::LDS);
    tile_gemm<BQ, BK, D, true, false, false>(do_s, L::LDT, v_s, L::LDT,
                                             dp_s, L::LDS);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK;
      const int c = idx % BK;
      const float s = masked(causal, i * BQ + r, j * BK + c, skv)
                          ? kMasked
                          : s_s[r * L::LDS + c] * scale;
      const float p = expf(s - lse_s[r]);
      const float ds = p * (dp_s[r * L::LDS + c] - delta_s[r]) * scale;
      ds_s[r * L::LDP + c] = Cvt<T>::from(ds);  // ds in k's dtype
    }
    __syncthreads();
    tile_gemm<BQ, D, BK, true, true, true>(ds_s, L::LDP, k_s, L::LDT,
                                           dq_s, L::LDO);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D;
    const int row = i * BQ + r;
    if (row < sq) {
      dq[(q_row0 + row) * D + idx % D] =
          Cvt<T>::from(dq_s[r * L::LDO + idx % D]);
    }
  }
}

template <int D>
struct DkvSmem {
  using T = float;
  static constexpr int LDT = D + Pad<T>::value;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + Pad<T>::value;
  static constexpr int LDO = D + 4;
  static constexpr int kQTile = round_up_128(BQ3 * LDT * sizeof(T));
  static constexpr int kKTile = round_up_128(BK * LDT * sizeof(T));
  static constexpr int kScores = round_up_128(BQ3 * LDS * 4);
  static constexpr int kP = round_up_128(BQ3 * LDP * sizeof(T));
  static constexpr int kAcc = round_up_128(BK * LDO * 4);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  static constexpr int kK = kDo + kQTile;
  static constexpr int kV = kK + kKTile;
  static constexpr int kS = kV + kKTile;
  static constexpr int kDp = kS + kScores;
  static constexpr int kPOff = kDp + kScores;
  static constexpr int kDsOff = kPOff + kP;
  static constexpr int kDk = kDsOff + kP;
  static constexpr int kDv = kDk + kAcc;
  static constexpr int kStats = kDv + kAcc;  // lse, delta: 2 x BQ3 floats
  static constexpr int kBytes = kStats + 2 * BQ3 * 4;
};

// One CTA an SM as the bound: without it ptxas caps the D 16 instantiation
// at 48 registers and spills 4 bytes; shared memory, not registers, sets
// these kernels' occupancy at every D.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_fp32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int hq,
                      int hkv, int sq, int skv, float scale, bool causal) {
  using T = float;
  using L = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* do_s = reinterpret_cast<T*>(smem + L::kDo);
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDp);
  T* p_s = reinterpret_cast<T*>(smem + L::kPOff);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDsOff);
  float* dk_s = reinterpret_cast<float*>(smem + L::kDk);
  float* dv_s = reinterpret_cast<float*>(smem + L::kDv);
  float* lse_s = reinterpret_cast<float*>(smem + L::kStats);
  float* delta_s = lse_s + BQ3;

  const int nq = (sq + BQ3 - 1) / BQ3;
  const int jj = blockIdx.x;  // key tile; the long ones (small jj) first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = hq / hkv;

  const size_t kv_row0 = ((size_t)b * hkv + hk) * skv;
  load_rows<T, D, BK>(k_s, L::LDT, k + kv_row0 * D, jj * BK, skv);
  load_rows<T, D, BK>(v_s, L::LDT, v + kv_row0 * D, jj * BK, skv);
  for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
    const int o = (idx / D) * L::LDO + idx % D;
    dk_s[o] = 0.f;
    dv_s[o] = 0.f;
  }

  // query tile i reaches key tile jj iff its last row sees jj's first key
  const int first_i = causal ? (jj * BK) / BQ3 : 0;
  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const size_t q_row0 = ((size_t)b * hq + h) * sq;
    for (int i = first_i; i < nq; ++i) {
      __syncthreads();  // the previous step is done with Q, dO, P and dS
      load_rows<T, D, BQ3>(q_s, L::LDT, q + q_row0 * D, i * BQ3, sq);
      load_rows<T, D, BQ3>(do_s, L::LDT, dout + q_row0 * D, i * BQ3, sq);
      load_vector<BQ3>(lse_s, lse + q_row0, i * BQ3, sq);
      load_vector<BQ3>(delta_s, delta + q_row0, i * BQ3, sq);
      __syncthreads();
      tile_gemm<BQ3, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
                                                s_s, L::LDS);
      tile_gemm<BQ3, BK, D, true, false, false>(do_s, L::LDT, v_s,
                                                L::LDT, dp_s, L::LDS);
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ3 * BK; idx += kThreads) {
        const int rr = idx / BK;
        const int c = idx % BK;
        const int row = i * BQ3 + rr;
        float p = 0.f;
        float ds = 0.f;
        if (row < sq) {  // padding rows contribute nothing
          const float s = masked(causal, row, jj * BK + c, skv)
                              ? kMasked
                              : s_s[rr * L::LDS + c] * scale;
          p = expf(s - lse_s[rr]);
          ds = p * (dp_s[rr * L::LDS + c] - delta_s[rr]) * scale;
        }
        p_s[rr * L::LDP + c] = Cvt<T>::from(p);    // p in dO's dtype
        ds_s[rr * L::LDP + c] = Cvt<T>::from(ds);  // ds in q's dtype
      }
      __syncthreads();
      // dV[key][d] += sum_row P[row][key] dO[row][d]: A = P^T (col-major)
      tile_gemm<BK, D, BQ3, false, true, true>(p_s, L::LDP, do_s, L::LDT,
                                               dv_s, L::LDO);
      tile_gemm<BK, D, BQ3, false, true, true>(ds_s, L::LDP, q_s, L::LDT,
                                               dk_s, L::LDO);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
    const int key = jj * BK + idx / D;
    if (key < skv) {
      const int o = (idx / D) * L::LDO + idx % D;
      dk[(kv_row0 + key) * D + idx % D] = Cvt<T>::from(dk_s[o]);
      dv[(kv_row0 + key) * D + idx % D] = Cvt<T>::from(dv_s[o]);
    }
  }
}

// ---- launches ------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq | dk, dv
  int batch, hq, hkv, sq, skv;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_bf16(const Args& a) {
  constexpr int bytes = k2::Layout<D>::kBytes;
  auto kernel = flash_dq_mma_kernel<D>;
  dim3 grid;
  cudaError_t err = grid_1d((a.sq + k2::BQ - 1) / k2::BQ, a.hq, a.batch,
                            &grid);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, k2::kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.batch, a.hq, a.hkv, a.sq, a.skv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a) {
  constexpr int bytes = k3::Layout<D>::kBytes;
  auto kernel = flash_dkv_mma_kernel<D>;
  dim3 grid;
  cudaError_t err = grid_1d((a.skv + k3::BK - 1) / k3::BK, a.hkv, a.batch,
                            &grid);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, k3::kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.batch, a.hq,
      a.hkv, a.sq, a.skv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_fp32(const Args& a) {
  constexpr int bytes = DqSmem<D>::kBytes;
  auto kernel = flash_dq_fp32_kernel<D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), a.hq, a.hkv, a.sq, a.skv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_fp32(const Args& a) {
  constexpr int bytes = DkvSmem<D>::kBytes;
  auto kernel = flash_dkv_fp32_kernel<D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + BK - 1) / BK, a.hkv, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.hq, a.hkv,
      a.sq, a.skv, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, int D>
cudaError_t launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0: return DKV ? launch_dkv_fp32<D>(a) : launch_dq_fp32<D>(a);
    case 1: return DKV ? launch_dkv_bf16<D>(a) : launch_dq_bf16<D>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.batch < 1 || a.hkv < 1 || a.sq < 1 || a.skv < 1 ||
      a.hq % a.hkv != 0 || a.batch > 65535 || a.hq > 65535) {
    return cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 16: return launch<DKV, 16>(dtype, a);
    case 32: return launch<DKV, 32>(dtype, a);
    case 64: return launch<DKV, 64>(dtype, a);
    case 128: return launch<DKV, 128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it); lse and delta are fp32 [B, Hq, Sq].
extern "C" int st_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int batch,
                               int num_q_heads, int num_kv_heads, int seq_q,
                               int seq_kv, int head_dim, float scale,
                               int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch, num_q_heads,
               num_kv_heads, seq_q, seq_kv, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim, dtype);
}

extern "C" int st_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int batch, int num_q_heads, int num_kv_heads,
                                int seq_q, int seq_kv, int head_dim,
                                float scale, int causal, int dtype,
                                void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch, num_q_heads,
               num_kv_heads, seq_q, seq_kv, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim, dtype);
}
