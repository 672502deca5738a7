// Flash-attention forward (K1), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (scaletorch_tpu/ops/pallas/flash.py, launched by `_flash_forward`). It
// computes the same function: O = softmax(scale * Q K^T + causal mask) V by
// online softmax over key tiles, and LSE = m + log(l), for q [B, Hq, Sq, D]
// against the unexpanded k, v [B, Hkv, Skv, D] (query head h reads key head
// h / (Hq / Hkv)). Numerics kept from the Pallas kernel: the scores come
// out of the product in fp32 and are scaled after it; masked logits are
// -1e30; m, l and the accumulator are fp32; l sums the unrounded p; p is
// rounded to v's dtype before P V; l is floored at 1e-30. The causal mask
// compares absolute indices (row >= col) for any Sq and Skv.
//
// What bounds it on the H100: operations. A causal forward does
// 4 * B * Hq * D * S(S+1)/2 flops over 4 * B * Hq * S * D bytes of q, out
// (and k, v once), thousands of flops per byte at S = 8192, far above the
// ~295 flop/byte where the tensor cores become the limit.
//
// bf16: register accumulators on tensor-core mma.sync (mma_sm90.cuh), the
// design of the bf16 dQ kernel (flash_bwd.cu) run forward.
//   * One CTA of 4 warps per (64 query rows, q head, batch), each warp
//     owning 16 rows; a tile-major 1-D grid issues every head's longest
//     causal tiles first.
//   * Q is copied once (cp.async into an XOR-swizzled tile) and held in
//     registers as A fragments for the whole loop.
//   * K and V tiles of 64 keys stream through a two-stage cp.async ring;
//     zero-size copies fill the rows past Skv. One barrier per key tile.
//   * S = Q K^T is formed in registers; the online softmax runs on the
//     accumulator fragments (a quad of lanes shares a row: the row max and
//     sum take two shuffles); the mask is evaluated only on tiles that
//     straddle the diagonal or the ragged key edge, and a warp skips the
//     tiles that lie wholly above its rows' diagonal.
//   * P is rounded to bf16 straight into the A fragments of O += P V
//     (`acc_to_a`); V is the B operand through ldmatrix.trans. O stays in
//     registers, is divided by max(l, 1e-30) once, and leaves through the
//     warp's own rows of the Q tile, so the stores to global are 16 bytes.
//   * At head_dim 16 (rows of 32 bytes, four to a swizzled 128-byte line)
//     S = Q K^T is one k-step and O = P V two n8 tiles: the same loop with
//     a quarter of D 64's products per key, so it is bound by the softmax
//     and the K, V stream more than by the tensor cores.
//   * One 16-row m-tile per warp and two stages: the kernel fits two CTAs
//     an SM without spilling. Two m-tiles per warp would read each K and V
//     fragment once for both (fewer shared-memory reads per product) but
//     hold O (128 registers at D 128), S and the Q fragments at once;
//     built that way it spilled at D 128 and ran no faster on the H100,
//     even with S worked in 32-key chunks and Q read from shared memory.
//     Neither did a three-stage ring, nor three CTAs an SM (registers
//     capped at 168, Q parked in the ring: it spilled).
// What it leaves on the table: mma.sync's issue rate and the latency of
// the softmax between the two products of a tile, with 8 warps an SM to
// hide it; each warp reads every K and V tile itself (one ldmatrix.x4 per
// two mma). FlashAttention-3's wgmma (B read once per warpgroup), TMA and
// ping-pong warpgroups that overlap one tile's softmax with the next
// tile's products address all three.
// fp32: shared-memory tiles with `tile_gemm`'s fp32 FMA products
// (no TF32), one CTA of 8 warps per 64-row query tile.
//
// The C entry returns the cudaError_t of cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it was not built for). It
// launches on the caller's stream, allocates nothing, does not synchronise.

#include "flash_common.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// ---- bf16 K1 on mma.sync ----------------------------------------------------------
namespace k1 {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // query rows per CTA, 16 per warp
constexpr int BK = 64;           // keys per ring stage
constexpr int kStages = 2;       // ring depth

template <int D>
struct Layout {
  using QTile = mma::SwizzledTile<BQ, D>;  // Q, then O on its way out
  using KTile = mma::SwizzledTile<BK, D>;  // K, V
  static constexpr int kQ = 0;
  static constexpr int kRing = QTile::kBytes;  // stage s: K, then V
  static constexpr int kStageBytes = 2 * KTile::kBytes;
  static constexpr int kBytes = kRing + kStages * kStageBytes;
};
}  // namespace k1

template <int D>
__global__ void __launch_bounds__(k1::kThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int batch, int hq, int hkv,
                     int sq, int skv, float scale, bool causal) {
  constexpr int kThreads = k1::kThreads;
  constexpr int kStages = k1::kStages;
  constexpr int BQ = k1::BQ;
  constexpr int BK = k1::BK;
  using L = k1::Layout<D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  constexpr int RB = KTile::kRowBytes;
  constexpr int KSTEPS = D / 16;  // k-steps of S over head_dim
  constexpr int NT = D / 8;       // n-tiles of O
  constexpr int ST = BK / 8;      // n-tiles of S
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
  // key tile j is needed iff its first key is visible to the tile's last row
  const int last_j = causal ? min(nk - 1, (i * BQ + BQ - 1) / BK) : nk - 1;

  auto load_kv = [&](int j) {
    const uint32_t dst = base + L::kRing + (j % kStages) * L::kStageBytes;
    KTile::template load_async<kThreads>(dst, k_bh, j * BK, skv, tid);
    KTile::template load_async<kThreads>(dst + KTile::kBytes, v_bh, j * BK,
                                         skv, tid);
  };
  QTile::template load_async<kThreads>(base + L::kQ, q + q_row0 * D, i * BQ,
                                       sq, tid);
  mma::cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j <= last_j) load_kv(j);
    mma::cp_async_commit();  // one group per stage, empty or not
  }

  // this thread's query rows: g and g + 8 of its warp's 16 (lane = 4g + t)
  const int warp_row0 = i * BQ + warp * 16;
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    row[x] = warp_row0 + (lane >> 2) + 8 * x;
    m[x] = kMasked;
    l[x] = 0.f;
  }

  mma::cp_async_wait<kStages - 1>();  // Q
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma::ldmatrix_x4(qf[kk],
                     mma::a_addr<RB>(la, base + L::kQ, warp * 16, kk * 16));
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int j = 0; j <= last_j; ++j) {
    mma::cp_async_wait<kStages - 2>();  // tile j
    __syncthreads();  // ... seen by all; tile j - 1's stage is free
    if (j + kStages - 1 <= last_j) load_kv(j + kStages - 1);
    mma::cp_async_commit();
    const int key0 = j * BK;
    // warp-uniform: every key of the tile lies past this warp's diagonal
    if (causal && key0 > warp_row0 + 15) continue;
    const uint32_t ks = base + L::kRing + (j % kStages) * L::kStageBytes;
    const uint32_t vs = ks + KTile::kBytes;

    // S = Q K^T (B: K rows as [n][k], no transpose)
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, mma::b_addr<RB>(la, ks, np * 16, kk * 16));
        mma::mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scaled logits; the mask only where the tile straddles the diagonal
    // of this warp's rows or the ragged key edge (warp-uniform)
    const bool edge =
        key0 + BK > skv || (causal && key0 + BK - 1 > warp_row0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float z = s[n][e] * scale;
        if (edge && masked(causal, row[e >> 1], key0 + n * 8 + 2 * t + (e & 1),
                           skv)) {
          z = kMasked;
        }
        s[n][e] = z;
        mx[e >> 1] = fmaxf(mx[e >> 1], z);
      }
    }
    // online softmax: the row's four lanes agree on m, then p, corr, l
    float m2[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      corr[x] = exp2f((m[x] - mx[x]) * kLog2e);
      m[x] = mx[x];
      m2[x] = mx[x] * kLog2e;
    }
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], kLog2e, -m2[e >> 1]));
        psum[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      psum[x] += __shfl_xor_sync(0xffffffffu, psum[x], 1);
      psum[x] += __shfl_xor_sync(0xffffffffu, psum[x], 2);
      l[x] = l[x] * corr[x] + psum[x];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V (P rounded to bf16 in registers; B: V rows as [k][n])
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      mma::acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(bv, mma::a_addr<RB>(la, vs, kc * 16, dn * 16));
        mma::mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
        mma::mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
  }

  // O / max(l, 1e-30) in bf16 through this warp's own 16 rows of the Q
  // tile (no other warp reads them; its Q fragments are in registers),
  // then 16-byte stores
  unsigned char* stage = smem + L::kQ;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float lf = fmaxf(l[x], 1e-30f);
    const int r = warp * 16 + (lane >> 2) + 8 * x;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(stage + QTile::offset(r, col / 8) +
                                   (col % 8) * 2) =
          mma::pack_bf16(acc[n][2 * x] / lf, acc[n][2 * x + 1] / lf);
    }
    if (t == 0 && row[x] < sq) lse[q_row0 + row[x]] = m[x] + logf(lf);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * QTile::kChunks / 32; ++it) {
    const int idx = lane + 32 * it;
    const int r = idx / QTile::kChunks;
    const int c = idx % QTile::kChunks;
    if (warp_row0 + r < sq) {
      *reinterpret_cast<uint4*>(out + (q_row0 + warp_row0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage +
                                          QTile::offset(warp * 16 + r, c));
    }
  }
}

// ---- fp32: shared-memory tiles, FMA products ---------------------------------------
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per loop step

template <int D>
struct FwdSmem {
  using T = float;
  static constexpr int LDT = D + Pad<T>::value;   // Q, K, V rows
  static constexpr int LDS = BK + 4;              // fp32 scores
  static constexpr int LDP = BK + Pad<T>::value;  // P
  static constexpr int LDO = D + 4;               // fp32 accumulator
  static constexpr int kTile = round_up_128(BQ * LDT * sizeof(T));
  static constexpr int kScores = round_up_128(BQ * LDS * 4);
  static constexpr int kP = round_up_128(BQ * LDP * sizeof(T));
  static constexpr int kAcc = round_up_128(BQ * LDO * 4);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kS = kV + kTile;
  static constexpr int kPOff = kS + kScores;
  static constexpr int kO = kPOff + kP;
  static constexpr int kStats = kO + kAcc;  // m, l, corr: 3 x BQ floats
  static constexpr int kBytes = kStats + 3 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int hq, int hkv, int sq,
                      int skv, float scale, bool causal) {
  using T = float;
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  T* p_s = reinterpret_cast<T*>(smem + L::kPOff);
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  float* m_s = reinterpret_cast<float*>(smem + L::kStats);
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int nq = (sq + BQ - 1) / BQ;
  const int nk = (skv + BK - 1) / BK;
  const int i = nq - 1 - blockIdx.x;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const size_t q_row0 = ((size_t)b * hq + h) * sq;
  const T* q_bh = q + q_row0 * D;
  const T* k_bh = k + ((size_t)b * hkv + hk) * skv * D;
  const T* v_bh = v + ((size_t)b * hkv + hk) * skv * D;

  load_rows<T, D, BQ>(q_s, L::LDT, q_bh, i * BQ, sq);
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    o_s[(idx / D) * L::LDO + idx % D] = 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }

  // key tile j is needed iff its first key is visible to the tile's last row
  const int last_j = causal ? min(nk - 1, (i * BQ + BQ - 1) / BK) : nk - 1;
  for (int j = 0; j <= last_j; ++j) {
    __syncthreads();  // the previous step is done with K, V and P
    load_rows<T, D, BK>(k_s, L::LDT, k_bh, j * BK, skv);
    load_rows<T, D, BK>(v_s, L::LDT, v_bh, j * BK, skv);
    __syncthreads();
    tile_gemm<BQ, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
                                             s_s, L::LDS);
    __syncthreads();
    // online softmax: warp w owns rows w*8 .. w*8+7, lanes own 2 columns
    for (int rr = 0; rr < BQ / kWarps; ++rr) {
      const int r = warp * (BQ / kWarps) + rr;
      const int row = i * BQ + r;
      float s[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        s[t] = masked(causal, row, j * BK + c, skv)
                   ? kMasked
                   : s_s[r * L::LDS + c] * scale;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = expf(s[t] - m_new);
        psum += p;
        p_s[r * L::LDP + lane + 32 * t] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
      const int r = idx / D;
      o_s[r * L::LDO + idx % D] *= corr_s[r];
    }
    __syncthreads();
    tile_gemm<BQ, D, BK, true, true, true>(p_s, L::LDP, v_s, L::LDT, o_s,
                                           L::LDO);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D;
    const int row = i * BQ + r;
    if (row < sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      out[(q_row0 + row) * D + idx % D] = o_s[r * L::LDO + idx % D] / l;
    }
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = i * BQ + r;
    if (row < sq) lse[q_row0 + row] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// ---- launches ------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int batch, hq, hkv, sq, skv;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  constexpr int bytes = k1::Layout<D>::kBytes;
  auto kernel = flash_fwd_mma_kernel<D>;
  dim3 grid;
  cudaError_t err = grid_1d((a.sq + k1::BQ - 1) / k1::BQ, a.hq, a.batch,
                            &grid);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, k1::kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), a.batch, a.hq, a.hkv, a.sq, a.skv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Args& a) {
  constexpr int bytes = FwdSmem<D>::kBytes;
  auto kernel = flash_fwd_fp32_kernel<D>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), a.hq, a.hkv, a.sq, a.skv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0: return launch_fp32<D>(a);
    case 1: return launch_bf16<D>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse is fp32).
extern "C" int st_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int batch, int num_q_heads,
                            int num_kv_heads, int seq_q, int seq_kv,
                            int head_dim, float scale, int causal, int dtype,
                            void* stream) {
  if (batch < 1 || num_kv_heads < 1 || seq_q < 1 || seq_kv < 1 ||
      num_q_heads % num_kv_heads != 0 || batch > 65535 ||
      num_q_heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args a{q,     k,          v,       out,     lse,
               batch, num_q_heads, num_kv_heads, seq_q, seq_kv,
               scale, causal != 0, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16: return launch<16>(dtype, a);
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}
