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
// What bounds them on the H100: bytes, at the training shape (E 128, G 1,
// C 320, H 2048, I 768, about 256 rows an expert): the grads pass reads
// the 3 H I weights of every filled expert, K6 two of them, K7 writes 3 H I
// gradients an expert; their flops (6, 4 and 6 H I a row) come close.
//
// Design. The TPU dx kernel keeps a [bc, H] fp32 accumulator across its I
// loop (512 KB at H 2048 for 64 rows): too big for a CTA. So the math is
// split at the tensors the TPU kernels round anyway: the grads pass, K6,
// K7. No CTA reads a slot tile at or past a fill count.
//
// bf16: pipelined grouped GEMMs on tensor-core mma.sync (gmlp_ring.cuh,
// K5's ring generalised): a cp.async ring of XOR-swizzled tiles, A through
// ldmatrix, B through ldmatrix(.trans), fp32 sums in registers, the
// elementwise math and the count mask applied there, 16-byte stores of
// tiles staged in shared memory. 8 warps a CTA, one CTA an SM.
//   * grads pass: one CTA per (64 I-columns, 128 slot rows, (e, g)) runs
//     three products in one ring over H: x Wg and x Wu (sharing the x
//     tile) and dO Wd^T (Wd's rows read as [I][H] tiles, transposed by
//     ldmatrix). A 56 KB stage holds the x, dO, Wg, Wu and Wd tiles; three
//     stages. 4 x 2 warps of 32 x 32 keep 96 fp32 sums a thread. The
//     elementwise gradient runs on the sums; s, dG and dU leave through
//     the drained ring. The 128-row slot tile halves the weight re-reads
//     of a 64-row one.
//   * K6: one CTA per (128 H-columns, 128 slot rows, (e, g)): dG Wg^T +
//     dU Wu^T, two products into one accumulator over I, Wg's and Wu's
//     rows as [128][64] tiles read through ldmatrix; 64 KB stages, three
//     of them. The count mask zeroes rows in registers; a tile past the
//     fill count writes its zeros and returns, as K5's down launch does.
//   * K7: one CTA per (128 output rows, a walk of output-column tiles,
//     expert, kind: gate/up or down). Its A operand, x (dWg, dWu) or s
//     (dWd) of the expert's filled slot tiles and the CTA's 128 columns,
//     stays resident in shared memory (at most 320 rows, 80 KB) while the
//     CTA walks its column tiles: 6 of I's for gate/up, 12 of H's for down
//     (12 products each). The B operands (dG and dU, or dO) stream through
//     a four-stage ring, one step per (column tile, slot tile). So x and s
//     are read once per output-row block and not once per 64 x 64 tile.
//     The sum over (group, slot tile) runs inside the CTA in a fixed
//     order: no atomics, the result is deterministic. x, s, dG, dU and dO
//     past the count load as zeros (the TPU dW kernel's dO mask). An
//     expert whose counts are all 0 writes zeros. Where the rows do not
//     fit the resident buffer, A streams through the ring beside B (the
//     resident buffer holds its stages). A summed column tile leaves warp
//     by warp: each warp stages its own 32 x 32 blocks in a buffer of its
//     own and stores them, with no barrier across the CTA, while the next
//     tile's loads are in flight. The loader and the consumer step through
//     the walk with cursors: no division or search per k step.
// What they still leave: mma.sync instead of wgmma + TMA; the s / dG / dU
// round trip through device memory; the grads pass and K6 re-read an
// expert's weights for each 128-row slot tile and their A rows for each
// column tile (from L2).
// fp32: the tile path of grouped_mlp_common.cuh (plain FMA products).
//
// Each C entry returns the cudaError_t of cudaGetLastError() after its
// launch (cudaErrorInvalidValue for a shape it was not built for). They
// launch on the caller's stream, allocate nothing, do not synchronise.

#include "gmlp_ring.cuh"

namespace {

using namespace gmlp;
using bf16 = __nv_bfloat16;
using gring::Products;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// ---- bf16: the grads pass on mma.sync ------------------------------------------------
namespace kg {
constexpr int BM = 128, kStages = 3;
using W = gring::Warps<BM, BN, 4, 2>;  // 8 warps of 32 x 32
using ATile = mma::SwizzledTile<BM, BK>;  // x, dO
using BTile = mma::SwizzledTile<BK, BN>;  // Wg, Wu: [H][I] rows
using DTile = mma::SwizzledTile<BN, BK>;  // Wd: [I][H] rows, read as Wd^T
constexpr int kStageBytes = 2 * ATile::kBytes + 2 * BTile::kBytes +
                            DTile::kBytes;
constexpr int kBytes = kStages * kStageBytes;
static_assert(3 * W::OTile::kBytes <= kBytes, "s, dG, dU fit the ring");

// x Wg, x Wu, dO Wd^T
struct Plan {
  static constexpr int kNA = 2, kNP = 3, kNAcc = 3;
  static constexpr bool kATrans = false;
  __host__ __device__ static constexpr int a_of(int p) {
    return p < 2 ? 0 : 1;
  }
  __host__ __device__ static constexpr int acc_of(int p) { return p; }
  __host__ __device__ static constexpr bool b_col(int p) { return p == 2; }
};
}  // namespace kg

__global__ void __launch_bounds__(kg::W::kThreads, 1)
gmlp_grads_mma_kernel(const bf16* __restrict__ x,
                      const int* __restrict__ counts,
                      const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu,
                      const bf16* __restrict__ wd,
                      const bf16* __restrict__ dout, bf16* __restrict__ s_ws,
                      bf16* __restrict__ dg_ws, bf16* __restrict__ du_ws,
                      int groups, int cap, int hid, int inter) {
  using W = kg::W;
  using Pr = Products<W, kg::Plan>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * kg::BM;
  const int count = fill_count(counts, eg, cap);
  if (row0 >= count) return;  // K6 and K7 never read this tile
  const int e = eg / groups;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const uint32_t base = mma::smem_u32(smem);
  const size_t rows0 = (size_t)eg * cap;
  const bf16* x_eg = x + rows0 * hid;
  const bf16* do_eg = dout + rows0 * hid;
  const bf16* wg_e = wg + (size_t)e * hid * inter + n0;
  const bf16* wu_e = wu + (size_t)e * hid * inter + n0;
  const bf16* wd_e = wd + ((size_t)e * inter + n0) * hid;  // rows n0..
  constexpr int kA = kg::ATile::kBytes;
  constexpr int kB = kg::BTile::kBytes;
  const mma::LaneAddr la(tid & 31);
  const int m0 = W::m0();
  const int nw0 = W::n0();
  typename Pr::Acc acc;  // x Wg, x Wu, dO Wd^T
  Pr::zero(acc);
  gring::Ring<kg::kStages>::run(
      hid / BK,
      [&](int kt, int slot) {
        const uint32_t dst = base + slot * kg::kStageBytes;
        const int k0 = kt * BK;
        kg::ATile::load_async_strided<W::kThreads>(dst, x_eg + k0, hid, row0,
                                                   count, tid);
        kg::ATile::load_async_strided<W::kThreads>(dst + kA, do_eg + k0, hid,
                                                   row0, count, tid);
        kg::BTile::load_async_strided<W::kThreads>(
            dst + 2 * kA, wg_e + (size_t)k0 * inter, inter, 0, BK, tid);
        kg::BTile::load_async_strided<W::kThreads>(
            dst + 2 * kA + kB, wu_e + (size_t)k0 * inter, inter, 0, BK, tid);
        kg::DTile::load_async_strided<W::kThreads>(
            dst + 2 * kA + 2 * kB, wd_e + k0, hid, 0, BN, tid);
      },
      [&](int, int slot) {
        const uint32_t st = base + slot * kg::kStageBytes;
        const uint32_t a[2] = {st, st + kA};
        const uint32_t b[3] = {st + 2 * kA, st + 2 * kA + kB,
                               st + 2 * kA + 2 * kB};
        Pr::step(acc, a, b, la, m0, nw0);
      });
  // s, dG, dU in fp32 on the sums, then rounded, through the drained ring
  constexpr int kO = W::OTile::kBytes;
  gring::for_each_pair<W>([&](int r, int col, int mt, int nt, int xr) {
    float sv[2], dgv[2], duv[2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const float g = acc[0][mt][nt][2 * xr + y];
      const float u = acc[1][mt][nt][2 * xr + y];
      const float ds = acc[2][mt][nt][2 * xr + y];
      const float sig = sigmoid(g);
      const float silu = g * sig;
      sv[y] = silu * u;
      duv[y] = ds * silu;
      dgv[y] = ds * u * (sig * (1.f + g * (1.f - sig)));
    }
    const uint32_t o = gring::pair_offset<W>(r, col);
    *reinterpret_cast<uint32_t*>(smem + o) = mma::pack_bf16(sv[0], sv[1]);
    *reinterpret_cast<uint32_t*>(smem + kO + o) =
        mma::pack_bf16(dgv[0], dgv[1]);
    *reinterpret_cast<uint32_t*>(smem + 2 * kO + o) =
        mma::pack_bf16(duv[0], duv[1]);
  });
  __syncthreads();
  const int rows = min(kg::BM, cap - row0);
  const size_t out0 = (rows0 + row0) * inter + n0;
  gring::store_tile<W>(smem, s_ws + out0, inter, rows);
  gring::store_tile<W>(smem + kO, dg_ws + out0, inter, rows);
  gring::store_tile<W>(smem + 2 * kO, du_ws + out0, inter, rows);
}

// ---- bf16: K6 on mma.sync ------------------------------------------------------------
namespace k6 {
constexpr int BM = 128, BNX = 128, kStages = 3;
using W = gring::Warps<BM, BNX, 4, 2>;  // 8 warps of 32 x 64
using ATile = mma::SwizzledTile<BM, BK>;   // dG, dU
using WTile = mma::SwizzledTile<BNX, BK>;  // Wg, Wu: [H][I] rows, read as ^T
constexpr int kStageBytes = 2 * ATile::kBytes + 2 * WTile::kBytes;
constexpr int kBytes = kStages * kStageBytes;
static_assert(W::OTile::kBytes <= kBytes, "dx fits the ring");

// dG Wg^T + dU Wu^T into one sum
struct Plan {
  static constexpr int kNA = 2, kNP = 2, kNAcc = 1;
  static constexpr bool kATrans = false;
  __host__ __device__ static constexpr int a_of(int p) { return p; }
  __host__ __device__ static constexpr int acc_of(int) { return 0; }
  __host__ __device__ static constexpr bool b_col(int) { return true; }
};
}  // namespace k6

__global__ void __launch_bounds__(k6::W::kThreads, 1)
gmlp_dx_mma_kernel(const int* __restrict__ counts,
                   const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                   const bf16* __restrict__ dg_ws,
                   const bf16* __restrict__ du_ws, bf16* __restrict__ dx,
                   int groups, int cap, int hid, int inter) {
  using W = k6::W;
  using Pr = Products<W, k6::Plan>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int eg = blockIdx.z;
  const int row0 = blockIdx.y * k6::BM;
  const int n0 = blockIdx.x * k6::BNX;
  const int count = fill_count(counts, eg, cap);
  const int rows = min(k6::BM, cap - row0);
  const int cols = min(k6::BNX, hid - n0);
  bf16* dx_t = dx + ((size_t)eg * cap + row0) * hid + n0;
  if (row0 >= count) {  // a tile past the fill count: structural zeros
    gring::store_zeros<W>(dx_t, hid, rows, cols);
    return;
  }
  const int e = eg / groups;
  const int tid = threadIdx.x;
  const uint32_t base = mma::smem_u32(smem);
  const size_t ws0 = (size_t)eg * cap * inter;
  const bf16* wg_e = wg + ((size_t)e * hid + n0) * inter;  // rows n0..
  const bf16* wu_e = wu + ((size_t)e * hid + n0) * inter;
  constexpr int kA = k6::ATile::kBytes;
  constexpr int kW = k6::WTile::kBytes;
  const mma::LaneAddr la(tid & 31);
  const int m0 = W::m0();
  const int nw0 = W::n0();
  typename Pr::Acc acc;
  Pr::zero(acc);
  gring::Ring<k6::kStages>::run(
      inter / BK,
      [&](int kt, int slot) {
        const uint32_t dst = base + slot * k6::kStageBytes;
        const int k0 = kt * BK;
        k6::ATile::load_async_strided<W::kThreads>(dst, dg_ws + ws0 + k0,
                                                   inter, row0, count, tid);
        k6::ATile::load_async_strided<W::kThreads>(dst + kA, du_ws + ws0 + k0,
                                                   inter, row0, count, tid);
        k6::WTile::load_async_strided<W::kThreads>(dst + 2 * kA, wg_e + k0,
                                                   inter, 0, cols, tid);
        k6::WTile::load_async_strided<W::kThreads>(
            dst + 2 * kA + kW, wu_e + k0, inter, 0, cols, tid);
      },
      [&](int, int slot) {
        const uint32_t st = base + slot * k6::kStageBytes;
        const uint32_t a[2] = {st, st + kA};
        const uint32_t b[2] = {st + 2 * kA, st + 2 * kA + kW};
        Pr::step(acc, a, b, la, m0, nw0);
      });
  gring::stage_tile<W>(smem, [&](int r, int mt, int nt, int xr) {
    const bool in = row0 + r < count;
    return mma::pack_bf16(in ? acc[0][mt][nt][2 * xr] : 0.f,
                          in ? acc[0][mt][nt][2 * xr + 1] : 0.f);
  });
  __syncthreads();
  gring::store_tile<W>(smem, dx_t, hid, rows, cols);
}

// ---- bf16: K7 on mma.sync ------------------------------------------------------------
namespace k7 {
constexpr int BM = 128, BNT = 64, kStages = 4;  // output tile BM x BNT
constexpr int kResRows = 320;  // A rows an expert keeps resident
constexpr int kWalkGateUp = 6;  // I-column tiles a gate/up CTA walks
constexpr int kWalkDown = 12;   // H-column tiles a down CTA walks
using W = gring::Warps<BM, BNT, 4, 2>;  // 8 warps of 32 x 32
using ATile = mma::SwizzledTile<BK, BM>;   // a k step of x or s: [rows][M]
using BTile = mma::SwizzledTile<BK, BNT>;  // a k step of dG, dU or dO
constexpr int kRes = 0;  // resident A (or, streaming, A's ring stages)
constexpr int kResBytes = kResRows * BM * 2;
static_assert(kResRows % BK == 0 && kStages * ATile::kBytes <= kResBytes,
              "the resident buffer holds A's stages when A streams");
constexpr int kRing = kResBytes;  // B's stages
constexpr int kStageBytes = 2 * BTile::kBytes;
// then each warp's staged output blocks, one per product
constexpr int kOut = kRing + kStages * kStageBytes;
constexpr int kWarpBlockBytes = W::MW * W::NW * 2;
constexpr int kBytes = kOut + W::kThreads / 32 * 2 * kWarpBlockBytes;

// x^T dG and x^T dU (NP 2), or s^T dO (NP 1): A read as [rows][M] tiles
template <int NP>
struct Plan {
  static_assert(NP == 1 || NP == 2, "gate/up or down");
  static constexpr int kNA = 1, kNP = NP, kNAcc = NP;
  static constexpr bool kATrans = true;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int acc_of(int p) { return p; }
  __host__ __device__ static constexpr bool b_col(int) { return false; }
};

// One CTA's share of an expert's dW of one kind: output rows m0..m0+127
// of an [m_dim, n_dim] gradient, column tiles j0..j0+nj-1. A: rows of an
// [E*G*C, lda] matrix (x or s), the CTA's columns at m0; B[p]: rows of an
// [E*G*C, ldb] matrix (dG, dU or dO); out[p]: the expert's gradient.
template <int NP>
__device__ __forceinline__ void dw_walk(
    unsigned char* smem, const int* counts, int e, int groups, int cap,
    const bf16* a_src, int lda, int m_dim, const bf16* const (&b_src)[NP],
    int ldb, int n_dim, bf16* const (&out)[NP], int m0, int j0, int nj) {
  using Pr = Products<W, Plan<NP>>;
  const int tid = threadIdx.x;
  const uint32_t base = mma::smem_u32(smem);
  const int m_rows = min(BM, m_dim - m0);
  // the k steps: every slot tile below a fill count, groups in order
  int nk = 0;
  for (int g = 0; g < groups; ++g) {
    nk += ceil_div(fill_count(counts, e * groups + g, cap), BK);
  }
  if (nk == 0) {  // an expert without rows: zero gradients
    for (int j = 0; j < nj; ++j) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        gring::store_zeros<W>(out[p] + (size_t)m0 * n_dim + (j0 + j) * BNT,
                              n_dim, m_rows);
      }
    }
    return;
  }
  // The loader's place in the walk: column tile j, k step kt = slot tile
  // t of group g, whose rows start at row `first` of [E*G*C] and hold
  // `count` rows. Loader and consumer step through the walk in order, so
  // each advances by one k step without a division or a search.
  struct Place {
    int j, kt, g, t, count;
    size_t first;
  };
  int g0 = 0;  // the first group with rows
  while (fill_count(counts, e * groups + g0, cap) == 0) ++g0;
  const Place start{0, 0, g0, 0, fill_count(counts, e * groups + g0, cap),
                    (size_t)(e * groups + g0) * cap};
  auto advance = [&](Place& q) {
    if (++q.kt == nk) {  // the next column tile, from the first slot tile
      const int j = q.j + 1;
      q = start;
      q.j = j;
    } else if (++q.t * BK >= q.count) {  // the next group with rows
      q.t = 0;
      do {
        ++q.g;
        q.count = fill_count(counts, e * groups + q.g, cap);
      } while (q.count == 0);
      q.first = (size_t)(e * groups + q.g) * cap;
    }
  };
  auto load_a = [&](const Place& q, uint32_t dst) {
    ATile::load_async_strided<W::kThreads>(dst, a_src + q.first * lda + m0,
                                           lda, q.t * BK, q.count, tid,
                                           m_dim - m0);
  };
  const bool resident = nk * BK <= kResRows;
  if (resident) {  // lands with step 0's copies
    Place q = start;
    for (int kt = 0; kt < nk; ++kt, advance(q)) {
      load_a(q, base + kRes + kt * ATile::kBytes);
    }
  }
  const mma::LaneAddr la(tid & 31);
  const int warp = tid >> 5;
  const int wm0 = W::m0();
  const int wn0 = W::n0();
  typename Pr::Acc acc;
  Pr::zero(acc);
  Place ld = start;  // the loader's place
  int cj = 0, ckt = 0;  // the consumer's column tile and k step
  gring::Ring<kStages>::run(
      nj * nk,
      [&](int, int slot) {
        const uint32_t dst = base + kRing + slot * kStageBytes;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          BTile::load_async_strided<W::kThreads>(
              dst + p * BTile::kBytes,
              b_src[p] + ld.first * ldb + (j0 + ld.j) * BNT, ldb, ld.t * BK,
              ld.count, tid);
        }
        if (!resident) load_a(ld, base + kRes + slot * ATile::kBytes);
        advance(ld);
      },
      [&](int, int slot) {
        const uint32_t a[1] = {
            base + kRes + (resident ? ckt : slot) * ATile::kBytes};
        uint32_t b[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          b[p] = base + kRing + slot * kStageBytes + p * BTile::kBytes;
        }
        Pr::step(acc, a, b, la, wm0, wn0);
        if (ckt == nk - 1) {  // column tile cj is summed: write it
          const int n0 = (j0 + cj) * BNT;
          // each warp stages and stores its own 32 x 32 blocks: no barrier
          unsigned char* blk = smem + kOut + warp * NP * kWarpBlockBytes;
          gring::store_warp_block<W>(
              blk, out[0] + (size_t)m0 * n_dim + n0, n_dim, m_rows,
              [&](int, int mt, int nt, int xr) {
                return mma::pack_bf16(acc[0][mt][nt][2 * xr],
                                      acc[0][mt][nt][2 * xr + 1]);
              });
          if constexpr (NP == 2) {
            gring::store_warp_block<W>(
                blk + kWarpBlockBytes, out[1] + (size_t)m0 * n_dim + n0,
                n_dim, m_rows, [&](int, int mt, int nt, int xr) {
                  return mma::pack_bf16(acc[1][mt][nt][2 * xr],
                                        acc[1][mt][nt][2 * xr + 1]);
                });
          }
          Pr::zero(acc);
          ++cj;
          ckt = 0;
        } else {
          ++ckt;
        }
      });
}
}  // namespace k7

// blockIdx.y: the expert; blockIdx.x: a gate/up unit (128 rows of H, a
// walk of I's column tiles), then a down unit (128 rows of I, a walk of
// H's column tiles).
__global__ void __launch_bounds__(k7::W::kThreads, 1)
gmlp_dw_mma_kernel(const bf16* __restrict__ x,
                   const int* __restrict__ counts,
                   const bf16* __restrict__ dout,
                   const bf16* __restrict__ s_ws,
                   const bf16* __restrict__ dg_ws,
                   const bf16* __restrict__ du_ws, bf16* __restrict__ dwg,
                   bf16* __restrict__ dwu, bf16* __restrict__ dwd,
                   int groups, int cap, int hid, int inter) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.y;
  const size_t w_e = (size_t)e * hid * inter;
  const int walks_gu = ceil_div(inter / k7::BNT, k7::kWalkGateUp);
  const int units_gu = ceil_div(hid, k7::BM) * walks_gu;
  int u = blockIdx.x;
  if (u < units_gu) {
    const int j0 = (u % walks_gu) * k7::kWalkGateUp;
    const bf16* const b[2] = {dg_ws, du_ws};
    bf16* const out[2] = {dwg + w_e, dwu + w_e};
    k7::dw_walk<2>(smem, counts, e, groups, cap, x, hid, hid, b, inter,
                   inter, out, (u / walks_gu) * k7::BM, j0,
                   min(k7::kWalkGateUp, inter / k7::BNT - j0));
  } else {
    u -= units_gu;
    const int walks_dn = ceil_div(hid / k7::BNT, k7::kWalkDown);
    const int j0 = (u % walks_dn) * k7::kWalkDown;
    const bf16* const b[1] = {dout};
    bf16* const out[1] = {dwd + w_e};
    k7::dw_walk<1>(smem, counts, e, groups, cap, s_ws, inter, inter, b, hid,
                   hid, out, (u / walks_dn) * k7::BM, j0,
                   min(k7::kWalkDown, hid / k7::BNT - j0));
  }
}

inline int dw_units(int hid, int inter) {
  return ceil_div(hid, k7::BM) * ceil_div(inter / k7::BNT, k7::kWalkGateUp) +
         ceil_div(inter, k7::BM) * ceil_div(hid / k7::BNT, k7::kWalkDown);
}

// fp32 keeps the tile path: shared-memory tiles and the register
// accumulator's fp32 FMA products (grouped_mlp_common.cuh, no TF32).
namespace f32 {
using T = float;
constexpr int BM = 64;  // slot rows of one CTA (grads pass, K6)

// ---- fp32: the grads pass -------------------------------------------------------------
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

__global__ void __launch_bounds__(kThreads)
gmlp_grads_fp32_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                  const T* __restrict__ wg, const T* __restrict__ wu,
                  const T* __restrict__ wd, const T* __restrict__ dout,
                  T* __restrict__ s_ws, T* __restrict__ dg_ws,
                  T* __restrict__ du_ws, int groups, int cap, int hid,
                  int inter) {
  using L = GradsSmem;
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

// ---- fp32: K6 --------------------------------------------------------------------------
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

__global__ void __launch_bounds__(kThreads)
gmlp_dx_fp32_kernel(const int* __restrict__ counts, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ dg_ws,
               const T* __restrict__ du_ws, T* __restrict__ dx, int groups,
               int cap, int hid, int inter) {
  using L = DxSmem;
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

// ---- fp32: K7 --------------------------------------------------------------------------
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
__global__ void __launch_bounds__(kThreads)
gmlp_dw_fp32_kernel(const T* __restrict__ x, const int* __restrict__ counts,
               const T* __restrict__ dout, const T* __restrict__ s_ws,
               const T* __restrict__ dg_ws, const T* __restrict__ du_ws,
               T* __restrict__ dwg, T* __restrict__ dwu, T* __restrict__ dwd,
               int groups, int cap, int hid, int inter) {
  using L = DwSmem;
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

}  // namespace f32

// ---- launches ------------------------------------------------------------------------
struct Args {
  const void *x, *counts, *wg, *wu, *wd, *dout;
  void *s, *dg, *du;      // workspaces [E, G, C, I]
  void *dx, *dwg, *dwu, *dwd;
  int experts, groups, cap, hid, inter;
  cudaStream_t stream;
};

template <typename T>
const T* as_in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* as_out(void* p) {
  return static_cast<T*>(p);
}

// Launch `kernel` on grid x block with `bytes` of dynamic shared memory.
template <typename Kernel, typename... A>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int bytes,
                   cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_grads(const Args& a, int dtype) {
  const int eg = a.experts * a.groups;
  if (dtype == 0) {
    using L = f32::GradsSmem;
    return launch(f32::gmlp_grads_fp32_kernel,
                  dim3(a.inter / BN, ceil_div(a.cap, f32::BM), eg), kThreads,
                  L::kBytes, a.stream, as_in<float>(a.x), as_in<int>(a.counts),
                  as_in<float>(a.wg), as_in<float>(a.wu), as_in<float>(a.wd),
                  as_in<float>(a.dout), as_out<float>(a.s), as_out<float>(a.dg),
                  as_out<float>(a.du), a.groups, a.cap, a.hid, a.inter);
  }
  return launch(gmlp_grads_mma_kernel,
                dim3(a.inter / BN, ceil_div(a.cap, kg::BM), eg),
                kg::W::kThreads, kg::kBytes, a.stream, as_in<bf16>(a.x),
                as_in<int>(a.counts), as_in<bf16>(a.wg), as_in<bf16>(a.wu),
                as_in<bf16>(a.wd), as_in<bf16>(a.dout), as_out<bf16>(a.s),
                as_out<bf16>(a.dg), as_out<bf16>(a.du), a.groups, a.cap, a.hid,
                a.inter);
}

cudaError_t launch_dx(const Args& a, int dtype) {
  const int eg = a.experts * a.groups;
  if (dtype == 0) {
    using L = f32::DxSmem;
    return launch(f32::gmlp_dx_fp32_kernel,
                  dim3(a.hid / BN, ceil_div(a.cap, f32::BM), eg), kThreads,
                  L::kBytes, a.stream, as_in<int>(a.counts), as_in<float>(a.wg),
                  as_in<float>(a.wu), as_in<float>(a.dg), as_in<float>(a.du),
                  as_out<float>(a.dx), a.groups, a.cap, a.hid, a.inter);
  }
  return launch(gmlp_dx_mma_kernel,
                dim3(ceil_div(a.hid, k6::BNX), ceil_div(a.cap, k6::BM), eg),
                k6::W::kThreads, k6::kBytes, a.stream, as_in<int>(a.counts),
                as_in<bf16>(a.wg), as_in<bf16>(a.wu), as_in<bf16>(a.dg),
                as_in<bf16>(a.du), as_out<bf16>(a.dx), a.groups, a.cap, a.hid,
                a.inter);
}

cudaError_t launch_dw(const Args& a, int dtype) {
  if (dtype == 0) {
    using L = f32::DwSmem;
    return launch(f32::gmlp_dw_fp32_kernel,
                  dim3((a.hid / BW) * (a.inter / BN), a.experts, 2), kThreads,
                  L::kBytes, a.stream, as_in<float>(a.x), as_in<int>(a.counts),
                  as_in<float>(a.dout), as_in<float>(a.s), as_in<float>(a.dg),
                  as_in<float>(a.du), as_out<float>(a.dwg), as_out<float>(a.dwu),
                  as_out<float>(a.dwd), a.groups, a.cap, a.hid, a.inter);
  }
  return launch(gmlp_dw_mma_kernel, dim3(dw_units(a.hid, a.inter), a.experts),
                k7::W::kThreads, k7::kBytes, a.stream, as_in<bf16>(a.x),
                as_in<int>(a.counts), as_in<bf16>(a.dout), as_in<bf16>(a.s),
                as_in<bf16>(a.dg), as_in<bf16>(a.du), as_out<bf16>(a.dwg),
                as_out<bf16>(a.dwu), as_out<bf16>(a.dwd), a.groups, a.cap, a.hid,
                a.inter);
}

enum Which { kGrads, kDx, kDw };

int dispatch(Which which, const Args& a, int dtype) {
  if (!shapes_ok(a.experts, a.groups, a.cap, a.hid, a.inter) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  switch (which) {
    case kGrads: return launch_grads(a, dtype);
    case kDx: return launch_dx(a, dtype);
    default: return launch_dw(a, dtype);
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

// bf16 K7's resident buffer in A rows (k7::kResRows): an expert whose
// filled slot tiles hold more rows streams them through the ring
extern "C" int st_grouped_mlp_bwd_resident_rows() { return k7::kResRows; }
