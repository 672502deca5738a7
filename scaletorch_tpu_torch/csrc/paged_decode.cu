// Paged single-token decode attention (K4), written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (scaletorch_tpu/ops/pallas/paged_attention.py, launched by
// `pallas_paged_decode_attention`). It computes the same function: for
// each slot b and KV head h, the n_rep query rows of that head (q heads
// h * n_rep .. h * n_rep + n_rep - 1) attend the keys at absolute
// positions 0 .. min(positions[b], max_pages * page_size - 1), where
// logical page j of the slot lives in physical pool page
// page_tables[b, j]. Numerics kept from the Pallas kernel: scores in fp32,
// scaled after the product; masked logits -1e30; m, l and the accumulator
// in fp32; l sums the unrounded p; p is rounded to the cache dtype before
// P V; the output is acc / max(l, 1e-30) in q's dtype. Dead pages are
// never read.
//
// What bounds it: bytes. One query token per slot does 4 * n_rep * D
// flops for every 4 * D bytes of K and V it reads (bf16), far under the
// ~295 flop/byte where the tensor cores become the limit. So the design
// reads every live K/V byte once and keeps enough of them in flight to
// fill the card, whatever the batch and the context lengths.
//
// Design (flash-decoding through the page table):
//   * Grid (splits, Hkv, B). A split is kKeysPerSplit keys of one slot and
//     KV head; splits = ceil(max_pages * page_size / kKeysPerSplit) comes
//     from the shapes alone, and a split whose first key lies past the
//     slot's last visible key exits at once. A slot's splits depend on its
//     own position only, so its output bits are the same alone and inside
//     any batch (the Pallas kernel is batch-invariant too).
//   * A CTA stages its split's page-table entries in shared memory once,
//     then copies the split's K and V rows, 16 bytes a thread, through a
//     ring of 64-key stages (cp.async, zero-filled past the last visible
//     key): the next stages' loads are in flight while this one is
//     computed. Keys are a flat index and each row finds its own page, so
//     every page_size >= 1 works and a tile may straddle pages.
//   * bf16: four warps, each taking one 16-key tile of a stage. The n_rep
//     query rows are the rows of mma.sync's A operand (rows past n_rep are
//     zero and never stored); S = Q K^T comes out of the tensor cores in
//     fp32; the online softmax runs on the accumulator fragment, where a
//     quad of lanes holds a row (two shuffles for the max, two for the
//     sum, per tile); P is rounded to bf16 straight into the A fragment of
//     O += P V, with V read by ldmatrix.trans. Tiles are XOR-swizzled
//     (mma_sm90.cuh; 64-byte rows at D 32), so ldmatrix and cp.async
//     touch distinct banks.
//   * fp32 (the parity dtype): the same grid and ring on CUDA cores. A
//     lane scores one key over half of D (one shuffle joins the halves),
//     the 16 lanes of a half reduce the max and the sum, and P V runs over
//     the lane's D/32 columns with P broadcast through shared memory.
//   * Each warp keeps its own (m, l, acc); the CTA merges its warps in
//     shared memory. A slot whose keys fit in one split writes its output
//     there. Otherwise each split writes an unnormalised fp32 partial
//     (m, l, acc[D]) per query row into the workspace [splits, B, Hq,
//     D + 2] and counts itself in on the (slot, KV head)'s counter; the
//     last CTA to do so resets the counter and merges the slot's live
//     splits in a fixed order:
//       M = max_s m_s,  L = sum_s l_s e^(m_s - M),
//       out = sum_s acc_s e^(m_s - M) / max(L, 1e-30).
//     Splits that never ran are never read. The only atomic operation
//     is the count; none touches the data, so two runs are equal bit for
//     bit. (Chosen over a second launch for the merge by timing both on
//     the H100; PERF.md has the numbers.)
//
// The C entry returns the cudaError_t of cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it was not built for, or a
// workspace or counter buffer too small). It launches one kernel on the
// caller's stream, allocates nothing, reads no device memory on the host
// and does not synchronise: the grid and the workspace follow from the
// shapes and the counters are zero between calls, so a CUDA graph can
// capture it. Calls that run at once must not share a counter buffer.

#include <limits.h>

#include <type_traits>

#include "flash_common.cuh"
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Cvt;
using flash::kLog2e;
using flash::kMasked;

constexpr int kKeysPerSplit = 256;  // chosen over 128 and 512 (PERF.md §6)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 16;           // keys of one warp's tile
constexpr int BK = kWarps * kTileKeys;  // keys of one ring stage
constexpr int kMaxRep = 8;              // query rows of a KV head, at most
static_assert(kKeysPerSplit % BK == 0, "a split is whole ring stages");

template <typename T, int D>
struct Layout;

// bf16: the A rows (n_rep queries, then zeros), the ring of K and V
// stages, the split's page-table entries.
template <int D>
struct Layout<bf16, D> {
  using QTile = mma::SwizzledTile<16, D>;
  using KTile = mma::SwizzledTile<BK, D>;
  static constexpr int kStages = 3;
  static constexpr int kQ = 0;
  static constexpr int kRing = QTile::kBytes;
  static constexpr int kTileBytes = KTile::kBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kTable = kRing + kStages * kStageBytes;
  static constexpr int kBytes = kTable + (kKeysPerSplit + 1) * 4;
};

// fp32: the query rows, each warp's P, the ring (rows padded by 16 bytes,
// so the 16 keys a warp scores at once fall on distinct banks), the table.
template <int D>
struct Layout<float, D> {
  static constexpr int LD = D + 4;
  static constexpr int kStages = 2;
  static constexpr int kQ = 0;
  static constexpr int kP = kQ + kMaxRep * D * 4;
  static constexpr int kRing = kP + kWarps * kMaxRep * kTileKeys * 4;
  static constexpr int kTileBytes = BK * LD * 4;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kTable = kRing + kStages * kStageBytes;
  static constexpr int kBytes = kTable + (kKeysPerSplit + 1) * 4;
};

// After the key loop the ring holds the warps' states: m and l
// [kWarps][kMaxRep], then acc [kWarps][kMaxRep][D].
template <typename T, int D>
struct WarpStates {
  using L = Layout<T, D>;
  static_assert((2 + D) * kWarps * kMaxRep * 4 <= L::kStages * L::kStageBytes,
                "the warps' states fit in the ring");
  float* m;
  float* l;
  float* acc;
  __device__ __forceinline__ explicit WarpStates(unsigned char* smem)
      : m(reinterpret_cast<float*>(smem + L::kRing)),
        l(m + kWarps * kMaxRep),
        acc(l + kWarps * kMaxRep) {}
};

// What a CTA works on: keys k0 .. k_end of slot b, KV head h. last is the
// slot's last visible key; the table holds logical pages p0 onwards.
struct Split {
  int b, h, split, last, k0, k_end, p0;
  size_t row0;  // q row of the head's first query: (b * Hkv + h) * n_rep

  // false when the split holds no visible key; a slot that sees no key at
  // all (a negative position) gets zeros, as the Pallas kernel gives it
  template <typename T, int D, int NREP>
  __device__ __forceinline__ bool start(const int32_t* positions, T* out,
                                        int hkv, int page_size,
                                        int max_pages) {
    split = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
    row0 = ((size_t)b * hkv + h) * NREP;
    last = min(positions[b], max_pages * page_size - 1);
    k0 = split * kKeysPerSplit;
    if (k0 > last) {
      if (split == 0) {
        for (int i = threadIdx.x; i < NREP * D; i += kThreads) {
          out[row0 * D + i] = Cvt<T>::from(0.f);
        }
      }
      return false;
    }
    k_end = min(k0 + kKeysPerSplit - 1, last);
    p0 = k0 / page_size;
    return true;
  }

  // the split's page-table entries, read once (the caller synchronises)
  __device__ __forceinline__ void stage_table(int* tbl,
                                              const int32_t* page_tables,
                                              int page_size,
                                              int max_pages) const {
    const int32_t* table = page_tables + (size_t)b * max_pages;
    for (int i = threadIdx.x; i <= k_end / page_size - p0; i += kThreads) {
      tbl[i] = __ldg(table + p0 + i);
    }
  }

  // element offset of key t's row of this head in a pool
  // [n_pages, Hkv, page_size, D]
  __device__ __forceinline__ size_t row_offset(const int* tbl, int t,
                                               int page_size, int hkv,
                                               int d) const {
    const int lp = t / page_size;
    return (((size_t)tbl[lp - p0] * hkv + h) * page_size +
            (t - lp * page_size)) * d;
  }

  __device__ __forceinline__ int stages() const {
    return (k_end - k0) / BK + 1;
  }
};

// The CTA's warps merged in a fixed order: the output itself when the slot
// has one live split, else this split's partial (m, l, acc) per row.
template <typename T, int D, int NREP>
__device__ __forceinline__ void finish(const WarpStates<T, D>& w,
                                       const Split& s, T* out, float* part,
                                       int batch, int hkv) {
  const bool single = s.last < kKeysPerSplit;
  const size_t hq = (size_t)hkv * NREP;
  for (int i = threadIdx.x; i < NREP * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = kMasked;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) mx = fmaxf(mx, w.m[x * kMaxRep + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      const float c = expf(w.m[x * kMaxRep + r] - mx);
      lsum += w.l[x * kMaxRep + r] * c;
      a += w.acc[(x * kMaxRep + r) * D + d] * c;
    }
    if (single) {
      out[(s.row0 + r) * D + d] = Cvt<T>::from(a / fmaxf(lsum, 1e-30f));
    } else {
      float* dst =
          part + (((size_t)s.split * batch) * hq + s.row0 + r) * (D + 2);
      dst[2 + d] = a;
      if (d == 0) {
        dst[0] = mx;
        dst[1] = lsum;
      }
    }
  }
}

// The merge of a slot's live splits, done by the last CTA of the (slot,
// KV head) to finish: each CTA counts itself in after its partial is
// written, and the one that brings the count to the number of live
// splits resets the counter for the next call and merges. One warp a row
// finds M and L; then groups of D/2 threads (two columns each) sum every
// G-th split's row, and the groups' sums are added in group order. The
// order of every sum is fixed, whichever CTA comes last.
template <typename T, int D, int NREP>
__device__ __forceinline__ void merge_in_last_cta(const Split& s,
                                                  const float* part,
                                                  int* counters, T* out,
                                                  int batch, int hkv,
                                                  float* scratch) {
  __shared__ int is_last;
  const int n_live = s.last / kKeysPerSplit + 1;
  if (n_live <= 1) return;  // finish wrote the output
  __syncthreads();          // the CTA's partial is written ...
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible before the count says so
    int* c = counters + (size_t)s.b * hkv + s.h;
    is_last = atomicAdd(c, 1) == n_live - 1;
    if (is_last) {
      *c = 0;  // for the next call
      __threadfence();
    }
  }
  __syncthreads();
  if (!is_last) return;
  const size_t width = D + 2;
  const size_t stride = (size_t)batch * hkv * NREP * width;  // one split
  const float* rows = part + s.row0 * width;  // split 0, this head's rows
  float* stat = scratch;                      // [kMaxRep][2]: M, L
  constexpr int C2 = D / 2;                   // float2 columns
  constexpr int G = kThreads / C2;            // groups of splits
  float* red = scratch + 2 * kMaxRep;         // [G][NREP][D]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < NREP; r += kWarps) {
    const float* pr = rows + r * width;
    float mx = kMasked;
    for (int sp = lane; sp < n_live; sp += 32) {
      mx = fmaxf(mx, __ldcg(pr + sp * stride));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float lsum = 0.f;
    for (int sp = lane; sp < n_live; sp += 32) {
      lsum += __ldcg(pr + sp * stride + 1) *
              expf(__ldcg(pr + sp * stride) - mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    }
    if (lane == 0) {
      stat[2 * r] = mx;
      stat[2 * r + 1] = lsum;
    }
  }
  __syncthreads();
  const int c2 = threadIdx.x % C2;
  const int grp = threadIdx.x / C2;
  float2 a[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) a[r] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int sp = grp; sp < n_live; sp += G) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float* pr = rows + r * width + sp * stride;
      const float w = expf(__ldcg(pr) - stat[2 * r]);
      const float2 v = __ldcg(reinterpret_cast<const float2*>(pr + 2) + c2);
      a[r].x += v.x * w;
      a[r].y += v.y * w;
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    *reinterpret_cast<float2*>(red + (grp * NREP + r) * D + 2 * c2) = a[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NREP * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) sum += red[(g * NREP + r) * D + d];
    out[(s.row0 + r) * D + d] =
        Cvt<T>::from(sum / fmaxf(stat[2 * r + 1], 1e-30f));
  }
}

// ---- bf16 on mma.sync -------------------------------------------------------------
template <int D, int NREP>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ pool_k,
                        const bf16* __restrict__ pool_v,
                        const int32_t* __restrict__ page_tables,
                        const int32_t* __restrict__ positions,
                        bf16* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, int batch, int hkv,
                        int page_size, int max_pages,
                        float scale) {
  static_assert(NREP >= 1 && NREP <= kMaxRep, "n_rep rows of one m-tile");
  using L = Layout<bf16, D>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  constexpr int kStages = L::kStages;
  constexpr int RB = KTile::kRowBytes;
  constexpr int kChunks = KTile::kChunks;
  constexpr int KSTEPS = D / 16;  // k-steps of S over head_dim
  constexpr int NT = D / 8;       // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_u32(smem);
  int* tbl = reinterpret_cast<int*>(smem + L::kTable);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t4 = lane & 3;
  const int g = lane >> 2;  // this lane's query row (lane = 4 g + t4)

  Split s;
  if (!s.start<bf16, D, NREP>(positions, out, hkv, page_size, max_pages)) {
    return;
  }
  for (int idx = tid; idx < 16 * QTile::kChunks; idx += kThreads) {
    const int r = idx / QTile::kChunks;
    const int c = idx % QTile::kChunks;
    const bool valid = r < NREP;
    mma::cp_async_16(base + L::kQ + QTile::offset(r, c),
                     valid ? q + (s.row0 + r) * D + c * 8 : q, valid);
  }
  mma::cp_async_commit();
  s.stage_table(tbl, page_tables, page_size, max_pages);
  __syncthreads();

  auto load_stage = [&](int j) {
    const uint32_t dst = base + L::kRing + (j % kStages) * L::kStageBytes;
#pragma unroll
    for (int it = 0; it < BK * kChunks / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int key = s.k0 + j * BK + r;
      const bool valid = key <= s.k_end;
      const size_t off =
          valid ? s.row_offset(tbl, key, page_size, hkv, D) + c * 8 : 0;
      mma::cp_async_16(dst + KTile::offset(r, c), pool_k + off, valid);
      mma::cp_async_16(dst + L::kTileBytes + KTile::offset(r, c),
                       pool_v + off, valid);
    }
  };
  const int n_stages = s.stages();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_stages) load_stage(j);
    mma::cp_async_commit();  // one group per stage, empty or not
  }

  mma::cp_async_wait<kStages - 1>();  // Q
  __syncthreads();
  const mma::LaneAddr la(lane);
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma::ldmatrix_x4(qf[kk], mma::a_addr<RB>(la, base + L::kQ, 0, kk * 16));
    qf[kk][1] = qf[kk][3] = 0u;  // rows 8..15: past every n_rep
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m = kMasked, l = 0.f;

  for (int j = 0; j < n_stages; ++j) {
    mma::cp_async_wait<kStages - 2>();  // stage j
    __syncthreads();  // ... seen by all; stage j - 1's slot is free
    if (j + kStages - 1 < n_stages) load_stage(j + kStages - 1);
    mma::cp_async_commit();
    // warp-uniform: a tile with no visible key is skipped, so every tile
    // computed holds a real score and masked keys get p == 0 exactly
    const int key0 = s.k0 + j * BK + warp * kTileKeys;
    if (key0 > s.k_end) continue;
    const uint32_t ks = base + L::kRing + (j % kStages) * L::kStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
    const int r0 = warp * kTileKeys;

    // S = Q K^T (B: K rows as [n][k], no transpose)
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t bk[4];
      mma::ldmatrix_x4(bk, mma::b_addr<RB>(la, ks, r0, kk * 16));
      mma::mma_bf16(sc[0], qf[kk], bk[0], bk[1]);
      mma::mma_bf16(sc[1], qf[kk], bk[2], bk[3]);
    }

    // row g: sc[n][e] is key key0 + 8 n + 2 t4 + e (rows g + 8 are padding)
    float mx = m;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * n + 2 * t4 + e;
        const float z = key <= s.k_end ? sc[n][e] * scale : kMasked;
        sc[n][e] = z;
        mx = fmaxf(mx, z);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = exp2f((m - mx) * kLog2e);
    const float m2 = mx * kLog2e;
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(sc[n][e], kLog2e, -m2));
        psum += p;
        sc[n][e] = p;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }

    // O += P V (P rounded to bf16 in registers; B: V rows as [k][n])
    const uint32_t a[4] = {mma::pack_bf16(sc[0][0], sc[0][1]), 0u,
                           mma::pack_bf16(sc[1][0], sc[1][1]), 0u};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bv[4];
      mma::ldmatrix_x4_trans(bv, mma::a_addr<RB>(la, vs, r0, dn * 16));
      mma::mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
      mma::mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
    }
  }

  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  const WarpStates<bf16, D> w(smem);
  if (g < NREP) {
    if (t4 == 0) {
      w.m[warp * kMaxRep + g] = m;
      w.l[warp * kMaxRep + g] = l;
    }
    float* row = w.acc + (warp * kMaxRep + g) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(row + n * 8) =
          make_float2(acc[n][0], acc[n][1]);
    }
  }
  __syncthreads();
  finish<bf16, D, NREP>(w, s, out, part, batch, hkv);
  merge_in_last_cta<bf16, D, NREP>(s, part, counters, out, batch, hkv,
                                   reinterpret_cast<float*>(smem + L::kRing));
}

// ---- fp32 on CUDA cores -------------------------------------------------------------
template <int D, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_fp32_kernel(const float* __restrict__ q,
                         const float* __restrict__ pool_k,
                         const float* __restrict__ pool_v,
                         const int32_t* __restrict__ page_tables,
                         const int32_t* __restrict__ positions,
                         float* __restrict__ out, float* __restrict__ part,
                         int* __restrict__ counters, int batch, int hkv,
                         int page_size, int max_pages,
                         float scale) {
  static_assert(NREP >= 1 && NREP <= kMaxRep, "n_rep rows");
  using L = Layout<float, D>;
  constexpr int kStages = L::kStages;
  constexpr int LD = L::LD;
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  constexpr int E = D / 32;       // output columns of a lane
  constexpr int H = D / 2;        // a lane scores its key over half of D
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_u32(smem);
  const float* q_s = reinterpret_cast<const float*>(smem + L::kQ);
  int* tbl = reinterpret_cast<int*>(smem + L::kTable);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kl = lane & 15;   // the key this lane scores
  const int half = lane >> 4;  // ... over columns half * H .. half * H + H
  float* p_s = reinterpret_cast<float*>(smem + L::kP) +
               warp * kMaxRep * kTileKeys;

  Split s;
  if (!s.start<float, D, NREP>(positions, out, hkv, page_size, max_pages)) {
    return;
  }
  for (int i = tid; i < NREP * D; i += kThreads) {
    reinterpret_cast<float*>(smem + L::kQ)[i] = q[s.row0 * D + i];
  }
  s.stage_table(tbl, page_tables, page_size, max_pages);
  __syncthreads();

  auto load_stage = [&](int j) {
    const uint32_t dst = base + L::kRing + (j % kStages) * L::kStageBytes;
#pragma unroll
    for (int it = 0; it < BK * kChunks / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int key = s.k0 + j * BK + r;
      const bool valid = key <= s.k_end;
      const size_t off =
          valid ? s.row_offset(tbl, key, page_size, hkv, D) + c * 4 : 0;
      const uint32_t at = dst + (r * LD + c * 4) * 4;
      mma::cp_async_16(at, pool_k + off, valid);
      mma::cp_async_16(at + L::kTileBytes, pool_v + off, valid);
    }
  };
  const int n_stages = s.stages();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_stages) load_stage(j);
    mma::cp_async_commit();
  }

  float m[NREP], l[NREP], acc[NREP][E];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int j = 0; j < n_stages; ++j) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_stages) load_stage(j + kStages - 1);
    mma::cp_async_commit();
    const int key0 = s.k0 + j * BK + warp * kTileKeys;
    if (key0 > s.k_end) continue;  // warp-uniform, as in the bf16 kernel
    const float* ks = reinterpret_cast<const float*>(
                          smem + L::kRing + (j % kStages) * L::kStageBytes) +
                      warp * kTileKeys * LD;
    const float* vs = ks + L::kTileBytes / 4;

    float sc[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) sc[r] = 0.f;
    const float* krow = ks + kl * LD + half * H;
#pragma unroll 4
    for (int i = 0; i < H; i += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + i);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + r * D + half * H + i);
        sc[r] = fmaf(qv.x, kv.x, sc[r]);
        sc[r] = fmaf(qv.y, kv.y, sc[r]);
        sc[r] = fmaf(qv.z, kv.z, sc[r]);
        sc[r] = fmaf(qv.w, kv.w, sc[r]);
      }
    }
    const bool visible = key0 + kl <= s.k_end;
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float dot = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 16);
      const float z = visible ? dot * scale : kMasked;
      float mx = fmaxf(m[r], z);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float p = expf(z - mx);
      float psum = p;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      }
      const float corr = expf(m[r] - mx);
      l[r] = l[r] * corr + psum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
      if (half == 0) p_s[r * kTileKeys + kl] = p;
    }
    __syncwarp();
    // O += P V over this lane's columns lane * E .. lane * E + E - 1
#pragma unroll 4
    for (int k = 0; k < kTileKeys; ++k) {
      float v[E];
      const float* vrow = vs + k * LD + lane * E;
      if constexpr (E == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vrow);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else if constexpr (E == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vrow);
        v[0] = x.x;
        v[1] = x.y;
      } else {
        v[0] = vrow[0];
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = p_s[r * kTileKeys + k];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, v[e], acc[r][e]);
      }
    }
    __syncwarp();  // P is read before the next tile writes it
  }

  mma::cp_async_wait<0>();
  __syncthreads();
  const WarpStates<float, D> w(smem);
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      w.m[warp * kMaxRep + r] = m[r];
      w.l[warp * kMaxRep + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      w.acc[(warp * kMaxRep + r) * D + lane * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  finish<float, D, NREP>(w, s, out, part, batch, hkv);
  merge_in_last_cta<float, D, NREP>(s, part, counters, out, batch, hkv,
                                    reinterpret_cast<float*>(smem + L::kRing));
}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int32_t* page_tables;
  const int32_t* positions;
  void* out;
  float* part;
  int* counters;
  int batch, hq, hkv, page_size, max_pages, splits;
  float scale;
  cudaStream_t stream;
};

// the split kernel of a dtype
template <typename T, int D, int NREP>
auto split_kernel() {
  if constexpr (std::is_same<T, bf16>::value) {
    return paged_decode_mma_kernel<D, NREP>;
  } else {
    return paged_decode_fp32_kernel<D, NREP>;
  }
}

template <typename T, int D, int NREP>
cudaError_t launch(const Args& a) {
  constexpr int bytes = Layout<T, D>::kBytes;
  auto kernel = split_kernel<T, D, NREP>();
  const cudaError_t err = flash::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.hkv, a.batch), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v), a.page_tables, a.positions,
      static_cast<T*>(a.out), a.part, a.counters, a.batch, a.hkv,
      a.page_size, a.max_pages, a.scale);
  return cudaGetLastError();
}

// Every n_rep of 1..8 (the presets use 2, 4, 5 and 8) and head_dim 32,
// 64 and 128.
template <typename T, int D>
cudaError_t dispatch_rep(int n_rep, const Args& a) {
  switch (n_rep) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 3: return launch<T, D, 3>(a);
    case 4: return launch<T, D, 4>(a);
    case 5: return launch<T, D, 5>(a);
    case 6: return launch<T, D, 6>(a);
    case 7: return launch<T, D, 7>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, int n_rep, const Args& a) {
  switch (head_dim) {
    case 32: return dispatch_rep<T, 32>(n_rep, a);
    case 64: return dispatch_rep<T, 64>(n_rep, a);
    case 128: return dispatch_rep<T, 128>(n_rep, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys of one split: the wrapper sizes the workspace with it.
extern "C" int st_paged_decode_keys_per_split() { return kKeysPerSplit; }

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// workspace: fp32 [splits, batch, num_q_heads, head_dim + 2], splits =
// ceil(max_pages * page_size / keys per split); counters: int32, at least
// batch * num_kv_heads, zero before the first call (the kernel leaves them
// zero). Both are used only when splits > 1.
extern "C" int st_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* page_tables, const void* positions, void* out,
    void* workspace, long long workspace_bytes, void* counters,
    int n_counters, int batch, int num_q_heads, int num_kv_heads,
    int head_dim, int page_size, int max_pages, float scale, int dtype,
    void* stream) {
  if (batch < 1 || num_kv_heads < 1 || page_size < 1 || max_pages < 1 ||
      num_q_heads % num_kv_heads != 0 || batch > 65535 ||
      num_kv_heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const long long keys = (long long)max_pages * page_size;
  if (keys > INT_MAX) return cudaErrorInvalidValue;
  const int splits = (int)((keys + kKeysPerSplit - 1) / kKeysPerSplit);
  const long long need =
      (long long)splits * batch * num_q_heads * (head_dim + 2) * 4;
  if (splits > 1 && (workspace == nullptr || workspace_bytes < need ||
                     counters == nullptr ||
                     n_counters < (long long)batch * num_kv_heads)) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, pool_k, pool_v,
               static_cast<const int32_t*>(page_tables),
               static_cast<const int32_t*>(positions), out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               batch, num_q_heads,
               num_kv_heads, page_size, max_pages, splits, scale,
               static_cast<cudaStream_t>(stream)};
  const int n_rep = num_q_heads / num_kv_heads;
  switch (dtype) {
    case 0: return dispatch_dim<float>(head_dim, n_rep, a);
    case 1: return dispatch_dim<__nv_bfloat16>(head_dim, n_rep, a);
    default: return cudaErrorInvalidValue;
  }
}
