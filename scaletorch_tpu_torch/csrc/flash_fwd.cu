// Flash-attention forward (K1), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (scaletorch_tpu/ops/pallas/flash.py, launched by `_flash_forward`). It
// computes the same function: O = softmax(scale * Q K^T + causal mask) V by
// online softmax over key tiles, and LSE = m + log(l), for q [B, Hq, Sq, D]
// against the unexpanded k, v [B, Hkv, Skv, D] (query head h reads key head
// h / (Hq / Hkv)). Numerics kept from the Pallas kernel: the scores come
// out of the product in fp32 and are scaled after it; masked logits are
// -1e30; m, l and the accumulator are fp32; p is rounded to v's dtype before
// P V; l is floored at 1e-30.
//
// What bounds it on the H100: operations. A causal forward does
// 4 * B * Hq * D * S(S+1)/2 flops over 4 * B * Hq * S * D bytes of q, out
// (and k, v once), thousands of flops per byte at S = 8192, far above the
// ~295 flop/byte where the tensor cores become the limit.
//
// Shape of the kernel (a simple one that is right):
//   * one CTA of 8 warps per (query tile of 64 rows, q head, batch); the
//     query tiles are issued last-first, so the long causal rows start
//     early;
//   * the Pallas grid's sequential key axis is a loop inside the CTA over
//     the key tiles of 64 keys up to the diagonal (the same causal skip);
//     the mask is evaluated element-wise on every tile;
//   * Q, K, V, the scores, P and the fp32 accumulator sit in shared memory;
//     the products run on the tensor cores (wmma, bf16) or as fp32 FMAs.
// What it leaves on the table: K/V tiles are loaded synchronously (no
// cp.async/TMA double buffering), the accumulator makes a round trip
// through shared memory per key tile, and wmma issues 16x16x16 products
// instead of Hopper's wgmma (FlashAttention-3's design).
//
// The C entry returns the cudaError_t of cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it was not built for). It
// launches on the caller's stream, allocates nothing, does not synchronise.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per loop step

template <typename T, int D>
struct FwdSmem {
  static constexpr int LDT = D + Pad<T>::value;   // Q, K, V rows
  static constexpr int LDS = BK + 4;              // fp32 scores
  static constexpr int LDP = BK + Pad<T>::value;  // P in T
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 float scale, bool causal) {
  using L = FwdSmem<T, D>;
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
    tile_gemm<T, BQ, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
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
        p_s[r * L::LDP + lane + 32 * t] = Cvt<T>::from(p);  // p in v's dtype
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
    tile_gemm<T, BQ, D, BK, true, true, true>(p_s, L::LDP, v_s, L::LDT, o_s,
                                              L::LDO);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D;
    const int row = i * BQ + r;
    if (row < sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      out[(q_row0 + row) * D + idx % D] =
          Cvt<T>::from(o_s[r * L::LDO + idx % D] / l);
    }
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = i * BQ + r;
    if (row < sq) lse[q_row0 + row] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int batch, hq, hkv, sq, skv;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr int bytes = FwdSmem<T, D>::kBytes;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.hq, a.hkv, a.sq, a.skv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
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
  switch (dtype) {
    case 0: return dispatch_dim<float>(head_dim, a);
    case 1: return dispatch_dim<__nv_bfloat16>(head_dim, a);
    default: return cudaErrorInvalidValue;
  }
}
