// Flash-attention backward (K2: dQ, K3: dK and dV), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (scaletorch_tpu/ops/pallas/flash.py, launched by `_flash_backward`).
// They compute the same functions, FlashAttention-2's backward from the
// saved LSE and delta = rowsum(dO * O) (computed by the caller):
//   P  = exp(scale * Q K^T (masked to -1e30) - LSE)
//   dS = P * (dO V^T - delta) * scale
//   K2: dQ = sum over key tiles of dS K                (ds rounded to k's dtype)
//   K3: dV = sum of P^T dO, dK = sum of dS^T Q over the query tiles and
//       over the n_rep query heads of a KV head   (p rounded to dO's dtype,
//                                                   ds rounded to q's dtype)
// k and v stay unexpanded [B, Hkv, S, D]; query head h reads KV head
// h / n_rep, and K3 sums the n_rep heads h = hk * n_rep + r in the CTA.
// Sums are fp32 in shared memory, written once in the output dtype: no
// atomics, so the result is deterministic.
//
// What bounds them on the H100: operations (6 and 8 * B * Hq * D * S(S+1)/2
// flops for K2 and K3 causal, thousands of flops per byte at S = 8192).
//
// Shape of the kernels (simple ones that are right):
//   * K2: one CTA of 8 warps per (query tile of 64 rows, q head, batch),
//     looping over key tiles of 64 up to the diagonal (long rows first);
//   * K3: one CTA per (key tile of 64, KV head, batch), looping over the
//     n_rep query heads and, for each, over query tiles of 32 rows from the
//     first one that reaches the key tile (the Pallas kernel's clamp_i);
//   * every tile and every fp32 sum sits in shared memory; the products
//     run on the tensor cores (wmma, bf16) or as fp32 FMAs (fp32).
// What they leave on the table: synchronous tile loads (no cp.async/TMA
// pipelining), the recomputation of S and dP in both kernels (a fused
// FA2 backward computes them once and adds dQ with atomics), 16x16x16
// wmma instead of wgmma, and K3's small query tile (shared memory holds
// dK, dV and the K, V tiles for the whole loop).
//
// Each C entry returns the cudaError_t of cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it was not built for). They
// launch on the caller's stream, allocate nothing, do not synchronise.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;   // K2: query rows per CTA
constexpr int BK = 64;   // keys per tile (K2 loop step, K3 CTA)
constexpr int BQ3 = 32;  // K3: query rows per loop step

// ---- K2: dQ ------------------------------------------------------------------
template <typename T, int D>
struct DqSmem {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int hq, int hkv, int sq, int skv,
                float scale, bool causal) {
  using L = DqSmem<T, D>;
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
    tile_gemm<T, BQ, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
                                                s_s, L::LDS);
    tile_gemm<T, BQ, BK, D, true, false, false>(do_s, L::LDT, v_s, L::LDT,
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
    tile_gemm<T, BQ, D, BK, true, true, true>(ds_s, L::LDP, k_s, L::LDT,
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

// ---- K3: dK, dV ----------------------------------------------------------------
template <typename T, int D>
struct DkvSmem {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int hq, int hkv, int sq, int skv,
                 float scale, bool causal) {
  using L = DkvSmem<T, D>;
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
      tile_gemm<T, BQ3, BK, D, true, false, false>(q_s, L::LDT, k_s, L::LDT,
                                                   s_s, L::LDS);
      tile_gemm<T, BQ3, BK, D, true, false, false>(do_s, L::LDT, v_s,
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
      tile_gemm<T, BK, D, BQ3, false, true, true>(p_s, L::LDP, do_s, L::LDT,
                                                  dv_s, L::LDO);
      tile_gemm<T, BK, D, BQ3, false, true, true>(ds_s, L::LDP, q_s, L::LDT,
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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq | dk, dv
  int batch, hq, hkv, sq, skv;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int bytes = DqSmem<T, D>::kBytes;
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.hq, a.hkv, a.sq, a.skv, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int bytes = DkvSmem<T, D>::kBytes;
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + BK - 1) / BK, a.hkv, a.batch);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.hq, a.hkv, a.sq,
      a.skv, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.batch < 1 || a.hkv < 1 || a.sq < 1 || a.skv < 1 ||
      a.hq % a.hkv != 0 || a.batch > 65535 || a.hq > 65535) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return dispatch_dim<DKV, float>(head_dim, a);
    case 1: return dispatch_dim<DKV, __nv_bfloat16>(head_dim, a);
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
