// Paged single-token decode attention, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (scaletorch_tpu/ops/pallas/paged_attention.py, launched by
// `pallas_paged_decode_attention`). It computes the same function: for
// each slot b and KV head h, the n_rep query rows of that head attend the
// keys at absolute positions 0..positions[b], where logical page j of the
// slot lives in physical pool page page_tables[b, j]. The softmax runs
// online in fp32 (m, l, acc), the probabilities are rounded to the cache
// dtype before the P.V product (as the Pallas kernel's `p.astype(v.dtype)`
// does), and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: bytes. One query token per slot does 4 * n_rep * D
// flops for every 4 * D bytes of K and V it reads (bf16), far under the
// ~295 flop/byte the card needs before its tensor cores are the limit. So
// the design reads every live K/V byte exactly once, reads nothing past
// the slot's position (dead pages are never touched, the counterpart of
// the Pallas kernel's clamped DMA), and keeps the scores, the running
// softmax state and the accumulator on chip.
//
// Shape of the kernel (a simple one that is right; wgmma, TMA and a split
// of the key loop across CTAs are later work):
//   * one CTA per (KV head, slot): grid (Hkv, B), 8 warps;
//   * the n_rep query rows are staged through shared memory into
//     registers, each lane holding D/32 consecutive elements of every row;
//   * warps stride over the live keys, kGroup keys per step so that
//     several K/V loads are in flight per warp; lanes cover D, and a
//     score is a warp-shuffle sum of the lanes' partial dot products;
//   * each warp keeps its own online softmax over its keys; at the end
//     the warps' (m, l, acc) are merged through shared memory.
//
// The C entry point returns the cudaError_t of cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape it was not built for).
// It launches on the caller's stream, allocates nothing and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;              // keys each warp loads per step
constexpr float kMasked = -1e30f;      // the Pallas kernel's mask value

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ __forceinline__ static float to(float x) { return x; }
  __device__ __forceinline__ static float from(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as astype(bfloat16) rounds
  __device__ __forceinline__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};

// E consecutive elements, loaded as one vector (8 or 16 bytes).
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ Vec<T, E> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, E>*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int32_t* __restrict__ page_tables,
                    const int32_t* __restrict__ positions,
                    T* __restrict__ out, int hkv, int page_size,
                    int max_pages, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  __shared__ float q_s[NREP][D];
  __shared__ float m_s[kWarps][NREP];
  __shared__ float l_s[kWarps][NREP];
  __shared__ float acc_s[kWarps][NREP][D];

  // q rows h*NREP .. h*NREP+NREP-1 of slot b (q viewed as [B, Hkv, NREP, D])
  const size_t row0 = ((size_t)b * hkv + h) * NREP;
  for (int i = threadIdx.x; i < NREP * D; i += kThreads) {
    q_s[i / D][i % D] = Cvt<T>::to(q[row0 * D + i]);
  }
  __syncthreads();

  float qr[NREP][E];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = q_s[r][lane * E + e];
  }

  // keys 0..last are visible; the table holds max_pages pages, and keys
  // past its reach do not exist for the Pallas kernel either
  const int last = min(positions[b], max_pages * page_size - 1);
  const int32_t* table = page_tables + (size_t)b * max_pages;

  float m[NREP], l[NREP], acc[NREP][E];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // every step starts at a visible key (t0 <= last), so the running max
  // is a real score and masked keys get exp(-1e30 - m) == 0 exactly
  for (int t0 = warp * kGroup; t0 <= last; t0 += kWarps * kGroup) {
    Vec<T, E> kv[kGroup], vv[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int t = min(t0 + i, last);  // a masked tail key re-reads `last`
      const size_t page = (size_t)__ldg(table + t / page_size);
      const size_t off =
          ((page * hkv + h) * page_size + t % page_size) * D + lane * E;
      kv[i] = load_vec<T, E>(pool_k + off);
      vv[i] = load_vec<T, E>(pool_v + off);
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s[kGroup];
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[r][e] * Cvt<T>::to(kv[i].v[e]);
        const float dot = warp_sum(part);
        s[i] = (t0 + i <= last) ? dot * scale : kMasked;
        mx = fmaxf(mx, s[i]);
      }
      const float corr = expf(m[r] - mx);
      float psum = 0.f;
      float pv[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float p = expf(s[i] - mx);
        psum += p;
        pv[i] = Cvt<T>::to(Cvt<T>::from(p));  // p in the cache dtype
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][e] * corr;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) a += pv[i] * Cvt<T>::to(vv[i].v[e]);
        acc[r][e] = a;
      }
      m[r] = mx;
    }
  }

  // merge the warps' partial softmax states; a warp that saw no key holds
  // m = -1e30, l = 0, acc = 0 and weighs exp(-1e30 - M) == 0
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NREP * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][r] - mx);
      lsum += l_s[w][r] * c;
      a += acc_s[w][r][d] * c;
    }
    out[row0 * D + i] = Cvt<T>::from(a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int32_t* page_tables;
  const int32_t* positions;
  void* out;
  int batch, hkv, page_size, max_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int NREP>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.hkv, a.batch);
  paged_decode_kernel<T, D, NREP><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v), a.page_tables, a.positions,
      static_cast<T*>(a.out), a.hkv, a.page_size, a.max_pages, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(int n_rep, const Args& a) {
  switch (n_rep) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, int n_rep, const Args& a) {
  switch (head_dim) {
    case 64: return dispatch_rep<T, 64>(n_rep, a);
    case 128: return dispatch_rep<T, 128>(n_rep, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
extern "C" int st_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* page_tables, const void* positions, void* out, int batch,
    int num_q_heads, int num_kv_heads, int head_dim, int page_size,
    int max_pages, float scale, int dtype, void* stream) {
  if (batch < 1 || num_kv_heads < 1 || page_size < 1 || max_pages < 1 ||
      num_q_heads % num_kv_heads != 0 || batch > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, pool_k, pool_v,
               static_cast<const int32_t*>(page_tables),
               static_cast<const int32_t*>(positions), out, batch,
               num_kv_heads, page_size, max_pages, scale,
               static_cast<cudaStream_t>(stream)};
  const int n_rep = num_q_heads / num_kv_heads;
  switch (dtype) {
    case 0: return dispatch_dim<float>(head_dim, n_rep, a);
    case 1: return dispatch_dim<__nv_bfloat16>(head_dim, n_rep, a);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* st_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
