// Single-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_attention.py::
// paged_attention_kernel` (its `pl.pallas_call`); computes what the
// reference oracle `repro/kernels/ref.py::paged_attention_ref` computes. The
// plain PyTorch version beside it is
// `repro_torch/kernels/paged_attention.py::paged_attention_plain`.
//
//   q          [B, H, D]            H = KVH * G, head h = kvh * G + g
//   k/v pages  [N, page, KVH, D]    the physical page pool
//   page_table int32[B, P]          -1 reads page 0 (ids clamped to [0, N))
//   seq_lens   int32[B]             positions >= seq_len are masked
//   out        [B, H, D]            q's dtype; softmax(q.k / sqrt(D)) . v
//
// Online softmax in fp32 (m, l, acc), output acc / max(l, 1e-30), so a
// sequence of length 0 gives zeros.
//
// What bounds it. One decode step reads each valid K/V row once: at
// granite-3-8b's serving shape (B=8, KVH=8, D=128, ~550 tokens, bf16) that
// is ~18 MB against ~75 MFLOP, so device-memory bytes bound it (a few
// microseconds at 3.35 TB/s), not arithmetic.
//
// What this simple design does about it. One CTA of 128 threads per
// (sequence, KV head) walks that sequence's pages in order and stops at
// ceil(seq_len / page): pages past the end would leave m, l and acc
// unchanged, so their bytes are never read. Per page:
//   1. scores: each warp takes tokens in groups of four, every lane loading
//      D/32 consecutive-lane elements of each K row (coalesced), so four
//      rows' loads are in flight at once; a warp reduction gives q.k for
//      each of the G query heads, which share the row (GQA: K is read once
//      for all G heads);
//   2. softmax: one warp per query head updates m and l and turns the
//      scores into p (masked tokens get p = 0);
//   3. p.v: each thread owns head_dim columns and accumulates up to eight
//      heads at a time in registers over the page's V rows (coalesced
//      across threads), rescaling acc by exp(m_old - m_new) first.
// q (fp32), the page's scores and acc live in shared memory. The grid is
// only B*KVH CTAs (64 at the serving shape, on 132 SMs): splitting the
// sequence over CTAs (flash-decoding) and staging pages with TMA are later
// designs.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / 32;   // K elements a lane holds per row
constexpr int kRows = 4;                // K rows a warp loads at once
constexpr int kHeadChunk = 8;           // query heads accumulated per pass
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int H, int KVH, int D, int N, int page, int P,
                       float scale) {
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int G = H / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, D]
  float* acc = q_s + G * D;        // [G, D]
  float* p_s = acc + G * D;        // [G, page] scores, then probabilities
  float* m_s = p_s + G * page;     // [G]
  float* l_s = m_s + G;            // [G]
  float* a_s = l_s + G;            // [G] rescale of this page

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = seq_lens[b];
  const int n_pages = min(P, (max(len, 0) + page - 1) / page);
  const size_t row = (size_t)KVH * D;           // elements between tokens
  const size_t page_elems = (size_t)page * row;

  for (int j = 0; j < n_pages; ++j) {
    const int id = min(max(page_table[(size_t)b * P + j], 0), N - 1);
    const T* kpage = kp + (size_t)id * page_elems + (size_t)kvh * D;
    const T* vpage = vp + (size_t)id * page_elems + (size_t)kvh * D;
    const int valid = min(page, len - j * page);  // >= 1 here

    // ---- 1. scores q.k for the page's valid tokens -----------------------
    for (int t0 = warp * kRows; t0 < valid; t0 += kWarps * kRows) {
      float kr[kRows][kDPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = t0 + r;
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) {
          const int d = lane + 32 * i;
          kr[r][i] = (t < valid && d < D)
                         ? to_f(kpage[(size_t)t * row + d]) : 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * D;
        float part[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kDPerLane; ++i) {
          const int d = lane + 32 * i;
          const float qv = d < D ? qg[d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) part[r] = fmaf(qv, kr[r][i], part[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float s = warp_sum(part[r]);
          if (lane == 0 && t0 + r < valid) p_s[g * page + t0 + r] = s * scale;
        }
      }
    }
    __syncthreads();

    // ---- 2. online softmax update, one warp per query head ---------------
    for (int g = warp; g < G; g += kWarps) {
      float* sg = p_s + g * page;
      float mx = kNegInf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- 3. acc = acc * alpha + p . v, columns per thread ----------------
    for (int d = tid; d < D; d += kThreads) {
      for (int g0 = 0; g0 < G; g0 += kHeadChunk) {
        const int ng = min(kHeadChunk, G - g0);
        float a[kHeadChunk];
#pragma unroll
        for (int c = 0; c < kHeadChunk; ++c)
          a[c] = c < ng ? acc[(g0 + c) * D + d] * a_s[g0 + c] : 0.f;
#pragma unroll 4
        for (int t = 0; t < valid; ++t) {
          const float v = to_f(vpage[(size_t)t * row + d]);
#pragma unroll
          for (int c = 0; c < kHeadChunk; ++c)
            if (c < ng) a[c] = fmaf(p_s[(g0 + c) * page + t], v, a[c]);
        }
#pragma unroll
        for (int c = 0; c < kHeadChunk; ++c)
          if (c < ng) acc[(g0 + c) * D + d] = a[c];
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = fmaxf(l_s[i / D], 1e-30f);
    ob[i] = from_f<T>(acc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* sl, void* out, int B, int H, int KVH, int D, int N,
           int page, int P, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * ((size_t)2 * G * D +
                                       (size_t)G * page + 3 * (size_t)G);
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 1/sqrt(D) in double, rounded once, as the reference's Python scalar
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  kern<<<B * KVH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, sl, static_cast<T*>(out), H, KVH, D, N,
      page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// -1 for a shape the kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const int* page_table,
                                      const int* seq_lens, void* out,
                                      int dtype, int B, int H, int KVH, int D,
                                      int N, int page, int P, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > kMaxD ||
      N <= 0 || page <= 0 || P <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, page_table, seq_lens, out, B, H, KVH, D, N,
                         page, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, page_table, seq_lens, out, B, H,
                                 KVH, D, N, page, P, s);
  return -1;
}
