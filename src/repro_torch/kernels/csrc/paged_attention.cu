// Single-token GQA decode attention over a paged KV pool, for Hopper (sm_90a),
// with each sequence split over CTAs (flash-decoding).
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
// microseconds at 3.35 TB/s), not arithmetic. To stream those bytes at the
// card's rate, many CTAs must each keep many wide loads in flight.
//
// What this design does about it.
// 1. `paged_attention_kernel`: the grid is (B * KVH, splits). Split s of a
//    sequence takes the contiguous run of pages [s * pps, (s + 1) * pps) of
//    its valid pages; the wrapper picks pps so that the grid has at least
//    about two CTAs per SM (at the serving shape one page per split: 6
//    splits, 384 CTAs on 132 SMs). A CTA copies its run to shared memory
//    by 16-byte cp.async: all at once where it fits 72 KiB (at the serving
//    shape a split is one page, 128 tokens: 68 KiB, so the whole split's
//    bytes are in flight from the start), else in chunks of up to 64
//    tokens through a ring of two stages, the next chunk's copy overlapping
//    this chunk's arithmetic. Per chunk:
//    - scores: thread t of the chunk (of 256) takes token t and one or more
//      query heads, reads K's row in 16-byte pieces (rows padded by 16
//      bytes, so the warp's reads fall in distinct banks) and q (fp32) as
//      broadcasts; K is read once for the G heads that share it (GQA);
//    - softmax: one warp per query head updates m and l;
//    - p.v: the G x D outputs are cut into units of 8 columns of one head;
//      up to 8 lanes share a unit, each reading every 8th token's 16-byte
//      piece of V, and their sums meet by shuffles before acc (in shared
//      memory) is rescaled by exp(m_old - m_new) and added to.
//    Pages past ceil(seq_len / page) are never read; a split with no valid
//    token writes m = -1e30, l = 0, acc = 0. The products stay fp32 FMAs:
//    G <= 8 rows would leave the tensor cores idle, and bytes bound it.
// 2. `paged_attention_merge`: one thread per output element combines the
//    splits' fp32 partials (m_i, l_i, acc_i):
//      M = max_i m_i,  out = sum_i e^(m_i - M) acc_i /
//                            max(sum_i e^(m_i - M) l_i, 1e-30).
//    With one split the first kernel writes the output itself and the merge
//    is not launched. The merge sums the splits in another order than one
//    pass over the pages would: fp32 results differ from the plain version
//    by reordered fp32 sums, within the reference's 2e-5.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 128;
constexpr int kMaxD = 256;
constexpr int kRingBytes = 72 * 1024;   // shared memory of K and V, all stages
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
template <typename T> __device__ __forceinline__ T zero() { return T(0.f); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// 8 consecutive elements at p (16-byte aligned shared memory) as floats.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Split blockIdx.y of (sequence, KV head) blockIdx.x. tk: tokens per chunk
// (a power of 2 from 16 to kThreads); stages: 1 when the split's tokens fit
// one chunk, else 2 (a ring). vec: D * sizeof(T) % 16 == 0 and the pools
// 16-byte aligned, so rows are copied by cp.async.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int H, int KVH, int D,
                       int N, int page, int P, int pps, int tk, int stages,
                       int vec, float scale) {
  constexpr int E16 = 16 / sizeof(T);  // elements per 16 bytes
  const int rowid = blockIdx.x;        // b * KVH + kvh
  const int b = rowid / KVH, kvh = rowid % KVH;
  const int split = blockIdx.y, splits = gridDim.y;
  const int G = H / KVH;
  const int Dr = (D + 7) & ~7;  // D padded with zeros to a multiple of 8
  const int Dk = Dr + E16;      // a K row in shared memory, padded
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // p.v: units of 8 columns of one head, and lanes per unit (1 to 8)
  const int n_units = G * (Dr / 8);
  int tpu = 8;
  while (tpu > 1 && n_units * tpu > kThreads) tpu >>= 1;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [G][Dr]
  float* acc = q_s + G * Dr;                     // [G][Dr]
  float* p_s = acc + G * Dr;                     // [G][tk] scores, then p
  T* k_s = reinterpret_cast<T*>(p_s + G * tk);   // [stages][tk][Dk]
  T* v_s = k_s + stages * tk * Dk;               // [stages][tk][Dr]
  float* m_s = reinterpret_cast<float*>(v_s + stages * tk * Dr);  // [G]
  float* l_s = m_s + G;                          // [G]
  float* a_s = l_s + G;                          // [G] rescale of a chunk

  const T* qb = q + (static_cast<size_t>(b) * H +
                     static_cast<size_t>(kvh) * G) * D;
  for (int i = tid; i < G * Dr; i += kThreads) {
    const int g = i / Dr, d = i - g * Dr;
    q_s[i] = d < D ? to_f(qb[g * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // this split's tokens: [t_begin, t_end) of the valid ones
  const long long n_tok = min(static_cast<long long>(max(seq_lens[b], 0)),
                              static_cast<long long>(P) * page);
  const long long t_begin = static_cast<long long>(split) * pps * page;
  const int t_end = static_cast<int>(min(n_tok, t_begin + 1LL * pps * page));
  const int t0 = static_cast<int>(min(t_begin, n_tok));
  const int n_chunks = t_end > t0 ? (t_end - t0 + tk - 1) / tk : 0;
  const size_t row = static_cast<size_t>(KVH) * D;  // elements per token
  const int* pt = page_table + static_cast<size_t>(b) * P;

  // K and V rows of chunk c into stage st
  auto load_chunk = [&](int c, int st) {
    const int units = Dr / E16;  // 16-byte pieces of a row
    T* ks = k_s + st * tk * Dk;
    T* vs = v_s + st * tk * Dr;
    for (int i = tid; i < tk * units; i += kThreads) {
      const int r = i / units, col = (i - r * units) * E16;
      const int t = t0 + c * tk + r;
      const bool in = t < t_end && col < D;
      const T* sk = kp;
      const T* sv = vp;
      if (in) {
        const int j = t / page;
        const int id = min(max(pt[j], 0), N - 1);
        const size_t off =
            (static_cast<size_t>(id) * page + (t - j * page)) * row +
            static_cast<size_t>(kvh) * D + col;
        sk += off;
        sv += off;
      }
      T* dk = ks + r * Dk + col;
      T* dv = vs + r * Dr + col;
      if (vec) {
        cp_async16(dk, sk, in ? 16 : 0);
        cp_async16(dv, sv, in ? 16 : 0);
      } else {
        for (int e = 0; e < E16; ++e) {
          const bool ok = in && col + e < D;
          dk[e] = ok ? sk[e] : zero<T>();
          dv[e] = ok ? sv[e] : zero<T>();
        }
      }
    }
  };

  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();
  __syncthreads();  // q, acc, m and l are initialised

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) % stages);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const int n = min(tk, t_end - (t0 + c * tk));
    const T* ks = k_s + (c % stages) * tk * Dk;
    const T* vs = v_s + (c % stages) * tk * Dr;

    // ---- 1. scores: token t, query heads g0, g0 + gstep, ... -------------
    const int t = tid % tk, gstep = kThreads / tk;
    if (t < n) {
      const T* kr = ks + t * Dk;
      for (int g0 = tid / tk; g0 < G; g0 += 4 * gstep) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < Dr; d += 8) {
          float kx[8];
          load8(kr + d, kx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (g0 + i * gstep < G) {
              float qx[8];
              load8(q_s + (g0 + i * gstep) * Dr + d, qx);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                part[i] = fmaf(qx[e], kx[e], part[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (g0 + i * gstep < G)
            p_s[(g0 + i * gstep) * tk + t] = part[i] * scale;
      }
    }
    __syncthreads();

    // ---- 2. online softmax update, one warp per query head ---------------
    for (int g = warp; g < G; g += kWarps) {
      float* sg = p_s + g * tk;
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sg[i]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(sg[i] - m_new);
        sg[i] = p;
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

    // ---- 3. acc = acc * alpha + p . v --------------------------------------
    // unit w = (head g, columns [8u, 8u + 8)): tpu lanes of a warp share a
    // unit, each summing every tpu-th token; the 32 / tpu units of a warp
    // read consecutive 16-byte pieces of one V row
    for (int w0 = 0; w0 < n_units; w0 += kThreads / tpu) {
      const int w = w0 + warp * (32 / tpu) + lane % (32 / tpu);
      const int g = w / (Dr / 8), u = w - g * (Dr / 8);
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (w < n_units) {
        for (int j = lane / (32 / tpu); j < n; j += tpu) {
          float vx[8];
          load8(vs + j * Dr + 8 * u, vx);
          const float p = p_s[g * tk + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = fmaf(p, vx[e], a[e]);
        }
      }
      for (int o = 32 / tpu; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] += __shfl_xor_sync(kFull, a[e], o);
      if (w < n_units && lane < 32 / tpu) {
        float* ac = acc + g * Dr + 8 * u;
        const float alpha = a_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) ac[e] = fmaf(ac[e], alpha, a[e]);
      }
    }
    __syncthreads();  // this stage and p_s are free again
  }
  cp_async_wait<0>();

  if (splits == 1) {
    T* ob = out + (static_cast<size_t>(b) * H +
                   static_cast<size_t>(kvh) * G) * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      ob[i] = from_f<T>(acc[g * Dr + i - g * D] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  const size_t part = static_cast<size_t>(rowid) * splits + split;
  float* pa = part_acc + part * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    pa[i] = acc[g * Dr + i - g * D];
  }
  float* pm = part_ml + part * G * 2;
  for (int g = tid; g < G; g += kThreads) {
    pm[2 * g] = m_s[g];
    pm[2 * g + 1] = l_s[g];
  }
}

// Combine the splits of (sequence, KV head) blockIdx.x: one output element
// g * D + d per thread.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_attention_merge(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ out,
                      int H, int KVH, int D, int splits) {
  const int rowid = blockIdx.x;
  const int b = rowid / KVH, kvh = rowid % KVH;
  const int G = H / KVH;
  const int i = blockIdx.y * kMergeThreads + threadIdx.x;
  if (i >= G * D) return;
  const int g = i / D;
  const float* pa = part_acc + static_cast<size_t>(rowid) * splits * G * D;
  const float* pm = part_ml + static_cast<size_t>(rowid) * splits * G * 2;
  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) *
                    D;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[(s * G + g) * 2]);
  float L = 0.f, A = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float w = expf(pm[(s * G + g) * 2] - M);
    L = fmaf(w, pm[(s * G + g) * 2 + 1], L);
    A = fmaf(w, pa[static_cast<size_t>(s) * G * D + i], A);
  }
  ob[i] = from_f<T>(A / fmaxf(L, 1e-30f));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* sl, void* out, float* part_acc, float* part_ml, int B,
           int H, int KVH, int D, int N, int page, int P, int pps, int splits,
           cudaStream_t stream) {
  const int G = H / KVH;
  const int elt = static_cast<int>(sizeof(T));
  const int Dr = (D + 7) & ~7;
  // a token's K and V rows in shared memory
  const size_t row_bytes = static_cast<size_t>(elt) * (2 * Dr + 16 / elt);
  // one stage holding the whole split where it fits, else a ring of two
  int tk = 16, stages = 1;
  while (tk < pps * page && tk < kThreads) tk <<= 1;
  if (tk < pps * page || tk * row_bytes > kRingBytes) {
    stages = 2;
    tk = 64;
    while (tk > 16 && 2 * tk * row_bytes > kRingBytes) tk >>= 1;
  }
  const size_t g = static_cast<size_t>(G);
  const size_t smem = sizeof(float) * (2 * g * Dr + g * tk + 3 * g) +
                      stages * tk * row_bytes;
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // returned here, not left for a later check
      return (int)e;
    }
  }
  const int vec = (D * elt) % 16 == 0 && aligned16(k) && aligned16(v);
  // 1/sqrt(D) in double, rounded once, as the reference's Python scalar
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(B * KVH, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, sl, static_cast<T*>(out), part_acc,
      part_ml, H, KVH, D, N, page, P, pps, tk, stages, vec, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const dim3 merge_grid(B * KVH, (G * D + kMergeThreads - 1) / kMergeThreads);
  paged_attention_merge<T><<<merge_grid, kMergeThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), H, KVH, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pps: pages per split; splits: CTAs per
// (sequence, KV head), at least ceil(P / pps). With splits > 1, part_acc
// ([B * KVH, splits, G, D] fp32) and part_ml ([B * KVH, splits, G, 2] fp32)
// are the caller's scratch. Returns a cudaError_t (0 = launched); -1 for a
// shape the kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const int* page_table,
                                      const int* seq_lens, void* out,
                                      float* part_acc, float* part_ml,
                                      int dtype, int B, int H, int KVH, int D,
                                      int N, int page, int P, int pps,
                                      int splits, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || D > kMaxD ||
      N <= 0 || page <= 0 || P <= 0 || pps <= 0 || splits <= 0 ||
      splits > 65535 || static_cast<long long>(pps) * splits < P ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, page_table, seq_lens, out, part_acc,
                         part_ml, B, H, KVH, D, N, page, P, pps, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, page_table, seq_lens, out,
                                 part_acc, part_ml, B, H, KVH, D, N, page, P,
                                 pps, splits, s);
  return -1;
}
