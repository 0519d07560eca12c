// Causal / sliding-window GQA flash attention (forward), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::
// flash_attention_kernel` (its `pl.pallas_call`, body `_kernel`). The plain
// PyTorch version beside it is
// `repro_torch/kernels/flash_attention.py::flash_attention_plain`.
//
//   q    [B, S, H, hd]     H = KVH * G, query head h reads KV head h / G
//   k/v  [B, T, KVH, hd]
//   out  [B, S, H, hd]     q's dtype
//
// The function is the Pallas body's: q, k and v in fp32, s = (q . k) * scale
// with scale = 1/sqrt(hd); a key is visible to query row i iff
// (!causal || i >= j) && (window == 0 || i - j < window) on absolute
// positions (no offset when S != T); hidden scores are -1e30 and their p is
// 0; fp32 online softmax (m, l, acc), p kept in fp32 through the p.v
// product; out = acc / max(l, 1e-30), so a row that sees no key is 0.
//
// What bounds it. At granite-3-8b's prefill shape (B=8, S=T=512, H=32,
// KVH=8, hd=128, causal, bf16) one call reads q, k, v and writes out once,
// ~84 MB (0.025 ms at 3.35 TB/s), and does ~17.2 GFLOP of products (the
// causal half: 0.017 ms at 989 TFLOP/s of dense bf16 tensor-core rate); at
// S = T = 8192 the ~0.55 TFLOP bound it (0.556 ms). So operations bound
// it at long context, bytes and operations about equally at prefill.
//
// What this simple design does about it. It keeps S x T scores out of
// device memory, as the TPU kernel does, but it does not reach the tensor
// cores: the products run as fp32 FMAs on the CUDA cores (the reference
// keeps q, k, v and p in fp32, which bf16 tensor-core products would not),
// so its floor is ~67 TFLOP/s, not 989. One CTA of 8 warps per (batch,
// query head, 64-row query tile); the tiles of the last rows, which see the
// most keys under a causal mask, are scheduled first. Per 64-key KV tile:
//   1. the CTA stages K transposed ([hd][64], padded to 65 columns so the
//      transposing stores and the key-per-lane loads are free of bank
//      conflicts) and V ([64][hd], in the input's dtype) in shared memory;
//      q's tile sits there in fp32 for the whole CTA;
//   2. scores: each warp owns 8 query rows; lane j computes keys j and
//      j + 32 for all 8 rows, reading q four columns at a time (broadcast)
//      and K from its own column: 64 FMAs per 16 shared loads;
//   3. softmax: a warp reduction per row gives the tile's max and sum,
//      the lane rescales its accumulators by exp(m_old - m_new), and p goes
//      to the warp's slice of shared memory;
//   4. p.v: lane d owns head_dim columns d, d + 32, ... (up to 8), reads p
//      four keys at a time (broadcast) and V rows (coalesced).
// KV tiles wholly hidden from the CTA's rows (above the causal diagonal,
// before the window) are skipped, which is exact: they would leave m, l
// and acc unchanged. Keys past T read zeros and are hidden. wgmma, TMA
// staging and a pipelined producer are later designs.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                   // query rows per CTA
constexpr int kKeys = 64;                   // keys per KV tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kKStride = kKeys + 1;         // padded row of K^T
constexpr int kMaxHd = 256;
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
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// DPL: head_dim columns per lane in the p.v phase (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Tk, int H, int KVH, int hd, int hdp, int causal,
                       int window, float scale, int nq) {
  const int iq = nq - 1 - static_cast<int>(blockIdx.x % nq);  // long first
  const int bh = blockIdx.x / nq;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = iq * kRows;
  const int r0 = warp * kRowsPerWarp;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);              // [kRows][hdp]
  float* kt_s = q_s + kRows * hdp;                           // [hdp][kKStride]
  float* p_s = kt_s + hdp * kKStride;                        // [kRows][kKeys]
  T* v_s = reinterpret_cast<T*>(p_s + kRows * kKeys);        // [kKeys][hdp]
  float* p_w = p_s + r0 * kKeys;                             // this warp's rows

  const size_t q_row = static_cast<size_t>(H) * hd;    // elements per token
  const size_t kv_row = static_cast<size_t>(KVH) * hd;
  const T* qb = q + (static_cast<size_t>(b) * S) * q_row +
                static_cast<size_t>(h) * hd;
  const T* kb = k + (static_cast<size_t>(b) * Tk) * kv_row +
                static_cast<size_t>(kvh) * hd;
  const T* vb = v + (static_cast<size_t>(b) * Tk) * kv_row +
                static_cast<size_t>(kvh) * hd;

  for (int i = tid; i < kRows * hdp; i += kThreads) {
    const int r = i / hdp, d = i - r * hdp;
    const int s = q0 + r;
    q_s[i] = (s < S && d < hd) ? to_f(qb[static_cast<size_t>(s) * q_row + d])
                               : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // keys any of this CTA's rows can see
  const int q_last = min(q0 + kRows, S) - 1;
  const long long lo = window ? static_cast<long long>(q0) - window + 1 : 0;
  const int kv_lo = static_cast<int>(lo < 0 ? 0 : (lo > Tk ? Tk : lo));
  const int kv_hi = causal ? min(Tk, q_last + 1) : Tk;

  for (int kv0 = (kv_lo / kKeys) * kKeys; kv0 < kv_hi; kv0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * hdp; i += kThreads) {
      const int j = i / hdp, d = i - j * hdp;
      const int t = kv0 + j;
      const bool in = t < Tk && d < hd;
      const size_t g = static_cast<size_t>(t) * kv_row + d;
      kt_s[d * kKStride + j] = in ? to_f(kb[g]) : 0.f;
      v_s[i] = in ? vb[g] : zero<T>();
    }
    __syncthreads();

    // ---- 2. scores for keys lane and lane + 32 of the tile -------------
    float sc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r][0] = sc[r][1] = 0.f;
    for (int d = 0; d < hdp; d += 4) {
      float4 qv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (r0 + r) * hdp + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float k0 = kt_s[(d + dd) * kKStride + lane];
        const float k1 = kt_s[(d + dd) * kKStride + lane + 32];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float qd = comp(qv[r], dd);
          sc[r][0] = fmaf(qd, k0, sc[r][0]);
          sc[r][1] = fmaf(qd, k1, sc[r][1]);
        }
      }
    }

    // ---- 3. mask, online softmax, p to shared memory -------------------
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + r0 + r;
      bool vis[2];
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kv0 + lane + 32 * c;
        vis[c] = kpos < Tk && (!causal || qpos >= kpos) &&
                 (window == 0 ||
                  static_cast<long long>(qpos) - kpos < window);
        s[c] = vis[c] ? sc[r][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m[r] - m_new);
      const float p0 = vis[0] ? expf(s[0] - m_new) : 0.f;
      const float p1 = vis[1] ? expf(s[1] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      p_w[r * kKeys + lane] = p0;
      p_w[r * kKeys + lane + 32] = p1;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // ---- 4. acc += p . v ------------------------------------------------
    for (int j = 0; j < kKeys; j += 4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pv[r] = *reinterpret_cast<const float4*>(p_w + r * kKeys + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < hdp ? to_f(v_s[(j + jj) * hdp + d]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pr = comp(pv[r], jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
        }
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * S) * q_row +
          static_cast<size_t>(h) * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + r0 + r;
    if (s >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) ob[static_cast<size_t>(s) * q_row + d] =
          from_f<T>(acc[r][i] / den);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KVH, int hd, int causal, int window,
           cudaStream_t stream) {
  const int hdp = (hd + 3) & ~3;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRows) * hdp +
                                       static_cast<size_t>(hdp) * kKStride +
                                       static_cast<size_t>(kRows) * kKeys) +
                      sizeof(T) * static_cast<size_t>(kKeys) * hdp;
  auto kern = flash_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nq = (S + kRows - 1) / kRows;
  const long long grid = static_cast<long long>(B) * H * nq;
  if (grid > 0x7fffffffLL) return -1;
  // 1/sqrt(hd) in double, rounded once, as the reference's Python scalar
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  kern<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KVH, hd, hdp,
      causal, window, scale, nq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Tk, int H, int KVH, int hd, int causal, int window,
              cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, B, S, Tk, H, KVH, hd, causal, window, s);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, B, S, Tk, H, KVH, hd, causal, window, s);
  return launch<T, 8>(q, k, v, out, B, S, Tk, H, KVH, hd, causal, window, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// -1 for a shape the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int S, int T, int H, int KVH,
                                      int hd, int causal, int window,
                                      void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 ||
      hd > kMaxHd || window < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, S, T, H, KVH, hd, causal, window,
                            s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, KVH, hd, causal,
                                    window, s);
  return -1;
}
