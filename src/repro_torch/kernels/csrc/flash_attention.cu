// Causal / sliding-window GQA flash attention (forward), for Hopper
// (sm_90a): bf16 on the tensor cores, fp32 on the CUDA cores.
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
// Two routes, chosen by dtype in `flash_attention_launch`, which reports
// the route it took so that the wrapper counts the launches of each:
//
// 1. bf16: `flash_attention_kernel_tc`, on the tensor cores. One CTA of 4
//    warps per (batch, query head, query tile of 64 * MT rows); each warp
//    owns MT tiles of 16 rows, so each K and V fragment it loads feeds MT
//    row tiles (MT = 2 at head_dim <= 128, 1 at 256, where registers run
//    out). The tiles of the last rows, which see the most keys under a
//    causal mask, are scheduled first, over all heads. Per KV tile of BN
//    keys (64 at head_dim <= 64, else 32):
//    - K and V tiles are staged in shared memory by cp.async in a ring of
//      two stages, so the next tile's copy overlaps this tile's products;
//      q's tile is staged once. Rows of 16-byte chunks are XOR-swizzled, so
//      ldmatrix and cp.async touch distinct banks.
//    - s = q . k runs as mma.sync.m16n8k16 with bf16 operands (q's and k's
//      own values) and fp32 accumulators: bf16 products are exact in fp32,
//      so this is the reference's fp32 product up to summation order.
//    - mask (only on tiles some key of which is hidden; a warp whose rows
//      see no key of the tile skips it), online softmax in fp32 in
//      registers (base 2 on the special-function unit, the scale folded
//      in), p in fp32.
//    - p.v keeps p's fp32 products: p = p_hi + p_lo with p_hi = bf16(p) and
//      p_lo = bf16(p - p_hi), and acc += p_hi . v + p_lo . v, two bf16
//      tensor-core products with fp32 accumulators. That keeps ~16 bits of
//      p (its error is ~2^-17 p), where p rounded to bf16 keeps 8 and fails
//      the full-width checks. The price of the reference's fp32 p is a
//      third product: 1.5x the tensor-core work of a bf16-p kernel such as
//      scaled_dot_product_attention. The row sum l is taken from fp32 p.
//    head_dim is padded with zeros to 64, 128 or 256 (exact: the padded
//    columns add 0 to every score and are not stored); a head_dim that is
//    not a multiple of 8, or an unaligned tensor, is copied element by
//    element instead of by cp.async.
//
// 2. fp32: `flash_attention_kernel`, on the CUDA cores, as first ported:
//    bf16 tensor-core operands would round q, k and v, so the products run
//    as fp32 FMAs (floor ~67 TFLOP/s). One CTA of 8 warps per (batch, query
//    head, 64-row query tile), tail tiles first; per 64-key KV tile the CTA
//    stages K transposed (padded to 65 columns) and V in shared memory,
//    each warp computes scores for 8 rows (lane j: keys j and j + 32),
//    updates the online softmax with warp reductions, and accumulates p.v
//    with lane d owning head_dim columns d, d + 32, ....
//
// Both routes skip KV tiles wholly hidden from the CTA's rows (above the
// causal diagonal, before the window), which is exact: they would leave
// m, l and acc unchanged. Keys past T read zeros and are hidden.
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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

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
    if (e != cudaSuccess) {
      cudaGetLastError();  // returned here, not left for a later check
      return static_cast<int>(e);
    }
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


// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;             // 4 warps
constexpr double kLog2e = 1.4426950408889634;

// Offset of element (r, 8 * chunk) of a [rows][HD] bf16 tile in shared
// memory: the 16-byte chunks of row r are XOR-swizzled by r & 7.
template <int HD>
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * HD + ((chunk ^ (r & 7)) << 3);
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment), fp32 d.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two fp32 p values (x at the lower column) as the bf16 pairs hi and lo of
// an A fragment: hi = bf16(p), lo = bf16(p - hi), so hi + lo is p to ~2^-17.
__device__ __forceinline__ void split_p(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = as_u32(h);
  lo = as_u32(r);
}

// Copy rows [0, ROWS) of a bf16 matrix with row stride `stride` at src into
// the swizzled [ROWS][HD] tile dst; rows >= valid and columns >= hd read 0.
// vec: hd % 8 == 0 and src 16-byte aligned, so each chunk is one cp.async;
// else element by element (synchronous).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int valid, int hd,
                                          bool vec) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks, col = 8 * c;
    bf16* d = dst + swz<HD>(r, c);
    if (vec) {
      const bool in = r < valid && col < hd;
      cp_async16(d, in ? src + r * stride + col : src, in ? 16 : 0);
    } else {
      for (int e = 0; e < 8; ++e)
        d[e] = (r < valid && col + e < hd) ? src[r * stride + col + e]
                                           : __float2bfloat16(0.f);
    }
  }
}

// 2^x on the special-function unit (relative error ~2^-22; 0 below 2^-126).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile of BN keys starting at kv0 for this warp's MT tiles of 16
// query rows: s = q . k, the online softmax update of (m, l, o),
// o += (p_hi + p_lo) . v. Each K and V fragment feeds all MT row tiles.
// m[t] and l[t] hold rows lane/4 and lane/4 + 8 of row tile t; l is this
// thread's partial sum over its columns (the quad's four partials are
// summed at the end).
template <int HD, int BN, int MT>
__device__ __forceinline__ void attend_tile(
    const bf16* q_s, const bf16* k_s, const bf16* v_s,
    float (&o)[MT][HD / 8][4], float (&m)[MT][2], float (&l)[MT][2], int kv0,
    int q0, int Tk, int causal, int window, bool mask, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 * MT;  // the warp's first row
  // keys wholly hidden from the warp's rows leave m, l and o unchanged
  if ((causal && kv0 > q0 + r0 + 16 * MT - 1) ||
      (window && q0 + r0 - (kv0 + BN - 1) >= window))
    return;
  float s[MT][BN / 8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][j][e] = 0.f;

  // ---- s = q . k: bf16 operands, fp32 accumulators --------------------
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
      ldsm_x4(a[t], q_s + swz<HD>(r0 + 16 * t + (lane & 15),
                                  2 * kk + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < BN / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, k_s + swz<HD>(16 * nb + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1)));
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma16816(s[t][2 * nb], a[t], b[0], b[1]);
        mma16816(s[t][2 * nb + 1], a[t], b[2], b[3]);
      }
    }
  }

  // ---- mask, online softmax in base 2, p in fp32 ----------------------
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int qa = q0 + r0 + 16 * t + (lane >> 2);  // rows qa and qa + 8
    unsigned vis = 0xffffffffu;                      // bit 4 * j + e
    float mx[2] = {m[t][0], m[t][1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][j][e] * scale_log2;
        if (mask) {
          const int qpos = qa + 8 * (e >> 1);
          const int kpos = kv0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const bool in = kpos < Tk && (!causal || qpos >= kpos) &&
                          (window == 0 || qpos - kpos < window);
          if (!in) {
            x = kNegInf;
            vis &= ~(1u << (4 * j + e));
          }
        }
        s[t][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = fast_exp2(m[t][r] - mx[r]);
      m[t][r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * j + e)) & 1u
                            ? fast_exp2(s[t][j][e] - m[t][e >> 1])
                            : 0.f;
        s[t][j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[t][r] = l[t][r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[t][n][0] *= alpha[0];
      o[t][n][1] *= alpha[0];
      o[t][n][2] *= alpha[1];
      o[t][n][3] *= alpha[1];
    }
  }

  // ---- o += p_hi . v + p_lo . v ----------------------------------------
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      split_p(s[t][2 * kk][0], s[t][2 * kk][1], hi[t][0], lo[t][0]);
      split_p(s[t][2 * kk][2], s[t][2 * kk][3], hi[t][1], lo[t][1]);
      split_p(s[t][2 * kk + 1][0], s[t][2 * kk + 1][1], hi[t][2], lo[t][2]);
      split_p(s[t][2 * kk + 1][2], s[t][2 * kk + 1][3], hi[t][3], lo[t][3]);
    }
#pragma unroll
    for (int nd = 0; nd < HD / 16; ++nd) {
      uint32_t b[4];
      const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(b, v_s + swz<HD>(key, 2 * nd + (lane >> 4)));
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma16816(o[t][2 * nd], hi[t], b[0], b[1]);
        mma16816(o[t][2 * nd], lo[t], b[0], b[1]);
        mma16816(o[t][2 * nd + 1], hi[t], b[2], b[3]);
        mma16816(o[t][2 * nd + 1], lo[t], b[2], b[3]);
      }
    }
  }
}

// HD: head_dim padded (64, 128 or 256); BN: keys per KV tile; MT: tiles of
// 16 query rows per warp (the CTA takes 64 * MT rows).
template <int HD, int BN, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_kernel_tc(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int S, int Tk, int H, int KVH, int hd, int causal,
                          int window, float scale_log2, int nq, int bh_count,
                          int vec) {
  constexpr int kRowsTc = 64 * MT;  // query rows per CTA
  const int iq = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = blockIdx.x % bh_count;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = iq * kRowsTc;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 * MT;

  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kRowsTc][HD]
  bf16* k_s = q_s + kRowsTc * HD;                // [2][BN][HD]
  bf16* v_s = k_s + 2 * BN * HD;                 // [2][BN][HD]

  const size_t q_row = static_cast<size_t>(H) * hd;  // elements per token
  const size_t kv_row = static_cast<size_t>(KVH) * hd;
  const bf16* qb = q + (static_cast<size_t>(b) * S + q0) * q_row +
                   static_cast<size_t>(h) * hd;
  const bf16* kb = k + static_cast<size_t>(b) * Tk * kv_row +
                   static_cast<size_t>(kvh) * hd;
  const bf16* vb = v + static_cast<size_t>(b) * Tk * kv_row +
                   static_cast<size_t>(kvh) * hd;

  // keys any of this CTA's rows can see
  const int q_last = min(q0 + kRowsTc, S) - 1;
  const long long lo = window ? static_cast<long long>(q0) - window + 1 : 0;
  const int kv_lo = static_cast<int>(lo < 0 ? 0 : (lo > Tk ? Tk : lo));
  const int kv_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin = (kv_lo / BN) * BN;
  const int n_tiles = kv_hi > kv_begin ? (kv_hi - kv_begin + BN - 1) / BN : 0;

  load_tile<HD, kRowsTc>(q_s, qb, q_row, S - q0, hd, vec);
  if (n_tiles > 0) {
    load_tile<HD, BN>(k_s, kb + kv_begin * kv_row, kv_row, Tk - kv_begin, hd,
                      vec);
    load_tile<HD, BN>(v_s, vb + kv_begin * kv_row, kv_row, Tk - kv_begin, hd,
                      vec);
  }
  cp_async_commit();

  float o[MT][HD / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    m[t][0] = m[t][1] = kNegInf;
    l[t][0] = l[t][1] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * BN;
    if (it + 1 < n_tiles) {  // the next tile's copy, into the other stage
      const int nx = kv0 + BN, st = ((it + 1) & 1) * BN * HD;
      load_tile<HD, BN>(k_s + st, kb + nx * kv_row, kv_row, Tk - nx, hd, vec);
      load_tile<HD, BN>(v_s + st, vb + nx * kv_row, kv_row, Tk - nx, hd, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) have landed
    __syncthreads();
    const int st = (it & 1) * BN * HD;
    const bool mask = kv0 + BN > Tk || (causal && kv0 + BN - 1 > q0) ||
                      (window && q0 + kRowsTc - 1 - kv0 >= window);
    attend_tile<HD, BN, MT>(q_s, k_s + st, v_s + st, o, m, l, kv0, q0, Tk,
                            causal, window, mask, scale_log2);
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  bf16* ob = out + static_cast<size_t>(b) * S * q_row +
             static_cast<size_t>(h) * hd;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[t][r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      const int s = q0 + r0 + 16 * t + (lane >> 2) + 8 * r;
      if (s >= S) continue;
      const float den = fmaxf(lr, 1e-30f);
      bf16* orow = ob + static_cast<size_t>(s) * q_row;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int d = 8 * n + 2 * (lane & 3);
        if (d >= hd) continue;
        const float x0 = o[t][n][2 * r] / den, x1 = o[t][n][2 * r + 1] / den;
        if (vec) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          orow[d] = __float2bfloat16(x0);
          if (d + 1 < hd) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int HD, int BN, int MT>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Tk, int H, int KVH, int hd, int causal, int window,
              cudaStream_t stream) {
  constexpr int kRowsTc = 64 * MT;
  const size_t smem = sizeof(bf16) * (static_cast<size_t>(kRowsTc) * HD +
                                      4 * static_cast<size_t>(BN) * HD);
  auto kern = flash_attention_kernel_tc<HD, BN, MT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // returned here, not left for a later check
      return static_cast<int>(e);
    }
  }
  const int nq = (S + kRowsTc - 1) / kRowsTc;
  const long long grid = static_cast<long long>(B) * H * nq;
  if (grid > 0x7fffffffLL) return -1;
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out);
  // 1/sqrt(hd) in double, times log2(e), rounded once
  const float scale_log2 =
      static_cast<float>(kLog2e / std::sqrt(static_cast<double>(hd)));
  kern<<<static_cast<unsigned>(grid), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Tk, H, KVH,
      hd, causal, window, scale_log2, nq, B * H, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_hd(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Tk, int H, int KVH, int hd, int causal,
                 int window, cudaStream_t s) {
  if (hd <= 64)
    return launch_tc<64, 64, 2>(q, k, v, out, B, S, Tk, H, KVH, hd, causal,
                                window, s);
  if (hd <= 128)
    return launch_tc<128, 32, 2>(q, k, v, out, B, S, Tk, H, KVH, hd, causal,
                                 window, s);
  return launch_tc<256, 32, 1>(q, k, v, out, B, S, Tk, H, KVH, hd, causal,
                               window, s);
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

// dtype: 0 = float32 (route 0, CUDA cores), 1 = bfloat16 (route 1, tensor
// cores); *route is set to the route taken. Returns a cudaError_t
// (0 = launched); -1 for a shape the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int S, int T, int H, int KVH,
                                      int hd, int causal, int window,
                                      void* stream, int* route) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 ||
      hd > kMaxHd || window < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    *route = 0;
    return launch_hd<float>(q, k, v, out, B, S, T, H, KVH, hd, causal, window,
                            s);
  }
  if (dtype == 1) {
    *route = 1;
    return launch_tc_hd(q, k, v, out, B, S, T, H, KVH, hd, causal, window, s);
  }
  return -1;
}
