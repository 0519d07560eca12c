// Thread-cache freelist pop / push, one CTA per thread cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/freelist.py::freelist_op_kernel`
// (its `pl.pallas_call`, body `_kernel`), with the index rule the reference
// has as its tests run it (interpret mode). The plain PyTorch version beside
// it is `repro_torch/kernels/freelist.py::freelist_op_plain`.
//
//   stacks      int32[T, NC, CAP]  LIFO size-class stacks per thread cache
//   counts      int32[T, NC]       their depths
//   op/cls/ptr  int32[T]           0 = pop cls, 1 = push ptr onto cls, else idle
//   ptr_out     int32[T]           the popped pointer, -1 when none
//   counts_out, stacks_out         the caches after the op
//
// Index rule: the class is clamped into [0, NC-1]; a stack position counts
// from the end when negative and is then clamped into [0, CAP-1]; reads and
// writes alike. Count arithmetic wraps as int32 (done in uint32 here).
//
// What bounds it. Every cache is copied to the outputs: at the allocator's
// width (8192 thread caches x 8 classes x 1024 entries) that is 256 MiB read
// and 256 MiB written, ~537 MB or ~0.160 ms at 3.35 TB/s; the op itself
// touches two words per cache. Bytes bound it.
//
// What this simple design does about it. One CTA of 256 threads per cache
// copies its [NC, CAP] stacks with 16-byte loads and stores (32 KiB per
// cache at the allocator's width, 8 iterations), then one thread applies
// the op after a barrier, so the op's write lands after the copy of that
// word. 8192 CTAs keep the copy streaming on every SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_clamp(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
freelist_kernel(const int* __restrict__ stacks, const int* __restrict__ counts,
                const int* __restrict__ op, const int* __restrict__ cls,
                const int* __restrict__ ptr_in, int* __restrict__ ptr_out,
                int* __restrict__ counts_out, int* __restrict__ stacks_out,
                int NC, int CAP) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t per = static_cast<size_t>(NC) * CAP;
  const int* src = stacks + static_cast<size_t>(t) * per;
  int* dst = stacks_out + static_cast<size_t>(t) * per;

  const bool wide = (per & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (wide) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const size_t n4 = per / 4;
#pragma unroll 4
    for (size_t i = tid; i < n4; i += kThreads) d4[i] = s4[i];
  } else {
    for (size_t i = tid; i < per; i += kThreads) dst[i] = src[i];
  }
  const int* cnt_in = counts + static_cast<size_t>(t) * NC;
  int* cnt_out = counts_out + static_cast<size_t>(t) * NC;
  for (int i = tid; i < NC; i += kThreads) cnt_out[i] = cnt_in[i];
  __syncthreads();

  if (tid == 0) {
    const int o = op[t];
    const int c = min(max(cls[t], 0), NC - 1);
    const int cnt = cnt_in[c];
    const bool is_pop = o == 0 && cnt > 0;
    const bool is_push = o == 1 && cnt < CAP;
    const int cnt_m1 = static_cast<int>(static_cast<uint32_t>(cnt) - 1u);
    const int pos_pop = wrap_clamp(max(cnt_m1, 0), CAP);
    ptr_out[t] = is_pop ? src[static_cast<size_t>(c) * CAP + pos_pop] : -1;
    const int pos_push = wrap_clamp(min(cnt, CAP - 1), CAP);
    if (is_push) dst[static_cast<size_t>(c) * CAP + pos_push] = ptr_in[t];
    const int delta = is_pop ? -1 : (is_push ? 1 : 0);
    cnt_out[c] = static_cast<int>(static_cast<uint32_t>(cnt) +
                                  static_cast<uint32_t>(delta));
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched); -1 for a shape the kernel does not
// take.
extern "C" int freelist_launch(const void* stacks, const void* counts,
                               const void* op, const void* cls,
                               const void* ptr_in, void* ptr_out,
                               void* counts_out, void* stacks_out, int T,
                               int NC, int CAP, void* stream) {
  if (T <= 0 || NC <= 0 || CAP <= 0) return -1;
  freelist_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stacks), static_cast<const int*>(counts),
      static_cast<const int*>(op), static_cast<const int*>(cls),
      static_cast<const int*>(ptr_in), static_cast<int*>(ptr_out),
      static_cast<int*>(counts_out), static_cast<int*>(stacks_out), NC, CAP);
  return static_cast<int>(cudaGetLastError());
}
