// Batched buddy-tree allocation, one warp per core, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/buddy_traverse.py::
// buddy_alloc_batch_kernel` (its `pl.pallas_call`, body `_kernel` /
// `_alloc_one`), bit for bit. The plain PyTorch version beside it is
// `repro_torch/kernels/buddy_traverse.py::buddy_alloc_batch_plain`.
//
//   tree_in   int32[C, n_nodes]  longest[] per core, 1-indexed (slot 0 unused)
//   sizes     int32[C, B]        requests, served in order within a core
//   offs      int32[C, B]        byte offset of each block, -1 on failure
//   tree_out  int32[C, n_nodes]  the trees after the batch
//
// A request is served iff size > 0, r <= heap and longest[1] >= r, where
// r = max(next_pow2(size), min_block) and next_pow2 wraps as the reference's
// int32 bit-smear does (a size above 2^30 gives INT32_MIN, so r = min_block).
// The walk: descend from the root, left when longest[left] >= r, until the
// node's size is r; zero that node; re-max every ancestor up to the root.
//
// What bounds it. The bytes are few: each tree is read once and written
// once (2 x 64 KiB per core at the allocator's geometry, 32 MiB heaps of
// 4 KiB blocks: ~67.6 MB for 512 cores, ~0.020 ms at 3.35 TB/s). The work
// is a dependent chain: B requests x (descent + up-walk), up to
// B x 2 x depth = 128 x 26 = 3328 steps per core, each a load whose
// address depends on the one before.
//
// What this simple design does about it. The chain is made short in time
// by walking a copy of the core's tree in shared memory (a dependent step
// is a ~30-cycle shared-memory load instead of a device-memory round
// trip); the 32 lanes of the warp copy the tree in and out with 16-byte
// loads and stores. One lane walks (the chain has no parallelism), and the
// C cores' chains run side by side, a few CTAs per SM (64 KiB of shared
// memory each). The next request's size is loaded ahead of the walk. All
// tree indices stay in bounds for any tree contents: the descent only goes
// below a node whose size exceeds r >= min_block, that is above the leaves.
// The offset product runs in uint32 (node * size < 2 heap <= 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ int next_pow2(int x) {
  uint32_t u = static_cast<uint32_t>(max(x, 1)) - 1u;
  u |= u >> 1;
  u |= u >> 2;
  u |= u >> 4;
  u |= u >> 8;
  u |= u >> 16;
  return static_cast<int>(u + 1u);  // > 2^30 wraps to INT32_MIN
}

// Copy n ints, 16 bytes a lane where both ends are 16-byte aligned.
__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n,
                                          int lane) {
  const bool wide = (n & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  if (wide) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll 8
    for (int i = lane; i < n / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = lane; i < n; i += kThreads) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
buddy_alloc_batch_kernel(const int* __restrict__ tree_in,
                         const int* __restrict__ sizes,
                         int* __restrict__ offs, int* __restrict__ tree_out,
                         int B, int n_nodes, int heap, int min_block) {
  extern __shared__ int4 smem4[];
  int* tree = reinterpret_cast<int*>(smem4);
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(c) * n_nodes;

  copy_ints(tree, tree_in + base, n_nodes, lane);
  __syncwarp();

  if (lane == 0) {
    const int* sz = sizes + static_cast<size_t>(c) * B;
    int* off_out = offs + static_cast<size_t>(c) * B;
    int next = sz[0];
    for (int b = 0; b < B; ++b) {
      const int req = next;
      if (b + 1 < B) next = sz[b + 1];  // in flight during the walk
      const int r = max(next_pow2(req), min_block);
      int off = -1;
      if (req > 0 && r <= heap && tree[1] >= r) {
        int node = 1, node_size = heap;
        while (node_size > r) {
          const int left = 2 * node;
          node = tree[left] >= r ? left : left + 1;
          node_size >>= 1;
        }
        off = static_cast<int>(static_cast<uint32_t>(node) *
                                   static_cast<uint32_t>(node_size) -
                               static_cast<uint32_t>(heap));
        tree[node] = 0;
        for (int n = node >> 1; n >= 1; n >>= 1)
          tree[n] = max(tree[2 * n], tree[2 * n + 1]);
      }
      off_out[b] = off;
    }
  }
  __syncwarp();

  copy_ints(tree_out + base, tree, n_nodes, lane);
}

}  // namespace

// Returns a cudaError_t (0 = launched); -1 for a shape the kernel does not
// take.
extern "C" int buddy_traverse_launch(const void* tree_in, const void* sizes,
                                     void* offs, void* tree_out, int C, int B,
                                     int n_nodes, int heap, int min_block,
                                     void* stream) {
  if (C <= 0 || B <= 0 || n_nodes < 2 || (n_nodes & (n_nodes - 1)) != 0 ||
      min_block <= 0 || heap <= 0 || heap / min_block * 2 != n_nodes)
    return -1;
  const size_t smem = sizeof(int) * static_cast<size_t>(n_nodes);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        buddy_alloc_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  buddy_alloc_batch_kernel<<<C, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tree_in), static_cast<const int*>(sizes),
      static_cast<int*>(offs), static_cast<int*>(tree_out), B, n_nodes, heap,
      min_block);
  return static_cast<int>(cudaGetLastError());
}
