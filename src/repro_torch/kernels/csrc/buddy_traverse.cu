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
// address depends on the one before. With 64 KiB of shared memory a CTA,
// three CTAs fit an SM, so 512 cores take 1.29 waves, and each CTA's copy
// in, walk and copy out run one after the other.
//
// What the design does about it.
//   * The walk runs on a copy of the core's tree in shared memory (a
//     dependent step is a ~30-cycle shared-memory load), on one lane (the
//     chain has no parallelism; the C cores' chains run side by side), as
//     before: the next request's size is loaded ahead of the walk. Walks
//     that load three levels at once, fold the up-walk in registers or
//     bring the sizes to shared memory were measured slower (PERF.md).
//   * The copy in is the copy engine's (TMA bulk copies,
//     `cp.async.bulk...mbarrier::complete_tx`), in level order: the top
//     kTopLevels levels (4 KiB) in one chunk, then one chunk per level,
//     each completing on its own mbarrier. The whole tree is in flight at
//     once (the warp's loop kept ~4 KiB in flight), and the walks start as
//     soon as what they read has
//     landed: the top chunk is enough to fail a request at the root (a
//     full tree), and the first walk waits for the rest.
//   * The copy out is one bulk copy per chunk from shared to device memory
//     (`cp.async.bulk.global.shared::cta.bulk_group`), issued after the last
//     walk; the CTA waits only until the copy has read shared memory, not
//     for the writes, so its slot frees for the next wave at once.
//   * A tree whose size or address is not a multiple of 16 bytes (a
//     2-node tree, a tensor view at an odd offset) is copied by the warp
//     instead, 16 bytes a lane where both ends allow it. This is a copy path
//     of the kernel, not a fallback to the plain version.
// All tree indices stay in bounds for any tree contents: the descent only
// goes below a node whose size exceeds r >= min_block, that is above the
// leaves. The offset product runs in uint32 (node * size < 2 heap <= 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTopLevels = 10;  // chunk 0: nodes [0, 2^10), 4 KiB
constexpr int kMaxChunks = 7;   // chunk 0 + one a level: trees <= 2^16 nodes
constexpr int kMaxLevels = kTopLevels + kMaxChunks - 2;  // below the root

__device__ __forceinline__ int next_pow2(int x) {
  uint32_t u = static_cast<uint32_t>(max(x, 1)) - 1u;
  u |= u >> 1;
  u |= u >> 2;
  u |= u >> 4;
  u |= u >> 8;
  u |= u >> 16;
  return static_cast<int>(u + 1u);  // > 2^30 wraps to INT32_MIN
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes from device to shared memory by the copy engine, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {  // phase 0 done
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// bytes from shared to device memory by the copy engine (a bulk group)
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
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

// Chunk k of a tree of `top` levels in chunk 0: its first node and nodes.
__device__ __forceinline__ int chunk_first(int k, int top) {
  return k == 0 ? 0 : 1 << (top + k - 1);
}
__device__ __forceinline__ int chunk_nodes(int k, int top) {
  return k == 0 ? 1 << top : 1 << (top + k - 1);
}

// Which levels of the tree have landed in shared memory: levels
// [0, ready) (all of them on the warp's copy path). Lane 0's.
struct Landing {
  uint64_t* bars;  // the chunks' mbarriers, null on the warp's copy path
  int top, depth, ready, next_chunk;

  __device__ __forceinline__ void operator()(int level) {
    while (ready <= level) {
      bulk_wait(bars + next_chunk);
      ready = next_chunk == 0 ? top : ready + 1;
      ++next_chunk;
    }
  }
};

// Serve the B requests on the tree in shared memory (lane 0).
__device__ __forceinline__ void walk(int* tree, Landing& land, const int* sz,
                                     int* off_out, int B, int heap,
                                     int min_block) {
  int next = sz[0];
  for (int b = 0; b < B; ++b) {
    const int req = next;
    if (b + 1 < B) next = sz[b + 1];  // in flight during the walk
    const int r = max(next_pow2(req), min_block);
    int off = -1;
    if (req > 0 && r <= heap) {
      land(0);
      if (tree[1] >= r) {
        // the first walk waits for every level: a check per walk, not per
        // step, keeps the descent loop tight
        land(land.depth);
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
    }
    off_out[b] = off;
  }
}

__global__ void __launch_bounds__(kThreads)
buddy_alloc_batch_kernel(const int* __restrict__ tree_in,
                         const int* __restrict__ sizes,
                         int* __restrict__ offs, int* __restrict__ tree_out,
                         int B, int n_nodes, int heap, int min_block) {
  extern __shared__ int4 smem4[];
  int* tree = reinterpret_cast<int*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4 + (n_nodes + 3) / 4);
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(c) * n_nodes;
  const int depth = 30 - __clz(n_nodes);        // levels below the root
  const int top = min(kTopLevels, depth + 1);    // levels in chunk 0
  const int nchunks = depth + 2 - top;
  const bool bulk = (n_nodes & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(tree_in + base) |
                      reinterpret_cast<uintptr_t>(tree_out + base)) & 15) == 0;
  Landing land{bulk ? bars : nullptr, top, depth, bulk ? 0 : depth + 1, 0};

  if (!bulk) {
    copy_ints(tree, tree_in + base, n_nodes, lane);
  } else if (lane == 0) {  // the whole tree in flight, a chunk a level
    for (int k = 0; k < nchunks; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < nchunks; ++k) {
      const int first = chunk_first(k, top);
      bulk_load(tree + first, tree_in + base + first,
                4u * static_cast<uint32_t>(chunk_nodes(k, top)), bars + k);
    }
  }
  if (!bulk) __syncwarp();
  if (lane == 0)
    walk(tree, land, sizes + static_cast<size_t>(c) * B,
         offs + static_cast<size_t>(c) * B, B, heap, min_block);
  __syncwarp();

  if (bulk) {
    if (lane == 0) {  // all levels in, the walk's stores (generic proxy)
      land(depth);    // before the copy engine reads them, then out
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int k = 0; k < nchunks; ++k) {
        const int first = chunk_first(k, top);
        bulk_store(tree_out + base + first, tree + first,
                   4u * static_cast<uint32_t>(chunk_nodes(k, top)));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // only until the copy has read shared memory: the writes complete
      // on their own, and the CTA's slot frees for the next wave
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    copy_ints(tree_out + base, tree, n_nodes, lane);
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched); -1 for a shape the kernel does not
// take.
extern "C" int buddy_traverse_launch(const void* tree_in, const void* sizes,
                                     void* offs, void* tree_out, int C, int B,
                                     int n_nodes, int heap, int min_block,
                                     void* stream) {
  if (C <= 0 || B <= 0 || n_nodes < 2 || (n_nodes & (n_nodes - 1)) != 0 ||
      n_nodes > (2 << kMaxLevels) || min_block <= 0 ||
      heap <= 0 || heap / min_block * 2 != n_nodes)
    return -1;
  // the tree, padded to 16 bytes, then one mbarrier a chunk
  const size_t smem = 4 * ((static_cast<size_t>(n_nodes) + 3) / 4 * 4) +
                      sizeof(uint64_t) * kMaxChunks;
  static size_t smem_allowed = 48 * 1024;  // raised once per process
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        buddy_alloc_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  buddy_alloc_batch_kernel<<<C, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tree_in), static_cast<const int*>(sizes),
      static_cast<int*>(offs), static_cast<int*>(tree_out), B, n_nodes, heap,
      min_block);
  return static_cast<int>(cudaGetLastError());
}
