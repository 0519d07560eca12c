// One full heap-protocol round per PIM core, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/heap_step.py::fused_heap_step`
// (the `pl.pallas_call` in `_fused_heap_step`, body `protocol_round`), bit
// for bit over all 31 outputs (9 state leaves, 22 int32[T] records), with
// the reference's batched run-carve refill (`batch_refill`) as well as its
// serial walk. The plain PyTorch version beside it is
// `repro_torch/kernels/heap_step.py::protocol_round`.
//
// What bounds it. A round moves few bytes: op/size/ptr and 22 records per
// thread, the metadata words and stack rows it touches, a carved stack row
// of max_sub = 256 entries per refill; some 2-10 MB for 512 cores, a few
// microseconds at 3.35 TB/s. What bounds it is each core's dependent
// chain: in mutex order every backend op walks the buddy tree down and up
// (2*depth+1 = 27 steps at depth 13), each step a tree word whose address
// depends on the one before plus an access to the 16-entry LRU buddy
// cache. On an H100 (tools/warp_latency.py) a dependent warp vote costs
// about twice a shared-memory load, a reduction or a shuffle about as
// much, and the tree's hot words come from L1 at about the shared-memory
// latency: the LRU's votes, not where the tree lives, set the chain.
//
// What the design does about it. One CTA of 32 threads per core; the
// per-thread phases run on the T lanes at once; the serial phases run in
// thread order with the whole warp computing each walk (one broadcast
// load per step; every lane stores the same value). The LRU lives in
// registers, one entry per lane: a hit is one ballot, a miss a reduction
// and a second ballot.
//   * The walk's loads leave the chain: the descent loads the next left
//     child before the current node's LRU access, so the two overlap; the
//     up-walk loads every sibling on the path at once (the walk writes
//     none of them), then folds the maxima in registers and stores the
//     ancestors, with one __syncwarp per walk instead of one per step.
//   * The up-walk's LRU accesses take no vote: when every entry was used
//     before the clock and no word is cached twice (as every access leaves
//     them) and a root-to-leaf path's words fit the cache, the descent only
//     evicts entries it did not use, so every up-walk access is a hit on
//     a word the descent cached; each lane sets its entry's clock itself.
//   * The run-carve (`batch_refill`): when every needy thread allocates
//     exactly one block and the run of blocks from the leftmost free one
//     is free, the round carves the run with depth warp-parallel levels,
//     writes the refill rows with the whole warp and the block metadata
//     from the needy lanes in parallel, and replays the serial walks' LRU
//     accesses. Otherwise the serial walk.
//   * The tree stays in device memory (its hot words come from L1):
//     staging its top levels in shared memory for the round measured
//     slower on the H100 (PERF.md). It is read and written by explicit
//     global loads and stores from an address computed once (`Tree`):
//     through a plain pointer nvcc re-derives each address from the
//     kernel parameter, a constant-bank load on the walk's dependent
//     chain that cost 22 % of the kernel's time.
//
// Integer semantics. The reference wraps int32; signed overflow is
// undefined in C++, so shifts, smears and the offset product run in
// uint32_t. Every division and modulo here has a non-negative left operand
// (pointers are range-checked first), so C's truncation equals the
// reference's floor. In the big-free walk, `(ptr + heap) / fsize` is only
// formed for a thread whose free reaches the backend, whose pointer lies in
// [0, heap): lanes the reference masks never compute it.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalid = -1;
constexpr int kNodesPerWord = 16;
constexpr int kRecords = 22;
constexpr int kMaxClasses = 32;
constexpr int kChunk = 16;  // siblings an up-walk loads at once

struct Args {
  const int* op;
  const int* size;
  const int* ptr;
  int* longest;     // [C, 2 nb]
  int* counts;      // [C, T, NC]
  int* stacks;      // [C, T, NC, CAP]
  int* block_cls;   // [C, nb]
  int* block_free;  // [C, nb]
  int* big_log2;    // [C, nb]
  int* tags;        // [C, E]
  int* last_used;   // [C, E]
  int* clock;       // [C]
  int* rec;         // [22, C, T]
  int C, T, NC, CAP, E, heap, block;
  int batch_refill;
  int class_sizes[kMaxClasses];  // by value: no copy to the device per round
};

__device__ __forceinline__ int next_pow2(int x) {
  uint32_t u = static_cast<uint32_t>(max(x, 1)) - 1u;
  u |= u >> 1;
  u |= u >> 2;
  u |= u >> 4;
  u |= u >> 8;
  u |= u >> 16;
  return static_cast<int>(u + 1u);  // > 2^30 wraps to INT32_MIN
}

__device__ __forceinline__ int ilog2(int x) {  // popcount(x - 1)
  return __popc(static_cast<uint32_t>(x) - 1u);
}

__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<uint32_t>(x) << s);
}

__device__ __forceinline__ int level_of(int n) { return 31 - __clz(n); }

// The LRU buddy cache: lane i < E holds entry i. `node` is warp-uniform and
// >= 0 (inactive accesses are skipped by the callers: they change nothing).
struct Lru {
  int tag, lu, clock, E, lane;

  __device__ __forceinline__ void access(int node, int& hits, int& misses) {
    const int word = node / kNodesPerWord;
    const bool mine = lane < E;
    const unsigned match = __ballot_sync(kFull, mine && tag == word);
    int idx;
    if (match) {  // argmax of the match vector: the first matching entry
      idx = __ffs(match) - 1;
      ++hits;
    } else {      // argmin of last_used: the first least-recent entry
      const int m = __reduce_min_sync(kFull, mine ? lu : INT_MAX);
      idx = __ffs(__ballot_sync(kFull, mine && lu == m)) - 1;
      ++misses;
    }
    if (lane == idx) {
      tag = word;
      lu = clock;
    }
    ++clock;
  }

  // The up-walk after a descent to `node`: node >> 1, ..., node >> lvu (the
  // root). With `fast` (see the kernel) each is a hit on the entry the
  // descent left its word in, which ends at the clock of its word's last
  // access: every lane sets its own entry, with no vote. Otherwise one
  // access at a time.
  __device__ __forceinline__ void up(int node, int lvu, bool fast,
                                     int& hits, int& misses) {
    if (!fast) {
      for (int k = 1; k <= lvu; ++k) access(node >> k, hits, misses);
      return;
    }
    if (lvu <= 0) return;
    if (lane < E && tag >= 0) {
      // the last k in [1, lvu] whose node's word (node >> (k + 4)) is tag
      int k = lvu;  // word 0 (nodes 1..15) ends at the root
      if (tag > 0) {
        const int j = level_of(node) - level_of(tag);
        k = (j >= 0 && (node >> j) == tag) ? j - 4 : 0;
      }
      if (k >= 1 && k <= lvu) lu = clock + k - 1;
    }
    hits += lvu;
    clock += lvu;
  }
};

// One core's `longest[]`, by explicit global loads and stores from the
// global address of node 0, computed once. The accesses are volatile and
// clobber memory: they stay in program order, which the descent's
// look-ahead load relies on.
struct Tree {
  uint64_t at;

  __device__ __forceinline__ int get(int n) const {
    int v;
    asm volatile("ld.global.s32 %0, [%1];"
                 : "=r"(v)
                 : "l"(at + 4ull * n)
                 : "memory");
    return v;
  }
  __device__ __forceinline__ void set(int n, int v) const {
    asm volatile("st.global.s32 [%0], %1;" ::"l"(at + 4ull * n), "r"(v)
                 : "memory");
  }
};

// The up-walk from `node` (its new value v, its size nsize) through
// `levels` ancestors: every parent := combine(the child on the path, its
// sibling, the child's size). The walk writes no sibling, so a chunk of
// siblings is loaded at once, then folded and the ancestors stored.
template <typename F>
__device__ __forceinline__ void up_walk(const Tree& tr, int node, int levels,
                                        int v, int nsize, F combine) {
  for (int q0 = 0; q0 < levels; q0 += kChunk) {
    int sib[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (q0 + q < levels) sib[q] = tr.get((node >> (q0 + q)) ^ 1);
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (q0 + q < levels) {
        v = combine(v, sib[q], nsize);
        tr.set(node >> (q0 + q + 1), v);
        nsize = shl(nsize, 1);
      }
  }
}

__global__ void __launch_bounds__(32) heap_step_kernel(Args a) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const int T = a.T, NC = a.NC, CAP = a.CAP, heap = a.heap, block = a.block;
  const int nb = heap / block;
  const int n_nodes = 2 * nb;
  const int depth = 31 - __clz(nb);
  __shared__ int class_sizes[kMaxClasses];
#pragma unroll
  for (int i = 0; i < kMaxClasses; ++i)  // static indices: stays in registers
    if (i == lane) class_sizes[i] = a.class_sizes[i];

  const Tree tr{__cvta_generic_to_global(a.longest +
                                        static_cast<size_t>(c) * n_nodes)};
  __syncwarp();  // class_sizes written
  const int min_class = class_sizes[0];
  const int max_class = class_sizes[NC - 1];
  const int log2_min_class = 31 - __clz(min_class);
  const int max_sub = block / min_class;

  int* counts = a.counts + static_cast<size_t>(c) * T * NC;
  int* stacks = a.stacks + static_cast<size_t>(c) * T * NC * CAP;
  int* bcls = a.block_cls + static_cast<size_t>(c) * nb;
  int* bfree = a.block_free + static_cast<size_t>(c) * nb;
  int* blog = a.big_log2 + static_cast<size_t>(c) * nb;

  Lru lru;
  lru.E = a.E;
  lru.lane = lane;
  lru.tag = lane < a.E ? a.tags[c * a.E + lane] : kInvalid;
  lru.lu = lane < a.E ? a.last_used[c * a.E + lane] : INT_MAX;
  lru.clock = a.clock[c];
  // The up-walks' fast path: every entry used before the clock and no word
  // cached twice (as every access leaves them), and a root-to-leaf path's
  // words (one for levels 0-3, one a level below) no more than the
  // entries. Then a descent evicts only entries it has not used (there is
  // always an older one), so its up-walk finds every word it cached.
  const unsigned same_tag = __match_any_sync(kFull, lru.tag) &
                            (a.E >= 32 ? kFull : (1u << a.E) - 1u);
  const bool fast_up =
      __all_sync(kFull, lane >= a.E ||
                            (lru.lu < lru.clock &&
                             (lru.tag < 0 || __popc(same_tag) == 1))) &&
      1 + max(depth - 3, 0) <= a.E;

  auto class_of = [&](int x) {
    const int k = ilog2(next_pow2(max(x, min_class))) - log2_min_class;
    return min(max(k, 0), NC - 1);
  };

  const bool on = lane < T;
  const int op = on ? a.op[c * T + lane] : 0;
  const int size = on ? a.size[c * T + lane] : 0;
  const int ptr = on ? a.ptr[c * T + lane] : kInvalid;
  const bool is_alloc = op == 1 || op == 4;  // OP_MALLOC | OP_CALLOC
  const bool is_re = op == 3;                // OP_REALLOC
  const bool is_free = op == 2;              // OP_FREE

  // ---- realloc size-class analysis on the pre-round metadata ------------
  const bool pvalid = ptr >= 0 && ptr < heap;
  bool small_old = false, big_old = false;
  int old_bytes = 0;
  if (pvalid) {
    const int pb = ptr / block;
    const int pcls = bcls[pb];
    const int plg = blog[pb];
    small_old = pcls >= 0;
    big_old = pcls < 0 && plg >= 0 && ptr % block == 0;
    old_bytes = small_old ? class_sizes[pcls]
                          : (big_old ? shl(1, plg) : 0);
  }
  const bool new_small = size <= max_class;
  const int new_bytes = new_small ? class_sizes[class_of(size)]
                                  : next_pow2(max(size, block));
  const bool in_place_meta =
      ((small_old && new_small) || (big_old && !new_small)) &&
      new_bytes == old_bytes;
  const bool valid_old = small_old || big_old;
  const bool re_live = is_re && size > 0;
  const bool in_place = re_live && in_place_meta;
  const bool moved = re_live && !in_place_meta;
  const bool re_free0 = is_re && size <= 0 && ptr >= 0;

  // ---- malloc phase A: vectorized thread-cache pops ---------------------
  const bool m_active = (is_alloc && size > 0) || moved;
  const int msize = m_active ? size : 0;
  const bool too_big = m_active && msize > heap;
  const bool small = m_active && msize <= max_class && msize > 0;
  const int cls = class_of(msize);
  int* my_count = counts + lane * NC + cls;  // only dereferenced when `on`
  const int cnt = small ? *my_count : 0;
  const bool hit = small && cnt > 0;
  int ptr_a = kInvalid;
  if (hit) {
    ptr_a = stacks[(static_cast<size_t>(lane) * NC + cls) * CAP + (cnt - 1)];
    *my_count = cnt - 1;
    atomicAdd(&bfree[ptr_a / block], -1);  // two threads may share a block
  }
  const bool refill = small && !hit;
  const bool bypass = m_active && msize > max_class && !too_big;
  const bool need = refill || bypass;
  __syncwarp();

  // ---- malloc phase B: the backend (mutex order = thread order) ---------
  int m_ptr_b = kInvalid, m_bpos = kInvalid, m_okb = 0, m_lvd = 0, m_lvu = 0,
      m_hits = 0, m_miss = 0;
  const unsigned need_mask = __ballot_sync(kFull, need);
  const int n_need = __popc(need_mask);
  const int rank = __popc(need_mask & ((1u << lane) - 1u));
  // the reference's three-way switch: skip (no needy thread: the serial
  // loop below does nothing), run-carve, or the serial walk
  bool carve = false;
  int b0 = 0;
  if (n_need > 0 && a.batch_refill) {
    const int alloc_size = refill ? block : next_pow2(max(msize, block));
    if (__all_sync(kFull, !need || alloc_size == block) &&
        tr.get(1) >= block) {
      int node = 1;  // leftmost_block: the serial descent at one block
      for (int i = 0; i < depth; ++i) {
        const int left = 2 * node;
        node = tr.get(left) >= block ? left : left + 1;
      }
      b0 = node - nb;
      if (b0 + n_need <= nb) {  // run_blocks_free, one leaf path per lane
        bool free_k = true;
        if (lane < n_need) {
          const int leaf = nb + b0 + lane;
          int mn = INT_MAX;
          for (int s = 0; s <= depth; ++s) mn = min(mn, tr.get(leaf >> s));
          free_k = mn >= block;
        }
        carve = __all_sync(kFull, free_k);
      }
    }
  }
  if (carve) {
    // the serial walks' LRU accesses, in mutex order: per needy thread the
    // root, the descent to its leaf, the up-walk
    for (unsigned m = need_mask; m; m &= m - 1) {
      const int t = __ffs(m) - 1;
      const int leaf = nb + b0 + __popc(need_mask & ((1u << t) - 1u));
      int hh = 0, mm = 0;
      lru.access(1, hh, mm);
      for (int s = depth - 1; s >= 0; --s) lru.access(leaf >> s, hh, mm);
      lru.up(leaf, depth, fast_up, hh, mm);
      if (lane == t) {
        m_hits = hh;
        m_miss = mm;
      }
    }
    // carve_run: zero the leaves, then every affected parent := max of its
    // children, level by level (at most T / 2 + 2 parents a level)
    if (lane < n_need) tr.set(nb + b0 + lane, 0);
    __syncwarp();
    for (int d = 1; d <= depth; ++d) {
      const int p = ((nb + b0) >> d) + lane;
      if (p <= ((nb + b0 + n_need - 1) >> d))
        tr.set(p, max(tr.get(2 * p), tr.get(2 * p + 1)));
      __syncwarp();
    }
    // the needy lanes' blocks are distinct: metadata written in parallel
    const int off = (b0 + rank) * block;
    if (need) {
      const int b = b0 + rank;
      if (refill) {
        const int sub = block / class_sizes[cls];
        counts[lane * NC + cls] = sub - 1;
        bcls[b] = cls;
        bfree[b] = sub - 1;
        m_ptr_b = off + (sub - 1) * class_sizes[cls];
      } else {
        blog[b] = ilog2(block);
        m_ptr_b = off;
      }
      m_bpos = rank;
      m_okb = 1;
      m_lvd = m_lvu = depth;
    }
    // bulk_refill: each refilled row written by the whole warp
    for (unsigned m = __ballot_sync(kFull, refill); m; m &= m - 1) {
      const int t = __ffs(m) - 1;
      const int c_t = __shfl_sync(kFull, cls, t);
      const int off_t = __shfl_sync(kFull, off, t);
      const int csize = class_sizes[c_t];
      const int sub = block / csize;
      int* row = stacks + (static_cast<size_t>(t) * NC + c_t) * CAP;
      for (int i = lane; i < max_sub; i += 32)
        row[i] = i < sub ? off_t + i * csize : kInvalid;
    }
  } else {
    int border = 0;
    for (int t = 0; t < T; ++t) {
      if (!((need_mask >> t) & 1u)) continue;  // warp-uniform
      const bool refill_t = __shfl_sync(kFull, refill, t);
      const int size_t_ = __shfl_sync(kFull, msize, t);
      const int c_t = __shfl_sync(kFull, cls, t);
      const int alloc_size =
          refill_t ? block : next_pow2(max(size_t_, block));  // else bypass
      // buddy alloc: root visit, descent (the next left child in flight
      // during each access), leaf commit, up-walk
      const int size_r = max(next_pow2(alloc_size), block);
      __syncwarp();  // the last walk's stores before this walk's loads
      const bool ok = size_r <= heap && tr.get(1) >= size_r;
      int hh = 0, mm = 0;
      int node = 1, node_size = heap, lvd = 0;
      int left_v = node_size > size_r ? tr.get(2) : 0;
      lru.access(1, hh, mm);
      while (node_size > size_r) {
        const int left = 2 * node;
        node = left_v >= size_r ? left : left + 1;
        node_size >>= 1;
        ++lvd;
        if (node_size > size_r) left_v = tr.get(2 * node);
        lru.access(node, hh, mm);
      }
      const int off = ok ? static_cast<int>(static_cast<uint32_t>(node) *
                                                static_cast<uint32_t>(
                                                    node_size) -
                                            static_cast<uint32_t>(heap))
                         : kInvalid;
      int lvu = 0;
      if (ok) {
        __syncwarp();  // every lane's descent loads before the stores
        tr.set(node, 0);
        up_walk(tr, node, lvd, 0, 0,
                [](int v, int sib, int) { return max(v, sib); });
        lvu = lvd;
        lru.up(node, lvu, fast_up, hh, mm);
      }
      int ptr_t = kInvalid;
      if (ok) {
        const int b = off / block;
        if (refill_t) {  // carve the block, push all sub-blocks, pop the top
          const int csize = class_sizes[c_t];
          const int sub = block / csize;
          int* row = stacks + (static_cast<size_t>(t) * NC + c_t) * CAP;
          for (int i = lane; i < max_sub; i += 32)
            row[i] = i < sub ? off + i * csize : kInvalid;
          if (lane == 0) {
            counts[t * NC + c_t] = sub - 1;
            bcls[b] = c_t;
            bfree[b] = sub - 1;
          }
          ptr_t = off + (sub - 1) * csize;
        } else {         // bypass: record the size for a ptr-only free
          if (lane == 0) blog[b] = ilog2(alloc_size);
          ptr_t = off;
        }
      }
      if (lane == t) {
        m_ptr_b = ptr_t;
        m_bpos = border;
        m_okb = ok;
        m_lvd = lvd;
        m_lvu = lvu;
        m_hits = hh;
        m_miss = mm;
      }
      ++border;
    }
  }
  __syncwarp();
  const int mptr = hit ? ptr_a : m_ptr_b;
  const bool mok = m_active && mptr >= 0;

  // ---- free phase: explicit frees + vacated realloc blocks --------------
  const bool f_active = is_free || (moved && valid_old && mok) || re_free0;
  const int fptr = f_active ? ptr : kInvalid;
  const bool factive = f_active && fptr >= 0 && fptr < heap;
  const int fb = factive ? fptr / block : 0;
  bool push = false, over = false, fbig = false;
  int flog = kInvalid;  // big_log2 of the freed block, for the walk below
  if (factive) {
    const int fcls = bcls[fb];
    if (fcls >= 0) {
      int* cnt_f = counts + lane * NC + fcls;
      const int fpos = *cnt_f;
      over = fpos >= CAP;
      push = !over;
      if (push) {
        stacks[(static_cast<size_t>(lane) * NC + fcls) * CAP + fpos] = fptr;
        *cnt_f = fpos + 1;
        atomicAdd(&bfree[fb], 1);
      }
    } else {
      flog = blog[fb];
      fbig = flog >= 0 && fptr % block == 0;
    }
  }
  const unsigned big_mask = __ballot_sync(kFull, fbig);
  // a same-round double free reads the -1 the first one wrote: fsize 1
  if (__match_any_sync(kFull, fbig ? fb : -1 - lane) & ((1u << lane) - 1u))
    flog = kInvalid;

  int f_bpos = kInvalid, f_lvu = 0, f_hits = 0, f_miss = 0;
  int border = 0;
  for (int t = 0; t < T; ++t) {
    if (!((big_mask >> t) & 1u)) continue;  // warp-uniform
    const int fptr_t = __shfl_sync(kFull, fptr, t);
    const int fsize = shl(1, max(__shfl_sync(kFull, flog, t), 0));
    const int node = max(min((fptr_t + heap) / max(fsize, 1), n_nodes - 1),
                         0);
    __syncwarp();  // the last walk's stores before this walk's loads
    const bool valid = tr.get(node) == 0;
    int hh = 0, mm = 0, lvu = 0;
    lru.access(node, hh, mm);
    if (valid) {
      lvu = node > 1 ? level_of(node) : 0;
      __syncwarp();  // every lane's load before the stores
      tr.set(node, fsize);
      up_walk(tr, node, lvu, fsize, fsize, [](int v, int sib, int nsize) {
        return (v == nsize && sib == nsize) ? shl(nsize, 1) : max(v, sib);
      });
      for (int k = 1; k <= lvu; ++k) lru.access(node >> k, hh, mm);
    }
    if (lane == t) {
      f_bpos = border;
      f_lvu = lvu;
      f_hits = hh;
      f_miss = mm;
    }
    ++border;
  }
  if (fbig) blog[fb] = kInvalid;

  // ---- write back the cache and the records ------------------------------
  if (lane < a.E) {
    a.tags[c * a.E + lane] = lru.tag;
    a.last_used[c * a.E + lane] = lru.lu;
  }
  if (lane == 0) a.clock[c] = lru.clock;
  if (on) {
    const int vals[kRecords] = {
        mptr, hit, refill, bypass, m_okb, m_bpos, m_lvd, m_lvu, m_hits,
        m_miss, push, fbig, over, f_bpos, f_lvu, f_hits, f_miss, valid_old,
        in_place, moved, old_bytes, new_bytes};
    const size_t stride = static_cast<size_t>(a.C) * T;
#pragma unroll
    for (int f = 0; f < kRecords; ++f)
      a.rec[f * stride + static_cast<size_t>(c) * T + lane] = vals[f];
  }
}

}  // namespace

extern "C" int heap_step_launch(
    const void* op, const void* size, const void* ptr, void* longest,
    void* counts, void* stacks, void* block_cls, void* block_free,
    void* big_log2, void* tags, void* last_used, void* clock,
    const int* class_sizes, void* rec, int C, int T, int NC, int CAP, int E,
    int heap_bytes, int block_bytes, int batch_refill, void* stream) {
  // class_sizes is a HOST array of NC ints, passed to the kernel by value
  if (C <= 0) return 0;
  if (T > 32 || E > 32 || T <= 0 || E <= 0 || NC <= 0 || NC > kMaxClasses ||
      block_bytes <= 0 || heap_bytes < block_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int*>(op), static_cast<const int*>(size),
         static_cast<const int*>(ptr), static_cast<int*>(longest),
         static_cast<int*>(counts), static_cast<int*>(stacks),
         static_cast<int*>(block_cls), static_cast<int*>(block_free),
         static_cast<int*>(big_log2), static_cast<int*>(tags),
         static_cast<int*>(last_used), static_cast<int*>(clock),
         static_cast<int*>(rec), C, T, NC, CAP, E, heap_bytes, block_bytes,
         batch_refill ? 1 : 0, {}};
  for (int i = 0; i < NC; ++i) a.class_sizes[i] = class_sizes[i];
  heap_step_kernel<<<C, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
