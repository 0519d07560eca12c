// One full heap-protocol round per PIM core, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/heap_step.py::fused_heap_step`
// (the `pl.pallas_call` in `_fused_heap_step`, body `protocol_round`): the
// reference's serial-walk semantics, bit for bit over all 31 outputs (9
// state leaves, 22 int32[T] records). The plain PyTorch version beside it is
// `repro_torch/kernels/heap_step.py::protocol_round`.
//
// What bounds it. A round moves few bytes: op/size/ptr and 22 records per
// thread, the O(T) metadata words and stack rows it touches, and at most one
// carved stack row of max_sub = 256 entries per refill. That is about
// 2 KiB + 1 KiB per refill per core, some 2-10 MB for 512 cores, a few
// microseconds at 3.35 TB/s. What bounds it is the dependent chain: in
// mutex order, each backend op walks the tree down and up (up to
// 2*depth+1 = 27 LRU-plus-tree steps at depth 13), so a round of T = 16
// backend ops is a chain of up to T*(2*depth+1) = 432 steps per core, each a
// dependent load of a `longest` word from device memory (L2 at best) plus a
// warp-wide LRU lookup. That chain, not bandwidth, sets the kernel's time.
//
// What this simple design does about it. One CTA of 32 threads per core
// (grid = C), so the C independent chains run side by side on all SMs. The
// per-thread phases (realloc analysis, freelist pops, free pushes) run on
// the T lanes at once; the refill carve of up to 256 stack entries is
// written by the whole warp. The serial phases run in thread order with the
// warp in lockstep: every lane reads the same tree word (one broadcast
// load), lane 0 writes, and the LRU cache lives in registers, one entry per
// lane, so a lookup is one ballot and a victim search one warp reduction.
// The state stays in device memory and is updated in place: staging the
// 160 KiB of `longest` + block metadata per core into shared memory every
// round would move far more bytes than the round touches. Staging across
// several rounds, and the reference's batched run-carve refill, are later
// designs.
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
};

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
  __syncwarp();
  const int min_class = class_sizes[0];
  const int max_class = class_sizes[NC - 1];
  const int log2_min_class = 31 - __clz(min_class);
  const int max_sub = block / min_class;

  int* longest = a.longest + static_cast<size_t>(c) * n_nodes;
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

  // ---- malloc phase B: serial backend (mutex order = thread order) ------
  int m_ptr_b = kInvalid, m_bpos = kInvalid, m_okb = 0, m_lvd = 0, m_lvu = 0,
      m_hits = 0, m_miss = 0;
  const unsigned need_mask = __ballot_sync(kFull, need);
  int border = 0;
  for (int t = 0; t < T; ++t) {
    if (!((need_mask >> t) & 1u)) continue;  // warp-uniform
    const bool refill_t = __shfl_sync(kFull, refill, t);
    const int size_t_ = __shfl_sync(kFull, msize, t);
    const int c_t = __shfl_sync(kFull, cls, t);
    const int alloc_size =
        refill_t ? block : next_pow2(max(size_t_, block));  // else bypass
    // buddy alloc: root visit, descent, leaf commit, up-walk
    const int size_r = max(next_pow2(alloc_size), block);
    const bool ok = size_r <= heap && longest[1] >= size_r;
    int hh = 0, mm = 0;
    lru.access(1, hh, mm);
    int node = 1, node_size = heap, lvd = 0, lvu = 0;
    while (lvd < depth && node_size > size_r) {
      const int left = 2 * node;
      node = longest[left] >= size_r ? left : left + 1;
      node_size >>= 1;
      ++lvd;
      lru.access(node, hh, mm);
    }
    const int off = ok ? static_cast<int>(static_cast<uint32_t>(node) *
                                              static_cast<uint32_t>(node_size) -
                                          static_cast<uint32_t>(heap))
                       : kInvalid;
    if (ok) {
      if (lane == 0) longest[node] = 0;
      __syncwarp();
      for (int n = node >> 1; n >= 1 && lvu < depth; n >>= 1) {
        const int v = max(longest[2 * n], longest[2 * n + 1]);
        if (lane == 0) longest[n] = v;
        __syncwarp();
        ++lvu;
        lru.access(n, hh, mm);
      }
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
      __syncwarp();
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
  __syncwarp();
  const int mptr = hit ? ptr_a : m_ptr_b;
  const bool mok = m_active && mptr >= 0;

  // ---- free phase: explicit frees + vacated realloc blocks --------------
  const bool f_active = is_free || (moved && valid_old && mok) || re_free0;
  const int fptr = f_active ? ptr : kInvalid;
  const bool factive = f_active && fptr >= 0 && fptr < heap;
  const int fb = factive ? fptr / block : 0;
  bool push = false, over = false, fbig = false;
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
      fbig = blog[fb] >= 0 && fptr % block == 0;
    }
  }
  __syncwarp();

  int f_bpos = kInvalid, f_lvu = 0, f_hits = 0, f_miss = 0;
  const unsigned big_mask = __ballot_sync(kFull, fbig);
  border = 0;
  for (int t = 0; t < T; ++t) {
    if (!((big_mask >> t) & 1u)) continue;  // warp-uniform
    const int fptr_t = __shfl_sync(kFull, fptr, t);
    const int fb_t = __shfl_sync(kFull, fb, t);
    // a same-round double free reads the -1 the first one wrote: fsize 1
    const int fsize = shl(1, max(blog[fb_t], 0));
    const int node = min((fptr_t + heap) / fsize, n_nodes - 1);
    const bool valid = longest[node] == 0;
    int hh = 0, mm = 0, lvu = 0;
    lru.access(node, hh, mm);
    if (valid) {
      if (lane == 0) longest[node] = fsize;
      __syncwarp();
      int nsize = fsize;
      for (int n = node >> 1; n >= 1 && lvu < depth; n >>= 1) {
        const int psize = shl(nsize, 1);
        const int l = longest[2 * n], r = longest[2 * n + 1];
        const int v = (l == nsize && r == nsize) ? psize : max(l, r);
        if (lane == 0) longest[n] = v;
        __syncwarp();
        ++lvu;
        lru.access(n, hh, mm);
        nsize = psize;
      }
    }
    if (lane == 0) blog[fb_t] = kInvalid;
    __syncwarp();
    if (lane == t) {
      f_bpos = border;
      f_lvu = lvu;
      f_hits = hh;
      f_miss = mm;
    }
    ++border;
  }

  // ---- write back the cache and the records -----------------------------
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
    int heap_bytes, int block_bytes, void* stream) {
  // class_sizes is a HOST array of NC ints, passed to the kernel by value
  if (C <= 0) return 0;
  if (T > 32 || E > 32 || T <= 0 || E <= 0 || NC <= 0 || NC > kMaxClasses)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int*>(op), static_cast<const int*>(size),
         static_cast<const int*>(ptr), static_cast<int*>(longest),
         static_cast<int*>(counts), static_cast<int*>(stacks),
         static_cast<int*>(block_cls), static_cast<int*>(block_free),
         static_cast<int*>(big_log2), static_cast<int*>(tags),
         static_cast<int*>(last_used), static_cast<int*>(clock),
         static_cast<int*>(rec), C, T, NC, CAP, E, heap_bytes, block_bytes,
         {}};
  for (int i = 0; i < NC; ++i) a.class_sizes[i] = class_sizes[i];
  heap_step_kernel<<<C, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
