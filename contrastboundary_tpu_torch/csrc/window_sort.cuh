// The ordered scatter shared by the kernels that add window slots' values
// onto their support rows without atomics (window_gather_bwd.cu, the second
// pass of cbl_dense.cu's backward).
//
// A block owns some rows of one support tile. The query tiles whose windows
// hold that tile are one contiguous range, because the window starts are
// non-decreasing in every geometry (self, TransitionDown, interpolation):
// two binary searches find it, and its slots are one contiguous range of
// flat (q, k) indices. The block walks that range in super-chunks of kSuper
// slots, in slot order. sort_chunk lays out the chunk's slots that land in
// the block's rows by bucket = local row % NB, each bucket in ascending slot
// order: a stable counting sort in shared memory (counts per (bucket, warp),
// an exclusive scan, a warp-ordered placement by __match_any_sync ranks),
// with no order left to scheduling. The caller's lane group b then walks
// bucket b's entries in order, so each row's sum is taken in ascending slot
// order, the same on every run.
#pragma once

#include <cuda_runtime.h>

namespace cbl_window_sort {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                    // slots a thread per super-chunk
constexpr int kSuper = kWarps * kSteps * 32;  // 4096 slots

// first g in [0, n) with start(g) >= v (n if none), start non-decreasing
template <class Start>
__device__ __forceinline__ int first_at_least(Start start, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start(mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The slots [lo, hi) of the query tiles whose windows [start(g), start(g) +
// width) hold support tile s, with kt slots a query tile.
template <class Start>
__device__ __forceinline__ int2 slot_range(Start start, int gq, int width,
                                           int s, int kt) {
  return make_int2(first_at_least(start, gq, s - width + 1) * kt,
                   first_at_least(start, gq, s + 1) * kt);
}

struct Counts {
  int cnt[kThreads];      // per (bucket, warp), bucket-major; 0 between chunks
  int off[kThreads + 1];  // exclusive scan of cnt; off[kThreads] the total
  int cur[kThreads];
  int wsum[kWarps];
};

// Sort the slots [base, min(base + kSuper, hi)) that `entry` maps to an
// entry (slot << 8 | local row, or -1 for a slot that lands elsewhere or
// adds nothing) into list, bucket by bucket (bucket = entry % NB, NB <= 32):
// bucket b's entries are list[cs.off[b * kWarps] .. cs.off[(b + 1) *
// kWarps]), in slot order. Returns the number of entries (block-uniform);
// with none, list is not written. cs.cnt must be 0 on the first call (the
// scan leaves it 0). Called by every thread of the block; ends with a
// barrier.
template <int NB, class Entry>
__device__ __forceinline__ int sort_chunk(int base, int hi, Entry entry,
                                          int* list, Counts& cs) {
  static_assert(NB * kWarps <= kThreads, "a counter a thread");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // 1. the slots landing in the block's rows (all kSteps evaluated before
  // any is counted, so their loads are in flight together), counted per
  // (bucket, warp)
  int ent[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int slot = base + (warp * kSteps + st) * 32 + lane;
    ent[st] = slot < hi ? entry(slot) : -1;
  }
#pragma unroll
  for (int st = 0; st < kSteps; ++st)
    if (ent[st] >= 0) atomicAdd(&cs.cnt[(ent[st] & (NB - 1)) * kWarps + warp], 1);
  __syncthreads();
  // 2. exclusive scan of the counts, bucket-major then warp
  {
    const int v = cs.cnt[tid];
    cs.cnt[tid] = 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) cs.wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? cs.wsum[lane] : 0;
      int y = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(kFull, y, o);
        if (lane >= o) y += z;
      }
      if (lane < kWarps) cs.wsum[lane] = y - w;
    }
    __syncthreads();
    const int ex = x - v + cs.wsum[warp];
    cs.off[tid] = ex;
    cs.cur[tid] = ex;
    if (tid == kThreads - 1) cs.off[kThreads] = ex + v;
  }
  __syncthreads();
  const int total = cs.off[kThreads];
  if (total == 0) return 0;
  // 3. each warp places its entries in slot order (step, then lane)
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int e = ent[st];
    if (!__any_sync(kFull, e >= 0)) continue;
    const int bucket = e >= 0 ? (e & (NB - 1)) : -1;
    const unsigned same = __match_any_sync(kFull, bucket);
    const int at = e >= 0 ? cs.cur[bucket * kWarps + warp] : 0;
    __syncwarp();
    if (e >= 0) {
      list[at + __popc(same & lower)] = e;
      if ((same & lower) == 0) cs.cur[bucket * kWarps + warp] = at + __popc(same);
    }
    __syncwarp();
  }
  __syncthreads();
  return total;
}

}  // namespace cbl_window_sort
