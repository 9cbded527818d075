// The ordered scatter of the CBL backwards' neighbour terms: the second
// pass of cbl_dense.cu's backward (cbl_stats_bwd) and of cbl_tile2.cu's v2
// backward (cbl_tile2_bwd). Pass 1 of each writes, for the listed slots
// (flat (q, k) index of a cloud), its coefficient w to cd [B, M, K] and the
// cloud row it lands on to lands [B, M, K] (-1 where w == 0 or the slot adds
// nothing), and the query rows' own parts to dx. This pass adds each slot's
// term w * (s - q), rounded as __fmul_rn(w, __fsub_rn(s, q)), onto its
// support row s in ascending slot order, then writes dx = dx + that sum:
// every dx element written once, no atomics, the same bits on every run.
//
// A block owns `rows` rows of one support tile (a power-of-two divisor of
// the tile, at most scatter_max_rows(C)). The query tiles whose windows
// hold that tile are one contiguous range (the self geometry's window
// starts clip(t - window, 0, M / tile - width) are non-decreasing): two
// binary searches find it, and its slots are one contiguous range of flat
// slots. The block scans that range in chunks of kSuper slots (one int of
// lands a slot), compacts the slots landing in its rows, in slot order, into
// `hits` (up to kSuper of them), then sorts them by row stably
// (window_sort.cuh) and lane group b (C / 4 lanes, a float4 each) adds
// bucket b's terms onto its rows in shared memory, reading w and the query
// row, with the block's own rows s in shared memory. It sorts and adds the
// hits once kSuper of them are kept, not every chunk of the range.
//
// ACTIVE (the v2 backward): only the query rows whose loss mask (stats
// [B, M, 8] lane 6) and cloud cotangent g [B] are both non-zero have slots
// that can land (pass 1 wrote lands on those rows only, and dq only there).
// The block compacts the active rows of its query-row range, in ascending
// order, kQueryChunk rows at a time, and scans only their
// slots (at the flagship's level 0, 17% of the range): a hit is packed as
// (v << 8) | local row, v its index among those slots (v = i K + k for the
// i-th active row), and its slot is recovered from the compacted rows, so
// the order is still ascending slot order and no limit on M K applies (K
// below 2^23). The rows of the block that are not active get dx = 0 + their
// sum. Without ACTIVE (cbl_stats_bwd) a hit is (slot << 8) | local row: the
// dense wrapper takes M K < 2^23.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_sort.cuh"

// each translation unit that includes this header has its own copy of the
// kernel (internal linkage): no host stub is shared between the two sources
namespace {

constexpr int kScatterMaxRows = 256;  // rows a block (8-bit local row)
constexpr int kScatterAhead = 4;      // hits a lane loads before it adds
constexpr int kActiveAhead = 8;       // the same, ACTIVE
constexpr int kQueryChunk = 2048;     // active query rows compacted at a time
constexpr int kMaxVirtual = 1 << 22;  // slots of a compacted chunk, at most

// rows a scatter block can hold at C channels: its accumulator and its own
// rows in shared memory beside the two hit lists
constexpr int scatter_max_rows(int c) {
  return c * kScatterMaxRows <= 16384 ? kScatterMaxRows : 16384 / c;
}

// the block's accumulator and own rows, its hits in slot order and by bucket
constexpr size_t scatter_smem(int c, int rows) {
  return (size_t)(2 * rows * c + 2 * cbl_window_sort::kSuper) * 4;
}

template <int C, bool ACTIVE>
__global__ void __launch_bounds__(cbl_window_sort::kThreads)
    slot_scatter_kernel(const float* __restrict__ f,
                        const int32_t* __restrict__ lands,
                        const float* __restrict__ cd,
                        const float* __restrict__ stats,
                        const float* __restrict__ g_loss,
                        float* __restrict__ dx, int m, int k, int tile,
                        int width, int window, int rows) {
  using namespace cbl_window_sort;
  static_assert(C == 32 || C == 64 || C == 128 || C == 256 || C == 512,
                "C / 4 lanes a row group, at least two groups a block");
  constexpr int NV = C / 4;           // float4 pieces of a row
  constexpr int LPG = NV;             // lanes a row group, a float4 each
  constexpr int NB = kThreads / LPG;  // buckets = lane groups
  constexpr int AHEAD = ACTIVE ? kActiveAhead : kScatterAhead;
  extern __shared__ float4 smem[];
  float4* acc = smem;                 // rows x NV
  float4* own = smem + rows * NV;     // the block's feature rows s
  int* hits = reinterpret_cast<int*>(own + rows * NV);  // kSuper, slot order
  int* list = hits + kSuper;          // kSuper, by bucket
  __shared__ Counts counts;
  __shared__ int warp_hits[kWarps];
  __shared__ int qlist[ACTIVE ? kQueryChunk : 1];  // active query rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = tile / rows;
  const int st = blockIdx.x / splits;  // support tile
  const int row0 = st * tile + (blockIdx.x - st * splits) * rows;
  const int b = blockIdx.y;
  const int gq = m / tile;
  const auto start = [&](int t) { return min(max(t - window, 0), gq - width); };

  // ACTIVE: whether query row q of this cloud can have a landing slot; the
  // flags of the first chunk of query rows are loaded before the block's
  // rows are staged, so that both are in flight together
  const bool g_on = ACTIVE && g_loss[b] != 0.f;
  const auto active = [&](int q) {
    return g_on && stats[((size_t)b * m + q) * 8 + 6] != 0.f;
  };
  constexpr int kRounds = ACTIVE ? kQueryChunk / kThreads : 1;
  bool flag[kRounds];
  const auto load_flags = [&](int q0, int q1) {  // q0 < q1
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      const int q = q0 + t * kThreads + tid;
      flag[t] = active(min(q, q1 - 1)) && q < q1;
    }
  };
  int q_first = 0, q_end = 0, chunk = kQueryChunk;
  if constexpr (ACTIVE) {
    q_first = first_at_least(start, gq, st - width + 1) * tile;
    q_end = first_at_least(start, gq, st + 1) * tile;
    chunk = k > 0 ? min(kQueryChunk, max(1, kMaxVirtual / k)) : kQueryChunk;
    if (q_first < q_end) load_flags(q_first, min(q_first + chunk, q_end));
  }

  const float4* f4 = reinterpret_cast<const float4*>(f) + (size_t)b * m * NV;
  for (int i = tid; i < rows * NV; i += kThreads) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    own[i] = f4[(size_t)row0 * NV + i];
  }
  counts.cnt[tid] = 0;
  __syncthreads();

  const int32_t* lands_b = lands + (size_t)b * m * k;
  const float* cd_b = cd + (size_t)b * m * k;
  const int gi = tid / LPG, gl = tid % LPG;
  // n / k without a division: n < 2^23 is exact in float, the product is
  // within one of the quotient, and the compare fixes it
  const float inv_k = 1.f / (float)k;
  const auto query_of = [&](int n) {
    int q = (int)((float)n * inv_k);
    q += (n >= (q + 1) * k) - (n < q * k);
    return q;
  };
  // sort the n hits by row (stably) and add lane group gi's rows' terms
  const auto add_hits = [&](int n) {
    if (sort_chunk<NB>(0, n, [&](int i) { return hits[i]; }, list, counts) == 0)
      return;
    const int e1 = counts.off[(gi + 1) * kWarps];
    for (int e = counts.off[gi * kWarps]; e < e1; e += AHEAD) {
      float4 qv[AHEAD];
      float w[AHEAD];
      int r[AHEAD];
      if constexpr (ACTIVE) {
        // every load unconditional (past the end, the last hit again), so
        // that all of them are in flight together
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          const int en = list[min(e + u, e1 - 1)];
          r[u] = e + u < e1 ? en & 255 : -1;
          const int v = en >> 8;
          const int i = query_of(v);
          const int q = qlist[i];
          w[u] = cd_b[(size_t)q * k + (v - i * k)];
          qv[u] = f4[(size_t)q * NV + gl];
        }
      } else {
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          r[u] = -1;
          if (e + u < e1) {
            const int en = list[e + u];
            const int slot = en >> 8;
            r[u] = en & 255;
            w[u] = cd_b[slot];
            qv[u] = f4[(size_t)query_of(slot) * NV + gl];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (r[u] < 0) continue;
        const int v = r[u] * NV + gl;
        const float4 sv = own[v];
        float4 a = acc[v];
        a.x = __fadd_rn(a.x, __fmul_rn(w[u], __fsub_rn(sv.x, qv[u].x)));
        a.y = __fadd_rn(a.y, __fmul_rn(w[u], __fsub_rn(sv.y, qv[u].y)));
        a.z = __fadd_rn(a.z, __fmul_rn(w[u], __fsub_rn(sv.z, qv[u].z)));
        a.w = __fadd_rn(a.w, __fmul_rn(w[u], __fsub_rn(sv.w, qv[u].w)));
        acc[v] = a;
      }
    }
    __syncthreads();
  };

  int n_hits = 0;  // block-uniform
  const unsigned lower = (1u << lane) - 1u;
  // keep one chunk's entries (-1: none) in slot order after the hits so far
  const auto keep = [&](const int (&ent)[kSteps]) {
    unsigned bal[kSteps];
    int count = 0;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      bal[i] = __ballot_sync(kFull, ent[i] >= 0);
      count += __popc(bal[i]);
    }
    if (lane == 0) warp_hits[warp] = count;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (n_hits + total > kSuper) {  // full: add what is kept, then go on
      add_hits(n_hits);
      n_hits = 0;
    }
    int at = n_hits + before;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (ent[i] >= 0) hits[at + __popc(bal[i] & lower)] = ent[i];
      at += __popc(bal[i]);
    }
    n_hits += total;
    __syncthreads();
  };

  if constexpr (ACTIVE) {
    for (int q0 = q_first; q0 < q_end; q0 += chunk) {
      // the active rows of [q0, q1), ascending, into qlist
      const int q1 = min(q0 + chunk, q_end);
      if (q0 != q_first) load_flags(q0, q1);
      int nq = 0;
#pragma unroll
      for (int t = 0; t < kRounds; ++t) {
        if (q0 + t * kThreads >= q1) break;  // block-uniform
        const bool on = flag[t];
        const int c0 = q0 + t * kThreads;
        const unsigned bal = __ballot_sync(kFull, on);
        if (lane == 0) warp_hits[warp] = __popc(bal);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          before += w < warp ? warp_hits[w] : 0;
          total += warp_hits[w];
        }
        if (on) qlist[nq + before + __popc(bal & lower)] = c0 + tid;
        nq += total;
        __syncthreads();
      }
      // their slots v = i K + k, all loads of a chunk in flight
      const int nv = nq * k;
      for (int base = 0; base < nv; base += kSuper) {
        // every load unconditional (past the end, the last slot again)
        int ent[kSteps];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          const int v = min(base + (warp * kSteps + i) * 32 + lane, nv - 1);
          const int qi = query_of(v);
          ent[i] = lands_b[(size_t)qlist[qi] * k + (v - qi * k)];
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          const int v = base + (warp * kSteps + i) * 32 + lane;
          const int r = ent[i] - row0;
          ent[i] = v < nv && r >= 0 && r < rows ? (v << 8) | r : -1;
        }
        keep(ent);
      }
      add_hits(n_hits);  // before qlist is overwritten
      n_hits = 0;
    }
  } else {
    const int2 range = slot_range(start, gq, width, st, k * tile);
    for (int base = range.x; base < range.y; base += kSuper) {
      // the chunk's slots landing in the block's rows, all loads in flight
      int ent[kSteps];
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const int slot = base + (warp * kSteps + i) * 32 + lane;
        int e = -1;
        if (slot < range.y) {
          const int r = lands_b[slot] - row0;  // lands is -1 where cd == 0
          if (r >= 0 && r < rows) e = (slot << 8) | r;
        }
        ent[i] = e;
      }
      keep(ent);
    }
    add_hits(n_hits);
  }

  // dx = the query part (pass 1; 0 on rows that are not active) + the slot
  // sum, every element once
  float4* dx4 = reinterpret_cast<float4*>(dx) + ((size_t)b * m + row0) * NV;
  for (int i = tid; i < rows * NV; i += kThreads) {
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!ACTIVE || active(row0 + i / NV)) d = dx4[i];
    const float4 a = acc[i];
    dx4[i] = make_float4(__fadd_rn(d.x, a.x), __fadd_rn(d.y, a.y),
                         __fadd_rn(d.z, a.z), __fadd_rn(d.w, a.w));
  }
}

// Launch the scatter over B clouds of M rows: rows a block a power-of-two
// divisor of the tile, at most scatter_max_rows(C); stats and g_loss only
// with ACTIVE.
template <int C, bool ACTIVE>
int launch_slot_scatter(const float* f, const int32_t* lands, const float* cd,
                        const float* stats, const float* g_loss, float* dx,
                        int b, int m, int k, int tile, int width, int window,
                        int rows, cudaStream_t s) {
  if (rows < 1 || rows > scatter_max_rows(C) || tile % rows)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_scatter_kernel<C, ACTIVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)scatter_smem(C, scatter_max_rows(C)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((m / tile) * (tile / rows), b);
  slot_scatter_kernel<C, ACTIVE><<<grid, cbl_window_sort::kThreads,
                                   scatter_smem(C, rows), s>>>(
      f, lands, cd, stats, g_loss, dx, m, k, tile, width, window, rows);
  return (int)cudaGetLastError();
}

}  // namespace
