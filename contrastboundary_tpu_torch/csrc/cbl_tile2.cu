// The flagship CBL stage loss (softnn, l2 distances, argmax-equality
// positives) per query row over its listed window slots, and its feature
// gradient, in the two forms of the TPU kernels:
//
//   v2  replaces contrastboundary_tpu/ops/pallas/cbl_tile2.py::
//       cbl_tile_softnn2: forward _stats_call (body _stats_kernel), backward
//       _bwd_call (body _grad_kernel) and the overlap-add after it. Rows are
//       features [B, M, C] with label metadata meta [B, M, 8] (lane 0 the
//       label argmax, lane 1 its validity, 0 or 1 as row_meta writes it);
//       one pass over the slots with a running max and rescaled sums
//       (_chunk_update).
//   v1  replaces contrastboundary_tpu/ops/pallas/cbl_tile.py::
//       cbl_tile_softnn: forward _fwd_call (body _fwd_kernel over
//       _tile_stats), backward _bwd_call (body _bwd_kernel). Rows are fused
//       [soft labels | features], [B, M, ncls + C]; a slot's class is the
//       first maximum of its ncls label columns and it is valid when they
//       sum above 0; two passes, the max of -d over valid slots, then the
//       sums. The label columns get no gradient.
//
// Contract of ops/cuda/cbl_tile2.py::cbl_tile2_fwd_plain / ::
// cbl_tile2_bwd_plain (and ops/cuda/cbl_tile.py for v1): li [B, M, K] int32
// is window-relative: query tile t reads the W = width * tile rows from
// tile clip(t - window, 0, M / tile - width) (v1: from starts[t], the same
// self geometry); a slot outside [0, W) (the shadow W) adds nothing. For a
// valid slot s of query q (s in the window, label valid):
//   d = sqrt(sum_c (q_c - s_c)^2 + 1e-12), pos = (|argmax q - argmax s| <
//   0.5), e = exp((-d - m) / T) with m the max of -d over valid slots.
// The forward writes stats [B, M, 8] = (m, sum e*pos, sum e, pos count,
// valid count, loss*mask, mask, 0), loss = -log(p / max(n, 1e-12) + 1e-12),
// mask = pos count > 0 and < valid count and the query's label valid; the
// caller sums lanes 5 and 6 over M. v2 computes lanes 0-2 only on the rows
// of the mask: elsewhere it writes the fill (0, 0, 0) there, and 0 in lane
// 5 (loss * 0). No output reads those lanes outside the mask (the caller
// sums lanes 5 and 6, the backward skips rows whose mask is 0), and the
// plain backward fed with the fill stays finite (dP is then -1e24, times
// mask 0). Lanes 3, 4, 6 and 7 hold on every row. The backward takes those
// stats (it does not recompute them, unlike the TPU kernels) and the
// cotangent of the loss sums g [B]; per valid slot
//   dd = (dP*pos + dN) * (-e/T) * mask * g, coef = dd / d,
//   gk = coef * (q - s),
// with dP = inv / n', dN = -inv * p / n'^2, inv = -1 / (p/n' + 1e-12),
// n' = max(n, 1e-12); dx[q] += sum gk, dx[s] -= gk.
//
// The TPU kernels stream a tile's window through VMEM and select neighbours
// by one-hot matmuls, k-chunked over a grid axis so that Mosaic compiles
// them; the function reads only the K listed rows of each query.
//
// v2 design: blocks of 256 threads, 8 lanes (a row group) a row; the
// wrapper pads the channels with zeros to C = 32, 64 or 128 (CPL = C / 32),
// which leaves every distance's bits unchanged; every load of a lane's slots
// is unconditional (a safe row stands in for one that names none), so that
// they are in flight together. Launch geometry: ops/cuda/cbl_tile2.py::
// fwd_plan and ::bwd_plan.
//   Forward, 1 (cbl_tile2_labels_kernel, every row, consecutive rows a
//   block): lane l takes slots l, l + 8, ..., reads their li, then their
//   meta, and counts the valid and the positive slots. The counts are sums
//   of 0/1, exact in any order, so a shuffle tree over the 8 lanes gives the
//   plain version's bits; with the query's validity they decide the mask.
//   Every row's stats are written here: the counts, the mask, and the fill
//   (0, 0, 0) in lanes 0-2 and 0 in lane 5; 83% of the rows at the
//   flagship's level 0 are outside the mask and done.
//   2 (cbl_tile2_masked_kernel): the rows are dealt round two blocks an SM
//   in chunks of 8 (the rows of the mask cluster in space; dealt, they load
//   every block alike); each thread tests its rows' lane 6, the block lists
//   the flagged ones and its row groups share them. Per row, lane l takes
//   slots c + l + 8 j (j < S, chunks c of 8 S slots), holds the query row
//   and reads each slot row whole (128 B at C = 32) into registers, and sums
//   its squared differences as one thread: per channel lane l' the channels
//   l', l' + 32, ... in order, then the 32 partial sums by a halving tree,
//   which is the previous design's lane sums and shuffle butterfly (and the
//   plain version's _lane_sum), so d has its bits. The running max before
//   each slot is an exact prefix max (shuffle scans over the lanes, carried
//   over the slots); from it each lane turns its slots' d into the online
//   chain's rescale exp((m_prev - m_new) / T), e and e * pos, as the
//   previous design did slot after slot, and (1, 0, 0) for a slot that adds
//   nothing. Then the 8 lanes walk the row's slots in order, each slot's
//   three terms handed round by shuffles: p = p * scale + e * pos, n = n *
//   scale + e, a few operations a slot and no load. Every lane of a masked
//   row is the previous design's bits.
//   Backward, pass 1 (cbl_tile2_rows_kernel): the rows whose mask and g are
//   not 0, dealt and shared as in the forward (the others have no term; the
//   scatter writes their dq): the slots split as in the forward, each lane
//   computes its slots' d, e, dd and coef = dd / d (the previous design's
//   roundings), writes coef to the scratch cd [B, M, K] and the cloud row
//   the slot lands on to lands [B, M, K] (-1 where coef is 0); then the
//   lanes split the channels (a float4 each, C / 32 of them) and add gk =
//   coef * (q - s) over the row's slots in slot order, each slot's coef and
//   row handed round by shuffles, and write dq = sum gk to dx.
//   Pass 2 (slot_scatter.cuh with ACTIVE, shared with cbl_dense.cu's
//   backward) adds each slot's coef * (s - q) = -gk onto its support row in
//   ascending slot order, scanning only the slots of the rows pass 1 served,
//   and writes dx = dq (0 on the other rows) + that sum. No atomics: every
//   dx element is written once, the same bits on every run, and the
//   neighbour part is the plain version's sum order (one index_add_ in slot
//   order).
// Limits: C <= 128 (the wrapper refuses wider rows, as the previous design
// did); any K below 2^23 (the scatter's quotient), longer rows in chunks;
// any tile, width and window with M % tile == 0; B * M below 2^30.
//
// Bound: bytes, counted from the loss mask of the call's data
// (chip_smoke.py::tile_costs). The function needs every row's K indices and
// label (8 bytes) to count its slots, which decide the mask; features only
// of the masked rows and of the valid rows their slots name; and its
// outputs are the two [B] sums. At the flagship's level 0 (B = 2, M =
// 65536, C = 32, K = 35) on the trained checkpoint 17% of the rows are
// masked and 29% are read: 24.2 MB, 0.0072 ms at 3.35 TB/s. The backward
// reads every row's statistics, li only of masked rows, and writes the
// whole gradient: 29.3 MB, 0.0087 ms. The operations, about 3C + 30 a valid
// slot of a masked row forward and 6C + 70 backward, are far below the FP32
// rate. The design moves more than that: the forward writes every row's
// [B, M, 8] statistics for the backward; pass 1 writes cd and lands on the
// masked rows' slots and pass 2 reads lands back. What bounds it is latency
// (phase clocks, PERF.md): a masked row's loads come in three dependent
// rounds (li, meta, slot rows), and the scatter's block of the support tile
// where the most terms land (about 6 times the mean at level 0) adds them in
// rounds of 8 a lane group; at the smaller levels, two launches in turn.
//
// v1 design (unchanged): one warp owns one query row, its lanes over the
// channels (lane l holds channels l, l + 32, ...; a 128-byte coalesced read
// of a C = 32 row), and walks the K slots twice (the max, then the sums);
// the squared distance is summed per lane, then by a butterfly of shuffles.
// The backward adds each slot's -gk onto its row and the query's own sum
// onto the query row with atomicAdd (dx zeroed by the caller), so dx's last
// bits vary from run to run. It does not overlap a warp's K serial slot
// reads (one dependent load chain a slot), nor skip the distances outside
// the loss mask: latency-bound, far above its bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_scatter.cuh"

namespace {

constexpr float kNeg = -1e9f;     // _NEG of cbl_tile2.py, INF of core/masking.py
constexpr float kEps = 1e-12f;    // EPS of core/masking.py
constexpr float kLogEps = 1e-12f;  // _LOG_EPS, inside the sqrt
constexpr unsigned kFullMask = 0xffffffffu;

// ---- v1: a warp per query row ---------------------------------------------

constexpr int kWarps = 8;  // query rows (warps) per block

struct Rows {
  const float* f;  // fused [B*M, ncls + C]
  int c;           // feature channels
  int ncls;        // label columns in front of the features
  int stride;      // floats a row: ncls + c
};

// Label argmax (as a float) and validity of row s, the same on every lane.
__device__ __forceinline__ void row_label(const Rows& x, long long s, int lane,
                                          float& amax, float& valid) {
  const bool lab = lane < x.ncls;
  float v = lab ? x.f[s * x.stride + lane] : 0.f;
  float mx = lab ? v : -INFINITY;
  int idx = lab ? lane : (1 << 30);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float omx = __shfl_xor_sync(kFullMask, mx, o);
    const int oidx = __shfl_xor_sync(kFullMask, idx, o);
    if (omx > mx || (omx == mx && oidx < idx)) {  // the first maximum
      mx = omx;
      idx = oidx;
    }
    v += __shfl_xor_sync(kFullMask, v, o);  // labels are >= 0: any order
  }
  amax = (float)idx;
  valid = v > 0.f ? 1.f : 0.f;
}

template <int CPL>
__device__ __forceinline__ void load_feat(const Rows& x, long long r, int lane,
                                          float (&v)[CPL]) {
  const float* row = x.f + r * x.stride + x.ncls;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int ci = lane + 32 * j;
    v[j] = ci < x.c ? row[ci] : 0.f;
  }
}

// d = sqrt(|q - s|^2 + 1e-12) on every lane; diff = q - s on this lane's
// channels. Per lane the squares are added in channel order, then the lanes
// by a butterfly (the plain version's _lane_sum).
template <int CPL>
__device__ __forceinline__ float slot_dist(const Rows& x, long long s, int lane,
                                           const float (&qv)[CPL],
                                           float (&diff)[CPL]) {
  const float* row = x.f + s * x.stride + x.ncls;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int ci = lane + 32 * j;
    diff[j] = ci < x.c ? __fsub_rn(qv[j], row[ci]) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(diff[j], diff[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, o));
  return sqrtf(__fadd_rn(acc, kLogEps));
}

struct Query {
  long long r;     // flat (b, q)
  long long base;  // flat row of the window's first row
  int b;
};

__device__ __forceinline__ bool query_row(Query& qr, const int32_t* starts,
                                          int b_sz, int m, int tile) {
  qr.r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qr.r >= (long long)b_sz * m) return false;
  qr.b = (int)(qr.r / m);
  const int q = (int)(qr.r - (long long)qr.b * m);
  qr.base = (long long)qr.b * m + (long long)starts[q / tile] * tile;
  return true;
}

// row of a valid slot (in the window, label valid) with its label argmax,
// or -1; the same on every lane (li is read by all of them)
__device__ __forceinline__ long long valid_slot(const Rows& x, const Query& qr,
                                                int j, int w_sz, int lane,
                                                float& amax, float& valid) {
  if (j < 0 || j >= w_sz) return -1;
  const long long s = qr.base + j;
  row_label(x, s, lane, amax, valid);
  return valid > 0.f ? s : -1;
}

// the max of -d over the valid slots first, then the sums
template <int CPL>
__global__ void cbl_tile_fwd_kernel(Rows x, const int32_t* __restrict__ li,
                                    const int32_t* __restrict__ starts,
                                    float* __restrict__ stats, int b_sz, int m,
                                    int k, int tile, int w_sz,
                                    float temperature) {
  Query qr;
  if (!query_row(qr, starts, b_sz, m, tile)) return;
  const int lane = threadIdx.x & 31;
  float qv[CPL], diff[CPL];
  load_feat<CPL>(x, qr.r, lane, qv);
  float qa, qvalid, sa, sv;
  row_label(x, qr.r, lane, qa, qvalid);
  const int32_t* lr = li + qr.r * k;

  float mr = kNeg;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = valid_slot(x, qr, lr[kk], w_sz, lane, sa, sv);
    if (s >= 0) mr = fmaxf(mr, -slot_dist<CPL>(x, s, lane, qv, diff));
  }
  float p = 0.f, n = 0.f, pc = 0.f, vc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = valid_slot(x, qr, lr[kk], w_sz, lane, sa, sv);
    if (s < 0) continue;  // an invalid slot changes nothing
    const float d = slot_dist<CPL>(x, s, lane, qv, diff);
    const float pos = fabsf(__fsub_rn(sa, qa)) < 0.5f ? sv : 0.f;
    const float e = __fmul_rn(expf((-d - mr) / temperature), sv);
    p = __fadd_rn(p, __fmul_rn(e, pos));
    n = __fadd_rn(n, e);
    pc = __fadd_rn(pc, pos);
    vc = __fadd_rn(vc, sv);
  }
  if (lane == 0) {
    const float ratio = p / fmaxf(n, kEps);
    const float loss = -logf(ratio + kEps);
    const float mask = (pc > 0.f && pc < vc && qvalid > 0.f) ? 1.f : 0.f;
    float4* out = reinterpret_cast<float4*>(stats + qr.r * 8);
    out[0] = make_float4(mr, p, n, pc);
    out[1] = make_float4(vc, loss * mask, mask, 0.f);
  }
}

template <int CPL>
__global__ void cbl_tile_bwd_kernel(Rows x, const int32_t* __restrict__ li,
                                    const int32_t* __restrict__ starts,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ g_loss,
                                    float* __restrict__ dx, int b_sz, int m,
                                    int k, int tile, int w_sz,
                                    float temperature) {
  Query qr;
  if (!query_row(qr, starts, b_sz, m, tile)) return;
  const float* st = stats + qr.r * 8;
  const float mask = st[6], gl = g_loss[qr.b];
  if (mask == 0.f || gl == 0.f) return;  // every gk of the row is 0
  const int lane = threadIdx.x & 31;
  const float mr = st[0], p = st[1];
  const float n_safe = fmaxf(st[2], kEps);
  const float inv = -1.f / (p / n_safe + kEps);  // dL/dratio
  const float dP = inv / n_safe;
  const float dN = -inv * p / (n_safe * n_safe);
  float qv[CPL], diff[CPL], dfq[CPL];
  load_feat<CPL>(x, qr.r, lane, qv);
#pragma unroll
  for (int j = 0; j < CPL; ++j) dfq[j] = 0.f;
  float qa, qvalid, sa, sv;
  row_label(x, qr.r, lane, qa, qvalid);
  const int32_t* lr = li + qr.r * k;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = valid_slot(x, qr, lr[kk], w_sz, lane, sa, sv);
    if (s < 0) continue;  // e = 0, so gk = 0
    const float d = slot_dist<CPL>(x, s, lane, qv, diff);
    const float pos = fabsf(__fsub_rn(sa, qa)) < 0.5f ? sv : 0.f;
    const float e = __fmul_rn(expf((-d - mr) / temperature), sv);
    const float dd = __fmul_rn(
        __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(dP, pos), dN), -e / temperature),
                  mask),
        gl);
    const float coef = dd / d;
    float* ds = dx + s * x.stride + x.ncls;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int ci = lane + 32 * j;
      if (ci >= x.c) continue;
      const float gk = __fmul_rn(coef, diff[j]);
      dfq[j] = __fadd_rn(dfq[j], gk);
      atomicAdd(ds + ci, -gk);
    }
  }
  float* dq = dx + qr.r * x.stride + x.ncls;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int ci = lane + 32 * j;
    if (ci < x.c) atomicAdd(dq + ci, dfq[j]);
  }
}

// channels a lane holds; 0 where the width is not taken
int lanes_per_row(int c) { return c <= 32 ? 1 : c <= 64 ? 2 : c <= 128 ? 4 : 0; }

unsigned blocks_for(int b, int m) {
  return (unsigned)(((long long)b * m + kWarps - 1) / kWarps);
}

int v1_fwd(const Rows& x, const int32_t* li, const int32_t* starts,
           float* stats, int b, int m, int k, int tile, int width,
           float temperature, cudaStream_t s) {
  const dim3 grid(blocks_for(b, m)), block(32 * kWarps);
  const int w_sz = width * tile;
  switch (lanes_per_row(x.c)) {
    case 1:
      cbl_tile_fwd_kernel<1><<<grid, block, 0, s>>>(x, li, starts, stats, b, m,
                                                    k, tile, w_sz, temperature);
      break;
    case 2:
      cbl_tile_fwd_kernel<2><<<grid, block, 0, s>>>(x, li, starts, stats, b, m,
                                                    k, tile, w_sz, temperature);
      break;
    case 4:
      cbl_tile_fwd_kernel<4><<<grid, block, 0, s>>>(x, li, starts, stats, b, m,
                                                    k, tile, w_sz, temperature);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int v1_bwd(const Rows& x, const int32_t* li, const int32_t* starts,
           const float* stats, const float* g_loss, float* dx, int b, int m,
           int k, int tile, int width, float temperature, cudaStream_t s) {
  const dim3 grid(blocks_for(b, m)), block(32 * kWarps);
  const int w_sz = width * tile;
  switch (lanes_per_row(x.c)) {
    case 1:
      cbl_tile_bwd_kernel<1><<<grid, block, 0, s>>>(
          x, li, starts, stats, g_loss, dx, b, m, k, tile, w_sz, temperature);
      break;
    case 2:
      cbl_tile_bwd_kernel<2><<<grid, block, 0, s>>>(
          x, li, starts, stats, g_loss, dx, b, m, k, tile, w_sz, temperature);
      break;
    case 4:
      cbl_tile_bwd_kernel<4><<<grid, block, 0, s>>>(
          x, li, starts, stats, g_loss, dx, b, m, k, tile, w_sz, temperature);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- v2: labels first, the masked rows' slots in flight, no atomics ---------

constexpr int kLanes = 8;                   // lanes a row (a row group)
constexpr int kThreads = 256;               // threads a block
constexpr int kGroups = kThreads / kLanes;  // row groups a block

struct V2 {
  const float* f;      // features [B * M, C], C = 32 * CPL (zero-padded)
  const float* meta;   // [B * M, 8]
  const int32_t* li;   // [B * M, K]
  int m, k, tile, width, window;
  int rows;            // B * M
};

__device__ __forceinline__ unsigned group_mask() {
  return 0xffu << (threadIdx.x & 31 & ~(kLanes - 1));
}

__device__ __forceinline__ float2 meta2(const V2& a, long long row) {
  return *reinterpret_cast<const float2*>(a.meta + row * 8);
}

// first flat row of the window of flat row r
__device__ __forceinline__ long long window_base(const V2& a, int r) {
  const int b = r / a.m;
  const int q = r - b * a.m;
  const int st = min(max(q / a.tile - a.window, 0), a.m / a.tile - a.width);
  return (long long)b * a.m + (long long)st * a.tile;
}

// The label pass of row r: its valid and positive slot counts over the 8
// lanes (lane l: slots l, l + 8, ..., 8 of them a round, their li loads
// then their meta loads in flight together). 0/1 sums: exact in any order.
__device__ __forceinline__ float2 label_counts(const V2& a, int r, float qa,
                                               int lane, unsigned gmask) {
  const long long base = window_base(a, r);
  const int w_sz = a.width * a.tile;
  const int32_t* lr = a.li + (long long)r * a.k;
  float pc = 0.f, vc = 0.f;
  // every load unconditional (past K, the last slot; a slot that names no
  // row, the query's own meta), so that all of a round are in flight
  for (int c0 = 0; c0 < a.k; c0 += 8 * kLanes) {
    int j[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int kk = c0 + t * kLanes + lane;
      j[t] = lr[min(kk, a.k - 1)];
      if (kk >= a.k || j[t] < 0 || j[t] >= w_sz) j[t] = -1;
    }
    float2 sm[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) sm[t] = meta2(a, j[t] >= 0 ? base + j[t] : r);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (j[t] < 0 || !(sm[t].y > 0.f)) continue;
      vc = __fadd_rn(vc, sm[t].y);
      if (fabsf(__fsub_rn(sm[t].x, qa)) < 0.5f) pc = __fadd_rn(pc, sm[t].y);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    pc = __fadd_rn(pc, __shfl_xor_sync(gmask, pc, o, kLanes));
    vc = __fadd_rn(vc, __shfl_xor_sync(gmask, vc, o, kLanes));
  }
  return make_float2(pc, vc);
}

template <int CPL>
__device__ __forceinline__ void load_row(const V2& a, long long r,
                                         float4 (&v)[8 * CPL]) {
  const float4* p = reinterpret_cast<const float4*>(a.f) + r * (8 * CPL);
#pragma unroll
  for (int i = 0; i < 8 * CPL; ++i) v[i] = p[i];
}

__device__ __forceinline__ float4 sq_diff(float4 q, float4 s) {
  const float x = __fsub_rn(q.x, s.x), y = __fsub_rn(q.y, s.y);
  const float z = __fsub_rn(q.z, s.z), w = __fsub_rn(q.w, s.w);
  return make_float4(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z),
                     __fmul_rn(w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// d = sqrt(|q - s|^2 + 1e-12) of one slot row, by one thread, in v1's
// (and the plain version's) order: channel lane l (0-31, component l % 4
// of piece l / 4) adds the squares of channels l, l + 32, ... in turn, then
// the 32 sums go by a halving tree (which is the shuffle butterfly's: each
// of its additions takes the same two operands).
template <int CPL>
__device__ __forceinline__ float row_dist(const float4 (&q)[8 * CPL],
                                          const float4* __restrict__ s) {
  float4 a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = sq_diff(q[i], s[i]);
#pragma unroll
  for (int j = 1; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = add4(a[i], sq_diff(q[8 * j + i], s[8 * j + i]));
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = add4(a[i], a[i + 4]);  // lanes + 16
#pragma unroll
  for (int i = 0; i < 2; ++i) a[i] = add4(a[i], a[i + 2]);  // lanes + 8
  a[0] = add4(a[0], a[1]);                                  // lanes + 4
  const float x = __fadd_rn(a[0].x, a[0].z), y = __fadd_rn(a[0].y, a[0].w);
  return sqrtf(__fadd_rn(__fadd_rn(x, y), kLogEps));
}

// One chunk of a row's slots, lane l holding slots c0 + l + 8 j (j < S):
// each slot's cloud row (-1 outside the window or past K), its validity sv
// (0 for a slot that adds nothing), whether its label is the query's, and
// its distance (of the query row itself where the slot adds nothing). Every
// load is unconditional (past K, the last slot; for a slot that names no
// row, the query's own row), so that the li loads, then the meta loads, then
// the slot rows are in flight together.
template <int CPL, int S>
__device__ __forceinline__ void slot_chunk(const V2& a, const int32_t* lr,
                                           long long base, long long cloud,
                                           int qr, int c0, int lane, float qa,
                                           const float4 (&qv)[8 * CPL],
                                           int (&sr)[S], float (&sv)[S],
                                           float (&d)[S], unsigned& pos) {
  const int w_sz = a.width * a.tile;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int kk = c0 + j * kLanes + lane;
    const int jj = lr[min(kk, a.k - 1)];
    sr[j] = kk < a.k && jj >= 0 && jj < w_sz ? (int)(base - cloud) + jj : -1;
  }
  pos = 0u;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float2 sm = meta2(a, cloud + (sr[j] >= 0 ? sr[j] : qr));
    sv[j] = sr[j] >= 0 && sm.y > 0.f ? sm.y : 0.f;
    if (fabsf(__fsub_rn(sm.x, qa)) < 0.5f) pos |= 1u << j;
  }
  const float4* f4 = reinterpret_cast<const float4*>(a.f);
#pragma unroll
  for (int j = 0; j < S; ++j)
    d[j] = row_dist<CPL>(qv, f4 + (cloud + (sv[j] > 0.f ? sr[j] : qr)) * (8 * CPL));
}

// Forward statistics of a masked row r, its row group's 8 lanes together.
template <int CPL, int S>
__device__ __forceinline__ void fwd_masked_row(const V2& a, int r, int lane,
                                               unsigned gmask, float temperature,
                                               float* __restrict__ stats) {
  float4 qv[8 * CPL];
  load_row<CPL>(a, r, qv);
  const float2 qm = meta2(a, r);
  const long long base = window_base(a, r);
  const long long cloud = (long long)(r / a.m) * a.m;
  const int32_t* lr = a.li + (long long)r * a.k;
  float carry = kNeg;  // the running max over the slots before the chunk
  float p = 0.f, n = 0.f, pc = 0.f, vc = 0.f;
  for (int c0 = 0; c0 < a.k; c0 += kLanes * S) {
    int sr[S];
    float sv[S], d[S], inc[S];
    unsigned pos;
    slot_chunk<CPL, S>(a, lr, base, cloud, (int)(r - cloud), c0, lane, qm.x, qv, sr,
                       sv, d, pos);
    // this lane's counts (0/1 sums: exact in any order), and each slot's -d
#pragma unroll
    for (int j = 0; j < S; ++j) {
      vc = __fadd_rn(vc, sv[j]);
      pc = __fadd_rn(pc, pos >> j & 1u ? sv[j] : 0.f);
      inc[j] = sv[j] > 0.f ? -d[j] : kNeg;
    }
    // the running max before each slot (slot order j, then lane): an exact
    // inclusive max over the lanes of each j, the j in turn carried
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float u = __shfl_up_sync(gmask, inc[j], o, kLanes);
        if (lane >= o) inc[j] = fmaxf(inc[j], u);
      }
    }
    // each slot's rescale and terms: (1, 0, 0) for a slot that adds nothing,
    // which leaves every sum as it is
    float scale[S], e[S], ep[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float before = __shfl_up_sync(gmask, inc[j], 1, kLanes);
      const float m_prev = lane > 0 ? fmaxf(carry, before) : carry;
      carry = fmaxf(carry, __shfl_sync(gmask, inc[j], kLanes - 1, kLanes));
      scale[j] = 1.f;
      e[j] = 0.f;
      ep[j] = 0.f;
      if (sv[j] > 0.f) {
        const float m_new = fmaxf(m_prev, -d[j]);
        scale[j] = expf((m_prev - m_new) / temperature);
        e[j] = __fmul_rn(expf((-d[j] - m_new) / temperature), sv[j]);
        ep[j] = __fmul_rn(e[j], pos >> j & 1u ? sv[j] : 0.f);
      }
    }
    // the sums in slot order, each slot's terms handed round
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const float sc = __shfl_sync(gmask, scale[j], l, kLanes);
        const float ee = __shfl_sync(gmask, e[j], l, kLanes);
        const float pe = __shfl_sync(gmask, ep[j], l, kLanes);
        p = __fadd_rn(__fmul_rn(p, sc), pe);
        n = __fadd_rn(__fmul_rn(n, sc), ee);
      }
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    pc = __fadd_rn(pc, __shfl_xor_sync(gmask, pc, o, kLanes));
    vc = __fadd_rn(vc, __shfl_xor_sync(gmask, vc, o, kLanes));
  }
  if (lane < 2) {
    const float ratio = p / fmaxf(n, kEps);
    const float loss = -logf(ratio + kEps);
    const float mask = (pc > 0.f && pc < vc && qm.y > 0.f) ? 1.f : 0.f;
    float4* out = reinterpret_cast<float4*>(stats + (long long)r * 8) + lane;
    *out = lane == 0 ? make_float4(carry, p, n, pc)
                     : make_float4(vc, loss * mask, mask, 0.f);
  }
}

// Forward, 1: every row's counts and mask; cbl_tile2_masked_kernel finishes
// the rows of the mask, which it finds by lane 6.
__global__ void __launch_bounds__(kThreads)
    cbl_tile2_labels_kernel(V2 a, float* __restrict__ stats, int rows_pb) {
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const unsigned gmask = group_mask();
  const int r0 = blockIdx.x * rows_pb;
  for (int i = grp; i < rows_pb && r0 + i < a.rows; i += kGroups) {
    const int r = r0 + i;
    const float2 qm = meta2(a, r);
    const float2 cnt = label_counts(a, r, qm.x, lane, gmask);
    const float mask = cnt.x > 0.f && cnt.x < cnt.y && qm.y > 0.f ? 1.f : 0.f;
    if (lane < 2) {
      float4* out = reinterpret_cast<float4*>(stats + (long long)r * 8) + lane;
      *out = lane == 0 ? make_float4(0.f, 0.f, 0.f, cnt.x)
                       : make_float4(cnt.y, 0.f, mask, 0.f);
    }
  }
}

constexpr int kMaxDealt = 4 * kThreads;  // rows a block of the row kernels
constexpr int kDealChunk = 8;            // consecutive rows dealt together

// Calls row(r) for the flagged rows among those dealt to the block: chunks
// of kDealChunk consecutive rows, chunk c of the block being rows (blockIdx.x
// + c gridDim.x) kDealChunk + [0, kDealChunk), rows_pb rows in all. Each
// thread tests up to 4 (their loads in flight together), the flagged ones
// are listed in shared memory (in no fixed order; a row's results do not
// depend on it) and shared by the block's row groups. The rows of the mask
// cluster in space; dealt round the blocks in small chunks, they load every
// block alike and keep some neighbours (whose windows overlap) together.
template <class Flag, class Row>
__device__ __forceinline__ void dealt_rows(int rows, int rows_pb, Flag flag,
                                           Row row) {
  __shared__ int s_list[kMaxDealt];
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  int r[kMaxDealt / kThreads];
  bool on[kMaxDealt / kThreads];
#pragma unroll
  for (int t = 0; t < kMaxDealt / kThreads; ++t) {
    const int j = t * kThreads + threadIdx.x;
    r[t] = (blockIdx.x + j / kDealChunk * gridDim.x) * kDealChunk + j % kDealChunk;
    on[t] = j < rows_pb && r[t] < rows;
    on[t] = flag(on[t] ? r[t] : 0) && on[t];
  }
#pragma unroll
  for (int t = 0; t < kMaxDealt / kThreads; ++t)
    if (on[t]) s_list[atomicAdd(&s_n, 1)] = r[t];
  __syncthreads();
  for (int i = threadIdx.x / kLanes; i < s_n; i += kGroups) row(s_list[i]);
}

// Forward, 2: the rows of the mask (lane 6 of the label pass), rows_pb
// dealt to a block.
template <int CPL, int S>
__global__ void __launch_bounds__(kThreads, CPL == 1 ? 2 : 1)
    cbl_tile2_masked_kernel(V2 a, float* __restrict__ stats, float temperature,
                            int rows_pb) {
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = group_mask();
  dealt_rows(
      a.rows, rows_pb,
      [&](int r) { return stats[(long long)r * 8 + 6] != 0.f; },
      [&](int r) { fwd_masked_row<CPL, S>(a, r, lane, gmask, temperature, stats); });
}

// Pass 1 of the backward for a row r whose mask and g are not 0.
template <int CPL, int S>
__device__ __forceinline__ void bwd_row(const V2& a, int r, int lane,
                                        unsigned gmask, float temperature,
                                        const float* __restrict__ stats, float gl,
                                        float* __restrict__ cd,
                                        int32_t* __restrict__ lands,
                                        float* __restrict__ dx) {
  constexpr int NV = 8 * CPL;  // float4 pieces a row; lane l: l + 8 i
  constexpr int AHEAD = 8 / CPL;  // slot rows a lane loads before it adds
  float4 qv[8 * CPL];
  load_row<CPL>(a, r, qv);
  const float qa = a.meta[(long long)r * 8];
  const long long base = window_base(a, r);
  const long long cloud = (long long)(r / a.m) * a.m;
  const int32_t* lr = a.li + (long long)r * a.k;
  const float* st = stats + (long long)r * 8;
  const float mr = st[0], p = st[1], mask = st[6];
  const float n_safe = fmaxf(st[2], kEps);
  const float inv = -1.f / (p / n_safe + kEps);  // dL/dratio
  const float dP = inv / n_safe;
  const float dN = -inv * p / (n_safe * n_safe);
  const float4* f4 = reinterpret_cast<const float4*>(a.f);
  float4 q4[CPL], acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    q4[i] = f4[(long long)r * NV + lane + 8 * i];
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c0 = 0; c0 < a.k; c0 += kLanes * S) {
    int sr[S];
    float sv[S], d[S], coef[S];
    unsigned pos;
    slot_chunk<CPL, S>(a, lr, base, cloud, (int)(r - cloud), c0, lane, qa, qv, sr, sv,
                       d, pos);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      coef[j] = 0.f;
      if (sv[j] > 0.f) {
        const float ps = pos >> j & 1u ? sv[j] : 0.f;
        const float e = __fmul_rn(expf((-d[j] - mr) / temperature), sv[j]);
        const float dd = __fmul_rn(
            __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(dP, ps), dN), -e / temperature),
                      mask),
            gl);
        coef[j] = dd / d[j];
      }
      const int kk = c0 + j * kLanes + lane;
      if (kk < a.k) {
        cd[(long long)r * a.k + kk] = coef[j];
        lands[(long long)r * a.k + kk] = coef[j] != 0.f ? sr[j] : -1;
      }
    }
    // dq: the lanes over the channels, the slots in order
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int l0 = 0; l0 < kLanes; l0 += AHEAD) {
        float w[AHEAD];
        float4 s4[AHEAD][CPL];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          w[u] = __shfl_sync(gmask, coef[j], l0 + u, kLanes);
          const int row = __shfl_sync(gmask, sr[j], l0 + u, kLanes);
          const long long s_row = cloud + (w[u] != 0.f ? row : (int)(r - cloud));
#pragma unroll
          for (int i = 0; i < CPL; ++i) s4[u][i] = f4[s_row * NV + lane + 8 * i];
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          if (w[u] == 0.f) continue;  // a zero term changes no sum
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            acc[i].x = __fadd_rn(acc[i].x, __fmul_rn(w[u], __fsub_rn(q4[i].x, s4[u][i].x)));
            acc[i].y = __fadd_rn(acc[i].y, __fmul_rn(w[u], __fsub_rn(q4[i].y, s4[u][i].y)));
            acc[i].z = __fadd_rn(acc[i].z, __fmul_rn(w[u], __fsub_rn(q4[i].z, s4[u][i].z)));
            acc[i].w = __fadd_rn(acc[i].w, __fmul_rn(w[u], __fsub_rn(q4[i].w, s4[u][i].w)));
          }
        }
      }
    }
  }
  float4* dq = reinterpret_cast<float4*>(dx) + (long long)r * NV + lane;
#pragma unroll
  for (int i = 0; i < CPL; ++i) dq[8 * i] = acc[i];
}

// Backward, pass 1: the rows whose mask and g are not 0 (every coefficient
// of the others is 0: they have no term, and the scatter writes their dq),
// rows_pb dealt to a block.
template <int CPL, int S>
__global__ void __launch_bounds__(kThreads, CPL == 1 ? 2 : 1)
    cbl_tile2_rows_kernel(V2 a, const float* __restrict__ stats,
                          const float* __restrict__ g_loss,
                          float* __restrict__ cd, int32_t* __restrict__ lands,
                          float* __restrict__ dx, float temperature, int rows_pb) {
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = group_mask();
  dealt_rows(
      a.rows, rows_pb,
      [&](int r) {
        return stats[(long long)r * 8 + 6] != 0.f && g_loss[r / a.m] != 0.f;
      },
      [&](int r) {
        bwd_row<CPL, S>(a, r, lane, gmask, temperature, stats, g_loss[r / a.m], cd,
                        lands, dx);
      });
}

template <int CPL, int S>
int v2_fwd_launch(const V2& a, float* stats, float temperature, int row_rows,
                  cudaStream_t s) {
  cbl_tile2_masked_kernel<CPL, S><<<(a.rows + row_rows - 1) / row_rows, kThreads, 0, s>>>(
      a, stats, temperature, row_rows);
  return (int)cudaGetLastError();
}

template <int CPL, int S>
int v2_bwd_launch(const V2& a, const float* stats, const float* g_loss,
                  float* cd, int32_t* lands, float* dx, float temperature,
                  int row_rows, int scatter_rows, cudaStream_t s) {
  cbl_tile2_rows_kernel<CPL, S><<<(a.rows + row_rows - 1) / row_rows, kThreads, 0, s>>>(
      a, stats, g_loss, cd, lands, dx, temperature, row_rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_slot_scatter<32 * CPL, true>(a.f, lands, cd, stats, g_loss, dx,
                                             a.rows / a.m, a.m, a.k, a.tile,
                                             a.width, a.window, scatter_rows, s);
}

// slots a lane holds a chunk: 3, 5 or 8 at C = 32 by K (the flagship's 23
// and 35 in one chunk), 4 at the wider rows
template <int CPL, class Launch>
int by_slots(int k, const Launch& launch) {
  const int spl = (k + kLanes - 1) / kLanes;
  if constexpr (CPL > 1) {
    return launch.template run<CPL, 4>();
  } else {
    if (spl <= 3) return launch.template run<1, 3>();
    if (spl <= 5) return launch.template run<1, 5>();
    return launch.template run<1, 8>();
  }
}

template <class Launch>
int by_width(int c, int k, const Launch& launch) {
  switch (c) {
    case 32:
      return by_slots<1>(k, launch);
    case 64:
      return by_slots<2>(k, launch);
    case 128:
      return by_slots<4>(k, launch);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

struct FwdLaunch {
  const V2& a;
  float* stats;
  float temperature;
  int row_rows;
  cudaStream_t s;
  template <int CPL, int S>
  int run() const {
    return v2_fwd_launch<CPL, S>(a, stats, temperature, row_rows, s);
  }
};

struct BwdLaunch {
  const V2& a;
  const float* stats;
  const float* g_loss;
  float* cd;
  int32_t* lands;
  float* dx;
  float temperature;
  int row_rows;
  int scatter_rows;
  cudaStream_t s;
  template <int CPL, int S>
  int run() const {
    return v2_bwd_launch<CPL, S>(a, stats, g_loss, cd, lands, dx, temperature,
                                 row_rows, scatter_rows, s);
  }
};

bool v2_args_ok(int b, int m, int k, int c, int tile, int width, int label_rows,
                int row_rows) {
  return b >= 1 && m > 0 && k >= 0 && k < (1 << 23) &&
         (c == 32 || c == 64 || c == 128) && tile > 0 && m % tile == 0 &&
         width >= 1 && width <= m / tile && (long long)b * m < (1LL << 30) &&
         label_rows >= 1 && row_rows >= kDealChunk && row_rows <= kMaxDealt &&
         row_rows % kDealChunk == 0;
}

}  // namespace

// v2 forward: features padded to C = 32, 64 or 128 channels (zeros beyond
// the caller's width); label_rows: flat rows a block of the label pass;
// row_rows: rows dealt to a block of the kernel over the rows of the mask, a
// multiple of 8, at most 1024 (ops/cuda/cbl_tile2.py::fwd_plan).
extern "C" int cbl_tile2_fwd(const float* f, const float* meta,
                             const int32_t* li, float* stats, int b, int m,
                             int k, int c, int tile, int width, int window,
                             float temperature, int label_rows, int row_rows,
                             void* stream) {
  if (!v2_args_ok(b, m, k, c, tile, width, label_rows, row_rows))
    return (int)cudaErrorInvalidValue;
  const V2 a{f, meta, li, m, k, tile, width, window, b * m};
  cudaStream_t s = (cudaStream_t)stream;
  cbl_tile2_labels_kernel<<<(a.rows + label_rows - 1) / label_rows, kThreads, 0, s>>>(
      a, stats, label_rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return by_width(c, k, FwdLaunch{a, stats, temperature, row_rows, s});
}

// v2 backward: stats the forward's; cd [B, M, K] f32 and lands [B, M, K]
// int32 scratch (pass 1 writes both on the slots of the rows whose mask and
// g are not 0, and nowhere else); dx [B, M, C] written whole (uninitialised
// on entry); row_rows as for the forward; scatter_rows: the scatter's rows
// a block, a power-of-two divisor of the tile, at most scatter_max_rows(C)
// (ops/cuda/cbl_tile2.py::bwd_plan).
extern "C" int cbl_tile2_bwd(const float* f, const float* meta,
                             const int32_t* li, const float* stats,
                             const float* g_loss, float* cd, int32_t* lands,
                             float* dx, int b, int m, int k, int c, int tile,
                             int width, int window, float temperature,
                             int row_rows, int scatter_rows, void* stream) {
  if (!v2_args_ok(b, m, k, c, tile, width, 1, row_rows))
    return (int)cudaErrorInvalidValue;
  const V2 a{f, meta, li, m, k, tile, width, window, b * m};
  return by_width(c, k, BwdLaunch{a, stats, g_loss, cd, lands, dx, temperature,
                                  row_rows, scatter_rows, (cudaStream_t)stream});
}

// v1: C up to 128, ncls <= 32; starts [M / tile] the window start tiles
extern "C" int cbl_tile_fwd(const float* fused, const int32_t* li,
                            const int32_t* starts, float* stats, int b, int m,
                            int k, int c, int ncls, int tile, int width,
                            float temperature, void* stream) {
  if (ncls < 1 || ncls > 32) return (int)cudaErrorInvalidValue;
  return v1_fwd(Rows{fused, c, ncls, ncls + c}, li, starts, stats, b, m, k,
                tile, width, temperature, (cudaStream_t)stream);
}

extern "C" int cbl_tile_bwd(const float* fused, const int32_t* li,
                            const int32_t* starts, const float* stats,
                            const float* g_loss, float* dx, int b, int m,
                            int k, int c, int ncls, int tile, int width,
                            float temperature, void* stream) {
  if (ncls < 1 || ncls > 32) return (int)cudaErrorInvalidValue;
  return v1_bwd(Rows{fused, c, ncls, ncls + c}, li, starts, stats, g_loss, dx,
                b, m, k, tile, width, temperature, (cudaStream_t)stream);
}
