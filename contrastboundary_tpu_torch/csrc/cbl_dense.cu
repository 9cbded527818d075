// CBL softnn statistics of one stage over each query row's listed window
// slots, and their VJP.
//
// Replaces contrastboundary_tpu/ops/pallas/cbl_dense.py::cbl_dense_stats:
// forward _fwd_call (body _fwd_kernel) and backward _bwd_call (body
// _bwd_kernel). Contract of ops/cuda/cbl_dense.py::cbl_stats_fwd_plain and
// ::cbl_stats_bwd_plain:
//   features [B, M, C] f32 Morton-sorted rows, meta [B, M, 8] f32 (lane 0 the
//   label argmax, lane 1 the label validity), li [B, M, K] int32
//   window-relative in the self geometry: query tile t reads the W = width *
//   tile rows from tile clip(t - window, 0, M / tile - width); li = W is a
//   shadow slot. For each listed slot s of query q:
//     d2 = max((|q|^2 + |s|^2) - 2 (q . s), 0), dist = sqrt(d2 + 1e-12),
//     mv = member * valid(s), posmv = (|argmax(q) - argmax(s)| < 0.5) * mv,
//     m = max over mv > 0 of -dist (-1e9 if none),
//     e = exp((-dist - m) / T) * mv.
//   Forward: stats [B, M, 8] = (m, sum e*posmv, sum e, sum posmv, sum mv,
//   0, 0, 0). Backward, from the cotangent's lanes 1 (dpos) and 2 (dunder)
//   and the forward's m (stats lane 0, held constant):
//     cd = (dpos * posmv + dunder) * e * (-1/T) / dist, and 0 where
//     d2 <= 1e-5 (|q|^2 + |s|^2) (the cancellation floor of the expansion);
//     dx[q] += sum cd * q - sum cd * s, dx[s] += cd * (s - q).
//   Every product and sum of the distances is rounded in the plain version's
//   order (no FMA contraction), so the two agree to float noise.
//
// Design: the TPU kernel scores the whole [T, W] window with one matmul
// because its lanes want dense tiles; the function depends only on the K
// listed slots (K / W is about 5% at the flagship's level 0).
//
// Forward (cbl_stats_fwd_kernel): a block serves the rows of one query tile
// (or a power-of-two part of one; ops/cuda/cbl_dense.py::fwd_plan) and
// first stages the tile's window in shared memory once: W = width * tile
// rows of 32 floats (96 KB at the flagship's W = 768, so two blocks fit an
// SM), each with its |s|^2 summed in channel order and its two meta lanes.
// A window that does not fit (over 1,660 rows: a wider self window or a
// larger tile) is not staged: its rows are read through L2, and each slot's
// |s|^2 is summed beside its dot product in the same channel order, so every
// lane keeps the staged path's bits.
// Eight lanes serve a query row (the query's own row lies in the window);
// lane l takes a contiguous run of the row's slots and computes each slot's
// dist once, its dot product in channel order from shared memory, so d2,
// and with it the max-shift m (the exact max over the lanes, an order-free
// reduction), are the plain version's bits. Then each lane turns its dists
// into e, and the lanes add their terms in turn (lane l continues the sums
// lane l - 1 handed on by shuffle), so sum e*posmv, sum e and the two counts
// are added in slot order, as a thread walking the row's slots adds them
// (the previous design, a thread per row walking its slots twice): every
// lane of the output is that design's bits. A lane keeps up to S slots in
// registers (S = 3, 5 or 8 by K); longer rows go in chunks of 8 S slots,
// recomputing each chunk's dists after the max. li is read once, each slot
// by the lane that owns it. Bound: bytes (features, meta and li read once,
// the stats written); the operations, about (2C + 20) a valid slot with
// |s|^2 once a row, sit far below the card's FP32 rate. What holds it back
// is the issue and latency of the per-slot work (64 separately rounded
// operations a dot product, sqrtf and expf, the lanes' 8 turns at the
// ordered sums), and to a lesser part shared memory: the 8 lanes of a row
// read 8 data-dependent rows at one chunk, which the swizzle spreads over the
// bank groups only as far as those rows differ mod 8 (PERF.md: reads
// without conflicts, a pipeline of chunks over the lanes, and sums in a
// fixed tree order were each tried; scripts/diag_torch_kernels.py).
//
// Backward, two passes with no atomics (every dx element written once, the
// same bits on every run):
//   1. cbl_bwd_rows_kernel: a lane group of 8 lanes serves each query row
//      (4 rows a warp, so 8x the threads of a thread per row). First the
//      lanes split the row's slots (lane l takes slots l, l + 8, ...); each
//      lane holds the whole query row and reads a slot row as one 128 B
//      line, so its two dot products run in channel order, as the plain
//      version and the forward round them: then d2, the cancellation floor
//      and cd are the plain version's bits wherever exp rounds alike. m is
//      the forward's (stats lane 0, the same bits: the forward rounds d2 in
//      the same order), so no max pass runs. cd (0 for a non-member or
//      shadow slot and below the floor) goes to a scratch [B, M, K] tensor
//      and, with the slot's support row, to shared memory. Then the lanes
//      split the channels (float4 each) and sum cd and cd * s over the
//      row's slots in slot order, each slot row read as one coalesced
//      128 B line, and write the row-local part dq = sum(cd) q - sum(cd s)
//      to dx. A row whose cotangent lanes 1 and 2 are both 0 has cd = 0 on
//      every slot and skips its slots.
//   2. slot_scatter_kernel<32> (slot_scatter.cuh, shared with cbl_tile2.cu's
//      v2 backward): the transpose, as window_gather_bwd.cu does it
//      (window_sort.cuh). A block owns rows of one support tile and finds
//      the query tiles whose windows hold it by two binary searches over the
//      self geometry's starts clip(t - window, 0, M / tile - width). It
//      scans their slots (pass 1 wrote each slot's support row, or -1 where
//      cd == 0, so the scan reads one int a slot), compacts those landing in
//      its rows in slot order, sorts them by row stably, and lane group b
//      (8 lanes x float4) adds bucket b's terms cd * (s - q) onto its rows in
//      shared memory in ascending slot order (the order of CPU index_add_),
//      reading cd and the query row, with the block's own rows s in shared
//      memory. Then dx = dq + the sum. The [B, M, K, C] slot terms never
//      reach memory. The work follows the data: where most of a tile's rows
//      land (up to 9k terms at the flagship's level 0, against 1.5k on
//      average) its 32 lane groups add about 280 terms each, one load
//      latency for every 4, and that block takes the longest.
// Bound of the backward: bytes (features, meta, li, the m lane of the stats
// and the cotangent read once, dx written once).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_scatter.cuh"

namespace {

constexpr float kNegInf = -1e9f;  // INF of the reference's core/masking.py

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ f,
                                         long long row, float (&v)[C]) {
  const float4* p = reinterpret_cast<const float4*>(f + row * C);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 t = p[i];
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

template <int C>
__device__ __forceinline__ float sq_norm(const float (&v)[C]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) acc = __fadd_rn(acc, __fmul_rn(v[i], v[i]));
  return acc;
}

// ---- forward: a block per query tile (or part of one), its window staged in
// shared memory once ------------------------------------------------------

constexpr int kFwdLanes = 8;          // lanes a query row
constexpr int kFwdMaxThreads = 512;   // 64 rows at a time
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block can have

// Shared image of a window of W rows: the rows as float4 chunks (chunk i of
// row r at r * 8 + (i ^ (r & 7)), so that 8 lanes reading one chunk of 8
// consecutive rows hit 8 bank groups), then (argmax, validity) of each row,
// then |s|^2 of each row, summed in channel order once.
inline size_t fwd_smem(int w_sz) { return (size_t)w_sz * (128 + 8 + 4); }

__device__ __forceinline__ int chunk_at(int r, int i) { return r * 8 + (i ^ (r & 7)); }

// The window's rows as the forward reads them: staged in shared memory, or
// through L2 from the features and meta (|s|^2 then summed with each dot
// product, in the same channel order).
struct SharedWindow {
  static constexpr bool kStaged = true;
  const float4* win;
  const float2* mw;
  const float* s2w;
  __device__ float4 chunk(int r, int i) const { return win[chunk_at(r, i)]; }
  __device__ float2 meta(int r) const { return mw[r]; }
  __device__ float s2(int r) const { return s2w[r]; }
};

struct GlobalWindow {
  static constexpr bool kStaged = false;
  const float4* f4;
  const float* mt;
  long long base;  // the window's first row
  __device__ float4 chunk(int r, int i) const { return f4[(base + r) * 8 + i]; }
  __device__ float2 meta(int r) const {
    return *reinterpret_cast<const float2*>(mt + (base + r) * 8);
  }
  __device__ float s2(int r) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = chunk(r, i);
      acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
      acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
      acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
      acc = __fadd_rn(acc, __fmul_rn(v.w, v.w));
    }
    return acc;
  }
};

// One chunk of a lane's slots, S at most (slots c * 8 * spl + lane * spl + j
// for j < spl): for each valid member slot its dist (d2 rounded as the plain
// version rounds it: both dot products in channel order), its validity mv
// (0 for a slot that is no valid member) and whether its label is the
// query's; returns the largest -dist (kNegInf if none).
template <int S, class Win>
__device__ __forceinline__ float slot_chunk(
    const Win& win, const int32_t* __restrict__ lrow, int k, int w_sz, int qw,
    float q2, float qa, int first, int spl, float (&d)[S], float (&mv)[S],
    unsigned& pos) {
  int w[S];
  float s2[S];
  pos = 0u;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int kk = first + j;
    const int jj = j < spl && kk < k ? lrow[kk] : -1;
    const bool in = jj >= 0 && jj < w_sz;
    w[j] = in ? jj : qw;  // a row that is safe to read
    const float2 sm = win.meta(w[j]);
    mv[j] = in && sm.y > 0.f ? sm.y : 0.f;
    if (fabsf(__fsub_rn(qa, sm.x)) < 0.5f) pos |= 1u << j;
    d[j] = 0.f;
    s2[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 qc = win.chunk(qw, i);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float4 t = win.chunk(w[j], i);
      d[j] = __fadd_rn(d[j], __fmul_rn(qc.x, t.x));
      d[j] = __fadd_rn(d[j], __fmul_rn(qc.y, t.y));
      d[j] = __fadd_rn(d[j], __fmul_rn(qc.z, t.z));
      d[j] = __fadd_rn(d[j], __fmul_rn(qc.w, t.w));
      if constexpr (!Win::kStaged) {
        s2[j] = __fadd_rn(s2[j], __fmul_rn(t.x, t.x));
        s2[j] = __fadd_rn(s2[j], __fmul_rn(t.y, t.y));
        s2[j] = __fadd_rn(s2[j], __fmul_rn(t.z, t.z));
        s2[j] = __fadd_rn(s2[j], __fmul_rn(t.w, t.w));
      }
    }
  }
  float mloc = kNegInf;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float sc = __fadd_rn(q2, Win::kStaged ? win.s2(w[j]) : s2[j]);
    const float d2 = fmaxf(__fsub_rn(sc, __fmul_rn(2.f, d[j])), 0.f);
    d[j] = sqrtf(__fadd_rn(d2, 1e-12f));
    if (mv[j] > 0.f) mloc = fmaxf(mloc, -d[j]);
  }
  return mloc;
}

// The block's query rows, 8 lanes a row, over the window's rows.
template <int S, class Win>
__device__ __forceinline__ void fwd_rows(const Win& win,
                                         const int32_t* __restrict__ li,
                                         float* __restrict__ stats, int k,
                                         int w_sz, int row0, int start_row,
                                         long long base, int rows_pb,
                                         float inv_t) {
  const int lane = threadIdx.x % kFwdLanes;
  const unsigned gmask = 0xffu << (threadIdx.x & 31 & ~(kFwdLanes - 1));
  const int spl = min((k + kFwdLanes - 1) / kFwdLanes, S);  // slots a lane a chunk
  const int per_chunk = kFwdLanes * spl;
  const int nch = (k + per_chunk - 1) / per_chunk;
  for (int rr = threadIdx.x / kFwdLanes; rr < rows_pb;
       rr += blockDim.x / kFwdLanes) {  // uniform over a row group
    const int qw = row0 + rr - start_row;  // the query's row in the window
    const long long row = base + qw;
    const float q2 = win.s2(qw), qa = win.meta(qw).x;
    const int32_t* lrow = li + row * k;
    float d[S], mv[S];
    unsigned pos;
    // m: the exact max over the lanes (order-free, so the plain version's bits)
    float mhat = kNegInf;
    for (int c = 0; c < nch; ++c)
      mhat = fmaxf(mhat, slot_chunk<S>(win, lrow, k, w_sz, qw, q2, qa,
                                       c * per_chunk + lane * spl, spl, d, mv,
                                       pos));
#pragma unroll
    for (int o = kFwdLanes / 2; o > 0; o /= 2)
      mhat = fmaxf(mhat, __shfl_xor_sync(gmask, mhat, o, kFwdLanes));
    // the sums in slot order: the lanes take turns, each adding its own
    // slots onto the running sums of the lanes before it
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // pos, under, pcnt, vcnt
    for (int c = 0; c < nch; ++c) {
      if (nch > 1)  // one chunk keeps its dists from the max pass
        slot_chunk<S>(win, lrow, k, w_sz, qw, q2, qa,
                      c * per_chunk + lane * spl, spl, d, mv, pos);
#pragma unroll
      for (int j = 0; j < S; ++j)  // e
        d[j] = __fmul_rn(expf(__fmul_rn(__fsub_rn(-d[j], mhat), inv_t)), mv[j]);
      for (int l = 0; l < kFwdLanes; ++l) {
        if (lane == l) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            if (!(mv[j] > 0.f)) continue;  // e = posmv = mv = 0
            const float posmv = (pos >> j & 1u ? 1.f : 0.f) * mv[j];
            acc.x = __fadd_rn(acc.x, __fmul_rn(d[j], posmv));
            acc.y = __fadd_rn(acc.y, d[j]);
            acc.z = __fadd_rn(acc.z, posmv);
            acc.w = __fadd_rn(acc.w, mv[j]);
          }
        }
        acc.x = __shfl_sync(gmask, acc.x, l, kFwdLanes);
        acc.y = __shfl_sync(gmask, acc.y, l, kFwdLanes);
        acc.z = __shfl_sync(gmask, acc.z, l, kFwdLanes);
        acc.w = __shfl_sync(gmask, acc.w, l, kFwdLanes);
      }
    }
    if (lane < 2) {
      float4* out = reinterpret_cast<float4*>(stats + row * 8) + lane;
      *out = lane == 0 ? make_float4(mhat, acc.x, acc.y, acc.z)
                       : make_float4(acc.w, 0.f, 0.f, 0.f);
    }
  }
}

// STAGED: the window in shared memory (smem >= fwd_smem); else read through
// L2 (no dynamic shared memory).
template <int S, bool STAGED>
__global__ void __launch_bounds__(kFwdMaxThreads, 2)
    cbl_stats_fwd_kernel(const float* __restrict__ f,
                         const float* __restrict__ meta,
                         const int32_t* __restrict__ li,
                         float* __restrict__ stats, int m, int k, int tile,
                         int width, int window, int rows_pb, float inv_t) {
  extern __shared__ float4 fwd_shared[];
  const int w_sz = width * tile;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_pb;  // the block's first query row
  const int start = min(max(row0 / tile - window, 0), m / tile - width);
  const long long base = (long long)b * m + (long long)start * tile;
  const float4* f4 = reinterpret_cast<const float4*>(f);
  if constexpr (STAGED) {
    float4* win = fwd_shared;
    float2* mw = reinterpret_cast<float2*>(win + w_sz * 8);
    float* s2w = reinterpret_cast<float*>(mw + w_sz);
    // stage the window: each row once, its |s|^2 in channel order
    for (int r = threadIdx.x; r < w_sz; r += blockDim.x) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = f4[(base + r) * 8 + i];
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s2 = __fadd_rn(s2, __fmul_rn(v[i].x, v[i].x));
        s2 = __fadd_rn(s2, __fmul_rn(v[i].y, v[i].y));
        s2 = __fadd_rn(s2, __fmul_rn(v[i].z, v[i].z));
        s2 = __fadd_rn(s2, __fmul_rn(v[i].w, v[i].w));
        win[chunk_at(r, i)] = v[i];
      }
      s2w[r] = s2;
      mw[r] = *reinterpret_cast<const float2*>(meta + (base + r) * 8);
    }
    __syncthreads();
    fwd_rows<S>(SharedWindow{win, mw, s2w}, li, stats, k, w_sz, row0,
                start * tile, base, rows_pb, inv_t);
  } else {
    fwd_rows<S>(GlobalWindow{f4, meta, base}, li, stats, k, w_sz, row0,
                start * tile, base, rows_pb, inv_t);
  }
}

// ---- backward, pass 1: cd and dq of each query row ----------------------

constexpr int kRowLanes = 8;  // lanes a query row (8 x float4 = 32 channels)
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = kRowThreads / kRowLanes;
constexpr int kMaxK = 256;  // slots a row (pass 1's shared memory)

// dynamic shared memory of the pass-1 kernel: each row's slot coefficients
// and support rows
inline size_t rows_smem(int k) { return (size_t)kRowsPerBlock * k * 8; }

template <int C>
__global__ void __launch_bounds__(kRowThreads)
    cbl_bwd_rows_kernel(const float* __restrict__ f,
                        const float* __restrict__ meta,
                        const int32_t* __restrict__ li,
                        const float* __restrict__ stats,
                        const float* __restrict__ gstats,
                        float* __restrict__ cd, int32_t* __restrict__ lands,
                        float* __restrict__ dx, int rows, int m, int k,
                        int tile, int width, int window, float inv_t) {
  static_assert(C == 4 * kRowLanes, "one float4 of the row a lane");
  extern __shared__ float4 rows_shared[];
  const int lr = threadIdx.x / kRowLanes, gl = threadIdx.x % kRowLanes;
  const unsigned mask = 0xffu << (threadIdx.x & 31 & ~(kRowLanes - 1));
  const int row = blockIdx.x * kRowsPerBlock + lr;
  if (row >= rows) return;  // group-uniform; the groups meet by __syncwarp
  float* cd_s = reinterpret_cast<float*>(rows_shared) + lr * k;
  int* sr_s = reinterpret_cast<int*>(rows_shared) + (kRowsPerBlock + lr) * k;
  const int b = row / m;
  const int q = row - b * m;
  int start = q / tile - window;
  start = max(start, 0);
  start = min(start, m / tile - width);
  const int base = b * m + start * tile;  // the window's first support row
  const int w_sz = width * tile;
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float* cd_row = cd + (size_t)row * k;
  int32_t* lands_row = lands + (size_t)row * k;
  float4* dq = reinterpret_cast<float4*>(dx) + (size_t)row * (C / 4) + gl;
  const float dpos = gstats[(size_t)row * 8 + 1];
  const float dunder = gstats[(size_t)row * 8 + 2];
  if (dpos == 0.f && dunder == 0.f) {  // every cd is 0
    for (int kk = gl; kk < k; kk += kRowLanes) {
      cd_row[kk] = 0.f;
      lands_row[kk] = -1;
    }
    *dq = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float qv[C];
  load_row<C>(f, row, qv);
  const float q2 = sq_norm<C>(qv);
  const float qa = meta[(size_t)row * 8];
  const float mhat = stats[(size_t)row * 8];
  // A. lane gl takes slots gl, gl + 8, ...: their support rows first (the
  // li loads in flight together), then d2 in channel order and cd
  for (int kk = gl; kk < k; kk += kRowLanes) {
    const int j = li[(size_t)row * k + kk];
    sr_s[kk] = j >= 0 && j < w_sz ? base + j : -1;
  }
  for (int kk = gl; kk < k; kk += kRowLanes) {
    const int sr = sr_s[kk];
    float cdv = 0.f;
    if (sr >= 0) {
      const float mv = meta[(size_t)sr * 8 + 1];
      const float sa = meta[(size_t)sr * 8];
      float sv[C];
      load_row<C>(f, sr, sv);
      if (mv > 0.f) {
        float s2 = 0.f, qs = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s2 = __fadd_rn(s2, __fmul_rn(sv[c], sv[c]));
          qs = __fadd_rn(qs, __fmul_rn(qv[c], sv[c]));
        }
        const float sc = __fadd_rn(q2, s2);
        const float d2 = fmaxf(__fsub_rn(sc, __fmul_rn(2.f, qs)), 0.f);
        const float posmv = (fabsf(__fsub_rn(qa, sa)) < 0.5f ? 1.f : 0.f) * mv;
        const float dist = sqrtf(__fadd_rn(d2, 1e-12f));
        const float e =
            __fmul_rn(expf(__fmul_rn(__fsub_rn(-dist, mhat), inv_t)), mv);
        const float coef = __fmul_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(dpos, posmv), dunder), e), -inv_t);
        if (d2 > __fmul_rn(1e-5f, sc)) cdv = __fdiv_rn(coef, dist);
      }
    }
    cd_row[kk] = cdv;
    lands_row[kk] = cdv != 0.f ? sr - b * m : -1;
    cd_s[kk] = cdv;
  }
  __syncwarp(mask);
  // B. lane gl owns channels [4 gl, 4 gl + 4): sum cd and cd * s over the
  // row's slots in slot order, reading each slot row's 16 bytes
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float cd_sum = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < k; ++kk) {
    const float cdv = cd_s[kk];
    if (cdv == 0.f) continue;
    const float4 sv = f4[(size_t)sr_s[kk] * (C / 4) + gl];
    cd_sum = __fadd_rn(cd_sum, cdv);
    acc.x = __fadd_rn(acc.x, __fmul_rn(cdv, sv.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(cdv, sv.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(cdv, sv.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(cdv, sv.w));
  }
  const float4 q4 = f4[(size_t)row * (C / 4) + gl];
  *dq = make_float4(__fsub_rn(__fmul_rn(cd_sum, q4.x), acc.x),
                    __fsub_rn(__fmul_rn(cd_sum, q4.y), acc.y),
                    __fsub_rn(__fmul_rn(cd_sum, q4.z), acc.z),
                    __fsub_rn(__fmul_rn(cd_sum, q4.w), acc.w));
}

template <int S, bool STAGED>
int fwd_launch(const float* f, const float* meta, const int32_t* li,
               float* stats, int b, int m, int k, int tile, int width,
               int window, float inv_t, int blocks, int threads, int smem,
               cudaStream_t s) {
  static bool configured = false;
  if (STAGED && !configured) {
    cudaError_t e = cudaFuncSetAttribute(
        cbl_stats_fwd_kernel<S, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    // two windows of the flagship's width to an SM
    e = cudaFuncSetAttribute(cbl_stats_fwd_kernel<S, true>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cbl_stats_fwd_kernel<S, STAGED><<<dim3(blocks, b), threads, smem, s>>>(
      f, meta, li, stats, m, k, tile, width, window, m / blocks, inv_t);
  return (int)cudaGetLastError();
}

template <int S>
int fwd(const float* f, const float* meta, const int32_t* li, float* stats,
        int b, int m, int k, int tile, int width, int window, float inv_t,
        int blocks, int threads, int smem, cudaStream_t s) {
  return smem > 0 ? fwd_launch<S, true>(f, meta, li, stats, b, m, k, tile,
                                        width, window, inv_t, blocks, threads,
                                        smem, s)
                  : fwd_launch<S, false>(f, meta, li, stats, b, m, k, tile,
                                         width, window, inv_t, blocks, threads,
                                         0, s);
}

template <int C>
int bwd(const float* f, const float* meta, const int32_t* li,
        const float* stats, const float* gstats, float* cd, int32_t* lands,
        float* dx, int b, int m, int k, int tile, int width, int window,
        float inv_t, int rows, cudaStream_t s) {
  static bool configured = false;
  cudaError_t e;
  if (!configured) {
    e = cudaFuncSetAttribute(cbl_bwd_rows_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows_smem(kMaxK));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n = b * m;
  cbl_bwd_rows_kernel<C>
      <<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kRowThreads, rows_smem(k), s>>>(
          f, meta, li, stats, gstats, cd, lands, dx, n, m, k, tile, width,
          window, inv_t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_slot_scatter<C, false>(f, lands, cd, nullptr, nullptr, dx, b, m,
                                       k, tile, width, window, rows, s);
}

}  // namespace

// The feature width is the latent width base_fdim = 32 (the wrapper refuses
// other widths). blocks (a cloud), threads and smem come from
// ops/cuda/cbl_dense.py::fwd_plan: a block serves M / blocks query rows of
// one tile (a power-of-two divisor of it), 8 lanes a row; smem holds the
// tile's window (fwd_smem), or is 0 for a window read through L2; the
// query's own tile lies inside its window (window < width, as in the self
// geometry).
extern "C" int cbl_stats_fwd(const float* f, const float* meta,
                             const int32_t* li, float* stats, int b, int m,
                             int k, int c, int tile, int width, int window,
                             float inv_t, int blocks, int threads, int smem,
                             void* stream) {
  if (c != 32 || k < 1 || blocks < 1 || m % blocks || tile % (m / blocks) ||
      threads < 32 || threads > kFwdMaxThreads || threads % 32 ||
      window >= width ||
      (smem != 0 && (smem < (int)fwd_smem(width * tile) || smem > kSmemLimit)))
    return (int)cudaErrorInvalidValue;
  const int spl = (k + kFwdLanes - 1) / kFwdLanes;
  cudaStream_t s = (cudaStream_t)stream;
  if (spl <= 3)
    return fwd<3>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                  blocks, threads, smem, s);
  if (spl <= 5)
    return fwd<5>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                  blocks, threads, smem, s);
  return fwd<8>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                blocks, threads, smem, s);
}

// stats: the forward's output (lane 0, m, is read); cd and lands: scratch
// [B, M, K] f32 and int32 (pass 1 writes each slot's coefficient and, where
// it is not 0, the support row it lands on); dx written whole
// (uninitialised on entry); rows: the scatter's rows
// a block, a power-of-two divisor of the tile, at most 256
// (ops/cuda/cbl_dense.py::bwd_plan). The wrapper raises before M * K reaches
// 2^23 (a slot and its 8-bit row share one int) and for K > 256.
extern "C" int cbl_stats_bwd(const float* f, const float* meta,
                             const int32_t* li, const float* stats,
                             const float* gstats, float* cd,
                             int32_t* lands, float* dx, int b, int m, int k,
                             int c, int tile, int width, int window,
                             float inv_t, int rows, void* stream) {
  if (c != 32 || k > kMaxK || rows < 1 || rows > kScatterMaxRows ||
      tile % rows)
    return (int)cudaErrorInvalidValue;
  return bwd<32>(f, meta, li, stats, gstats, cd, lands, dx, b, m, k, tile,
                 width, window, inv_t, rows, (cudaStream_t)stream);
}
