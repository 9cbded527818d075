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
//
// Widths: the kernels are instantiated for rows of C = 32, 64, 128, 256 and
// 512 floats; the wrapper pads any other width up to 512 with zero channels
// (+0 in every sum: the bits of the distances stay) and cuts dx back. The
// description above is C = 32's, whose instances are unchanged. A wider
// row is read in float4 chunks in channel order everywhere: the forward's
// staged window takes 4 C + 12 bytes a row (up to 1,660 rows at C = 32,
// 112 at C = 512; wider windows go through L2), the backward's first pass
// (cbl_bwd_rows_wide_kernel) holds no row in registers and gives each lane
// the chunks gl, gl + 8, ..., and the scatter's lane groups are C / 4 lanes
// (a block holds at most 16384 floats of accumulator: 64 rows at C = 256,
// 32 at 512).
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

// acc + |t|^2 of one float4 chunk, its channels in order
__device__ __forceinline__ float add_sq(float acc, float4 t) {
  acc = __fadd_rn(acc, __fmul_rn(t.x, t.x));
  acc = __fadd_rn(acc, __fmul_rn(t.y, t.y));
  acc = __fadd_rn(acc, __fmul_rn(t.z, t.z));
  return __fadd_rn(acc, __fmul_rn(t.w, t.w));
}

// acc + q . t of one float4 chunk, its channels in order
__device__ __forceinline__ float add_dot(float acc, float4 q, float4 t) {
  acc = __fadd_rn(acc, __fmul_rn(q.x, t.x));
  acc = __fadd_rn(acc, __fmul_rn(q.y, t.y));
  acc = __fadd_rn(acc, __fmul_rn(q.z, t.z));
  return __fadd_rn(acc, __fmul_rn(q.w, t.w));
}

// ---- forward: a block per query tile (or part of one), its window staged in
// shared memory once ------------------------------------------------------

constexpr int kFwdLanes = 8;          // lanes a query row
constexpr int kFwdMaxThreads = 512;   // 64 rows at a time
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block can have

// The kernels take rows of C = 32, 64, 128, 256 or 512 floats (NV = C / 4
// float4 chunks, a multiple of 8); the wrapper pads other widths with zero
// channels, which adds +0 to every sum of the distances and leaves its bits
// as they are, and cuts the gradient back. The chunks of a row are read in
// order and each sum runs in channel order at every width.
template <int C>
struct Width {
  static_assert(C == 32 || C == 64 || C == 128 || C == 256 || C == 512,
                "rows of 32 to 512 floats, a power of two");
  static constexpr int NV = C / 4;
};

// Shared image of a window of W rows: the rows as float4 chunks (chunk i of
// row r at r * NV + (i ^ (r & 7)), so that 8 lanes reading one chunk of 8
// consecutive rows hit 8 bank groups), then (argmax, validity) of each row,
// then |s|^2 of each row, summed in channel order once.
inline size_t fwd_smem(int w_sz, int c) { return (size_t)w_sz * (4 * c + 8 + 4); }

template <int NV>
__device__ __forceinline__ int chunk_at(int r, int i) { return r * NV + (i ^ (r & 7)); }

// The window's rows as the forward reads them: staged in shared memory, or
// through L2 from the features and meta (|s|^2 then summed with each dot
// product, in the same channel order).
template <int C>
struct SharedWindow {
  static constexpr bool kStaged = true;
  static constexpr int C_ = C;
  const float4* win;
  const float2* mw;
  const float* s2w;
  __device__ float4 chunk(int r, int i) const {
    return win[chunk_at<Width<C>::NV>(r, i)];
  }
  __device__ float2 meta(int r) const { return mw[r]; }
  __device__ float s2(int r) const { return s2w[r]; }
};

template <int C>
struct GlobalWindow {
  static constexpr bool kStaged = false;
  static constexpr int C_ = C;
  const float4* f4;
  const float* mt;
  long long base;  // the window's first row
  __device__ float4 chunk(int r, int i) const {
    return f4[(base + r) * Width<C>::NV + i];
  }
  __device__ float2 meta(int r) const {
    return *reinterpret_cast<const float2*>(mt + (base + r) * 8);
  }
  __device__ float s2(int r) const {
    float acc = 0.f;
#pragma unroll 8  // whole at C = 32
    for (int i = 0; i < Width<C>::NV; ++i) acc = add_sq(acc, chunk(r, i));
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
  using W = Width<Win::C_>;
#pragma unroll 8  // whole at C = 32
  for (int i = 0; i < W::NV; ++i) {
    const float4 qc = win.chunk(qw, i);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float4 t = win.chunk(w[j], i);
      d[j] = add_dot(d[j], qc, t);
      if constexpr (!Win::kStaged) s2[j] = add_sq(s2[j], t);
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
template <int C, int S, bool STAGED>
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
  constexpr int NV = Width<C>::NV;
  if constexpr (STAGED) {
    float4* win = fwd_shared;
    float2* mw = reinterpret_cast<float2*>(win + w_sz * NV);
    float* s2w = reinterpret_cast<float*>(mw + w_sz);
    // stage the window: each row once, its |s|^2 in channel order, 8 chunks
    // of it loaded together at a time
    for (int r = threadIdx.x; r < w_sz; r += blockDim.x) {
      float s2 = 0.f;
      for (int i0 = 0; i0 < NV; i0 += 8) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = f4[(base + r) * NV + i0 + i];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s2 = add_sq(s2, v[i]);
          win[chunk_at<NV>(r, i0 + i)] = v[i];
        }
      }
      s2w[r] = s2;
      mw[r] = *reinterpret_cast<const float2*>(meta + (base + r) * 8);
    }
    __syncthreads();
    fwd_rows<S>(SharedWindow<C>{win, mw, s2w}, li, stats, k, w_sz, row0,
                start * tile, base, rows_pb, inv_t);
  } else {
    fwd_rows<S>(GlobalWindow<C>{f4, meta, base}, li, stats, k, w_sz, row0,
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

// The coefficient cd of a valid member slot (mv > 0) from |q|^2, |s|^2 and
// q . s, each summed in channel order: 0 below the cancellation floor.
__device__ __forceinline__ float slot_cd(float q2, float s2, float qs, float qa,
                                         float sa, float mv, float mhat,
                                         float dpos, float dunder, float inv_t) {
  const float sc = __fadd_rn(q2, s2);
  const float d2 = fmaxf(__fsub_rn(sc, __fmul_rn(2.f, qs)), 0.f);
  const float posmv = (fabsf(__fsub_rn(qa, sa)) < 0.5f ? 1.f : 0.f) * mv;
  const float dist = sqrtf(__fadd_rn(d2, 1e-12f));
  const float e = __fmul_rn(expf(__fmul_rn(__fsub_rn(-dist, mhat), inv_t)), mv);
  const float coef =
      __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(dpos, posmv), dunder), e), -inv_t);
  return d2 > __fmul_rn(1e-5f, sc) ? __fdiv_rn(coef, dist) : 0.f;
}

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
        cdv = slot_cd(q2, s2, qs, qa, sa, mv, mhat, dpos, dunder, inv_t);
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

// Pass 1 at C > 32: the same work and roundings, with no row held in
// registers. The lanes split the slots as above; each lane reads the query
// row and a slot row chunk by chunk (the query's chunks from L1) and sums
// |s|^2 and q . s in channel order. Then lane gl owns the float4 chunks gl,
// gl + 8, ... of the row and, one chunk at a time, sums cd * s over the
// row's slots in slot order (cd summed with the first chunk).
template <int C>
__global__ void __launch_bounds__(kRowThreads)
    cbl_bwd_rows_wide_kernel(const float* __restrict__ f,
                             const float* __restrict__ meta,
                             const int32_t* __restrict__ li,
                             const float* __restrict__ stats,
                             const float* __restrict__ gstats,
                             float* __restrict__ cd, int32_t* __restrict__ lands,
                             float* __restrict__ dx, int rows, int m, int k,
                             int tile, int width, int window, float inv_t) {
  constexpr int NV = Width<C>::NV;
  constexpr int PL = NV / kRowLanes;  // float4 chunks a lane in part B
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
  const float4* qrow = f4 + (size_t)row * NV;
  float* cd_row = cd + (size_t)row * k;
  int32_t* lands_row = lands + (size_t)row * k;
  float4* dq = reinterpret_cast<float4*>(dx) + (size_t)row * NV + gl;
  const float dpos = gstats[(size_t)row * 8 + 1];
  const float dunder = gstats[(size_t)row * 8 + 2];
  if (dpos == 0.f && dunder == 0.f) {  // every cd is 0
    for (int kk = gl; kk < k; kk += kRowLanes) {
      cd_row[kk] = 0.f;
      lands_row[kk] = -1;
    }
#pragma unroll
    for (int p = 0; p < PL; ++p) dq[p * kRowLanes] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float q2 = 0.f;
#pragma unroll 8
  for (int i = 0; i < NV; ++i) q2 = add_sq(q2, qrow[i]);
  const float qa = meta[(size_t)row * 8];
  const float mhat = stats[(size_t)row * 8];
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
      if (mv > 0.f) {
        const float4* srow = f4 + (size_t)sr * NV;
        float s2 = 0.f, qs = 0.f;
#pragma unroll 8
        for (int i = 0; i < NV; ++i) {
          const float4 sv = srow[i];
          s2 = add_sq(s2, sv);
          qs = add_dot(qs, qrow[i], sv);
        }
        cdv = slot_cd(q2, s2, qs, qa, sa, mv, mhat, dpos, dunder, inv_t);
      }
    }
    cd_row[kk] = cdv;
    lands_row[kk] = cdv != 0.f ? sr - b * m : -1;
    cd_s[kk] = cdv;
  }
  __syncwarp(mask);
  float cd_sum = 0.f;
  for (int p = 0; p < PL; ++p) {
    const int piece = gl + p * kRowLanes;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float cdv = cd_s[kk];
      if (cdv == 0.f) continue;
      const float4 sv = f4[(size_t)sr_s[kk] * NV + piece];
      if (p == 0) cd_sum = __fadd_rn(cd_sum, cdv);
      acc.x = __fadd_rn(acc.x, __fmul_rn(cdv, sv.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(cdv, sv.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(cdv, sv.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(cdv, sv.w));
    }
    const float4 q4 = qrow[piece];
    dq[p * kRowLanes] = make_float4(__fsub_rn(__fmul_rn(cd_sum, q4.x), acc.x),
                                    __fsub_rn(__fmul_rn(cd_sum, q4.y), acc.y),
                                    __fsub_rn(__fmul_rn(cd_sum, q4.z), acc.z),
                                    __fsub_rn(__fmul_rn(cd_sum, q4.w), acc.w));
  }
}

template <int C, int S, bool STAGED>
int fwd_launch(const float* f, const float* meta, const int32_t* li,
               float* stats, int b, int m, int k, int tile, int width,
               int window, float inv_t, int blocks, int threads, int smem,
               cudaStream_t s) {
  static bool configured = false;
  if (STAGED && !configured) {
    cudaError_t e = cudaFuncSetAttribute(
        cbl_stats_fwd_kernel<C, S, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    // two windows of the flagship's width to an SM
    e = cudaFuncSetAttribute(cbl_stats_fwd_kernel<C, S, true>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cbl_stats_fwd_kernel<C, S, STAGED><<<dim3(blocks, b), threads, smem, s>>>(
      f, meta, li, stats, m, k, tile, width, window, m / blocks, inv_t);
  return (int)cudaGetLastError();
}

template <int C, int S>
int fwd(const float* f, const float* meta, const int32_t* li, float* stats,
        int b, int m, int k, int tile, int width, int window, float inv_t,
        int blocks, int threads, int smem, cudaStream_t s) {
  return smem > 0 ? fwd_launch<C, S, true>(f, meta, li, stats, b, m, k, tile,
                                           width, window, inv_t, blocks,
                                           threads, smem, s)
                  : fwd_launch<C, S, false>(f, meta, li, stats, b, m, k, tile,
                                            width, window, inv_t, blocks,
                                            threads, 0, s);
}

template <int C>
int fwd_by_slots(const float* f, const float* meta, const int32_t* li,
                 float* stats, int b, int m, int k, int tile, int width,
                 int window, float inv_t, int blocks, int threads, int smem,
                 cudaStream_t s) {
  const int spl = (k + kFwdLanes - 1) / kFwdLanes;
  if (spl <= 3)
    return fwd<C, 3>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                     blocks, threads, smem, s);
  if (spl <= 5)
    return fwd<C, 5>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                     blocks, threads, smem, s);
  return fwd<C, 8>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                   blocks, threads, smem, s);
}

// pass 1 at C: a whole row in registers at C = 32, wider rows chunk by chunk
// (the wide kernel at C = 32 gives the same bits, 1.4% slower over the
// flagship's five calls on an H100: PERF.md)
template <int C>
constexpr auto rows_kernel() {
  if constexpr (C == 32)
    return cbl_bwd_rows_kernel<32>;
  else
    return cbl_bwd_rows_wide_kernel<C>;
}

template <int C>
int bwd(const float* f, const float* meta, const int32_t* li,
        const float* stats, const float* gstats, float* cd, int32_t* lands,
        float* dx, int b, int m, int k, int tile, int width, int window,
        float inv_t, int rows, cudaStream_t s) {
  constexpr auto kernel = rows_kernel<C>();
  static bool configured = false;
  cudaError_t e;
  if (!configured) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows_smem(kMaxK));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n = b * m;
  kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kRowThreads, rows_smem(k), s>>>(
      f, meta, li, stats, gstats, cd, lands, dx, n, m, k, tile, width, window,
      inv_t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_slot_scatter<C, false>(f, lands, cd, nullptr, nullptr, dx, b, m,
                                       k, tile, width, window, rows, s);
}

}  // namespace

// c: the row width, 32, 64, 128, 256 or 512 floats (the wrapper pads the
// features to it with zero channels). blocks (a cloud), threads and smem
// come from
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
  if (k < 1 || blocks < 1 || m % blocks || tile % (m / blocks) ||
      threads < 32 || threads > kFwdMaxThreads || threads % 32 ||
      window >= width ||
      (smem != 0 && (smem < (int)fwd_smem(width * tile, c) || smem > kSmemLimit)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
#define CBL_FWD_WIDTH(C)                                                     \
  case C:                                                                    \
    return fwd_by_slots<C>(f, meta, li, stats, b, m, k, tile, width, window, \
                           inv_t, blocks, threads, smem, s);
    CBL_FWD_WIDTH(32)
    CBL_FWD_WIDTH(64)
    CBL_FWD_WIDTH(128)
    CBL_FWD_WIDTH(256)
    CBL_FWD_WIDTH(512)
#undef CBL_FWD_WIDTH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// stats: the forward's output (lane 0, m, is read); cd and lands: scratch
// [B, M, K] f32 and int32 (pass 1 writes each slot's coefficient and, where
// it is not 0, the support row it lands on); dx written whole
// (uninitialised on entry); c as for the forward; rows: the scatter's rows
// a block, a power-of-two divisor of the tile, at most scatter_max_rows(c)
// (ops/cuda/cbl_dense.py::bwd_plan). The wrapper raises before M * K reaches
// 2^23 (a slot and its 8-bit row share one int) and for K > 256.
extern "C" int cbl_stats_bwd(const float* f, const float* meta,
                             const int32_t* li, const float* stats,
                             const float* gstats, float* cd,
                             int32_t* lands, float* dx, int b, int m, int k,
                             int c, int tile, int width, int window,
                             float inv_t, int rows, void* stream) {
  if (k > kMaxK || rows < 1 || rows > kScatterMaxRows || tile % rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
#define CBL_BWD_WIDTH(C)                                                     \
  case C:                                                                    \
    return bwd<C>(f, meta, li, stats, gstats, cd, lands, dx, b, m, k, tile, \
                  width, window, inv_t, rows, s);
    CBL_BWD_WIDTH(32)
    CBL_BWD_WIDTH(64)
    CBL_BWD_WIDTH(128)
    CBL_BWD_WIDTH(256)
    CBL_BWD_WIDTH(512)
#undef CBL_BWD_WIDTH
    default:
      return (int)cudaErrorInvalidValue;
  }
}
