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
// Forward: one thread owns one query row, keeps it in registers, and walks
// its K slots twice: once for the max-shift m, once for the sums, reading
// each slot's 4C bytes as float4. Bound: bytes (features, meta and li read
// once, the stats written: B*M*(4C + 32 + 4K + 32) bytes); its operations,
// about (4C + 10) a slot, sit far below the card's FP32 rate. It reads each
// slot row again from L2 rather than sharing a tile's window in shared
// memory.
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
//   2. cbl_bwd_scatter_kernel: the transpose, as window_gather_bwd.cu does
//      it (window_sort.cuh). A block owns rows of one support tile and finds
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

#include "window_sort.cuh"

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

// (d2, |q|^2 + |s|^2) of query row qv against support row srow
template <int C>
__device__ __forceinline__ float2 slot_d2(const float (&qv)[C], float q2,
                                          const float* __restrict__ f,
                                          long long srow) {
  const float4* p = reinterpret_cast<const float4*>(f + srow * C);
  float s2 = 0.f, qs = 0.f;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 t = p[i];
    s2 = __fadd_rn(s2, __fmul_rn(t.x, t.x));
    s2 = __fadd_rn(s2, __fmul_rn(t.y, t.y));
    s2 = __fadd_rn(s2, __fmul_rn(t.z, t.z));
    s2 = __fadd_rn(s2, __fmul_rn(t.w, t.w));
    qs = __fadd_rn(qs, __fmul_rn(qv[4 * i], t.x));
    qs = __fadd_rn(qs, __fmul_rn(qv[4 * i + 1], t.y));
    qs = __fadd_rn(qs, __fmul_rn(qv[4 * i + 2], t.z));
    qs = __fadd_rn(qs, __fmul_rn(qv[4 * i + 3], t.w));
  }
  const float sc = __fadd_rn(q2, s2);
  return make_float2(fmaxf(__fsub_rn(sc, __fmul_rn(2.f, qs)), 0.f), sc);
}

struct Row {
  long long r;     // flat (b, q)
  long long base;  // flat row of the window's first support row
  int w_sz;
};

__device__ __forceinline__ bool make_row(Row& row, int b_sz, int m, int tile,
                                         int width, int window) {
  row.r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row.r >= (long long)b_sz * m) return false;
  const int b = (int)(row.r / m);
  const int q = (int)(row.r - (long long)b * m);
  int start = q / tile - window;
  start = max(start, 0);
  start = min(start, m / tile - width);
  row.base = (long long)b * m + (long long)start * tile;
  row.w_sz = width * tile;
  return true;
}

// support row of slot j, or -1 for a slot that is no valid member
__device__ __forceinline__ long long member_row(const Row& row, int j,
                                                const float* __restrict__ meta) {
  if (j < 0 || j >= row.w_sz) return -1;
  const long long s = row.base + j;
  return meta[s * 8 + 1] > 0.f ? s : -1;
}

template <int C>
__device__ __forceinline__ float max_shift(const Row& row, const float (&qv)[C],
                                           float q2, const float* f,
                                           const float* meta,
                                           const int32_t* li, int k) {
  float mhat = kNegInf;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = member_row(row, li[row.r * k + kk], meta);
    if (s < 0) continue;
    const float d2 = slot_d2<C>(qv, q2, f, s).x;
    mhat = fmaxf(mhat, -sqrtf(__fadd_rn(d2, 1e-12f)));
  }
  return mhat;
}

template <int C>
__global__ void cbl_stats_fwd_kernel(const float* __restrict__ f,
                                     const float* __restrict__ meta,
                                     const int32_t* __restrict__ li,
                                     float* __restrict__ stats, int b_sz,
                                     int m, int k, int tile, int width,
                                     int window, float inv_t) {
  Row row;
  if (!make_row(row, b_sz, m, tile, width, window)) return;
  float qv[C];
  load_row<C>(f, row.r, qv);
  const float q2 = sq_norm<C>(qv);
  const float qa = meta[row.r * 8];
  const float mhat = max_shift<C>(row, qv, q2, f, meta, li, k);
  float pos = 0.f, under = 0.f, pcnt = 0.f, vcnt = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = member_row(row, li[row.r * k + kk], meta);
    if (s < 0) continue;  // e = posmv = mv = 0
    const float mv = meta[s * 8 + 1];
    const float posmv =
        (fabsf(__fsub_rn(qa, meta[s * 8])) < 0.5f ? 1.f : 0.f) * mv;
    const float d2 = slot_d2<C>(qv, q2, f, s).x;
    const float dist = sqrtf(__fadd_rn(d2, 1e-12f));
    const float e = __fmul_rn(expf(__fmul_rn(__fsub_rn(-dist, mhat), inv_t)), mv);
    pos = __fadd_rn(pos, __fmul_rn(e, posmv));
    under = __fadd_rn(under, e);
    pcnt = __fadd_rn(pcnt, posmv);
    vcnt = __fadd_rn(vcnt, mv);
  }
  float4* out = reinterpret_cast<float4*>(stats + row.r * 8);
  out[0] = make_float4(mhat, pos, under, pcnt);
  out[1] = make_float4(vcnt, 0.f, 0.f, 0.f);
}

// ---- backward, pass 1: cd and dq of each query row ----------------------

constexpr int kRowLanes = 8;  // lanes a query row (8 x float4 = 32 channels)
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = kRowThreads / kRowLanes;

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

// ---- backward, pass 2: the ordered scatter of cd * (s - q) --------------

constexpr int kScatterMaxRows = 256;  // rows a block (8-bit local row)
constexpr int kMaxK = 256;            // slots a row (pass 1's shared memory)
constexpr int kScatterAhead = 4;      // hits a lane loads before it adds
// the block's accumulator and own rows, its hits in slot order and by bucket
constexpr int kScatterSmem =
    (2 * kScatterMaxRows * 32 + 2 * cbl_window_sort::kSuper) * 4;

// Each block first compacts the slots that land in its rows (cd != 0) out
// of its whole slot range, in slot order, into `hits` (up to kSuper of them:
// at the flagship's level 0 a block keeps about 1 in 17 of the 27k slots
// it scans), then sorts them by row once and adds them, instead of sorting
// and adding every 4096-slot chunk of the range.
template <int C>
__global__ void __launch_bounds__(cbl_window_sort::kThreads)
    cbl_bwd_scatter_kernel(const float* __restrict__ f,
                           const int32_t* __restrict__ lands,
                           const float* __restrict__ cd,
                           float* __restrict__ dx, int m, int k, int tile,
                           int width, int window, int rows) {
  using namespace cbl_window_sort;
  constexpr int NV = C / 4;           // float4 pieces of a row
  constexpr int LPG = NV;             // lanes a row group, a float4 each
  constexpr int NB = kThreads / LPG;  // buckets = lane groups
  constexpr int AHEAD = kScatterAhead;
  extern __shared__ float4 smem[];
  float4* acc = smem;                 // rows x NV
  float4* own = smem + rows * NV;     // the block's feature rows s
  int* hits = reinterpret_cast<int*>(own + rows * NV);  // kSuper, slot order
  int* list = hits + kSuper;          // kSuper, by bucket
  __shared__ Counts counts;
  __shared__ int warp_hits[kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = tile / rows;
  const int st = blockIdx.x / splits;  // support tile
  const int row0 = st * tile + (blockIdx.x - st * splits) * rows;
  const int b = blockIdx.y;
  const int gq = m / tile;
  const int kt = k * tile;
  const auto start = [&](int t) { return min(max(t - window, 0), gq - width); };
  const int2 range = slot_range(start, gq, width, st, kt);

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
  // slot / k without a division: slot < 2^23 is exact in float, the
  // product is within one of the quotient, and the compare fixes it
  const float inv_k = 1.f / (float)k;
  const auto query_of = [&](int slot) {
    int q = (int)((float)slot * inv_k);
    q += (slot >= (q + 1) * k) - (slot < q * k);
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
  }
  add_hits(n_hits);

  // dx = dq (pass 1) + the slot sum, every element once
  float4* dx4 = reinterpret_cast<float4*>(dx) + ((size_t)b * m + row0) * NV;
  for (int i = tid; i < rows * NV; i += kThreads) {
    const float4 d = dx4[i], a = acc[i];
    dx4[i] = make_float4(__fadd_rn(d.x, a.x), __fadd_rn(d.y, a.y),
                         __fadd_rn(d.z, a.z), __fadd_rn(d.w, a.w));
  }
}

constexpr int kThreads = 128;

template <int C>
int fwd(const float* f, const float* meta, const int32_t* li, float* stats,
        int b, int m, int k, int tile, int width, int window, float inv_t,
        cudaStream_t s) {
  const long long rows = (long long)b * m;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  cbl_stats_fwd_kernel<C><<<blocks, kThreads, 0, s>>>(
      f, meta, li, stats, b, m, k, tile, width, window, inv_t);
  return (int)cudaGetLastError();
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
    e = cudaFuncSetAttribute(cbl_bwd_scatter_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScatterSmem);
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
  const dim3 grid((m / tile) * (tile / rows), b);
  const size_t smem =
      (size_t)(2 * rows * C + 2 * cbl_window_sort::kSuper) * 4;
  cbl_bwd_scatter_kernel<C><<<grid, cbl_window_sort::kThreads, smem, s>>>(
      f, lands, cd, dx, m, k, tile, width, window, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// the feature width is the latent width base_fdim = 32 (a compile-time
// constant, so a row lives in registers); the wrapper refuses other widths
extern "C" int cbl_stats_fwd(const float* f, const float* meta,
                             const int32_t* li, float* stats, int b, int m,
                             int k, int c, int tile, int width, int window,
                             float inv_t, void* stream) {
  if (c != 32) return (int)cudaErrorInvalidValue;
  return fwd<32>(f, meta, li, stats, b, m, k, tile, width, window, inv_t,
                 (cudaStream_t)stream);
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
