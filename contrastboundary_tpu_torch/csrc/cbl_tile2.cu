// The flagship CBL stage loss (softnn, l2 distances, argmax-equality
// positives) per query row over its listed window slots, and its feature
// gradient, in the two forms of the TPU kernels:
//
//   v2  replaces contrastboundary_tpu/ops/pallas/cbl_tile2.py::
//       cbl_tile_softnn2: forward _stats_call (body _stats_kernel), backward
//       _bwd_call (body _grad_kernel) and the overlap-add after it. Rows are
//       features [B, M, C] with label metadata meta [B, M, 8] (lane 0 the
//       label argmax, lane 1 its validity); one pass over the slots with a
//       running max and rescaled sums (_chunk_update).
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
// tile starts[t]; a slot outside [0, W) (the shadow W) adds nothing. For a
// valid slot s of query q (s in the window, label valid):
//   d = sqrt(sum_c (q_c - s_c)^2 + 1e-12), pos = (|argmax q - argmax s| <
//   0.5), e = exp((-d - m) / T) with m the max of -d over valid slots.
// The forward writes stats [B, M, 8] = (m, sum e*pos, sum e, pos count,
// valid count, loss*mask, mask, 0), loss = -log(p / max(n, 1e-12) + 1e-12),
// mask = pos count > 0 and < valid count and the query's label valid; the
// caller sums lanes 5 and 6 over M. The backward takes those stats (it does
// not recompute them, unlike the TPU kernels) and the cotangent of the
// loss sums g [B]; per valid slot
//   dd = (dP*pos + dN) * (-e/T) * mask * g, gk = dd / d * (q - s),
// with dP = inv / n', dN = -inv * p / n'^2, inv = -1 / (p/n' + 1e-12),
// n' = max(n, 1e-12); dx[q] += sum gk, dx[s] -= gk. dx is zeroed by the
// caller.
//
// Design: the TPU kernels stream a tile's window through VMEM and select
// neighbours by one-hot matmuls, k-chunked over a grid axis so that Mosaic
// compiles them; the function reads only the K listed rows of each query.
// Here one warp owns one query row, its lanes over the channels (lane l holds
// channels l, l + 32, ...; a 128-byte coalesced read of a C = 32 row), and
// walks the K slots; the squared distance is summed per lane, then by a
// butterfly of shuffles, each product and sum rounded separately in the
// plain version's order. The backward adds each slot's -gk onto its row and
// the query's own sum onto the query row with atomicAdd (the overlap-add of
// the TPU kernel), so dx's last bits vary from run to run.
//
// Bound: bytes, counted from the loss mask of the call's data. The
// function needs every row's K indices and label (8 bytes) to count its
// slots, which decide the mask; features only of the masked rows and of the
// valid rows their slots name; and its outputs are the two [B] sums. At the
// flagship's level 0 (B = 2, M = 65536, C = 32, K = 35) on the trained
// checkpoint 17% of the rows are masked and 29% are read: 24.2 MB, 0.0072
// ms at 3.35 TB/s. The backward reads every row's statistics, li only of
// masked rows, and writes the whole gradient: 29.3 MB, 0.0087 ms. The
// operations, about 3C + 30 a valid slot of a masked row forward and 6C +
// 70 backward, are far below the FP32 rate. The design reads each listed
// row once a pass in whole 128-byte lines and keeps the query row and the
// sums in registers; the forward also reads every row's features and
// writes its [B, M, 8] statistics for the backward (43.5 MB at level 0).
// What it does not do is overlap a warp's K serial slot reads (one
// dependent load chain a slot), share a window's rows between the warps of
// a block, or skip the forward's distances outside the loss mask, so it is
// latency-bound, far above that bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;     // _NEG of cbl_tile2.py, INF of core/masking.py
constexpr float kEps = 1e-12f;    // EPS of core/masking.py
constexpr float kLogEps = 1e-12f;  // _LOG_EPS, inside the sqrt
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // query rows (warps) per block

struct Rows {
  const float* f;     // v2: features [B*M, C]; v1: fused [B*M, ncls + C]
  const float* meta;  // v2: [B*M, 8]; v1: null
  int c;              // feature channels
  int ncls;           // v1: label columns in front of the features; v2: 0
  int stride;         // floats a row: ncls + c
};

// Label argmax (as a float) and validity of row s, the same on every lane.
__device__ __forceinline__ void row_label(const Rows& x, long long s, int lane,
                                          float& amax, float& valid) {
  if (x.meta != nullptr) {
    amax = x.meta[s * 8];
    valid = x.meta[s * 8 + 1];
    return;
  }
  const bool lab = lane < x.ncls;
  float v = lab ? x.f[s * x.stride + lane] : 0.f;
  float mx = lab ? v : -INFINITY;
  int idx = lab ? lane : (1 << 30);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float omx = __shfl_xor_sync(kFull, mx, o);
    const int oidx = __shfl_xor_sync(kFull, idx, o);
    if (omx > mx || (omx == mx && oidx < idx)) {  // the first maximum
      mx = omx;
      idx = oidx;
    }
    v += __shfl_xor_sync(kFull, v, o);  // labels are >= 0: any order
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
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
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

// ONLINE (v2): running max with rescaled sums; else (v1) the max first.
template <int CPL, bool ONLINE>
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
  if (!ONLINE) {
    for (int kk = 0; kk < k; ++kk) {
      const long long s = valid_slot(x, qr, lr[kk], w_sz, lane, sa, sv);
      if (s >= 0) mr = fmaxf(mr, -slot_dist<CPL>(x, s, lane, qv, diff));
    }
  }
  float p = 0.f, n = 0.f, pc = 0.f, vc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = valid_slot(x, qr, lr[kk], w_sz, lane, sa, sv);
    if (s < 0) continue;  // an invalid slot changes nothing
    const float d = slot_dist<CPL>(x, s, lane, qv, diff);
    const float pos = fabsf(__fsub_rn(sa, qa)) < 0.5f ? sv : 0.f;
    float e;
    if (ONLINE) {
      const float m_new = fmaxf(mr, -d);
      const float scale = expf((mr - m_new) / temperature);
      e = __fmul_rn(expf((-d - m_new) / temperature), sv);
      p = __fadd_rn(__fmul_rn(p, scale), __fmul_rn(e, pos));
      n = __fadd_rn(__fmul_rn(n, scale), e);
      mr = m_new;
    } else {
      e = __fmul_rn(expf((-d - mr) / temperature), sv);
      p = __fadd_rn(p, __fmul_rn(e, pos));
      n = __fadd_rn(n, e);
    }
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

template <bool ONLINE>
int fwd(const Rows& x, const int32_t* li, const int32_t* starts, float* stats,
        int b, int m, int k, int tile, int width, float temperature,
        cudaStream_t s) {
  const dim3 grid(blocks_for(b, m)), block(32 * kWarps);
  const int w_sz = width * tile;
  switch (lanes_per_row(x.c)) {
    case 1:
      cbl_tile_fwd_kernel<1, ONLINE><<<grid, block, 0, s>>>(
          x, li, starts, stats, b, m, k, tile, w_sz, temperature);
      break;
    case 2:
      cbl_tile_fwd_kernel<2, ONLINE><<<grid, block, 0, s>>>(
          x, li, starts, stats, b, m, k, tile, w_sz, temperature);
      break;
    case 4:
      cbl_tile_fwd_kernel<4, ONLINE><<<grid, block, 0, s>>>(
          x, li, starts, stats, b, m, k, tile, w_sz, temperature);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bwd(const Rows& x, const int32_t* li, const int32_t* starts,
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

Rows v2_rows(const float* f, const float* meta, int c) {
  return Rows{f, meta, c, 0, c};
}

Rows v1_rows(const float* fused, int c, int ncls) {
  return Rows{fused, nullptr, c, ncls, ncls + c};
}

}  // namespace

// C up to 128 (the flagship's latents are 32 wide); v1 takes ncls <= 32
extern "C" int cbl_tile2_fwd(const float* f, const float* meta,
                             const int32_t* li, const int32_t* starts,
                             float* stats, int b, int m, int k, int c,
                             int tile, int width, float temperature,
                             void* stream) {
  return fwd<true>(v2_rows(f, meta, c), li, starts, stats, b, m, k, tile,
                   width, temperature, (cudaStream_t)stream);
}

extern "C" int cbl_tile2_bwd(const float* f, const float* meta,
                             const int32_t* li, const int32_t* starts,
                             const float* stats, const float* g_loss,
                             float* dx, int b, int m, int k, int c, int tile,
                             int width, float temperature, void* stream) {
  return bwd(v2_rows(f, meta, c), li, starts, stats, g_loss, dx, b, m, k,
             tile, width, temperature, (cudaStream_t)stream);
}

extern "C" int cbl_tile_fwd(const float* fused, const int32_t* li,
                            const int32_t* starts, float* stats, int b, int m,
                            int k, int c, int ncls, int tile, int width,
                            float temperature, void* stream) {
  if (ncls < 1 || ncls > 32) return (int)cudaErrorInvalidValue;
  return fwd<false>(v1_rows(fused, c, ncls), li, starts, stats, b, m, k, tile,
                    width, temperature, (cudaStream_t)stream);
}

extern "C" int cbl_tile_bwd(const float* fused, const int32_t* li,
                            const int32_t* starts, const float* stats,
                            const float* g_loss, float* dx, int b, int m,
                            int k, int c, int ncls, int tile, int width,
                            float temperature, void* stream) {
  if (ncls < 1 || ncls > 32) return (int)cudaErrorInvalidValue;
  return bwd(v1_rows(fused, c, ncls), li, starts, stats, g_loss, dx, b, m, k,
             tile, width, temperature, (cudaStream_t)stream);
}
