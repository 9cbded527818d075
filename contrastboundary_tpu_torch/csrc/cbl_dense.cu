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
//   0, 0, 0). Backward, from the cotangent's lanes 1 (dpos) and 2 (dunder):
//     cd = (dpos * posmv + dunder) * e * (-1/T) / dist, and 0 where
//     d2 <= 1e-5 (|q|^2 + |s|^2) (the cancellation floor of the expansion);
//     dx[q] += sum cd * q - sum cd * s, dx[s] += cd * (s - q).
//   Every product and sum of the distances is rounded in the plain version's
//   order (no FMA contraction), so the two agree to float noise.
//
// Design: the TPU kernel scores the whole [T, W] window with one matmul
// because its lanes want dense tiles; the function depends only on the K
// listed slots (K / W is about 5% at the flagship's level 0), so here one
// thread owns one query row, keeps it in registers, and walks its K slots
// twice: once for the max-shift m, once for the sums (forward) or the
// gradient (backward), reading each slot's 4C bytes as float4. The backward
// adds dx with atomicAdd (dx zeroed by the caller), so its sums are taken in
// an order that varies from run to run.
//
// Bound: bytes. The forward reads features, meta and li once and writes the
// stats (B*M*(4C + 32 + 4K + 32) bytes); its operations, about (4C + 10) a
// slot, sit far below the card's FP32 rate. The backward also reads the
// cotangent and reads and writes dx. This version reads each slot row again
// from L2 rather than sharing a tile's window in shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int C>
__global__ void cbl_stats_bwd_kernel(const float* __restrict__ f,
                                     const float* __restrict__ meta,
                                     const int32_t* __restrict__ li,
                                     const float* __restrict__ gstats,
                                     float* __restrict__ dx, int b_sz, int m,
                                     int k, int tile, int width, int window,
                                     float inv_t) {
  Row row;
  if (!make_row(row, b_sz, m, tile, width, window)) return;
  float qv[C];
  load_row<C>(f, row.r, qv);
  const float q2 = sq_norm<C>(qv);
  const float qa = meta[row.r * 8];
  const float dpos = gstats[row.r * 8 + 1];
  const float dunder = gstats[row.r * 8 + 2];
  const float mhat = max_shift<C>(row, qv, q2, f, meta, li, k);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float cd_row = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = member_row(row, li[row.r * k + kk], meta);
    if (s < 0) continue;  // e = 0, so cd = 0
    const float mv = meta[s * 8 + 1];
    const float posmv =
        (fabsf(__fsub_rn(qa, meta[s * 8])) < 0.5f ? 1.f : 0.f) * mv;
    const float2 ds = slot_d2<C>(qv, q2, f, s);
    const float dist = sqrtf(__fadd_rn(ds.x, 1e-12f));
    const float e = __fmul_rn(expf(__fmul_rn(__fsub_rn(-dist, mhat), inv_t)), mv);
    const float coef = __fmul_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(dpos, posmv), dunder), e), -inv_t);
    if (!(ds.x > __fmul_rn(1e-5f, ds.y))) continue;  // cancellation floor
    const float cd = __fdiv_rn(coef, dist);
    if (cd == 0.f) continue;
    cd_row = __fadd_rn(cd_row, cd);
    const float4* p = reinterpret_cast<const float4*>(f + s * C);
    float* dst = dx + s * C;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 t = p[i];
      const float sv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * i + u;
        acc[c] = __fadd_rn(acc[c], __fmul_rn(cd, sv[u]));
        atomicAdd(dst + c, __fmul_rn(cd, __fsub_rn(sv[u], qv[c])));
      }
    }
  }
  float* dq = dx + row.r * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    atomicAdd(dq + c, __fsub_rn(__fmul_rn(cd_row, qv[c]), acc[c]));
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
        const float* gstats, float* dx, int b, int m, int k, int tile,
        int width, int window, float inv_t, cudaStream_t s) {
  const long long rows = (long long)b * m;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  cbl_stats_bwd_kernel<C><<<blocks, kThreads, 0, s>>>(
      f, meta, li, gstats, dx, b, m, k, tile, width, window, inv_t);
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

extern "C" int cbl_stats_bwd(const float* f, const float* meta,
                             const int32_t* li, const float* gstats,
                             float* dx, int b, int m, int k, int c, int tile,
                             int width, int window, float inv_t,
                             void* stream) {
  if (c != 32) return (int)cudaErrorInvalidValue;
  return bwd<32>(f, meta, li, gstats, dx, b, m, k, tile, width, window, inv_t,
                 (cudaStream_t)stream);
}
