// Tile-window row gather: out[b, q, k, :] = x[b, starts[q / tile] * tile +
// li[b, q, k], :], and a zero row where li is outside [0, W) (the shadow
// index W). Elements are float32 or bfloat16 (4 or 2 bytes), copied as bits;
// a shadow row is zero bits, +0 in both.
//
// Replaces the forward of contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
// tile_window_gather_pl (_fwd_call, body _fwd_kernel), which builds a one-hot
// per (batch, tile) in VMEM and selects rows with a matmul. On Hopper the
// selection is a plain row copy. `starts` (int32 [gq], in tiles) carries the
// window geometry, so the same kernel serves the self geometry
// (ops/tile_gather.py::tile_window_gather) and the cross-level one
// (cross_window_gather).
//
// Bound: bytes (x, li and starts read once, out written once; out is the
// bulk, K rows of x for each query), at the element's size: a bfloat16 gather
// moves half the bytes of a float32 one. The reference's bf16 branch
// (tile_gather_pl.py::_fwd_call, bf16_2d) selects bf16 rows exactly by a
// one-hot matmul and writes bf16; here the same bits are copied.
//
// Design: a warp owns `rw` consecutive output rows (flat (b, q, k), rw <= 32).
// Lane t < rw reads li of row t once (one coalesced load for the warp) and
// turns it into the flat source row b * Ns + starts[q / tile] * tile + li
// (-1 for a shadow slot) with 32-bit index math, once a row; the lanes that
// move the row's data take it from lane t by a shuffle. Nothing is divided
// in the per-element loops. The wrapper chooses the path and rw
// (ops/cuda/tile_gather.py::gather_plan) and passes them in.
//   * Vector path (rows of whole 16-byte pieces: C % 4 == 0 floats or C % 8
//     == 0 bfloat16s; x and out 16-byte aligned): a lane group of LPG lanes
//     moves one row, neighbouring lanes on neighbouring 16-byte pieces, NT
//     pieces a lane; the warp loads U rows a group (U * NT >= 4 independent
//     16-byte loads a lane) before it stores any. Rows wider than 32 * NT
//     pieces are split over gridDim.y channel chunks. A shadow row stores
//     zeros without loading. A piece is moved as bits, whatever it holds.
//   * Scalar-read path (other widths: 3, and the [p | x] rows of
//     TransitionDown, 35 ... 259 floats): the warp's rw rows are one
//     contiguous run of rw * C output elements (aligned to 4 elements: rw is
//     a multiple of 4), stored 4 elements at a time (a 16-byte float4, or
//     8 bytes of bfloat16s), lane by lane; each element of a store is read as
//     a scalar from its source row. A lane steps through the run with a
//     (row, channel) counter, so the element loop has no division either.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 4 elements stored at once by the scalar-read path: a float4, or 4
// bfloat16s (bits) in 8 bytes
template <class T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  static __device__ __forceinline__ type make(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Quad<uint16_t> {
  using type = ushort4;
  static __device__ __forceinline__ type make(const uint16_t (&v)[4]) {
    return make_ushort4(v[0], v[1], v[2], v[3]);
  }
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// flat source row of output row r (-1: a shadow slot or past the end)
__device__ __forceinline__ int source_row(const int32_t* __restrict__ li,
                                          const int32_t* __restrict__ starts,
                                          int r, int rows, int m, int k,
                                          int ns, int tile, int w_sz) {
  if (r >= rows) return -1;
  const int j = li[r];
  if (j < 0 || j >= w_sz) return -1;
  const int bq = r / k;
  const int b = bq / m;
  const int q = bq - b * m;
  return b * ns + starts[q / tile] * tile + j;
}

template <int LPG, int NT>
__global__ void __launch_bounds__(kThreads)
    gather_vec_kernel(const float4* __restrict__ x,
                      const int32_t* __restrict__ li,
                      const int32_t* __restrict__ starts,
                      float4* __restrict__ out, int rows, int m, int k,
                      int ns, int cv, int tile, int w_sz, int rw) {
  constexpr int G = 32 / LPG;               // rows a warp moves at once
  constexpr int U = NT >= 4 ? 1 : 4 / NT;   // rows a group loads ahead
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * rw;
  if (r0 >= rows) return;  // warp-uniform
  const int src = lane < rw ? source_row(li, starts, r0 + lane, rows, m, k,
                                         ns, tile, w_sz)
                            : -1;
  const int gi = lane / LPG, gl = lane % LPG;
  const int c0 = blockIdx.y * (LPG * NT) + gl;  // this lane's first piece
  for (int t0 = 0; t0 < rw; t0 += G * U) {
    float4 v[U][NT];
    int s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * G + gi;
      s[u] = __shfl_sync(kFull, src, t & 31);
      if (t >= rw) s[u] = -2;  // no row: nothing stored
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = c0 + i * LPG;
        v[u][i] = s[u] >= 0 && c < cv ? x[(size_t)s[u] * cv + c]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + t0 + u * G + gi;
      if (s[u] == -2 || r >= rows) continue;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = c0 + i * LPG;
        if (c < cv) out[(size_t)r * cv + c] = v[u][i];
      }
    }
  }
}

// T: float, or uint16_t for the bits of a bfloat16. VS: out is aligned to 4
// elements, so whole quads of the run are stored as such.
template <class T, bool VS>
__global__ void __launch_bounds__(kThreads)
    gather_scalar_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ li,
                         const int32_t* __restrict__ starts,
                         T* __restrict__ out, int rows, int m, int k,
                         int ns, int c, int tile, int w_sz, int rw) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * rw;
  if (r0 >= rows) return;  // warp-uniform
  const int src = lane < rw ? source_row(li, starts, r0 + lane, rows, m, k,
                                         ns, tile, w_sz)
                            : -1;
  const int nrow = min(rw, rows - r0);
  const int n = nrow * c;         // elements of the warp's run
  const int nv = (n + 3) >> 2;    // quads of the run
  T* o = out + (size_t)r0 * c;
  // (row, channel) of this lane's first element; a step of 32 quads
  // advances the element offset by 128
  int t = (4 * lane) / c, cc = 4 * lane - t * c;
  const int dt = 128 / c, dc = 128 - dt * c;
  for (int v0 = 0; v0 < nv; v0 += 32) {  // warp-uniform
    T val[4];
    int tt = t, ci = cc;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = __shfl_sync(kFull, src, tt & 31);
      val[u] = tt < nrow && s >= 0 ? x[(size_t)s * c + ci] : T(0);
      if (++ci == c) {
        ci = 0;
        ++tt;
      }
    }
    const int p = v0 + lane;
    if (VS && 4 * p + 4 <= n) {
      reinterpret_cast<typename Quad<T>::type*>(o)[p] = Quad<T>::make(val);
    } else if (p < nv) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * p + u < n) o[4 * p + u] = val[u];
    }
    t += dt;
    cc += dc;
    if (cc >= c) {
      cc -= c;
      ++t;
    }
  }
}

template <int LPG, int NT>
cudaError_t launch_vec(dim3 grid, cudaStream_t s, const void* x,
                       const int32_t* li, const int32_t* starts, void* out,
                       int rows, int m, int k, int ns, int cv, int tile,
                       int w_sz, int rw) {
  gather_vec_kernel<LPG, NT><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), li, starts,
      reinterpret_cast<float4*>(out), rows, m, k, ns, cv, tile, w_sz, rw);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_scalar(unsigned blocks, cudaStream_t s, const void* x,
                          const int32_t* li, const int32_t* starts, void* out,
                          int rows, int m, int k, int ns, int c, int tile,
                          int w_sz, int rw) {
  const T* xt = reinterpret_cast<const T*>(x);
  T* ot = reinterpret_cast<T*>(out);
  if ((uintptr_t)out % (4 * sizeof(T)) == 0) {
    gather_scalar_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        xt, li, starts, ot, rows, m, k, ns, c, tile, w_sz, rw);
  } else {
    gather_scalar_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        xt, li, starts, ot, rows, m, k, ns, c, tile, w_sz, rw);
  }
  return cudaGetLastError();
}

}  // namespace

// x and out hold C elements a row of elem_bytes bytes each (4: float32, 2:
// bfloat16). lpg: lanes a row on the vector path (4, 8, 16 or 32), or 0 for
// the scalar-read path; nt: 16-byte pieces a lane (1, 2 or 4, with lpg 32
// where above 1); rw: rows a warp (1..32; on the scalar-read path a multiple
// of 4). The wrapper raises before B * M * K or B * Ns reaches 2^31.
extern "C" int cbl_window_gather(const void* x, const int32_t* li,
                                 const int32_t* starts, void* out, int b,
                                 int ns, int m, int k, int c, int tile,
                                 int width, int lpg, int nt, int rw,
                                 int elem_bytes, void* stream) {
  const int rows = b * m * k;
  const int w_sz = width * tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (rw < 1 || rw > 32 || c < 1 || (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const long long warps = ((long long)rows + rw - 1) / rw;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (lpg == 0) {
    if (rw % 4) return (int)cudaErrorInvalidValue;
    return (int)(elem_bytes == 4
                     ? launch_scalar<float>(blocks, s, x, li, starts, out, rows,
                                            m, k, ns, c, tile, w_sz, rw)
                     : launch_scalar<uint16_t>(blocks, s, x, li, starts, out,
                                               rows, m, k, ns, c, tile, w_sz,
                                               rw));
  }
  // the vector path needs whole, aligned 16-byte pieces
  const bool vec = (c * elem_bytes) % 16 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  if (!vec || rw < 32 / lpg) return (int)cudaErrorInvalidValue;
  const int cv = c * elem_bytes / 16;  // 16-byte pieces a row
  const int chunk = lpg * nt;
  const dim3 grid(blocks, (unsigned)((cv + chunk - 1) / chunk));
#define CBL_GATHER_CASE(L, N)                                                \
  if (lpg == L && nt == N)                                                  \
  return (int)launch_vec<L, N>(grid, s, x, li, starts, out, rows, m, k, ns, \
                               cv, tile, w_sz, rw)
  CBL_GATHER_CASE(4, 1);
  CBL_GATHER_CASE(8, 1);
  CBL_GATHER_CASE(16, 1);
  CBL_GATHER_CASE(32, 1);
  CBL_GATHER_CASE(32, 2);
  CBL_GATHER_CASE(32, 4);
#undef CBL_GATHER_CASE
  return (int)cudaErrorInvalidValue;
}
