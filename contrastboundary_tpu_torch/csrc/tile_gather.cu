// Tile-window row gather: out[b, q, k, :] = x[b, starts[q / tile] * tile +
// li[b, q, k], :], and a zero row where li is outside [0, W) (the shadow
// index W).
//
// Replaces the forward of contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
// tile_window_gather_pl (_fwd_call, body _fwd_kernel), which builds a one-hot
// per (batch, tile) in VMEM and selects rows with a matmul. On Hopper the
// selection is a plain row copy. `starts` (int32 [gq], in tiles) carries the
// window geometry, so the same kernel serves the self geometry
// (ops/tile_gather.py::tile_window_gather) and the cross-level one
// (cross_window_gather).
//
// Bound: bytes. One thread moves 16 bytes (float4) of a row when C % 4 == 0,
// neighbouring threads on neighbouring addresses of the same row; other
// widths (the 3-float positions, the [p | x] concatenation of TransitionDown)
// move one float per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void window_gather_kernel(const T* __restrict__ x,
                                     const int32_t* __restrict__ li,
                                     const int32_t* __restrict__ starts,
                                     T* __restrict__ out, long long rows,
                                     int m, int k, int ns, int cv, int tile,
                                     int w_sz) {
  const long long total = rows * cv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long r = e / cv;  // flat (b, q, kk)
    const int c = (int)(e - r * cv);
    const long long bq = r / k;  // flat (b, q)
    const int b = (int)(bq / m);
    const int q = (int)(bq - (long long)b * m);
    const int j = li[r];
    T v;
    if (j >= 0 && j < w_sz) {
      const long long src =
          (long long)b * ns + (long long)starts[q / tile] * tile + j;
      v = x[src * cv + c];
    } else {
      v = T{};
    }
    out[e] = v;
  }
}

template <typename T>
void launch(const T* x, const int32_t* li, const int32_t* starts, T* out,
            long long rows, int m, int k, int ns, int cv, int tile, int w_sz,
            cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (rows * cv + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (blocks < 1) blocks = 1;
  window_gather_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, li, starts, out, rows, m, k, ns, cv, tile, w_sz);
}

}  // namespace

extern "C" int cbl_window_gather(const float* x, const int32_t* li,
                                 const int32_t* starts, float* out, int b,
                                 int ns, int m, int k, int c, int tile,
                                 int width, void* stream) {
  const long long rows = (long long)b * m * k;
  const int w_sz = width * tile;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  if (vec) {
    launch<float4>(reinterpret_cast<const float4*>(x), li, starts,
                   reinterpret_cast<float4*>(out), rows, m, k, ns, c / 4,
                   tile, w_sz, s);
  } else {
    launch<float>(x, li, starts, out, rows, m, k, ns, c, tile, w_sz, s);
  }
  return (int)cudaGetLastError();
}
