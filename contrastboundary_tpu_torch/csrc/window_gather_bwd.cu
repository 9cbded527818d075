// Backward of the tile-window row gather: dx[b, starts[q / tile] * tile +
// li[b, q, k], :] += g[b, q, k, :] for every slot whose li is inside [0, W);
// shadow slots (li = W) add nothing. dx is zeroed by the caller.
//
// Replaces the backward of contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
// tile_window_gather_pl (_bwd_call, body _bwd_kernel), which builds per-tile
// window grads with a transposed one-hot matmul in VMEM and overlap-adds the
// windows in XLA. On Hopper the transpose of a row selection is a row
// scatter-add, done in one pass: one thread per (slot, 4 channels) reads 16
// bytes of g and adds them onto the support row with atomicAdd (one float
// per thread where C % 4 != 0). `starts` (int32 [gq], in tiles) carries the
// window geometry, so the same kernel serves the self and the cross-level
// gathers. The order of the additions onto a row varies from run to run, so
// dx agrees with a sequential sum to float rounding, not bit for bit; a
// deterministic shared-memory design is later work.
//
// Bound: bytes. g (B*M*K*C floats) and li (B*M*K ints) are read once and dx
// (B*Ns*C floats) is read and written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
__global__ void window_gather_bwd_kernel(const float* __restrict__ g,
                                         const int32_t* __restrict__ li,
                                         const int32_t* __restrict__ starts,
                                         float* __restrict__ dx,
                                         long long rows, int m, int k, int ns,
                                         int c, int tile, int w_sz) {
  const int cv = c / V;  // channel groups of V floats
  const long long total = rows * cv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long r = e / cv;  // flat (b, q, kk)
    const int cg = (int)(e - r * cv);
    const int j = li[r];
    if (j < 0 || j >= w_sz) continue;
    const long long bq = r / k;  // flat (b, q)
    const int b = (int)(bq / m);
    const int q = (int)(bq - (long long)b * m);
    const long long dst =
        ((long long)b * ns + (long long)starts[q / tile] * tile + j) * c +
        (long long)cg * V;
    if constexpr (V == 4) {
      const float4 v = reinterpret_cast<const float4*>(g)[e];
      atomicAdd(dx + dst, v.x);
      atomicAdd(dx + dst + 1, v.y);
      atomicAdd(dx + dst + 2, v.z);
      atomicAdd(dx + dst + 3, v.w);
    } else {
      atomicAdd(dx + dst, g[e]);
    }
  }
}

template <int V>
void launch(const float* g, const int32_t* li, const int32_t* starts,
            float* dx, long long rows, int m, int k, int ns, int c, int tile,
            int w_sz, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (rows * (c / V) + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (blocks < 1) blocks = 1;
  window_gather_bwd_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      g, li, starts, dx, rows, m, k, ns, c, tile, w_sz);
}

}  // namespace

extern "C" int cbl_window_gather_bwd(const float* g, const int32_t* li,
                                     const int32_t* starts, float* dx, int b,
                                     int ns, int m, int k, int c, int tile,
                                     int width, void* stream) {
  const long long rows = (long long)b * m * k;
  const int w_sz = width * tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && ((uintptr_t)g % 16) == 0) {
    launch<4>(g, li, starts, dx, rows, m, k, ns, c, tile, w_sz, s);
  } else {
    launch<1>(g, li, starts, dx, rows, m, k, ns, c, tile, w_sz, s);
  }
  return (int)cudaGetLastError();
}
