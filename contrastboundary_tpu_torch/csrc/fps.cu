// Farthest point sampling chains: for each of P point sets ("buckets") of
// `per` points, the greedy chain of contrastboundary_tpu/ops/sampling.py::
// _fps_single: start at row 0 with mind2 = +inf; at step s = 1 .. m_per − 1
// take d2 of every row to the last pick, mind2 = min(mind2, d2), and pick
// argmax(mind2), ties to the lowest row. Exact FPS is the one-bucket case
// (P = B); bucketed FPS runs the chain in each Morton bucket (P = B·G).
// Contract of ops/cuda/fps.py::fps_chains_plain.
//
// Replaces no Pallas kernel: the reference computes the chain as a
// lax.fori_loop on the device (ops/sampling.py:54-74). In plain PyTorch each
// step is a handful of launches, one Python iteration a pick (336 steps of a
// bucketed level pyramid at N = 65536, 16,383 of an exact 65536 → 16384), so
// the chain is a kernel here, as in the reference's own PyTorch stack
// (pytorch/lib/pointops/src/sampling/).
//
// Design: one thread block per bucket, up to 1024 threads, each thread
// owning rows tid, tid + threads, ... Each step every thread updates mind2
// for its rows and keeps its (max, lowest row); the block reduces those by
// warp shuffles, then through shared memory, and broadcasts the pick. The
// coordinates are read as three planes (x, y, z), which the wrapper lays
// out. A bucket of up to kStageMaxRows rows keeps its planes and mind2 in
// shared memory (16 bytes a row; the 1,024-row buckets of a bucketed level
// take 16 KB); a larger one (exact FPS at N = 65536 needs 1 MB, beyond the
// SM's 227 KB of shared memory and its 256 KB of registers) reads its
// planes from global memory and keeps mind2 in a global scratch row, both
// served from L2 after the first step. That path is bound by one SM's L2
// rate, ~1.3 MB a step; a cluster of blocks sharing their shared memory
// would hold it on chip, which is later work.
//
// Bits: d2 = (dx·dx + dy·dy) + dz·dz with every product and sum rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn, never contracted to an FMA),
// the plain version's order, so the picks equal its picks on any cloud.
//
// Bound: the chain. Each step depends on the previous pick, so a bucket
// runs m_per − 1 steps one after the other, each ending in a block-wide
// reduction (two barriers). Bytes: the points read once and the indices
// written once; operations: ~9 a row a step.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kStageMaxRows = 13312;  // 16 B a row: 208 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ planes, int32_t* __restrict__ out,
           float* __restrict__ scratch, int per, int m_per, int staged) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int pick;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const long long p = blockIdx.x;
  const float* gx = planes + p * 3 * per;
  const float *xs, *ys, *zs;
  float* md;
  if (staged) {
    float* sx = smem;
    for (int i = tid; i < per; i += nt) {
      sx[i] = gx[i];
      sx[per + i] = gx[per + i];
      sx[2 * per + i] = gx[2 * per + i];
      sx[3 * per + i] = INFINITY;
    }
    xs = sx;
    md = sx + 3 * per;
  } else {
    xs = gx;
    md = scratch + p * per;
    for (int i = tid; i < per; i += nt) md[i] = INFINITY;
  }
  ys = xs + per;
  zs = ys + per;
  int32_t* o = out + p * m_per;
  if (tid == 0) o[0] = 0;
  __syncthreads();
  int last = 0;
  for (int s = 1; s < m_per; ++s) {
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float best = -1.0f;  // below every mind2 (≥ 0)
    int bi = 0x7fffffff;
    for (int i = tid; i < per; i += nt) {
      const float dx = __fsub_rn(xs[i], lx);
      const float dy = __fsub_rn(ys[i], ly);
      const float dz = __fsub_rn(zs[i], lz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float m = fminf(md[i], d2);
      md[i] = m;
      if (m > best) {  // rows ascend, so the first of equal values stays
        best = m;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      take_better(best, bi, __shfl_down_sync(kFull, best, off),
                  __shfl_down_sync(kFull, bi, off));
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1)
        take_better(best, bi, __shfl_down_sync(kFull, best, off),
                    __shfl_down_sync(kFull, bi, off));
      if (lane == 0) {
        pick = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
    last = pick;
  }
}

}  // namespace

// planes [P, 3, per] float32 (x, y, z planes of each bucket), out [P, m_per]
// int32 rows within the bucket; scratch [P, per] float32, read only when a
// bucket has more than kStageMaxRows rows (may be null otherwise)
extern "C" int cbl_fps(const float* planes, int32_t* out, float* scratch,
                       int buckets, int per, int m_per, void* stream) {
  if (buckets < 0 || per <= 0 || m_per < 0) return (int)cudaErrorInvalidValue;
  if (buckets == 0 || m_per == 0) return (int)cudaSuccess;
  const int staged = per <= kStageMaxRows;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int threads = ((per + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shared = staged ? (size_t)per * 4 * sizeof(float) : 0;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<<<buckets, threads, shared, (cudaStream_t)stream>>>(
      planes, out, scratch, per, m_per, staged);
  return (int)cudaGetLastError();
}
