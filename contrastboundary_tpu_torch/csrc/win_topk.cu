// Window top-k: exact k nearest support points inside a Morton tile window.
//
// Replaces contrastboundary_tpu/ops/pallas/win_topk.py::window_topk (body
// _topk_kernel). Contract of ops/cuda/win_topk.py::window_topk_plain:
//   query [B, M, 3] f32, support [B, Ns, 3] f32, both Morton-sorted.
//   Query tile g (T = tile rows) scores the W = width * tile support rows that
//   start at tile clip((g * gs) / gq - window, 0, gs - width); the self
//   geometry is the same formula with gs == gq.
//   d2 = max((|q|^2 + |s|^2) - 2 * (q . s), 0) in f32, every product and sum
//   rounded in this order (no FMA contraction), so the plain PyTorch version,
//   which runs the same elementwise operations, gives the same bits.
//   Out: idx [B, M, k] int32 window-relative, val [B, M, k] f32 = -d2,
//   descending, ties to the lower window index; a slot with no candidate left
//   (k > W, or only the excluded self remains) gets (W, -inf).
//   mode 0 plain, 1 exclude_self (own window row scored -inf),
//   2 ensure_self (slot 0 overwritten with (own window row, 0)).
//
// Design: one block per (query tile, batch). The block stages the window's
// coordinates and squared norms as float4 in shared memory (16 B per row,
// 24 KB at W = 1536); each thread owns one query row. Pass p selects the best
// candidate strictly after the previous pick in the (value desc, index asc)
// order, recomputing the row's distances from shared memory instead of
// keeping the [T, W] tile (256 x 1536 f32 = 1.5 MB would not fit). The
// recompute is bit-identical, so k passes give exactly the k first-index
// argmax passes of the TPU kernel.
//
// Bound: the data is tiny (3 floats per point); the work is B*M*W distance
// evaluations plus their comparisons, so it is bound by operations (FP32 on
// the CUDA cores; D = 3 leaves nothing for tensor cores). This simple version
// does k passes over the window where one would do, so it does about k times
// the operations of the bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void win_topk_kernel(const float* __restrict__ query,
                                const float* __restrict__ support,
                                int32_t* __restrict__ idx_out,
                                float* __restrict__ val_out, int m, int ns,
                                int k, int tile, int width, int window, int gq,
                                int gs, int mode) {
  extern __shared__ float4 win[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int w_sz = width * tile;
  int start = (int)(((long long)g * gs) / gq) - window;
  start = max(start, 0);
  start = min(start, gs - width);

  const float* sup = support + ((size_t)b * ns + (size_t)start * tile) * 3;
  for (int j = threadIdx.x; j < w_sz; j += blockDim.x) {
    const float x = sup[3 * j], y = sup[3 * j + 1], z = sup[3 * j + 2];
    win[j] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= tile) return;
  const size_t row = (size_t)b * m + (size_t)g * tile + t;
  const float qx = query[3 * row], qy = query[3 * row + 1],
              qz = query[3 * row + 2];
  const float qn = dot3(qx, qy, qz, qx, qy, qz);
  const int self_pos = (g - start) * tile + t;
  int32_t* idx_row = idx_out + row * k;
  float* val_row = val_out + row * k;

  float prev_v = INFINITY;
  int prev_i = -1;
  for (int p = 0; p < k; ++p) {
    float best_v = -INFINITY;
    int best_i = w_sz;
    for (int j = 0; j < w_sz; ++j) {
      const float4 s = win[j];
      const float qs = dot3(qx, qy, qz, s.x, s.y, s.z);
      float v = -fmaxf(__fsub_rn(__fadd_rn(qn, s.w), __fmul_rn(2.0f, qs)),
                       0.0f);
      if (mode == 1 && j == self_pos) v = -INFINITY;
      const bool after = v < prev_v || (v == prev_v && j > prev_i);
      if (after && v > best_v) {
        best_v = v;
        best_i = j;
      }
    }
    idx_row[p] = best_i;
    val_row[p] = best_v;
    prev_v = best_v;
    prev_i = best_i;
  }
  if (mode == 2) {
    idx_row[0] = self_pos;
    val_row[0] = 0.0f;
  }
}

}  // namespace

extern "C" int cbl_win_topk(const float* query, const float* support,
                            int32_t* idx, float* val, int b, int m, int ns,
                            int k, int tile, int width, int window, int gs,
                            int mode, void* stream) {
  const int gq = m / tile;
  const int threads = ((tile + 31) / 32) * 32;
  const size_t smem = sizeof(float4) * (size_t)width * tile;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        win_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(gq, b);
  win_topk_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      query, support, idx, val, m, ns, k, tile, width, window, gq, gs, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* cbl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
