// Row gather: out[i, :] = x[idx[i], :] for x [N, C] with C % 128 == 0 and
// idx [M] int32; a row whose index lies outside [0, N) is written as zeros
// (the kernel never reads outside x).
//
// Replaces contrastboundary_tpu/ops/pallas/gather_dma.py::gather_rows_dma,
// which issues one async DMA a row from HBM into the output block, in waves
// of 256 DMAs a tile of 1024 rows (its semaphore budget). Contract of
// ops/cuda/gather_dma.py::gather_rows_plain.
//
// Design: a row is a whole number of 16-byte words (C % 128 == 0 for any
// element size), so the kernel copies words and does not look at the dtype.
// Each thread copies one word; a block of 256 threads covers 256 / (words a
// row) rows (8 rows of a 128-wide float32 row), its warps reading whole
// 512-byte rows, neighbouring threads on neighbouring addresses.
//
// Bound: bytes. idx is read once (4M bytes), the distinct rows it names are
// read once and M rows of out written; there is no arithmetic. At x
// [131072, 128] f32 and M = 131072 random rows (82,637 distinct) that is
// 110 MB, 0.033 ms at 3.35 TB/s. Rows are read in index order, so a random
// idx makes the reads random at row granularity: whole 512-byte rows, which
// HBM serves near its rate, and every byte is moved by 16-byte accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const uint4* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out, int n,
                                   long long words, int words_per_row) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < words; e += stride) {
    const long long row = e / words_per_row;
    const int w = (int)(e - row * words_per_row);
    const int src = idx[row];
    out[e] = (src >= 0 && src < n)
                 ? x[(long long)src * words_per_row + w]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

// row_bytes = C * element size, a multiple of 16; x and out 16-byte aligned
extern "C" int cbl_gather_rows(const void* x, const int32_t* idx, void* out,
                               int n, int m, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const int words_per_row = row_bytes / 16;
  const long long words = (long long)m * words_per_row;
  if (words == 0) return (int)cudaSuccess;
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(x), idx, reinterpret_cast<uint4*>(out), n,
      words, words_per_row);
  return (int)cudaGetLastError();
}
