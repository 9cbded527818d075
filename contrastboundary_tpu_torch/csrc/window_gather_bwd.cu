// Backward of the tile-window row gather: dx[b, starts[q / tile] * tile +
// li[b, q, k], :] = sum of g[b, q, k, :] over every slot whose li is inside
// [0, W); shadow slots (li = W) add nothing. Every element of dx is written
// once, rows no slot names as 0, so the caller allocates dx uninitialised.
// g and dx are both float32 or both bfloat16: the sums are float32 either
// way (a bfloat16 row widened exactly where it is loaded), and a bfloat16 dx
// is the float32 sum rounded once to nearest even, as the reference's
// backward sums the bf16 cotangent in float32 and casts the sum to x's dtype
// (tile_gather_pl.py::_bwd_call); folding both casts into the kernel saves a
// pass over g and one over dx.
//
// Replaces the backward of contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
// tile_window_gather_pl (_bwd_call, body _bwd_kernel), which builds each
// query tile's window gradient in VMEM with a transposed one-hot matmul and
// overlap-adds the windows in XLA in a fixed order. On Hopper the one-hot
// matmul wastes W/K of its work; what is kept is the accumulation local to a
// window, and the fixed order.
//
// Bound: bytes. g (B*M*K*C elements) and li (B*M*K ints) read once, dx
// (B*Ns*C elements) written once, at the element's size.
//
// Design: one block per (rows of a support tile, channel chunk, batch),
// 8 warps.
//   * `starts` (int32 [gq], in tiles) is non-decreasing in every geometry the
//     wrapper serves (self, TransitionDown, interpolation), so the query
//     tiles whose windows [starts[g], starts[g] + width) hold support tile s
//     are one contiguous range [g_lo, g_hi), found by two binary searches.
//     Their slots are one contiguous range of flat (q, k) indices.
//   * The block walks that range in super-chunks of 4096 slots in slot order.
//     Each thread reads 16 slots' li, keeps those landing in the block's rows
//     (packed as slot << 8 | local row) and counts them per (bucket, warp) in
//     shared memory, bucket = local row % NB. An exclusive scan of the counts
//     (bucket-major) and a warp-ordered placement (__match_any_sync ranks)
//     lay the entries out per bucket in ascending slot order: a stable
//     counting sort, with no order left to scheduling (window_sort.cuh, which
//     the CBL stats backward shares).
//   * Lane group b (LPG lanes, NB = 256 / LPG groups) owns the rows of bucket
//     b; its lanes own channels. It walks its entries in order, loading 8
//     gradient vectors a lane ahead (4 channels each where C % 4 == 0: 16 B
//     of float32 or 8 B of bfloat16, neighbouring lanes on neighbouring
//     channels) and adding them onto the block's
//     accumulator rows in shared memory. No two threads write one address and
//     no global atomics are used, so each dx element is the sequential float32
//     sum of its slots in ascending slot order, the same on every run: the
//     order in which index_add_ adds on the CPU.
//   * The accumulator holds the block's rows x one chunk of at most 256
//     channels (64 KB at most), so the slots are sorted once for all the
//     channels of the chunk; it is written out once, coalesced. Blocks split
//     a tile's rows (down to 16) where the tiles and chunks alone would not
//     fill two waves of the SMs: each such block scans the same slots, so
//     the split trades that scan for parallel loads.
//   * Where few support tiles take the slots of many query tiles (the K = 1
//     gathers from a deep level onto level 0: every slot of a cloud lands in
//     1-4 support tiles), the blocks scan far more slots than they keep; that
//     scan, not the bytes, bounds those calls.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_sort.cuh"

namespace {

using namespace cbl_window_sort;

constexpr int kMaxChunk = 256;                // channels a block
constexpr int kAccFloats = 16384;             // 64 KB accumulator
constexpr int kMaxRows = 256;                 // rows a block (8-bit row)
constexpr int kMinRows = 16;                  // rows a block, at least
constexpr int kMaxSmem = (kAccFloats + kSuper) * 4;

__device__ __forceinline__ void add_to(float* dst, const float4& v) {
  float4 a = *reinterpret_cast<float4*>(dst);
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
  *reinterpret_cast<float4*>(dst) = a;
}
__device__ __forceinline__ void add_to(float* dst, float v) { *dst += v; }

// bfloat16 bits widened exactly, and a float rounded to nearest even
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// V elements of E (float, or uint16_t for the bits of a bfloat16) as one
// access (raw), widened to floats (wide) and rounded back (narrow)
template <class E, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  using raw = float4;
  using wide_t = float4;
  static __device__ __forceinline__ float4 wide(const raw& v) { return v; }
  static __device__ __forceinline__ raw narrow(const float4& v) { return v; }
};
template <>
struct Vec<float, 1> {
  using raw = float;
  using wide_t = float;
  static __device__ __forceinline__ float wide(raw v) { return v; }
  static __device__ __forceinline__ raw narrow(float v) { return v; }
};
template <>
struct Vec<uint16_t, 4> {
  using raw = uint2;  // 4 bfloat16s, channel order low half first
  using wide_t = float4;
  static __device__ __forceinline__ float4 wide(const raw& v) {
    return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
  }
  static __device__ __forceinline__ raw narrow(const float4& v) {
    return make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16,
                      bf16_bits(v.z) | bf16_bits(v.w) << 16);
  }
};
template <>
struct Vec<uint16_t, 1> {
  using raw = uint16_t;
  using wide_t = float;
  static __device__ __forceinline__ float wide(raw v) { return bf16_lo(v); }
  static __device__ __forceinline__ raw narrow(float v) { return (raw)bf16_bits(v); }
};

// E the element of g and dx; V elements a lane access (4 where C % 4 ==
// 0), LPG lanes a row group, NT vectors a lane of each gradient row.
template <class E, int V, int LPG, int NT>
__global__ void __launch_bounds__(kThreads)
    window_gather_bwd_kernel(const E* __restrict__ g,
                             const int32_t* __restrict__ li,
                             const int32_t* __restrict__ starts,
                             E* __restrict__ dx, int m, int k, int ns,
                             int c, int tile, int width, int rows, int chunk) {
  using VE = Vec<E, V>;
  using T = typename VE::raw;
  constexpr int NB = kThreads / LPG;            // buckets = lane groups
  constexpr int AHEAD = NT >= 8 ? 1 : 8 / NT;   // gradient rows loaded ahead
  extern __shared__ float4 smem[];              // float4: 16-byte aligned
  float* acc = reinterpret_cast<float*>(smem);             // rows x chunk
  int* list = reinterpret_cast<int*>(acc + rows * chunk);  // kSuper
  __shared__ Counts counts;

  const int tid = threadIdx.x;
  const int splits = tile / rows;
  const int s = blockIdx.x / splits;  // support tile
  const int row0 = s * tile + (blockIdx.x - s * splits) * rows;
  const int c0 = blockIdx.y * chunk;
  const int nvec = min(chunk, c - c0) / V;
  const int b = blockIdx.z;
  const int gq = m / tile;
  const int w_sz = width * tile;
  const int kt = k * tile;  // slots a query tile
  const int2 range =
      slot_range([&](int t) { return starts[t]; }, gq, width, s, kt);

  for (int i = tid; i < rows * chunk; i += kThreads) acc[i] = 0.0f;
  counts.cnt[tid] = 0;
  __syncthreads();

  const int32_t* li_b = li + (size_t)b * m * k;
  const E* g_b = g + (size_t)b * m * k * c + c0;
  // the slot's entry: slot << 8 | local row where it lands in this block
  const auto entry = [&](int slot) {
    const int j = li_b[slot];
    const int r = starts[slot / kt] * tile + j - row0;
    return j >= 0 && j < w_sz && r >= 0 && r < rows ? (slot << 8) | r : -1;
  };
  for (int base = range.x; base < range.y; base += kSuper) {
    if (sort_chunk<NB>(base, range.y, entry, list, counts) == 0) continue;
    // 4. lane group gi adds its bucket's gradient rows in slot order
    {
      const int gi = tid / LPG, gl = tid % LPG;
      const int e1 = counts.off[(gi + 1) * kWarps];
      for (int e = counts.off[gi * kWarps]; e < e1; e += AHEAD) {
        T val[AHEAD][NT];
        int r[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          r[u] = -1;
          if (e + u < e1) {
            const int en = list[e + u];
            r[u] = en & 255;
            const T* src = reinterpret_cast<const T*>(g_b + (size_t)(en >> 8) * c);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const int cv = gl + t * LPG;
              if (cv < nvec) val[u][t] = src[cv];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          if (r[u] < 0) continue;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int cv = gl + t * LPG;
            if (cv < nvec) add_to(acc + r[u] * chunk + cv * V, VE::wide(val[u][t]));
          }
        }
      }
    }
    __syncthreads();
  }

  // every element of the block's rows and channels written once (a
  // bfloat16 one rounded once)
  E* dx_b = dx + ((size_t)b * ns + row0) * c + c0;
  for (int i = tid; i < rows * nvec; i += kThreads) {
    const int r = i / nvec, cv = i - r * nvec;
    reinterpret_cast<T*>(dx_b + (size_t)r * c)[cv] = VE::narrow(
        *reinterpret_cast<const typename VE::wide_t*>(acc + r * chunk + cv * V));
  }
}

template <class E, int V, int LPG, int NT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const void* g, const int32_t* li, const int32_t* starts,
                   void* dx, int m, int k, int ns, int c, int tile,
                   int width, int rows, int chunk) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_gather_bwd_kernel<E, V, LPG, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  window_gather_bwd_kernel<E, V, LPG, NT><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const E*>(g), li, starts, reinterpret_cast<E*>(dx), m,
      k, ns, c, tile, width, rows, chunk);
  return cudaGetLastError();
}

// the launch geometry, and the kernel for the element E
template <class E>
int dispatch(const void* g, const int32_t* li, const int32_t* starts,
             void* dx, int b, int ns, int m, int k, int c, int tile,
             int width, cudaStream_t s) {
  constexpr unsigned kAlign = 4 * sizeof(E);  // 4 elements a vector access
  const bool vec = c % 4 == 0 && (uintptr_t)g % kAlign == 0 &&
                   (uintptr_t)dx % kAlign == 0;
  // channels in chunks of at most 256, as even as the width allows
  const int chunks = (c + kMaxChunk - 1) / kMaxChunk;
  int chunk = (c + chunks - 1) / chunks;
  if (vec) chunk = (chunk + 3) & ~3;
  const int nvec = vec ? chunk / 4 : chunk;
  const int lpg = nvec > 16 ? 32 : nvec > 8 ? 16 : 8;
  const int nt = (nvec + lpg - 1) / lpg;
  // rows: a power-of-two divisor of the tile whose accumulator fits, halved
  // while the blocks would not fill two waves of the 132 SMs
  int rows = tile & -tile;
  if (rows > kMaxRows) rows = kMaxRows;
  while (rows > 1 && rows * chunk > kAccFloats) rows >>= 1;
  const int gs = ns / tile;
  long long blocks = (long long)gs * (tile / rows) * chunks * b;
  while (blocks < 2 * 132 && rows > kMinRows) {
    rows >>= 1;
    blocks <<= 1;
  }
  const dim3 grid(gs * (tile / rows), chunks, b);
  const size_t smem = (size_t)(rows * chunk + kSuper) * 4;
#define CBL_BWD_CASE(V, L, N)                                               \
  return (int)launch<E, V, L, N>(grid, smem, s, g, li, starts, dx, m, k, ns, \
                                 c, tile, width, rows, chunk)
  if (vec) {
    if (lpg == 8) CBL_BWD_CASE(4, 8, 1);
    if (lpg == 16) CBL_BWD_CASE(4, 16, 1);
    if (nt == 1) CBL_BWD_CASE(4, 32, 1);
    CBL_BWD_CASE(4, 32, 2);
  }
  if (lpg == 8) CBL_BWD_CASE(1, 8, 1);
  if (lpg == 16) CBL_BWD_CASE(1, 16, 1);
  if (nt == 1) CBL_BWD_CASE(1, 32, 1);
  if (nt == 2) CBL_BWD_CASE(1, 32, 2);
  if (nt <= 4) CBL_BWD_CASE(1, 32, 4);
  CBL_BWD_CASE(1, 32, 8);
#undef CBL_BWD_CASE
}

}  // namespace

// g and dx hold elem_bytes bytes an element (4: float32, 2: bfloat16).
// Limits (the wrapper raises before them): M * K < 2^23 (a slot and its
// 8-bit row share one int), C > 0.
extern "C" int cbl_window_gather_bwd(const void* g, const int32_t* li,
                                     const int32_t* starts, void* dx, int b,
                                     int ns, int m, int k, int c, int tile,
                                     int width, int elem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return dispatch<float>(g, li, starts, dx, b, ns, m, k, c, tile, width, s);
  if (elem_bytes == 2)
    return dispatch<uint16_t>(g, li, starts, dx, b, ns, m, k, c, tile, width, s);
  return (int)cudaErrorInvalidValue;
}
