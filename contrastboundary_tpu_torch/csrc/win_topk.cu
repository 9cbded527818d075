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
//   descending, ties to the lower window index (to the higher one with
//   last_ties, which only k = 1 takes: the top-1 of the reference's
//   lax.approx_max_k on the CPU); a slot with no candidate left (k > W, or
//   only the excluded self remains) gets (W, -inf).
//   mode 0 plain, 1 exclude_self (own window row scored -inf),
//   2 ensure_self (slot 0 overwritten with (own window row, 0)).
//
// Bound: the data is tiny (3 floats per point); the work is B*M*W distance
// evaluations plus their comparisons, so the kernel is bound by operations
// on the CUDA cores. D = 3 leaves nothing for tensor cores: a pair costs 3
// products, and the plain version's rounding (each product rounded on its
// own) rules out fused or TF32 products anyway.
//
// The TPU kernel builds the [T, W] distance tile once in VMEM and runs k
// (max, first-index argmax, mask) passes over it. A 256 x 1536 f32 tile does
// not fit in an SM's shared memory, and k passes over the window per output
// slot are k times the bound's work. Design here:
//   * One warp per query row; lane l scores the candidates j = l + 32 i,
//     i < CPL = ceil(W / 32), once, into registers. The key of a candidate is
//     the bit pattern of d2 (a non-negative float orders like its uint32
//     bits); d2 = +inf is the empty key (the padding rows; an overflowing
//     distance, which the plain version scores -inf, is no candidate either).
//   * Each lane keeps its best R candidates (R = 1 for k = 1, 2 for k <= 8,
//     else 3) in registers, sorted by (key, index). Output slot p is one
//     round: the warp takes the minimum key over the lanes' heads and then
//     the minimum window index among the lanes that hold it, with
//     __reduce_min_sync (exact; the result does not depend on which lane
//     found what), and the winning lane pops its head. With last_ties
//     (k = 1, R = 1) the order is (key, -index): each lane keeps its last
//     candidate of the least key and the warp takes the maximum index among
//     the lanes that hold the minimum key (__reduce_max_sync). The rounds pop in
//     (key, index) order, so when a lane that may hold more candidates runs
//     empty, every lane refills its list with its best R strictly after the
//     pair just popped, from its own CPL registers, in one warp-wide pass.
//     No lane rescans the window per output slot, and nothing is
//     recomputed. (A refill of only the lane that ran empty keeps the whole
//     warp waiting once per such lane, and lanes run empty often: at k = 36
//     that made the level-0 search 1.5x slower on an H100.)
//   * exclude_self skips the round whose winner is the query's own row (its
//     d2 is exactly 0, so it is popped like any other candidate);
//     ensure_self overwrites slot 0 as the plain version does.
//   * Blocks of 4 warps each take rows_per_block rows of one query tile and
//     stage that tile's window as float4 (x, y, z, |s|^2) rows in shared
//     memory (16 B a row, at most 32 KB at W = 2048). The launcher picks
//     rows_per_block (a divisor of the tile, 4..64) so that even the deepest
//     levels, with one query tile per cloud, launch enough blocks to spread
//     over the 132 SMs.
//   * Each lane buffers the output slot p with p % 32 == lane, so a row's
//     outputs are written 32 at a time, coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0x7f800000u;  // bits of d2 = +inf: no candidate
constexpr int kWarps = 4;
constexpr int kMaxCpl = 64;  // W <= 32 * 64 = 2048

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// The lane's best R candidates, ascending by (key, i) (by (key, -i) when
// kLast), among those strictly after (tk, ti) in that order (all of them when
// kAfter is false). Equal keys keep the lower i first because i ascends and
// a candidate goes before a strictly greater key only; with kLast it goes
// before an equal key too, so the higher i comes first.
template <int CPL, int R, bool kAfter, bool kLast>
__device__ __forceinline__ void best_r(const unsigned (&key)[CPL], unsigned tk,
                                       int ti, unsigned (&hk)[R],
                                       int (&hi)[R]) {
#pragma unroll
  for (int p = 0; p < R; ++p) {
    hk[p] = kEmpty;
    hi[p] = 0;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const unsigned kk = key[i];
    const bool ok =
        !kAfter || kk > tk || (kk == tk && (kLast ? i < ti : i > ti));
    bool c[R];
#pragma unroll
    for (int p = 0; p < R; ++p) c[p] = ok && (kLast ? kk <= hk[p] : kk < hk[p]);
#pragma unroll
    for (int p = R - 1; p > 0; --p) {
      if (c[p - 1]) {
        hk[p] = hk[p - 1];
        hi[p] = hi[p - 1];
      } else if (c[p]) {
        hk[p] = kk;
        hi[p] = i;
      }
    }
    if (c[0]) {
      hk[0] = kk;
      hi[0] = i;
    }
  }
}

template <int CPL, int R, bool kLast>
__global__ void __launch_bounds__(kWarps * 32)
    win_topk_kernel(const float* __restrict__ query,
                    const float* __restrict__ support,
                    int32_t* __restrict__ idx_out, float* __restrict__ val_out,
                    int m, int ns, int k, int tile, int width, int window,
                    int gq, int gs, int mode, int rows_per_block) {
  extern __shared__ float4 win[];  // 32 * CPL rows, padded with empty rows
  const int splits = tile / rows_per_block;
  const int g = blockIdx.x / splits;
  const int r_begin = (blockIdx.x - g * splits) * rows_per_block;
  const int b = blockIdx.y;
  const int w_sz = width * tile;
  int start = (int)(((long long)g * gs) / gq) - window;
  start = max(start, 0);
  start = min(start, gs - width);

  const float* sup = support + ((size_t)b * ns + (size_t)start * tile) * 3;
  for (int j = threadIdx.x; j < 32 * CPL; j += blockDim.x) {
    if (j < w_sz) {
      const float x = sup[3 * j], y = sup[3 * j + 1], z = sup[3 * j + 2];
      win[j] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
    } else {
      win[j] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);  // d2 = +inf
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r_begin + warp; r < r_begin + rows_per_block; r += kWarps) {
    const size_t row = (size_t)b * m + (size_t)g * tile + r;
    const float qx = query[3 * row], qy = query[3 * row + 1],
                qz = query[3 * row + 2];
    const float qn = dot3(qx, qy, qz, qx, qy, qz);
    const int self_pos = (g - start) * tile + r;

    unsigned key[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float4 s = win[lane + 32 * i];
      const float qs = dot3(qx, qy, qz, s.x, s.y, s.z);
      // (qn + |s|^2) - 2 qs rounded once: 2 qs is exact, so the fused form
      // gives the bits of the plain version's separate product and sum
      key[i] = __float_as_uint(
          fmaxf(__fmaf_rn(-2.0f, qs, __fadd_rn(qn, s.w)), 0.0f));
    }
    unsigned hk[R];
    int hi[R];
    best_r<CPL, R, false, kLast>(key, 0u, 0, hk, hi);
    bool more = hk[R - 1] != kEmpty;  // the lane may hold more than its list

    int32_t* idx_row = idx_out + row * k;
    float* val_row = val_out + row * k;
    int out_j = w_sz;
    float out_v = -INFINITY;
    for (int p = 0; p < k;) {
      const unsigned m1 = __reduce_min_sync(kFull, hk[0]);
      int j = w_sz;
      float v = -INFINITY;
      if (m1 < kEmpty) {
        if (kLast) {  // a lane without the minimum offers 0, below any holder
          j = (int)__reduce_max_sync(
              kFull, hk[0] == m1 ? (unsigned)(lane + 32 * hi[0]) : 0u);
        } else {
          j = (int)__reduce_min_sync(
              kFull, hk[0] == m1 ? (unsigned)(lane + 32 * hi[0]) : kFull);
        }
        const bool skip = mode == 1 && j == self_pos;  // the excluded self
        const bool popped = lane == (j & 31);
#pragma unroll
        for (int q = 0; q + 1 < R; ++q) {
          hk[q] = popped ? hk[q + 1] : hk[q];
          hi[q] = popped ? hi[q + 1] : hi[q];
        }
        hk[R - 1] = popped ? kEmpty : hk[R - 1];
        // Rounds pop in (key, index) order, so the candidates popped so far
        // are exactly those up to (m1, j): when a lane that may hold more
        // runs empty, every lane takes its best R after (m1, j) at once.
        // This lane's candidates after j are i > floor((j - lane) / 32), or
        // with kLast (indices descending) i < ceil((j - lane) / 32).
        if (__any_sync(kFull, hk[0] == kEmpty && more) && (p + 1 < k || skip)) {
          const int ti = kLast ? (j - lane + 31) >> 5 : (j - lane) >> 5;
          best_r<CPL, R, true, kLast>(key, m1, ti, hk, hi);
          more = hk[R - 1] != kEmpty;
        }
        if (skip) continue;
        v = -__uint_as_float(m1);
      }
      out_j = lane == (p & 31) ? j : out_j;
      out_v = lane == (p & 31) ? v : out_v;
      if (mode == 2 && p == 0 && lane == 0) {
        out_j = self_pos;
        out_v = 0.0f;
      }
      if ((p & 31) == 31 || p == k - 1) {
        const int base = p & ~31;
        if (lane <= (p & 31)) {
          idx_row[base + lane] = out_j;
          val_row[base + lane] = out_v;
        }
      }
      ++p;
    }
  }
}

template <int CPL>
cudaError_t launch_cpl(dim3 grid, cudaStream_t stream, const float* query,
                       const float* support, int32_t* idx, float* val, int m,
                       int ns, int k, int tile, int width, int window, int gq,
                       int gs, int mode, int last_ties, int rows_per_block) {
  const size_t smem = sizeof(float4) * 32 * CPL;
  if (k == 1 && last_ties) {
    win_topk_kernel<CPL, 1, true><<<grid, kWarps * 32, smem, stream>>>(
        query, support, idx, val, m, ns, k, tile, width, window, gq, gs, mode,
        rows_per_block);
  } else if (k == 1) {
    win_topk_kernel<CPL, 1, false><<<grid, kWarps * 32, smem, stream>>>(
        query, support, idx, val, m, ns, k, tile, width, window, gq, gs, mode,
        rows_per_block);
  } else if (k <= 8) {
    win_topk_kernel<CPL, 2, false><<<grid, kWarps * 32, smem, stream>>>(
        query, support, idx, val, m, ns, k, tile, width, window, gq, gs, mode,
        rows_per_block);
  } else {
    win_topk_kernel<CPL, 3, false><<<grid, kWarps * 32, smem, stream>>>(
        query, support, idx, val, m, ns, k, tile, width, window, gq, gs, mode,
        rows_per_block);
  }
  return cudaGetLastError();
}

}  // namespace

// Window sizes up to 32 * kMaxCpl = 2048 rows (the wrapper raises on wider)
// and a non-empty output (the wrapper launches nothing for an empty one);
// last_ties only with k = 1.
extern "C" int cbl_win_topk(const float* query, const float* support,
                            int32_t* idx, float* val, int b, int m, int ns,
                            int k, int tile, int width, int window, int gs,
                            int mode, int last_ties, void* stream) {
  const int gq = m / tile;
  const int w_sz = width * tile;
  const int cpl = (w_sz + 31) / 32;
  if (cpl > kMaxCpl || (last_ties && k != 1)) return (int)cudaErrorInvalidValue;
  // rows a block takes: a divisor of the tile, 4..64, aiming at >= 4 blocks
  // an SM (132 SMs) where the rows allow it
  const long long target_ll = (long long)b * m / (4 * 132);
  const int target = (int)(target_ll < 4 ? 4 : target_ll > 64 ? 64 : target_ll);
  int rows_per_block = 1;
  for (int d = 1; d <= target && d <= tile; ++d) {
    if (tile % d == 0) rows_per_block = d;
  }
  dim3 grid(gq * (tile / rows_per_block), b);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
#define CBL_TOPK_CASE(C)                                                     \
  e = launch_cpl<C>(grid, s, query, support, idx, val, m, ns, k, tile, width, \
                    window, gq, gs, mode, last_ties, rows_per_block)
  if (cpl <= 8) {
    CBL_TOPK_CASE(8);
  } else if (cpl <= 16) {
    CBL_TOPK_CASE(16);
  } else if (cpl <= 24) {
    CBL_TOPK_CASE(24);
  } else if (cpl <= 32) {
    CBL_TOPK_CASE(32);
  } else if (cpl <= 48) {
    CBL_TOPK_CASE(48);
  } else {
    CBL_TOPK_CASE(64);
  }
#undef CBL_TOPK_CASE
  return (int)e;
}

extern "C" const char* cbl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
