// Fused point-transformer attention (stale BatchNorm folded into the towers),
// forward and backward.
//
// Replaces contrastboundary_tpu/ops/pallas/pt_attn.py::pt_attn: the forward
// _fwd_call (bodies _fwd_kernel / _fwd_kernel_b) and the analytic backward
// _bwd_call (bodies _bwd_kernel / _bwd_kernel_b). The TPU kernel gathers
// neighbour rows by one-hot matmuls over a VMEM window of kv, with sub-tiles
// and grid splits to fit VMEM. Here a row's K neighbours are read directly
// by absolute row (as csrc/tile_gather.cu does); nothing of a window is
// staged, and no [B, M, K, C] tensor is written.
//
// Function, per query row (b, m) and slot k < K, with C channels, CS = C / 8
// weight channels (share_planes 8), W = width * tile:
//   row = starts[m / tile] * tile + li[b, m, k]; li == W is the shadow slot
//   (zero k|v row, attention weight 0)
//   pe    = relu(rel . A1 + c1) . W2 + b2                          [C]
//   w_pre = k_row - q + pe                                         [C]
//   bvec  = relu(w_pre * g1 + h1) . W3 + b3                        [CS]
//   w4    = relu(bvec * g2 + h2) . W4 + b4                         [CS]
//   att   = softmax over the valid slots of w4 (per weight channel)
//   out[c] = sum_k att[k, c % CS] * (v_row + pe)[c]
// plus the sums of w_pre, w_pre^2 (per C) and bvec, bvec^2 (per CS) over
// every slot, shadow slots included, for the running-statistic updates.
//
// q, kv, out and the backward's g_out are float32 or bfloat16 (the element
// type E of both kernels, one for all four): a bfloat16 value is widened to
// float32 where it is loaded and out rounded once to bfloat16 where it is
// stored, as the TPU kernel upcasts q and kv in the kernel and writes out in
// q's dtype. rel, the folded tower arrays, the statistics, dq, dk|dv and the
// parameter gradients are float32 in both (the wrapper casts dq and dk|dv to
// q's dtype afterwards, where the reference casts them); all arithmetic is
// float32.
//
// Both kernels take tiles of slot-rows, as the TPU kernel's batched body
// (_fwd_kernel_b) folds K into the row dimension: a block takes R query rows
// and all K slots of each (R K slot-rows; the geometry comes from
// ops/cuda/pt_attn.py::fwd_plan and ::bwd_plan) and walks tiles with a grid
// stride (a persistent grid). Each tile starts with the same device
// functions in both kernels, phases separated by block barriers:
//   P0 tile_support  each slot-row's support row, rel and the PE tower's
//                    first layer; the tile's q rows;
//   P1 tile_r1       r1 = relu(w_pre g1 + h1) of every (slot-row, channel):
//                    thread (slot-row, j) walks the 8 shares of weight
//                    channel j, each kv gather independent of the others;
//   P2 tile_bvec     bvec = r1 W3 + b3 (a thread computes 4 outputs of a
//                    slot-row, one W3 vector serving 4 products), bn2's
//                    affine and r2;
//   P3 tile_scores   w4 = r2 W4 + b4, once per (slot-row, weight channel),
//                    kept for all K slots of each row;
//   P4 tile_softmax  per (row, weight channel), split over up to 8 lanes,
//                    the max and the denominator over the row's K stored
//                    scores (two passes, no online rescaling), att in place
//                    of the scores.
// Up to the last ReLU input every value is rounded as the plain version
// rounds it (ops/cuda/pt_attn.py::_terms: the PE tower, w_pre and bn1's
// affine term by term; bvec as the shares' partials of CS terms each in
// order, then the shares in order; bn2's affine; no fused multiply-add), so
// forward, backward and plain version take the same side of every ReLU kink
// by construction: a flipped kink would move one slot's whole gradient.
// After it (w4, the softmax, the output, every backward product) any order
// and FMA. No tensor cores: r1 W3 must round as above.
//
// Forward (pt_attn_fwd_kernel), after P4: out[c] = sum_k att[k, c % CS]
// (v + pe)[c], one thread a (row, channel) with no atomics, the v half of
// each kv row read here (the k half in P1), so each is read once; the PE
// tower's part comes from P4's sums of att and att relu(pe1_i) per (row,
// weight channel), so a slot costs the output one multiply-add. The
// statistics stay in registers across tiles (thread t holds w_pre's
// channels p CS + t % CS and bvec's weight channels of its P2 vector) and
// are summed into one partial row a block in a fixed order; the caller sums
// the rows (deterministic for a given grid).
//
// Backward (pt_attn_bwd_kernel), after P1-P4 (P1 also sums dalpha = sum over
// the shares of g (v + pe); P4 also takes S = sum att dalpha and dw4 = att
// (dalpha - S) in place of dalpha):
//   P5 dr2 = dw4 W4^T, dbv, db4, and dW4 += r2^T dw4;
//   P6 thread (c, group) over its rows' slot-rows, TS at a time: dr1 = dbv
//      W3^T and dW3 += r1^T dbv (one W3 vector and TS dbv vectors serve 4 TS
//      multiply-adds), then the channel-wise backward: bn1, dq, dk|dv
//      (float4 atomicAdd, 4 channels of 4 lanes gathered by shuffle; their
//      last bits vary from run to run), the PE tower.
// The tile's q and g rows are read once into shared memory; below C = 512
// the tile also keeps w_pre there, so P6 reads no global memory (at C =
// 512, W3 alone takes 136 KB, and w_pre is recomputed from kv, q and the PE
// tower as P1 rounds it). The 12 parameter gradients stay in registers
// across tiles (thread (c, group) owns row c of dW3 and its channel's dW2,
// db2, dg1, dh1; the others split dW4 and the weight-channel vectors) and
// are summed into one packed partial row per block in a fixed group order.
//
// Slots in chunks: where a row's K slot-rows do not fit in shared memory
// (C = 512 with K > 16), the per-slot-row arrays (r1, w_pre, bvec, r2, dbv)
// hold kc slots of each row at a time, and only each slot's score, att and
// dalpha/dw4 (CS floats each) are kept for all K. The forward runs P1-P3
// chunk by chunk, then P4 and the output over all K. The backward runs
// P1-P3 chunk by chunk (pass A), P4 over all K, then P1-P2 again for each
// chunk before its P5-P6 (pass B; with one chunk pass A's arrays are still
// there and nothing is recomputed); dq is added over the chunks.
//
// Bound: at the flagship widths the forward moves ~3 floats per (row,
// channel) of q, kv and out plus K * 4 words of rel and li per row, and does
// about 2 (3C + C*CS + CS^2) + 10 C FP32 operations per slot; the level-0
// and level-4 layers are operation-bound on the CUDA cores. The backward
// recomputes the forward and about doubles it: operation-bound at every
// width. What holds both back is latency, not operations: a tile's phases
// are separated by barriers, with 16 (backward) or 24 (forward below
// C = 512) warps an SM to cover them. By phase clocks of the forward
// (PERF.md), P1's gathers take a third to a half of a tile up to C = 128,
// P2's separately rounded chains (instruction issue) most of it at
// C >= 256, and P0, the softmax and the output's gathers the rest; in the
// backward P6 takes 35-40% of a tile and P1 up to a third (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// an element of q, kv, out or g_out, widened where it is loaded and rounded
// (to nearest even) where it is stored
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int SHARES = 8;
constexpr float NEG = -1e9f;  // the masked score of a shadow slot
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have

struct Params {  // the 12 folded arrays, row-major float32
  const float *a1, *c1, *w2, *b2, *g1, *h1, *w3, *b3, *g2, *h2, *w4, *b4;
};

template <int N>
struct VecN;
template <>
struct VecN<4> {
  using type = float4;
  __device__ static float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct VecN<2> {
  using type = float2;
  __device__ static float at(const float2& v, int i) { return i == 0 ? v.x : v.y; }
};

constexpr __host__ __device__ int round4(int x) { return (x + 3) / 4 * 4; }
constexpr __host__ __device__ int cmax(int a, int b) { return a > b ? a : b; }

// The one parameter image and thread layout of both kernels.
template <int CS>
struct Tiling {
  static constexpr int C = CS * SHARES;
  static constexpr int T = CS >= 64 ? 512 : 256;  // threads a block (T >= C)
  static constexpr int VJ = CS >= 4 ? 4 : CS;     // floats a vector along j
  static constexpr int NQ = CS / VJ;              // vectors a weight row
  // row stride of W3 and W4 (floats): an odd number of vectors, so that 8
  // threads reading one vector of 8 consecutive rows hit 8 bank groups
  static constexpr int WS = (NQ % 2 ? NQ : NQ + 1) * VJ;
  static constexpr int CS4 = round4(CS);
  // shared image of the parameters (offsets in floats, multiples of 4)
  static constexpr int A1 = 0, C1 = 12, W2 = 16, B2 = W2 + 3 * C, G1 = B2 + C,
                       H1 = G1 + C, W3 = H1 + C, B3 = W3 + C * WS,
                       G2 = B3 + CS4, H2 = G2 + CS4, B4 = H2 + CS4,
                       W4 = B4 + CS4, PARAMS = W4 + CS * WS;
  static constexpr int RS = C + 1;  // row stride of r1 and w_pre
  // packed parameter-gradient row (the wrapper's order)
  static constexpr int PA1 = 0, PC1 = 9, PW2 = 12, PB2 = PW2 + 3 * C,
                       PG1 = PB2 + C, PH1 = PG1 + C, PW3 = PH1 + C,
                       PB3 = PW3 + C * CS, PG2 = PB3 + CS, PH2 = PG2 + CS,
                       PW4 = PH2 + CS, PB4 = PW4 + CS * CS, PROW = PB4 + CS;
  // owners of the backward's accumulated gradients (groups of threads that
  // split the slot-rows and are summed in group order at the end):
  // channel-wise (dW3 rows, dW2, db2, dg1, dh1): thread (c, g6)
  static constexpr int G6 = T / C;
  // weight-channel-wise (db3, dg2, dh2, db4): thread (j, g5)
  static constexpr int G5 = T / CS;
  // dW4: (row, vector) pairs, NP a thread, or one pair a thread in G4 groups
  static constexpr int PAIRS = CS * NQ;
  static constexpr int NP = PAIRS >= T ? PAIRS / T : 1;
  static constexpr int G4 = PAIRS >= T ? 1 : T / PAIRS;
  static constexpr int GMAX = cmax(G6, cmax(G5, G4));
  // the backward keeps w_pre in shared memory, so that P6 reads no global
  // memory (not at C = 512: W3 alone takes 136 KB there)
  static constexpr bool STASH = CS <= 32;
  // slot-rows a P6 step (2 at C = 512, where dW3 holds 64 registers a thread)
  static constexpr int TS = CS >= 64 ? 2 : 4;
  // forward statistics: thread t holds w_pre's channels p CS + t % CS (group
  // t / CS of T / CS) and bvec's weight channels (t % NQ) VJ + v (group
  // t / NQ of T / NQ); their partials in shared memory at the end
  static constexpr int FSTATS = 2 * C * (T / CS) + 2 * CS * (T / NQ);
  // blocks an SM the kernels are built for (registers)
  static constexpr int FWD_BLOCKS = CS >= 64 ? 1 : 3;
  static constexpr int BWD_BLOCKS = CS >= 64 ? 1 : 2;
};

// dynamic shared floats of a forward block whose tiles hold rows x k
// slot-rows, kc slots of each row at a time
template <int CS>
__host__ __device__ int fwd_smem_floats(int rows, int k, int kc) {
  using L = Tiling<CS>;
  const int ns = rows * k, nc = rows * kc;
  const int tile = L::PARAMS + round4(nc * L::RS) + round4(nc * CS) +
                   round4(ns * CS) + round4(3 * ns) + round4(ns) +
                   round4(rows * L::C) + 4 * rows * CS;
  return cmax(tile, L::FSTATS);
}

// the same for a backward block
template <int CS>
__host__ __device__ int bwd_smem_floats(int rows, int k, int kc) {
  using L = Tiling<CS>;
  const int ns = rows * k, nc = rows * kc;
  int tile = L::PARAMS + round4(nc * L::RS) + 3 * round4(nc * CS) +
             2 * round4(ns * CS) + 2 * round4(3 * ns) + round4(ns) +
             2 * round4(rows * L::C);
  if (L::STASH) tile += round4(nc * L::RS);
  return cmax(tile, round4(L::PROW) + 12 * (L::T / 32));
}

// The parameter image, each array copied by a loop of independent loads
// (the padding of the small arrays and of the W3 and W4 rows is never read).
template <int CS>
__device__ void load_image(float* sp, const Params& P) {
  using L = Tiling<CS>;
  constexpr int C = L::C;
  const int t = threadIdx.x;
#pragma unroll 8
  for (int i = t; i < C * CS; i += L::T) sp[L::W3 + (i / CS) * L::WS + i % CS] = P.w3[i];
#pragma unroll 4
  for (int i = t; i < CS * CS; i += L::T) sp[L::W4 + (i / CS) * L::WS + i % CS] = P.w4[i];
  for (int i = t; i < 3 * C; i += L::T) sp[L::W2 + i] = P.w2[i];
  for (int i = t; i < C; i += L::T) {
    sp[L::B2 + i] = P.b2[i];
    sp[L::G1 + i] = P.g1[i];
    sp[L::H1 + i] = P.h1[i];
  }
  if (t < CS) {
    sp[L::B3 + t] = P.b3[t];
    sp[L::G2 + t] = P.g2[t];
    sp[L::H2 + t] = P.h2[t];
    sp[L::B4 + t] = P.b4[t];
  }
  if (t < 9) sp[L::A1 + t] = P.a1[t];
  if (t < 3) sp[L::C1 + t] = P.c1[t];
}

// ---- the recompute, shared by both kernels ------------------------------
//
// A tile holds rows r0 .. r0 + R - 1 (of B M) and slot-row s = rr k + kk
// for row r0 + rr, slot kk. A chunk holds slots k0 .. k0 + kn - 1 of each
// row: its slot-row sl = rr kn + i is the tile's slot-row
// sl + rr (k - kn) + k0.

__device__ __forceinline__ int tile_row(int sl, int k, int k0, int kn) {
  return kn == k ? sl : sl + (sl / kn) * (k - kn) + k0;
}

// P0: each slot-row's support row (-1 a shadow slot, -2 past the last row),
// rel (in REL where KEEP) and the PE tower's first layer, term by term; the
// tile's q rows.
template <int CS, bool KEEP, class E>
__device__ __forceinline__ void tile_support(
    const float* sp, int r0, int R, int k, long long rows, int m, int tile,
    int w_sz, const E* __restrict__ q, const float* __restrict__ rel,
    const int32_t* __restrict__ li, const int32_t* __restrict__ starts,
    int* SRC, float* REL, float* PE1, float* QR) {
  using L = Tiling<CS>;
  constexpr int C = L::C;
  for (int s = threadIdx.x; s < R * k; s += L::T) {
    const int rr = s / k;
    const int row = r0 + rr;
    int src = -2;
    float rl[3] = {0.f, 0.f, 0.f};
    if (row < rows) {
      const long long rk = (long long)row * k + (s - rr * k);
      const int bb = row / m;
      const int l = li[rk], st = starts[(row - bb * m) / tile];  // both in flight
      src = l >= 0 && l < w_sz ? bb * m + st * tile + l : -1;
#pragma unroll
      for (int r = 0; r < 3; ++r) rl[r] = rel[rk * 3 + r];
    }
    SRC[s] = src;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if constexpr (KEEP) REL[s * 3 + i] = rl[i];
      float v = sp[L::C1 + i];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        v = __fadd_rn(v, __fmul_rn(rl[r], sp[L::A1 + r * 3 + i]));
      PE1[s * 3 + i] = v;
    }
  }
  for (int e = threadIdx.x; e < R * C; e += L::T)
    QR[e] = r0 + e / C < rows ? widen(q[(long long)r0 * C + e]) : 0.f;
}

// P1: r1 of the chunk's slot-rows (and w_pre, where W), rounded as the
// plain version rounds it. Thread (sl, j) walks the shares' channels
// c = p CS + j; chan(rr, p, c, src, wpre, pe, v) is called on each (v the
// kv row's v half where V, else 0) and returns a term summed over the
// shares, which unit(s, j, sum) takes (the backward's dalpha). Two units'
// gathers in flight at once.
template <int CS, bool V, bool W, class E, class Chan, class Unit>
__device__ __forceinline__ void tile_r1(const float* sp, int R, int k, int k0,
                                        int kn, const E* __restrict__ kv,
                                        const int* SRC, const float* PE1,
                                        const float* QR, float* R1, float* WP,
                                        Chan&& chan, Unit&& unit) {
  using L = Tiling<CS>;
  constexpr int C = L::C;
#pragma unroll 2
  for (int u = threadIdx.x; u < R * kn * CS; u += L::T) {
    const int sl = u / CS, j = u - sl * CS;
    const int rr = sl / kn;
    const int s = kn == k ? sl : sl + rr * (k - kn) + k0;
    const int src = SRC[s];
    float rp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rp[i] = fmaxf(PE1[s * 3 + i], 0.f);
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < SHARES; ++p) {
      const int c = p * CS + j;
      float pe = sp[L::B2 + c];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        pe = __fadd_rn(pe, __fmul_rn(rp[i], sp[L::W2 + i * C + c]));
      const float kk = src >= 0 ? widen(kv[(long long)src * (2 * C) + c]) : 0.f;
      const float vv = V && src >= 0 ? widen(kv[(long long)src * (2 * C) + C + c]) : 0.f;
      const float wpre = __fadd_rn(__fsub_rn(kk, QR[rr * C + c]), pe);
      const float a = __fadd_rn(__fmul_rn(wpre, sp[L::G1 + c]), sp[L::H1 + c]);
      R1[sl * L::RS + c] = fmaxf(a, 0.f);
      if constexpr (W) WP[sl * L::RS + c] = wpre;
      acc += chan(rr, p, c, src, wpre, pe, vv);
    }
    unit(s, j, acc);
  }
}

// P2: bvec of the nc chunk slot-rows in the plain version's order (per
// output the shares' partials of CS terms each in order, then the shares in
// order, no FMA), bn2's affine and r2; bvec kept in BV where KEEP;
// hook(sl, v, bvec) on each of the thread's VJ outputs.
template <int CS, bool KEEP, class Hook>
__device__ __forceinline__ void tile_bvec(const float* sp, int nc,
                                          const float* R1, float* BV,
                                          float* R2, Hook&& hook) {
  using L = Tiling<CS>;
  constexpr int VJ = L::VJ, NQ = L::NQ, WS = L::WS;
  using V = VecN<VJ>;
  using VT = typename V::type;
  for (int u = threadIdx.x; u < nc * NQ; u += L::T) {
    const int sl = u / NQ, j0 = (u - sl * NQ) * VJ;
    const float* r1 = R1 + sl * L::RS;
    float acc[VJ];
#pragma unroll
    for (int v = 0; v < VJ; ++v) acc[v] = sp[L::B3 + j0 + v];
#pragma unroll 1
    for (int p = 0; p < SHARES; ++p) {
      float part[VJ];
#pragma unroll
      for (int v = 0; v < VJ; ++v) part[v] = 0.f;
#pragma unroll 8
      for (int i = 0; i < CS; ++i) {
        const int c = p * CS + i;
        const float r = r1[c];
        const VT w = *reinterpret_cast<const VT*>(sp + L::W3 + c * WS + j0);
#pragma unroll
        for (int v = 0; v < VJ; ++v)
          part[v] = __fadd_rn(part[v], __fmul_rn(r, V::at(w, v)));
      }
#pragma unroll
      for (int v = 0; v < VJ; ++v) acc[v] = __fadd_rn(acc[v], part[v]);
    }
#pragma unroll
    for (int v = 0; v < VJ; ++v) {
      const int j = j0 + v;
      if constexpr (KEEP) BV[sl * CS + j] = acc[v];
      const float cpre = __fadd_rn(__fmul_rn(acc[v], sp[L::G2 + j]), sp[L::H2 + j]);
      R2[sl * CS + j] = fmaxf(cpre, 0.f);
      hook(sl, v, acc[v]);
    }
  }
}

// P3: w4 = r2 W4 + b4 of the chunk's slot-rows into SC, which holds every
// slot of the tile (after the last ReLU input: any order)
template <int CS>
__device__ __forceinline__ void tile_scores(const float* sp, int R, int k,
                                            int k0, int kn, const float* R2,
                                            float* SC) {
  using L = Tiling<CS>;
  constexpr int VJ = L::VJ, NQ = L::NQ, WS = L::WS;
  using V = VecN<VJ>;
  using VT = typename V::type;
  for (int u = threadIdx.x; u < R * kn * NQ; u += L::T) {
    const int sl = u / NQ, j0 = (u - sl * NQ) * VJ;
    float acc[VJ];
#pragma unroll
    for (int v = 0; v < VJ; ++v) acc[v] = sp[L::B4 + j0 + v];
#pragma unroll 8
    for (int i = 0; i < CS; ++i) {
      const float r = R2[sl * CS + i];
      const VT w = *reinterpret_cast<const VT*>(sp + L::W4 + i * WS + j0);
#pragma unroll
      for (int v = 0; v < VJ; ++v) acc[v] = fmaf(r, V::at(w, v), acc[v]);
    }
    const int s = tile_row(sl, k, k0, kn);
#pragma unroll
    for (int v = 0; v < VJ; ++v) SC[s * CS + j0 + v] = acc[v];
  }
}

// P4: the softmax over each row's K stored scores, per weight channel. A
// unit (row, j) is split over `parts` adjacent lanes (a power of two up to
// 8 that the block's threads cover), lane q taking slots q, q + parts, ...;
// the max and the denominator are combined over the unit's lanes by
// shuffles. Then att = e / den in place of the scores (0 on shadow slots and
// on rows past the last), slot_hook(s, j, att) on each of the lane's slots,
// and row_hook(rr, j, s0, q, parts, on) on every lane (on: the lane has a
// unit), which combines the lanes' sums by shuffles where it takes any.
template <int CS, class SlotHook, class RowHook>
__device__ __forceinline__ void tile_softmax(int r0, int R, int k,
                                             long long rows, const int* SRC,
                                             float* SC, SlotHook&& slot_hook,
                                             RowHook&& row_hook) {
  using L = Tiling<CS>;
  const int units = R * CS;
  int parts = 1;
  while (parts < 8 && parts < k && units * parts * 2 <= L::T) parts *= 2;
  const int total = units * parts;
  // whole warps take part, so that the shuffles have every lane
  for (int u = threadIdx.x; u < (total + 31) / 32 * 32; u += L::T) {
    const bool on = u < total;
    const int unit = on ? u / parts : 0, q = u % parts;
    const int rr = unit / CS, j = unit - rr * CS;
    const int s0 = rr * k;
    const int kq = on ? k : 0;  // the lane's slots: q, q + parts, ... < kq
    float mx = NEG;
    for (int kk = q; kk < kq; kk += parts)
      if (SRC[s0 + kk] >= 0) mx = fmaxf(mx, SC[(s0 + kk) * CS + j]);
    for (int o = 1; o < parts; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
    for (int kk = q; kk < kq; kk += parts) {
      const int s = s0 + kk;
      const float e = SRC[s] >= 0 ? expf(SC[s * CS + j] - mx) : 0.f;
      SC[s * CS + j] = e;
      den += e;
    }
    for (int o = 1; o < parts; o *= 2) den += __shfl_xor_sync(0xffffffffu, den, o);
    const bool act = on && r0 + rr < rows;
    for (int kk = q; kk < kq; kk += parts) {
      const int s = s0 + kk;
      const float att = act ? SC[s * CS + j] / den : 0.f;
      SC[s * CS + j] = att;
      slot_hook(s, j, att);
    }
    row_hook(rr, j, s0, q, parts, on);
  }
}

// ---- forward -------------------------------------------------------------

template <int CS, class E>
__global__ void __launch_bounds__(Tiling<CS>::T, Tiling<CS>::FWD_BLOCKS)
    pt_attn_fwd_kernel(const E* __restrict__ q,
                       const E* __restrict__ kv,
                       const float* __restrict__ rel,
                       const int32_t* __restrict__ li,
                       const int32_t* __restrict__ starts, Params P,
                       E* __restrict__ out, float* __restrict__ stats,
                       long long rows, int m, int k, int tile, int w_sz,
                       int R, int kc) {
  using L = Tiling<CS>;
  constexpr int C = L::C, T = L::T, VJ = L::VJ, NQ = L::NQ;
  extern __shared__ float4 fwd_shared[];
  float* sp = reinterpret_cast<float*>(fwd_shared);
  const int ns = R * k, nc = R * kc;
  float* R1 = sp + L::PARAMS;
  float* R2 = R1 + round4(nc * L::RS);
  float* SC = R2 + round4(nc * CS);  // w4, then att
  float* PE1 = SC + round4(ns * CS);
  int* SRC = reinterpret_cast<int*>(PE1 + round4(3 * ns));
  float* QR = reinterpret_cast<float*>(SRC) + round4(ns);
  float4* AP = reinterpret_cast<float4*>(QR + round4(R * C));  // [R, CS]
  load_image<CS>(sp, P);
  __syncthreads();

  const int tid = threadIdx.x;
  float s1[SHARES], s1q[SHARES], s2[VJ], s2q[VJ];
#pragma unroll
  for (int p = 0; p < SHARES; ++p) s1[p] = s1q[p] = 0.f;
#pragma unroll
  for (int v = 0; v < VJ; ++v) s2[v] = s2q[v] = 0.f;
  // the output's channel (T is a multiple of C) and its PE tower
  const int c = tid % C, jc = c % CS;
  const float b2c = sp[L::B2 + c];
  float w2c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w2c[i] = sp[L::W2 + i * C + c];

  const int n_tiles = (int)((rows + R - 1) / R);
  for (int tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int r0 = tl * R;
    __syncthreads();  // the last tile's arrays read
    tile_support<CS, false>(sp, r0, R, k, rows, m, tile, w_sz, q, rel, li,
                            starts, SRC, nullptr, PE1, QR);
    __syncthreads();
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int kn = min(kc, k - k0);
      tile_r1<CS, false, false>(
          sp, R, k, k0, kn, kv, SRC, PE1, QR, R1, nullptr,
          [&](int, int p, int, int src, float wpre, float, float) {
            if (src != -2) {  // a row of the cloud (shadow slots count)
              s1[p] += wpre;
              s1q[p] = fmaf(wpre, wpre, s1q[p]);
            }
            return 0.f;
          },
          [](int, int, float) {});
      __syncthreads();
      tile_bvec<CS, false>(sp, R * kn, R1, nullptr, R2, [&](int sl, int v, float bv) {
        if (r0 + sl / kn < rows) {
          s2[v] += bv;
          s2q[v] = fmaf(bv, bv, s2q[v]);
        }
      });
      __syncthreads();
      tile_scores<CS>(sp, R, k, k0, kn, R2, SC);
      __syncthreads();
    }
    // P4, and per (row, j) the sums that give the PE tower's part of the
    // output: sum_k att (v + pe)[c] = sum_k att v[c] + b2[c] sum_k att +
    // sum_i W2[i, c] sum_k att relu(pe1_i)
    float4 ap = make_float4(0.f, 0.f, 0.f, 0.f);
    tile_softmax<CS>(
        r0, R, k, rows, SRC, SC,
        [&](int s, int, float att) {
          ap.x += att;
          ap.y = fmaf(att, fmaxf(PE1[s * 3], 0.f), ap.y);
          ap.z = fmaf(att, fmaxf(PE1[s * 3 + 1], 0.f), ap.z);
          ap.w = fmaf(att, fmaxf(PE1[s * 3 + 2], 0.f), ap.w);
        },
        [&](int rr, int j, int, int q, int parts, bool on) {
          for (int o = 1; o < parts; o *= 2) {
            ap.x += __shfl_xor_sync(0xffffffffu, ap.x, o);
            ap.y += __shfl_xor_sync(0xffffffffu, ap.y, o);
            ap.z += __shfl_xor_sync(0xffffffffu, ap.z, o);
            ap.w += __shfl_xor_sync(0xffffffffu, ap.w, o);
          }
          if (on && q == 0) AP[rr * CS + j] = ap;
          ap = make_float4(0.f, 0.f, 0.f, 0.f);
        });
    __syncthreads();
    // out[c]: thread (row, c), two rows a step, the rows' v loads independent
    // of each other (att = 0 on a shadow slot and on rows past the last)
#pragma unroll 2
    for (int u = tid; u < R * C; u += T) {
      const int rr = u / C;
      const int s0 = rr * k;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < k; ++kk) {
        const int src = SRC[s0 + kk];
        const float vv = src >= 0 ? widen(kv[(long long)src * (2 * C) + C + c]) : 0.f;
        acc = fmaf(SC[(s0 + kk) * CS + jc], vv, acc);
      }
      const float4 a = AP[rr * CS + jc];
      acc = fmaf(b2c, a.x, acc);
      acc = fmaf(w2c[0], a.y, acc);
      acc = fmaf(w2c[1], a.z, acc);
      acc = fmaf(w2c[2], a.w, acc);
      if (r0 + rr < rows) store(out + (long long)(r0 + rr) * C + c, acc);
    }
  }

  // the block's statistics row: each thread's partials in shared memory,
  // then summed over the groups in order
  __syncthreads();
  float* A1 = sp;                          // [T / CS][2C]
  float* A2 = sp + 2 * C * (T / CS);       // [T / NQ][2CS]
  {
    const int g = tid / CS, j = tid % CS;
#pragma unroll
    for (int p = 0; p < SHARES; ++p) {
      A1[g * 2 * C + p * CS + j] = s1[p];
      A1[g * 2 * C + C + p * CS + j] = s1q[p];
    }
    const int g2 = tid / NQ, j0 = (tid % NQ) * VJ;
#pragma unroll
    for (int v = 0; v < VJ; ++v) {
      A2[g2 * 2 * CS + j0 + v] = s2[v];
      A2[g2 * 2 * CS + CS + j0 + v] = s2q[v];
    }
  }
  __syncthreads();
  float* st = stats + (long long)blockIdx.x * (2 * C + 2 * CS);
  for (int e = tid; e < 2 * C; e += T) {
    float t = 0.f;
    for (int g = 0; g < T / CS; ++g) t += A1[g * 2 * C + e];
    st[e] = t;
  }
  for (int e = tid; e < 2 * CS; e += T) {
    float t = 0.f;
    for (int g = 0; g < T / NQ; ++g) t += A2[g * 2 * CS + e];
    st[2 * C + e] = t;
  }
}

// ---- backward ------------------------------------------------------------

template <int CS, class E>
__global__ void __launch_bounds__(Tiling<CS>::T, Tiling<CS>::BWD_BLOCKS)
    pt_attn_bwd_kernel(const E* __restrict__ q,
                       const E* __restrict__ kv,
                       const float* __restrict__ rel,
                       const int32_t* __restrict__ li,
                       const int32_t* __restrict__ starts, Params P,
                       const E* __restrict__ gout, float* __restrict__ dq,
                       float* __restrict__ dkv, float* __restrict__ dparams,
                       long long rows, int m, int k, int tile, int w_sz,
                       int R, int kc) {
  using L = Tiling<CS>;
  constexpr int C = L::C, T = L::T, VJ = L::VJ, NQ = L::NQ, WS = L::WS;
  using V = VecN<VJ>;
  using VT = typename V::type;
  extern __shared__ float4 bwd_shared[];
  float* sp = reinterpret_cast<float*>(bwd_shared);
  const int ns = R * k, nc = R * kc;
  float* R1 = sp + L::PARAMS;
  float* WP = R1 + round4(nc * L::RS);  // STASH: w_pre
  float* BV = WP + (L::STASH ? round4(nc * L::RS) : 0);
  float* R2 = BV + round4(nc * CS);
  float* DBV = R2 + round4(nc * CS);
  float* SC = DBV + round4(nc * CS);   // w4, then att (every slot)
  float* DAL = SC + round4(ns * CS);   // dalpha, then dw4 (every slot)
  float* REL = DAL + round4(ns * CS);
  float* PE1 = REL + round4(3 * ns);
  int* SRC = reinterpret_cast<int*>(PE1 + round4(3 * ns));
  float* QR = reinterpret_cast<float*>(SRC) + round4(ns);  // q of each row
  float* GR = QR + round4(R * C);                          // g of each row
  load_image<CS>(sp, P);
  __syncthreads();

  const int tid = threadIdx.x;
  const int c6 = tid % C, g6 = tid / C;
  const int j5 = tid % CS, g5 = tid / CS;
  const int g4 = L::PAIRS >= T ? 0 : tid / L::PAIRS;
  float dW3[CS], dW4[L::NP][VJ];
#pragma unroll
  for (int j = 0; j < CS; ++j) dW3[j] = 0.f;
#pragma unroll
  for (int n = 0; n < L::NP; ++n)
#pragma unroll
    for (int v = 0; v < VJ; ++v) dW4[n][v] = 0.f;
  float dW2[3] = {0.f, 0.f, 0.f}, dc1[3] = {0.f, 0.f, 0.f}, dA1[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dA1[i] = 0.f;
  float db2 = 0.f, dg1 = 0.f, dh1 = 0.f;
  float db3 = 0.f, dg2 = 0.f, dh2 = 0.f, db4 = 0.f;

  // P6: thread (c6, g6) takes rows [rb6, rb6 + R / G6) of each tile; the
  // parameters it reads for its channel
  const int rb6 = g6 * (R / L::G6), re6 = rb6 + R / L::G6;
  const float g1c = sp[L::G1 + c6], b2c = sp[L::B2 + c6];
  float w2c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w2c[i] = sp[L::W2 + i * C + c6];
  const auto no_chan = [](int, int, int, int, float, float, float) { return 0.f; };
  const auto no_unit = [](int, int, float) {};
  const auto no_hook = [](int, int, float) {};
  const int n_tiles = (int)((rows + R - 1) / R);
  for (int tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int r0 = tl * R;
    __syncthreads();  // the parameters loaded; the last tile's arrays read
    tile_support<CS, true>(sp, r0, R, k, rows, m, tile, w_sz, q, rel, li, starts,
                           SRC, REL, PE1, QR);
    for (int e = tid; e < R * C; e += T)  // the tile's g rows, once
      GR[e] = r0 + e / C < rows ? widen(gout[(long long)r0 * C + e]) : 0.f;
    __syncthreads();
    // pass A: P1 (with dalpha) to P3, chunk by chunk
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int kn = min(kc, k - k0);
      tile_r1<CS, true, L::STASH>(
          sp, R, k, k0, kn, kv, SRC, PE1, QR, R1, WP,
          [&](int rr, int, int c, int, float, float pe, float vv) {
            return GR[rr * C + c] * (vv + pe);
          },
          [&](int s, int j, float dal) { DAL[s * CS + j] = dal; });
      __syncthreads();
      tile_bvec<CS, true>(sp, R * kn, R1, BV, R2, no_hook);
      __syncthreads();
      tile_scores<CS>(sp, R, k, k0, kn, R2, SC);
      __syncthreads();
    }
    // P4: softmax; S = sum att dalpha and dw4 in place of dalpha
    float S = 0.f;
    tile_softmax<CS>(
        r0, R, k, rows, SRC, SC,
        [&](int s, int j, float att) { S += att * DAL[s * CS + j]; },
        [&](int, int j, int s0, int q, int parts, bool on) {
          for (int o = 1; o < parts; o *= 2) S += __shfl_xor_sync(0xffffffffu, S, o);
          for (int kk = q; on && kk < k; kk += parts) {
            const int s = s0 + kk;
            DAL[s * CS + j] = SC[s * CS + j] * (DAL[s * CS + j] - S);
          }
          S = 0.f;
        });
    __syncthreads();
    // pass B: P5 and P6, chunk by chunk (r1 and r2 recomputed where the
    // tile has more than one chunk)
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int kn = min(kc, k - k0), nsc = R * kn;
      if (kc < k) {
        if (k0 > 0) __syncthreads();  // the last chunk's P6 done
        tile_r1<CS, false, L::STASH>(sp, R, k, k0, kn, kv, SRC, PE1, QR, R1, WP, no_chan,
                                     no_unit);
        __syncthreads();
        tile_bvec<CS, true>(sp, nsc, R1, BV, R2, no_hook);
        __syncthreads();
      }
      // P5: dr2 = dw4 W4^T, dbv and the weight-channel-wise gradients
      for (int u = tid; u < nsc * CS; u += T) {
        const int sl = u / CS, i = u - sl * CS;  // i == j5
        const int s = tile_row(sl, k, k0, kn);
        float dr2 = 0.f;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          const VT d = *reinterpret_cast<const VT*>(DAL + s * CS + qq * VJ);
          const VT w = *reinterpret_cast<const VT*>(sp + L::W4 + i * WS + qq * VJ);
#pragma unroll
          for (int v = 0; v < VJ; ++v) dr2 = fmaf(V::at(d, v), V::at(w, v), dr2);
        }
        db4 += DAL[s * CS + i];
        const float dcp = R2[sl * CS + i] > 0.f ? dr2 : 0.f;  // cpre > 0
        dg2 += dcp * BV[sl * CS + i];
        dh2 += dcp;
        const float dbv = dcp * sp[L::G2 + i];
        db3 += dbv;
        DBV[sl * CS + i] = dbv;
      }
      // dW4 += r2^T dw4
#pragma unroll
      for (int n = 0; n < L::NP; ++n) {
        const int pr = L::PAIRS >= T ? tid + n * T : tid % L::PAIRS;
        const int i = pr / NQ, j0 = (pr - i * NQ) * VJ;
        for (int sl = g4; sl < nsc; sl += L::G4) {
          const float r = R2[sl * CS + i];
          const VT d = *reinterpret_cast<const VT*>(DAL + tile_row(sl, k, k0, kn) * CS + j0);
#pragma unroll
          for (int v = 0; v < VJ; ++v) dW4[n][v] = fmaf(r, V::at(d, v), dW4[n][v]);
        }
      }
      __syncthreads();
      // P6: thread (c6, g6) over its rows' slot-rows, TS at a time; every
      // lane of a warp takes the same steps (the groups of a warp have equal
      // ranges), so the vector atomics' shuffles are whole
      const int c = c6;
      for (int rr = rb6; rr < re6; ++rr) {
        const int row = r0 + rr;
        const bool act = row < rows;
        const float gc = GR[rr * C + c], qc = QR[rr * C + c];
        float dqc = 0.f;
        for (int i0 = 0; i0 < kn; i0 += L::TS) {
          const int sl0 = rr * kn + i0, s0 = rr * k + k0 + i0;
          float dr1[L::TS], r1v[L::TS];
#pragma unroll
          for (int u = 0; u < L::TS; ++u) {
            dr1[u] = 0.f;
            r1v[u] = i0 + u < kn ? R1[(sl0 + u) * L::RS + c] : 0.f;
          }
#pragma unroll
          for (int qq = 0; qq < NQ; ++qq) {
            const VT w = *reinterpret_cast<const VT*>(sp + L::W3 + c * WS + qq * VJ);
#pragma unroll
            for (int u = 0; u < L::TS; ++u) {
              if (i0 + u >= kn) continue;
              const VT d = *reinterpret_cast<const VT*>(DBV + (sl0 + u) * CS + qq * VJ);
#pragma unroll
              for (int v = 0; v < VJ; ++v) {
                dr1[u] = fmaf(V::at(d, v), V::at(w, v), dr1[u]);
                dW3[qq * VJ + v] = fmaf(r1v[u], V::at(d, v), dW3[qq * VJ + v]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < L::TS; ++u) {
            if (i0 + u >= kn) continue;
            const int s = s0 + u;
            const int src = SRC[s];
            float pe1[3], rl[3];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              pe1[i] = PE1[s * 3 + i];
              rl[i] = REL[s * 3 + i];
            }
            float wpre;
            if constexpr (L::STASH) {
              wpre = WP[(sl0 + u) * L::RS + c];
            } else {
              float pe = b2c;
#pragma unroll
              for (int i = 0; i < 3; ++i) pe = __fadd_rn(pe, __fmul_rn(fmaxf(pe1[i], 0.f), w2c[i]));
              const float kk = src >= 0 ? widen(kv[(long long)src * (2 * C) + c]) : 0.f;
              wpre = __fadd_rn(__fsub_rn(kk, qc), pe);
            }
            const float da = act && r1v[u] > 0.f ? dr1[u] : 0.f;  // a > 0
            dg1 += da * wpre;
            dh1 += da;
            const float dwpre = da * g1c;
            dqc -= dwpre;
            const float dvpe = SC[s * CS + c % CS] * gc;
            // dk|dv of 4 consecutive channels (4 consecutive lanes) in one
            // vector atomic each
            float4 ak = make_float4(dwpre, 0.f, 0.f, 0.f), av = make_float4(dvpe, 0.f, 0.f, 0.f);
            ak.y = __shfl_down_sync(0xffffffffu, dwpre, 1);
            ak.z = __shfl_down_sync(0xffffffffu, dwpre, 2);
            ak.w = __shfl_down_sync(0xffffffffu, dwpre, 3);
            av.y = __shfl_down_sync(0xffffffffu, dvpe, 1);
            av.z = __shfl_down_sync(0xffffffffu, dvpe, 2);
            av.w = __shfl_down_sync(0xffffffffu, dvpe, 3);
            if (src >= 0 && (c & 3) == 0) {
              atomicAdd(reinterpret_cast<float4*>(dkv + (long long)src * (2 * C) + c), ak);
              atomicAdd(reinterpret_cast<float4*>(dkv + (long long)src * (2 * C) + C + c), av);
            }
            const float dpe = dwpre + dvpe;
            db2 += dpe;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              dW2[i] += fmaxf(pe1[i], 0.f) * dpe;
              const float dri = pe1[i] > 0.f ? dpe * w2c[i] : 0.f;
              dc1[i] += dri;
#pragma unroll
              for (int r = 0; r < 3; ++r) dA1[r * 3 + i] += rl[r] * dri;
            }
          }
        }
        // dq: the chunks' parts added in order (the same thread each time)
        if (act) {
          float* d = dq + (long long)row * C + c;
          *d = k0 == 0 ? dqc : *d + dqc;
        }
      }
    }
  }

  // the block's packed gradient row, in place of the parameters: each
  // group's partials added in group order, so the row is the same on every
  // run of a grid
  __syncthreads();
  float* pr = sp;
  float* wred = sp + round4(L::PROW);
  for (int e = tid; e < L::PROW; e += T) pr[e] = 0.f;
  __syncthreads();
  for (int g = 0; g < L::GMAX; ++g) {
    if (g6 == g) {
#pragma unroll
      for (int j = 0; j < CS; ++j) pr[L::PW3 + c6 * CS + j] += dW3[j];
#pragma unroll
      for (int i = 0; i < 3; ++i) pr[L::PW2 + i * C + c6] += dW2[i];
      pr[L::PB2 + c6] += db2;
      pr[L::PG1 + c6] += dg1;
      pr[L::PH1 + c6] += dh1;
    }
    if (g5 == g) {
      pr[L::PB3 + j5] += db3;
      pr[L::PG2 + j5] += dg2;
      pr[L::PH2 + j5] += dh2;
      pr[L::PB4 + j5] += db4;
    }
    if (g4 == g) {
#pragma unroll
      for (int n = 0; n < L::NP; ++n) {
        const int p = L::PAIRS >= T ? tid + n * T : tid % L::PAIRS;
        const int i = p / NQ, j0 = (p - i * NQ) * VJ;
#pragma unroll
        for (int v = 0; v < VJ; ++v) pr[L::PW4 + i * CS + j0 + v] += dW4[n][v];
      }
    }
    __syncthreads();
  }
  // dA1 and dc1: every thread holds a share; warps, then the warps in order
  float red[12];
#pragma unroll
  for (int v = 0; v < 12; ++v) {
    red[v] = v < 9 ? dA1[v] : dc1[v - 9];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) red[v] += __shfl_xor_sync(0xffffffffu, red[v], o);
  }
  if (tid % 32 == 0) {
#pragma unroll
    for (int v = 0; v < 12; ++v) wred[(tid / 32) * 12 + v] = red[v];
  }
  __syncthreads();
  if (tid < 12) {
    float t = 0.f;
    for (int w = 0; w < T / 32; ++w) t += wred[w * 12 + tid];
    pr[tid < 9 ? L::PA1 + tid : L::PC1 + tid - 9] = t;
  }
  __syncthreads();
  float* out = dparams + (long long)blockIdx.x * L::PROW;
  for (int e = tid; e < L::PROW; e += T) out[e] = pr[e];
}

// ---- launches ------------------------------------------------------------

// the geometry the wrapper's plan gives: T threads, whole rows for each of
// the backward's channel groups, kc slots a chunk, enough shared memory
template <int CS>
bool bad_geometry(int grid, int threads, int R, int k, int kc, int smem,
                  int need_floats, bool whole_groups) {
  using L = Tiling<CS>;
  return threads != L::T || grid < 1 || R < 1 || k < 1 || kc < 1 || kc > k ||
         (whole_groups && R % L::G6) || smem < 4 * need_floats ||
         smem > kSmemLimit;
}

template <class Kernel>
cudaError_t configure_once(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) configured = true;
  return e;
}

template <int CS, class E>
int launch_fwd(const void* q, const void* kv, const float* rel,
               const int32_t* li, const int32_t* starts, const Params& P,
               void* out, float* stats, long long rows, int m, int k,
               int tile, int w_sz, int grid, int threads, int R, int kc,
               int smem, cudaStream_t stream) {
  if (bad_geometry<CS>(grid, threads, R, k, kc, smem,
                       fwd_smem_floats<CS>(R, k, kc), false))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t e = configure_once(pt_attn_fwd_kernel<CS, E>, configured);
  if (e != cudaSuccess) return (int)e;
  pt_attn_fwd_kernel<CS, E><<<grid, threads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(kv), rel, li, starts, P,
      static_cast<E*>(out), stats, rows, m, k, tile, w_sz, R, kc);
  return (int)cudaGetLastError();
}

template <int CS, class E>
int launch_bwd(const void* q, const void* kv, const float* rel,
               const int32_t* li, const int32_t* starts, const Params& P,
               const void* gout, float* dq, float* dkv, float* dparams,
               long long rows, int m, int k, int tile, int w_sz, int grid,
               int threads, int R, int kc, int smem, cudaStream_t stream) {
  if (bad_geometry<CS>(grid, threads, R, k, kc, smem,
                       bwd_smem_floats<CS>(R, k, kc), true))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t e = configure_once(pt_attn_bwd_kernel<CS, E>, configured);
  if (e != cudaSuccess) return (int)e;
  pt_attn_bwd_kernel<CS, E><<<grid, threads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(kv), rel, li, starts, P,
      static_cast<const E*>(gout), dq, dkv, dparams, rows, m, k, tile, w_sz, R,
      kc);
  return (int)cudaGetLastError();
}

Params params_of(const float* const* p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5],
                p[6], p[7], p[8], p[9], p[10], p[11]};
}

#define PT_ATTN_WIDTHS(X) X(2) X(4) X(8) X(16) X(32) X(64)

template <class E>
int fwd_entry(const void* q, const void* kv, const float* rel,
              const int32_t* li, const int32_t* starts, const Params& P,
              void* out, float* stats, long long rows, int m, int k, int c,
              int tile, int width, int blocks, int threads, int rows_a_tile,
              int slots_a_chunk, int smem, cudaStream_t stream) {
  switch (c) {
#define PT_ATTN_FWD_CASE(CS_)                                                   \
  case CS_ * SHARES:                                                            \
    return launch_fwd<CS_, E>(q, kv, rel, li, starts, P, out, stats, rows, m, k, \
                              tile, width * tile, blocks, threads, rows_a_tile,  \
                              slots_a_chunk, smem, stream);
    PT_ATTN_WIDTHS(PT_ATTN_FWD_CASE)
#undef PT_ATTN_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class E>
int bwd_entry(const void* q, const void* kv, const float* rel,
              const int32_t* li, const int32_t* starts, const Params& P,
              const void* gout, float* dq, float* dkv, float* dparams,
              long long rows, int m, int k, int c, int tile, int width,
              int blocks, int threads, int rows_a_tile, int slots_a_chunk,
              int smem, cudaStream_t stream) {
  switch (c) {
#define PT_ATTN_BWD_CASE(CS_)                                                    \
  case CS_ * SHARES:                                                             \
    return launch_bwd<CS_, E>(q, kv, rel, li, starts, P, gout, dq, dkv, dparams, \
                              rows, m, k, tile, width * tile, blocks, threads,   \
                              rows_a_tile, slots_a_chunk, smem, stream);
    PT_ATTN_WIDTHS(PT_ATTN_BWD_CASE)
#undef PT_ATTN_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, M, C], kv [B, M, 2C] of elem_bytes bytes an element (4: float32, 2:
// bfloat16), rel [B, M, K, 3] f32; li [B, M, K] int32 window-relative;
// starts [M / tile] int32 (tiles); params: 12 f32 pointers; out [B, M, C]
// of q's element; stats [blocks, 2C + 2CS] f32: one partial row of the sums
// of w_pre, w_pre^2, bvec, bvec^2 a block, summed by the caller. blocks,
// threads, rows_a_tile, slots_a_chunk and smem come from
// ops/cuda/pt_attn.py::fwd_plan: a block takes tiles of rows_a_tile query
// rows, every slot of them, slots_a_chunk slots of each row at a time, with
// smem dynamic shared bytes (at least fwd_smem_floats floats).
extern "C" int cbl_pt_attn_fwd(const void* q, const void* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               void* out, float* stats, int b, int m, int k,
                               int c, int tile, int width, int blocks,
                               int threads, int rows_a_tile, int slots_a_chunk,
                               int smem, int elem_bytes, void* stream) {
  const Params P = params_of(params);
  const long long rows = (long long)b * m;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return fwd_entry<float>(q, kv, rel, li, starts, P, out, stats, rows, m, k,
                            c, tile, width, blocks, threads, rows_a_tile,
                            slots_a_chunk, smem, s);
  if (elem_bytes == 2)
    return fwd_entry<__nv_bfloat16>(q, kv, rel, li, starts, P, out, stats,
                                    rows, m, k, c, tile, width, blocks,
                                    threads, rows_a_tile, slots_a_chunk, smem,
                                    s);
  return (int)cudaErrorInvalidValue;
}

// As the forward, plus gout [B, M, C] of q's element; dq [B, M, C] f32
// written, dkv [B, M, 2C] f32 zeroed by the caller and added to; dparams
// [blocks, prow]: one packed partial row of the parameter gradients a block
// (dA1 9 | dc1 3 | dW2 3C | db2 C | dg1 C | dh1 C | dW3 C*CS | db3 CS | dg2
// CS | dh2 CS | dW4 CS*CS | db4 CS), summed by the caller. The geometry
// comes from ops/cuda/pt_attn.py::bwd_plan (rows_a_tile a multiple of
// threads / C; smem at least bwd_smem_floats floats).
extern "C" int cbl_pt_attn_bwd(const void* q, const void* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               const void* gout, float* dq, float* dkv,
                               float* dparams, int b, int m, int k, int c,
                               int tile, int width, int blocks, int threads,
                               int rows_a_tile, int slots_a_chunk, int smem,
                               int elem_bytes, void* stream) {
  const Params P = params_of(params);
  const long long rows = (long long)b * m;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return bwd_entry<float>(q, kv, rel, li, starts, P, gout, dq, dkv, dparams,
                            rows, m, k, c, tile, width, blocks, threads,
                            rows_a_tile, slots_a_chunk, smem, s);
  if (elem_bytes == 2)
    return bwd_entry<__nv_bfloat16>(q, kv, rel, li, starts, P, gout, dq, dkv,
                                    dparams, rows, m, k, c, tile, width,
                                    blocks, threads, rows_a_tile,
                                    slots_a_chunk, smem, s);
  return (int)cudaErrorInvalidValue;
}
