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
// Forward (pt_attn_fwd_kernel): one group of C threads per row, thread c
// owning channel c; 256 / C rows per block (one at C = 512); a block walks
// rows with a grid stride. The 12 folded tower arrays live in shared memory
// (W3 [C, CS] and W4 [CS, CS] with rows padded to CS + 1 floats against bank
// conflicts;
// 163 KB at C = 512). The product r1 . W3 is split over the group: thread
// (p, j) = (c / CS, c % CS) sums CS terms of output j, and the 8 partials
// are added in a fixed order. Up to the last ReLU input every product and
// sum is rounded separately (no fused multiply-add) in the order of the
// plain version, ops/cuda/pt_attn.py::_terms, so the two agree bit for bit
// there and take the same side of every ReLU kink; a flipped kink would
// move one slot's whole gradient. The softmax over slots is online (running
// max, denominator and numerator in registers).
//
// Backward (pt_attn_bwd_kernel): tiles of slot-rows. A block takes R query
// rows and all K slots of each (NS = R K slot-rows, about 8192 / C of them
// with C channels each: 256 at C = 32, 16 at C = 512; the geometry comes
// from ops/cuda/pt_attn.py::bwd_plan) and walks tiles with a grid stride.
// Per tile, seven phases separated by block barriers (not three to five a
// slot): the forward is recomputed once for all NS slot-rows and each row's
// K scores w4 stay in shared memory, so the softmax's max, denominator and
// S = sum att * datt come from them directly (the old kernel's first pass,
// which only recomputed the forward for the normaliser, is gone). The
// products run as small matrix products on the CUDA cores from operands in
// shared memory: bvec = r1 W3 (a thread computes 4 outputs of a slot-row,
// one W3 vector serving 4 multiply-adds), w4 = r2 W4, dr2 = dw4 W4^T,
// dW4 += r2^T dw4, and, with thread (c, group) owning channel c over its
// group's rows, 4 slot-rows at a time (2 at C = 512, where dW3 takes 64
// registers a thread), dr1 = dbv W3^T and dW3 += r1^T dbv (one W3 vector
// and 4 dbv vectors serve 32 multiply-adds). W3 and W4 rows are padded to
// an odd number of float4s, so threads of consecutive rows read distinct
// bank groups. The tile's q and g rows are read once into shared memory, so
// the gathers of kv are the only global reads per slot-row; below C = 512
// the tile also keeps w_pre there, so the last phase reads no global memory
// (at C = 512, W3 alone takes 136 KB, and w_pre is recomputed from kv, q
// and the PE tower as the forward rounds it). Up to the last ReLU input every value is
// rounded as the plain version rounds it (the PE tower, w_pre and bn1's
// affine term by term; bvec as the shares' partials of CS terms each in
// order, then the shares in order, no fused multiply-add; bn2's affine), so
// the recompute
// takes the same side of every ReLU kink as the forward kernel and the
// plain version; after it (w4 and every backward product) any order and
// FMA. No tensor cores: r1 W3 must round as above, TF32 in the backward
// products would risk the check at 1e-4 of scale, and the products were not
// what separated the old kernel from its bound (serial slots and barriers
// were). dq is a register sum over each row's slots; dk|dv rows are
// scatter-added onto the support rows with float4 atomicAdd, 4 channels of
// 4 lanes gathered by shuffle (their last bits vary from run to run). The
// 12 parameter gradients stay in registers across tiles (thread (c, group)
// owns row c of dW3 and its channel's dW2, db2, dg1, dh1; the others split
// dW4 and the weight-channel vectors) and are summed into one packed
// partial row per block in a fixed group order; the caller sums the rows
// (deterministic for a given grid). What holds it back now is latency, not
// operations: with 16 warps an SM and a barrier between phases, P6's
// per-slot-row work takes 35-40% of a tile and P1's gathers up to a third
// (PERF.md; scripts/diag_torch_kernels.py clocks).
//
// Bound: at the flagship widths the forward moves ~3 floats per (row,
// channel) of q, kv and out plus K * 4 words of rel and li per row, and does
// about 2 (3C + C*CS + CS^2) + 10 C FP32 operations per slot; the level-0
// and level-4 layers are operation-bound on the CUDA cores. The backward
// recomputes the forward and about doubles it: operation-bound at every
// width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHARES = 8;
constexpr float NEG = -1e9f;  // the masked score of a shadow slot

struct Params {  // the 12 folded arrays, row-major float32
  const float *a1, *c1, *w2, *b2, *g1, *h1, *w3, *b3, *g2, *h2, *w4, *b4;
};

template <int CS>
struct Lay {
  static constexpr int C = CS * SHARES;
  static constexpr int WS = CS + 1;  // padded row stride of W3 and W4
  // shared image of the parameters
  static constexpr int A1 = 0, C1 = 9, W2 = 12, B2 = W2 + 3 * C, G1 = B2 + C,
                       H1 = G1 + C, W3 = H1 + C, B3 = W3 + C * WS,
                       G2 = B3 + CS, H2 = G2 + CS, W4 = H2 + CS,
                       B4 = W4 + CS * WS, PARAMS = B4 + CS;
  // per-row-group scratch
  static constexpr int R1 = 0, GV = C, PART = 2 * C, R2 = 3 * C,
                       DW4 = 3 * C + CS, DBV = 3 * C + 2 * CS,
                       SCRATCH = 3 * C + 3 * CS;
};

template <int CS>
__device__ void load_params(float* sp, const Params& P) {
  using L = Lay<CS>;
  constexpr int C = L::C;
  for (int i = threadIdx.x; i < L::PARAMS; i += blockDim.x) {
    float v;
    if (i < L::C1) v = P.a1[i];
    else if (i < L::W2) v = P.c1[i - L::C1];
    else if (i < L::B2) v = P.w2[i - L::W2];
    else if (i < L::G1) v = P.b2[i - L::B2];
    else if (i < L::H1) v = P.g1[i - L::G1];
    else if (i < L::W3) v = P.h1[i - L::H1];
    else if (i < L::B3) {
      const int e = i - L::W3, r = e / L::WS, col = e - r * L::WS;
      v = col < CS ? P.w3[r * CS + col] : 0.f;
    } else if (i < L::G2) v = P.b3[i - L::B3];
    else if (i < L::H2) v = P.g2[i - L::G2];
    else if (i < L::W4) v = P.h2[i - L::H2];
    else if (i < L::B4) {
      const int e = i - L::W4, r = e / L::WS, col = e - r * L::WS;
      v = col < CS ? P.w4[r * CS + col] : 0.f;
    } else v = P.b4[i - L::B4];
    sp[i] = v;
  }
  (void)C;
}

// Everything one slot of one row computes up to its score w4; ends with the
// group's threads synchronised (three __syncthreads, which every thread of
// the block reaches).
struct Slot {
  bool valid;
  long long src;  // kv offset of the neighbour row (valid slots)
  float vv, pe, wpre, a, r1, w4;
  float rel[3], pe1[3], rpe[3];
  float bvec, cpre;  // weight channel c, threads c < CS only
  float dalpha;      // backward: sum over the shares of g * (v + pe)
};

template <int CS, bool BWD>
__device__ Slot slot_forward(const float* sp, float* scr, int c, bool active,
                             long long rk, long long kv_row0, float qc,
                             float gc, const float* __restrict__ kv,
                             const float* __restrict__ rel,
                             const int32_t* __restrict__ li, int w_sz) {
  using L = Lay<CS>;
  constexpr int C = L::C;
  const int j = c % CS, p = c / CS;
  Slot s;
  s.valid = false;
  s.src = 0;
  float kk = 0.f;
  s.vv = 0.f;
  s.rel[0] = s.rel[1] = s.rel[2] = 0.f;
  if (active) {
    const int l = li[rk];
    s.valid = l >= 0 && l < w_sz;
    if (s.valid) {
      s.src = (kv_row0 + l) * (2 * C);
      kk = kv[s.src + c];
      s.vv = kv[s.src + C + c];
    }
    s.rel[0] = rel[rk * 3];
    s.rel[1] = rel[rk * 3 + 1];
    s.rel[2] = rel[rk * 3 + 2];
  }
  // Every value up to the last ReLU input is rounded as the plain version
  // rounds it (one rounding per product and per sum, in its order: no
  // fused multiply-add), so both take the same side of each ReLU kink.
  s.pe = sp[L::B2 + c];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float v = sp[L::C1 + i];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      v = __fadd_rn(v, __fmul_rn(s.rel[r], sp[L::A1 + r * 3 + i]));
    s.pe1[i] = v;
    s.rpe[i] = fmaxf(v, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    s.pe = __fadd_rn(s.pe, __fmul_rn(s.rpe[i], sp[L::W2 + i * C + c]));
  s.wpre = __fadd_rn(__fsub_rn(kk, qc), s.pe);
  s.a = __fadd_rn(__fmul_rn(s.wpre, sp[L::G1 + c]), sp[L::H1 + c]);
  s.r1 = fmaxf(s.a, 0.f);
  scr[L::R1 + c] = s.r1;
  if (BWD) scr[L::GV + c] = gc * (s.vv + s.pe);
  __syncthreads();

  float part = 0.f;
#pragma unroll 8
  for (int i = 0; i < CS; ++i)
    part = __fadd_rn(part, __fmul_rn(scr[L::R1 + p * CS + i],
                                     sp[L::W3 + (p * CS + i) * L::WS + j]));
  scr[L::PART + c] = part;
  s.dalpha = 0.f;
  if (BWD) {
#pragma unroll
    for (int q = 0; q < SHARES; ++q) s.dalpha += scr[L::GV + q * CS + j];
  }
  __syncthreads();

  s.bvec = 0.f;
  s.cpre = 0.f;
  if (c < CS) {
    float bv = sp[L::B3 + c];
#pragma unroll
    for (int q = 0; q < SHARES; ++q) bv = __fadd_rn(bv, scr[L::PART + q * CS + c]);
    s.bvec = bv;
    s.cpre = __fadd_rn(__fmul_rn(bv, sp[L::G2 + c]), sp[L::H2 + c]);
    scr[L::R2 + c] = fmaxf(s.cpre, 0.f);
  }
  __syncthreads();

  float w4 = sp[L::B4 + j];
#pragma unroll 8
  for (int i = 0; i < CS; ++i) w4 += scr[L::R2 + i] * sp[L::W4 + i * L::WS + j];
  s.w4 = w4;
  return s;
}

template <int CS>
__global__ void __launch_bounds__(512)
pt_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                   const float* __restrict__ rel,
                   const int32_t* __restrict__ li,
                   const int32_t* __restrict__ starts, Params P,
                   float* __restrict__ out, float* __restrict__ stats,
                   long long rows, int m, int k, int tile, int w_sz) {
  using L = Lay<CS>;
  constexpr int C = L::C;
  extern __shared__ float smem[];
  float* sp = smem;
  const int rpb = blockDim.x / C;
  const int g = threadIdx.x / C, c = threadIdx.x - g * C;
  float* scr = smem + L::PARAMS + g * L::SCRATCH;
  load_params<CS>(sp, P);
  __syncthreads();

  float s1 = 0.f, s1q = 0.f, s2 = 0.f, s2q = 0.f;
  for (long long base = (long long)blockIdx.x * rpb; base < rows;
       base += (long long)gridDim.x * rpb) {
    const long long r = base + g;
    const bool active = r < rows;
    long long kv_row0 = 0;
    float qc = 0.f;
    if (active) {
      const long long bb = r / m;
      const int mq = (int)(r - bb * m);
      kv_row0 = bb * m + (long long)starts[mq / tile] * tile;
      qc = q[r * C + c];
    }
    float m_run = NEG, den = 0.f, num = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const Slot s = slot_forward<CS, false>(sp, scr, c, active, r * k + kk,
                                             kv_row0, qc, 0.f, kv, rel, li,
                                             w_sz);
      if (active) {
        s1 += s.wpre;
        s1q += s.wpre * s.wpre;
        if (c < CS) {
          s2 += s.bvec;
          s2q += s.bvec * s.bvec;
        }
      }
      const float av = s.valid ? s.w4 : NEG;
      const float m_new = fmaxf(m_run, av);
      const float sc = expf(m_run - m_new);
      const float e = s.valid ? expf(av - m_new) : 0.f;
      den = den * sc + e;
      num = num * sc + e * (s.vv + s.pe);
      m_run = m_new;
    }
    if (active) out[r * C + c] = num / den;
  }
  float* st = stats + ((long long)blockIdx.x * rpb + g) * (2 * C + 2 * CS);
  st[c] = s1;
  st[C + c] = s1q;
  if (c < CS) {
    st[2 * C + c] = s2;
    st[2 * C + CS + c] = s2q;
  }
}

// ---- backward: tiles of slot-rows ----------------------------------------

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

template <int CS>
struct BwdLay {
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
  static constexpr int RS = C + 1;  // row stride of the tile's r1
  // packed parameter-gradient row (the wrapper's order)
  static constexpr int PA1 = 0, PC1 = 9, PW2 = 12, PB2 = PW2 + 3 * C,
                       PG1 = PB2 + C, PH1 = PG1 + C, PW3 = PH1 + C,
                       PB3 = PW3 + C * CS, PG2 = PB3 + CS, PH2 = PG2 + CS,
                       PW4 = PH2 + CS, PB4 = PW4 + CS * CS, PROW = PB4 + CS;
  // owners of the accumulated gradients (groups of threads that split the
  // slot-rows and are summed in group order at the end):
  // channel-wise (dW3 rows, dW2, db2, dg1, dh1): thread (c, g6)
  static constexpr int G6 = T / C;
  // weight-channel-wise (db3, dg2, dh2, db4): thread (j, g5)
  static constexpr int G5 = T / CS;
  // dW4: (row, vector) pairs, NP a thread, or one pair a thread in G4 groups
  static constexpr int PAIRS = CS * NQ;
  static constexpr int NP = PAIRS >= T ? PAIRS / T : 1;
  static constexpr int G4 = PAIRS >= T ? 1 : T / PAIRS;
  static constexpr int GMAX = cmax(G6, cmax(G5, G4));
  // w_pre kept in shared memory, so that P6 reads no global memory (not at
  // C = 512: W3 alone takes 136 KB there)
  static constexpr bool STASH = CS <= 32;
  // slot-rows a P6 step (2 at C = 512, where dW3 holds 64 registers a thread)
  static constexpr int TS = CS >= 64 ? 2 : 4;
};

// dynamic shared floats of a backward block whose tiles hold rows x k
// slot-rows
template <int CS>
__host__ __device__ int bwd_smem_floats(int rows, int k) {
  using L = BwdLay<CS>;
  const int ns = rows * k;
  int tile = L::PARAMS + round4(ns * L::RS) + 6 * round4(ns * CS) +
             2 * round4(3 * ns) + round4(ns) + 2 * round4(rows * L::C);
  if (L::STASH) tile += round4(ns * L::RS);
  return cmax(tile, round4(L::PROW) + 12 * (L::T / 32));
}

template <int CS>
__device__ void load_params_bwd(float* sp, const Params& P) {
  using L = BwdLay<CS>;
  constexpr int C = L::C;
  for (int i = threadIdx.x; i < L::PARAMS; i += blockDim.x) {
    float v = 0.f;
    if (i < 9) v = P.a1[i];
    else if (i >= L::C1 && i < L::C1 + 3) v = P.c1[i - L::C1];
    else if (i >= L::W2 && i < L::B2) v = P.w2[i - L::W2];
    else if (i >= L::B2 && i < L::G1) v = P.b2[i - L::B2];
    else if (i >= L::G1 && i < L::H1) v = P.g1[i - L::G1];
    else if (i >= L::H1 && i < L::W3) v = P.h1[i - L::H1];
    else if (i >= L::W3 && i < L::B3) {
      const int e = i - L::W3, r = e / L::WS, col = e - r * L::WS;
      if (col < CS) v = P.w3[r * CS + col];
    } else if (i >= L::B3 && i < L::B3 + CS) v = P.b3[i - L::B3];
    else if (i >= L::G2 && i < L::G2 + CS) v = P.g2[i - L::G2];
    else if (i >= L::H2 && i < L::H2 + CS) v = P.h2[i - L::H2];
    else if (i >= L::B4 && i < L::B4 + CS) v = P.b4[i - L::B4];
    else if (i >= L::W4) {
      const int e = i - L::W4, r = e / L::WS, col = e - r * L::WS;
      if (col < CS) v = P.w4[r * CS + col];
    }
    sp[i] = v;
  }
  (void)C;
}

// A block takes tiles of R query rows x K slots (NS = R K slot-rows), one
// after another (a persistent grid), and runs each tile in seven phases
// separated by block barriers:
//   P0 each slot-row's support row (-1 shadow, -2 past the last row), rel
//      and the PE tower's first layer;
//   P1 r1 of every (slot-row, channel) and dalpha (thread (slot-row, j)
//      walks the 8 shares of weight channel j);
//   P2 bvec = r1 W3 + b3 rounded as the plain version rounds it (per output
//      the shares' partials of CS terms each in order, then the shares in
//      order, no FMA), then bn2's affine and r2;
//   P3 w4 = r2 W4 + b4;
//   P4 the softmax over each row's K stored scores (one pass: no recompute
//      for the normaliser), S = sum att dalpha, dw4 = att (dalpha - S);
//   P5 dr2 = dw4 W4^T, dbv, and dW4 += r2^T dw4;
//   P6 thread (c, g6): dr1 = dbv W3^T and dW3 += r1^T dbv over 4 slot-rows
//      at a time (one W3 vector and 4 dbv vectors serve 32 multiply-adds),
//      then the channel-wise backward: bn1, dq, dk|dv (atomics), the PE
//      tower.
// The parameter gradients stay in registers across tiles and are summed
// into one packed row per block at the end, in a fixed order.
template <int CS>
__global__ void __launch_bounds__(BwdLay<CS>::T, CS >= 64 ? 1 : 2)
    pt_attn_bwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ kv,
                       const float* __restrict__ rel,
                       const int32_t* __restrict__ li,
                       const int32_t* __restrict__ starts, Params P,
                       const float* __restrict__ gout, float* __restrict__ dq,
                       float* __restrict__ dkv, float* __restrict__ dparams,
                       long long rows, int m, int k, int tile, int w_sz,
                       int R) {
  using L = BwdLay<CS>;
  constexpr int C = L::C, T = L::T, VJ = L::VJ, NQ = L::NQ, WS = L::WS;
  using V = VecN<VJ>;
  using VT = typename V::type;
  extern __shared__ float4 bwd_shared[];
  float* sp = reinterpret_cast<float*>(bwd_shared);
  const int ns = R * k;
  float* R1 = sp + L::PARAMS;
  float* BV = R1 + round4(ns * L::RS);
  float* R2 = BV + round4(ns * CS);
  float* DW4 = R2 + round4(ns * CS);  // w4, then dw4
  float* ATT = DW4 + round4(ns * CS);
  float* DBV = ATT + round4(ns * CS);
  float* DAL = DBV + round4(ns * CS);
  float* REL = DAL + round4(ns * CS);
  float* PE1 = REL + round4(3 * ns);
  int* SRC = reinterpret_cast<int*>(PE1 + round4(3 * ns));
  float* QR = reinterpret_cast<float*>(SRC) + round4(ns);  // q of each row
  float* GR = QR + round4(R * C);                          // g of each row
  float* WP = GR + round4(R * C);                          // STASH: w_pre
  load_params_bwd<CS>(sp, P);
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
  const int n_tiles = (int)((rows + R - 1) / R);
  for (int tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int r0 = tl * R;
    __syncthreads();  // the parameters loaded; the last tile's arrays read
    // P0
    for (int s = tid; s < ns; s += T) {
      const int rr = s / k;
      const int row = r0 + rr;
      int src = -2;
      float rl[3] = {0.f, 0.f, 0.f};
      if (row < rows) {
        const long long rk = (long long)row * k + (s - rr * k);
        const int bb = row / m;
        const int l = li[rk];
        src = l >= 0 && l < w_sz ? bb * m + starts[(row - bb * m) / tile] * tile + l : -1;
#pragma unroll
        for (int r = 0; r < 3; ++r) rl[r] = rel[rk * 3 + r];
      }
      SRC[s] = src;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        REL[s * 3 + i] = rl[i];
        float v = sp[L::C1 + i];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          v = __fadd_rn(v, __fmul_rn(rl[r], sp[L::A1 + r * 3 + i]));
        PE1[s * 3 + i] = v;
      }
    }
    for (int e = tid; e < R * C; e += T) {  // the tile's q and g rows, once
      const int row = r0 + e / C;
      const bool act = row < rows;
      QR[e] = act ? q[(long long)r0 * C + e] : 0.f;
      GR[e] = act ? gout[(long long)r0 * C + e] : 0.f;
    }
    __syncthreads();
    // P1: r1 (rounded as the forward rounds it) and dalpha; two units'
    // gathers in flight at once
#pragma unroll 2
    for (int u = tid; u < ns * CS; u += T) {
      const int s = u / CS, j = u - s * CS;
      const int src = SRC[s];
      const int rr = s / k;
      float rp[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) rp[i] = fmaxf(PE1[s * 3 + i], 0.f);
      float dal = 0.f;
#pragma unroll
      for (int p = 0; p < SHARES; ++p) {
        const int c = p * CS + j;
        float pe = sp[L::B2 + c];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pe = __fadd_rn(pe, __fmul_rn(rp[i], sp[L::W2 + i * C + c]));
        float kk = 0.f, vv = 0.f;
        if (src >= 0) {
          kk = kv[(long long)src * (2 * C) + c];
          vv = kv[(long long)src * (2 * C) + C + c];
        }
        const float wpre = __fadd_rn(__fsub_rn(kk, QR[rr * C + c]), pe);
        const float a = __fadd_rn(__fmul_rn(wpre, sp[L::G1 + c]), sp[L::H1 + c]);
        R1[s * L::RS + c] = fmaxf(a, 0.f);
        if constexpr (L::STASH) WP[s * L::RS + c] = wpre;
        dal += GR[rr * C + c] * (vv + pe);
      }
      DAL[s * CS + j] = dal;
    }
    __syncthreads();
    // P2: bvec, in the plain version's order, bn2's affine and r2
    for (int u = tid; u < ns * NQ; u += T) {
      const int s = u / NQ, j0 = (u - s * NQ) * VJ;
      const float* r1 = R1 + s * L::RS;
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
        BV[s * CS + j] = acc[v];
        const float cpre = __fadd_rn(__fmul_rn(acc[v], sp[L::G2 + j]), sp[L::H2 + j]);
        R2[s * CS + j] = fmaxf(cpre, 0.f);
      }
    }
    __syncthreads();
    // P3: w4 = r2 W4 + b4 (after the last ReLU input: any order)
    for (int u = tid; u < ns * NQ; u += T) {
      const int s = u / NQ, j0 = (u - s * NQ) * VJ;
      float acc[VJ];
#pragma unroll
      for (int v = 0; v < VJ; ++v) acc[v] = sp[L::B4 + j0 + v];
#pragma unroll 8
      for (int i = 0; i < CS; ++i) {
        const float r = R2[s * CS + i];
        const VT w = *reinterpret_cast<const VT*>(sp + L::W4 + i * WS + j0);
#pragma unroll
        for (int v = 0; v < VJ; ++v) acc[v] = fmaf(r, V::at(w, v), acc[v]);
      }
#pragma unroll
      for (int v = 0; v < VJ; ++v) DW4[s * CS + j0 + v] = acc[v];
    }
    __syncthreads();
    // P4: softmax over each row's K scores; S; dw4
    for (int u = tid; u < R * CS; u += T) {
      const int rr = u / CS, j = u - rr * CS;  // j == j5
      const int s0 = rr * k;
      const bool act = r0 + rr < rows;
      float mx = NEG;
      for (int kk = 0; kk < k; ++kk)
        if (SRC[s0 + kk] >= 0) mx = fmaxf(mx, DW4[(s0 + kk) * CS + j]);
      float den = 0.f;
      for (int kk = 0; kk < k; ++kk) {
        const int s = s0 + kk;
        const float e = SRC[s] >= 0 ? expf(DW4[s * CS + j] - mx) : 0.f;
        ATT[s * CS + j] = e;
        den += e;
      }
      float S = 0.f;
      for (int kk = 0; kk < k; ++kk) {
        const int s = s0 + kk;
        const float att = act ? ATT[s * CS + j] / den : 0.f;
        ATT[s * CS + j] = att;
        S += att * DAL[s * CS + j];
      }
      for (int kk = 0; kk < k; ++kk) {
        const int s = s0 + kk;
        const float dw4 = ATT[s * CS + j] * (DAL[s * CS + j] - S);
        DW4[s * CS + j] = dw4;
        db4 += dw4;
      }
    }
    __syncthreads();
    // P5: dr2 = dw4 W4^T, dbv and the weight-channel-wise gradients
    for (int u = tid; u < ns * CS; u += T) {
      const int s = u / CS, i = u - s * CS;  // i == j5
      float dr2 = 0.f;
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        const VT d = *reinterpret_cast<const VT*>(DW4 + s * CS + qq * VJ);
        const VT w = *reinterpret_cast<const VT*>(sp + L::W4 + i * WS + qq * VJ);
#pragma unroll
        for (int v = 0; v < VJ; ++v) dr2 = fmaf(V::at(d, v), V::at(w, v), dr2);
      }
      const float dcp = R2[s * CS + i] > 0.f ? dr2 : 0.f;  // cpre > 0
      dg2 += dcp * BV[s * CS + i];
      dh2 += dcp;
      const float dbv = dcp * sp[L::G2 + i];
      db3 += dbv;
      DBV[s * CS + i] = dbv;
    }
    // dW4 += r2^T dw4
#pragma unroll
    for (int n = 0; n < L::NP; ++n) {
      const int pr = L::PAIRS >= T ? tid + n * T : tid % L::PAIRS;
      const int i = pr / NQ, j0 = (pr - i * NQ) * VJ;
      for (int s = g4; s < ns; s += L::G4) {
        const float r = R2[s * CS + i];
        const VT d = *reinterpret_cast<const VT*>(DW4 + s * CS + j0);
#pragma unroll
        for (int v = 0; v < VJ; ++v) dW4[n][v] = fmaf(r, V::at(d, v), dW4[n][v]);
      }
    }
    __syncthreads();
    // P6: thread (c6, g6) over its rows' slot-rows, TS at a time; every lane
    // of a warp takes the same steps (the groups of a warp have equal
    // ranges), so the vector atomics' shuffles are whole
    const int c = c6;
    for (int rr = rb6; rr < re6; ++rr) {
      const int row = r0 + rr;
      const bool act = row < rows;
      const float gc = GR[rr * C + c], qc = QR[rr * C + c];
      float dqc = 0.f;
      for (int k0 = 0; k0 < k; k0 += L::TS) {
        const int s0 = rr * k + k0;
        float dr1[L::TS], r1v[L::TS];
#pragma unroll
        for (int u = 0; u < L::TS; ++u) {
          dr1[u] = 0.f;
          r1v[u] = k0 + u < k ? R1[(s0 + u) * L::RS + c] : 0.f;
        }
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          const VT w = *reinterpret_cast<const VT*>(sp + L::W3 + c * WS + qq * VJ);
#pragma unroll
          for (int u = 0; u < L::TS; ++u) {
            if (k0 + u >= k) continue;
            const VT d = *reinterpret_cast<const VT*>(DBV + (s0 + u) * CS + qq * VJ);
#pragma unroll
            for (int v = 0; v < VJ; ++v) {
              dr1[u] = fmaf(V::at(d, v), V::at(w, v), dr1[u]);
              dW3[qq * VJ + v] = fmaf(r1v[u], V::at(d, v), dW3[qq * VJ + v]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < L::TS; ++u) {
          if (k0 + u >= k) continue;
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
            wpre = WP[s * L::RS + c];
          } else {
            float pe = b2c;
#pragma unroll
            for (int i = 0; i < 3; ++i) pe = __fadd_rn(pe, __fmul_rn(fmaxf(pe1[i], 0.f), w2c[i]));
            const float kk = src >= 0 ? kv[(long long)src * (2 * C) + c] : 0.f;
            wpre = __fadd_rn(__fsub_rn(kk, qc), pe);
          }
          const float da = act && r1v[u] > 0.f ? dr1[u] : 0.f;  // a > 0
          dg1 += da * wpre;
          dh1 += da;
          const float dwpre = da * g1c;
          dqc -= dwpre;
          const float dvpe = ATT[s * CS + c % CS] * gc;
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
      if (act) dq[(long long)row * C + c] = dqc;
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

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have

template <int CS>
int launch_fwd(const float* q, const float* kv, const float* rel,
               const int32_t* li, const int32_t* starts, const Params& P,
               float* out, float* stats, long long rows, int m, int k,
               int tile, int w_sz, int grid, int rpb, cudaStream_t stream) {
  using L = Lay<CS>;
  const int threads = L::C * rpb;
  const size_t bytes = (size_t)(L::PARAMS + rpb * L::SCRATCH) * sizeof(float);
  cudaFuncSetAttribute(pt_attn_fwd_kernel<CS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  pt_attn_fwd_kernel<CS><<<grid, threads, bytes, stream>>>(
      q, kv, rel, li, starts, P, out, stats, rows, m, k, tile, w_sz);
  return (int)cudaGetLastError();
}

template <int CS>
int launch_bwd(const float* q, const float* kv, const float* rel,
               const int32_t* li, const int32_t* starts, const Params& P,
               const float* gout, float* dq, float* dkv, float* dparams,
               long long rows, int m, int k, int tile, int w_sz, int grid,
               int threads, int rows_a_tile, int smem, cudaStream_t stream) {
  using L = BwdLay<CS>;
  if (threads != L::T || grid < 1 || rows_a_tile < 1 ||
      rows_a_tile % L::G6 ||
      smem < 4 * bwd_smem_floats<CS>(rows_a_tile, k) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        pt_attn_bwd_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  pt_attn_bwd_kernel<CS><<<grid, L::T, smem, stream>>>(
      q, kv, rel, li, starts, P, gout, dq, dkv, dparams, rows, m, k, tile,
      w_sz, rows_a_tile);
  return (int)cudaGetLastError();
}

Params params_of(const float* const* p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5],
                p[6], p[7], p[8], p[9], p[10], p[11]};
}

}  // namespace

#define PT_ATTN_WIDTHS(X) X(2) X(4) X(8) X(16) X(32) X(64)

// q [B, M, C], kv [B, M, 2C], rel [B, M, K, 3] f32; li [B, M, K] int32
// window-relative; starts [M / tile] int32 (tiles); params: 12 pointers;
// out [B, M, C]; stats [grid * rpb, 2C + 2CS] per-group sums.
extern "C" int cbl_pt_attn_fwd(const float* q, const float* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               float* out, float* stats, int b, int m, int k,
                               int c, int tile, int width, int grid, int rpb,
                               void* stream) {
  const Params P = params_of(params);
  const long long rows = (long long)b * m;
  switch (c) {
#define PT_ATTN_FWD_CASE(CS_)                                                \
  case CS_ * SHARES:                                                         \
    return launch_fwd<CS_>(q, kv, rel, li, starts, P, out, stats, rows, m, k, \
                           tile, width * tile, grid, rpb,                    \
                           (cudaStream_t)stream);
    PT_ATTN_WIDTHS(PT_ATTN_FWD_CASE)
#undef PT_ATTN_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As the forward, plus gout [B, M, C]; dq [B, M, C] written, dkv [B, M, 2C]
// zeroed by the caller and added to; dparams [grid, prow]: one packed
// partial row of the parameter gradients a block (dA1 9 | dc1 3 | dW2 3C |
// db2 C | dg1 C | dh1 C | dW3 C*CS | db3 CS | dg2 CS | dh2 CS | dW4 CS*CS |
// db4 CS), summed by the caller. grid, threads, rows_a_tile and smem come
// from ops/cuda/pt_attn.py::bwd_plan: a block takes tiles of rows_a_tile
// query rows (a multiple of threads / C), every slot of them, with smem
// dynamic shared bytes (at least bwd_smem_floats floats).
extern "C" int cbl_pt_attn_bwd(const float* q, const float* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               const float* gout, float* dq, float* dkv,
                               float* dparams, int b, int m, int k, int c,
                               int tile, int width, int grid, int threads,
                               int rows_a_tile, int smem, void* stream) {
  const Params P = params_of(params);
  const long long rows = (long long)b * m;
  switch (c) {
#define PT_ATTN_BWD_CASE(CS_)                                                 \
  case CS_ * SHARES:                                                          \
    return launch_bwd<CS_>(q, kv, rel, li, starts, P, gout, dq, dkv, dparams, \
                           rows, m, k, tile, width * tile, grid, threads,     \
                           rows_a_tile, smem, (cudaStream_t)stream);
    PT_ATTN_WIDTHS(PT_ATTN_BWD_CASE)
#undef PT_ATTN_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
