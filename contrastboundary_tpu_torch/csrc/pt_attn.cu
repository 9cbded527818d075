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
// Layout: one group of C threads per row, thread c owning channel c;
// 256 / C rows per block (one at C = 512); a block walks rows with a grid
// stride. The 12 folded tower arrays live in shared memory (W3 [C, CS] and
// W4 [CS, CS] with rows padded to CS + 1 floats against bank conflicts;
// 163 KB at C = 512). The product r1 . W3 is split over the group: thread
// (p, j) = (c / CS, c % CS) sums CS terms of output j, and the 8 partials
// are added in a fixed order. Up to the last ReLU input every product and
// sum is rounded separately (no fused multiply-add) in the order of the
// plain version, ops/cuda/pt_attn.py::_terms, so the two agree bit for bit
// there and take the same side of every ReLU kink; a flipped kink would
// move one slot's whole gradient. The softmax over slots is online (running
// max, denominator and numerator in registers).
//
// Backward: two recompute passes over a row's slots. Pass 1 gives the
// softmax max, denominator and S = sum_k att_k * datt_k (online, rescaled
// with the max); pass 2 recomputes each slot, forms dw4 = att (datt - S)
// and d(v + pe) = att * g, and runs the tower backward. dq is a register
// sum; dk|dv rows are scatter-added onto the support rows with atomicAdd
// (so their last bits vary from run to run). The 12 parameter gradients are
// sums over B * M * K slots: each thread keeps its share in registers
// (thread c owns row c of dW3, its channel of dW2, db2, dg1, dh1, ...), and
// each row group writes one packed partial row; the caller sums the rows
// (deterministic for a given grid).
//
// Bound: at the flagship widths the forward moves ~3 floats per (row,
// channel) of q, kv and out plus K * 4 words of rel and li per row, and does
// about 2 (3C + C*CS + CS^2) + 10 C FP32 operations per slot; the level-0
// and level-4 layers are operation-bound on the CUDA cores.
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
  // packed parameter-gradient row
  static constexpr int PA1 = 0, PC1 = 9, PW2 = 12, PB2 = PW2 + 3 * C,
                       PG1 = PB2 + C, PH1 = PG1 + C, PW3 = PH1 + C,
                       PB3 = PW3 + C * CS, PG2 = PB3 + CS, PH2 = PG2 + CS,
                       PW4 = PH2 + CS, PB4 = PW4 + CS * CS, PROW = PB4 + CS;
  static constexpr int NW4 = (CS * CS + C - 1) / C;  // dW4 entries a thread
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

template <int CS>
__global__ void __launch_bounds__(512)
pt_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                   const float* __restrict__ rel,
                   const int32_t* __restrict__ li,
                   const int32_t* __restrict__ starts, Params P,
                   const float* __restrict__ gout, float* __restrict__ dq,
                   float* __restrict__ dkv, float* __restrict__ dparams,
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

  float dW3[CS], dW4[L::NW4];
#pragma unroll
  for (int i = 0; i < CS; ++i) dW3[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::NW4; ++i) dW4[i] = 0.f;
  float dW2[3] = {0.f, 0.f, 0.f}, dA1[9], dc1[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) dA1[i] = 0.f;
  float db2 = 0.f, dg1 = 0.f, dh1 = 0.f;
  float db3 = 0.f, dg2 = 0.f, dh2 = 0.f, db4 = 0.f;  // threads c < CS

  for (long long base = (long long)blockIdx.x * rpb; base < rows;
       base += (long long)gridDim.x * rpb) {
    const long long r = base + g;
    const bool active = r < rows;
    long long kv_row0 = 0;
    float qc = 0.f, gc = 0.f;
    if (active) {
      const long long bb = r / m;
      const int mq = (int)(r - bb * m);
      kv_row0 = bb * m + (long long)starts[mq / tile] * tile;
      qc = q[r * C + c];
      gc = gout[r * C + c];
    }
    // pass 1: softmax max and denominator, S = sum_k att_k * datt_k
    float m_run = NEG, den = 0.f, snum = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const Slot s = slot_forward<CS, true>(sp, scr, c, active, r * k + kk,
                                            kv_row0, qc, gc, kv, rel, li,
                                            w_sz);
      const float av = s.valid ? s.w4 : NEG;
      const float m_new = fmaxf(m_run, av);
      const float sc = expf(m_run - m_new);
      const float e = s.valid ? expf(av - m_new) : 0.f;
      den = den * sc + e;
      snum = snum * sc + e * s.dalpha;
      m_run = m_new;
    }
    if (!active) den = 1.f;
    const float S = snum / den;

    // pass 2: recompute, then the tower, PE and attention-path backward
    float dqc = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const Slot s = slot_forward<CS, true>(sp, scr, c, active, r * k + kk,
                                            kv_row0, qc, gc, kv, rel, li,
                                            w_sz);
      const float alpha = s.valid ? expf(s.w4 - m_run) / den : 0.f;
      const float dw4 = alpha * (s.dalpha - S);
      const float dvpe = alpha * gc;
      if (c < CS) scr[L::DW4 + c] = dw4;
      __syncthreads();

#pragma unroll
      for (int t = 0; t < L::NW4; ++t) {
        const int e = c + t * C;
        if (e < CS * CS)
          dW4[t] += scr[L::R2 + e / CS] * scr[L::DW4 + e % CS];
      }
      if (c < CS) {
        float dr2 = 0.f;
#pragma unroll 8
        for (int jj = 0; jj < CS; ++jj)
          dr2 += scr[L::DW4 + jj] * sp[L::W4 + c * L::WS + jj];
        const float dcp = s.cpre > 0.f ? dr2 : 0.f;
        dg2 += dcp * s.bvec;
        dh2 += dcp;
        const float dbv = dcp * sp[L::G2 + c];
        db3 += dbv;
        db4 += dw4;
        scr[L::DBV + c] = dbv;
      }
      __syncthreads();

      float dr1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        const float dbv = scr[L::DBV + jj];
        dW3[jj] += s.r1 * dbv;
        dr1 += dbv * sp[L::W3 + c * L::WS + jj];
      }
      const float da = s.a > 0.f ? dr1 : 0.f;
      dg1 += da * s.wpre;
      dh1 += da;
      const float dwpre = da * sp[L::G1 + c];
      dqc -= dwpre;
      if (s.valid) {
        atomicAdd(dkv + s.src + c, dwpre);
        atomicAdd(dkv + s.src + C + c, dvpe);
      }
      const float dpe = dwpre + dvpe;
      db2 += dpe;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dW2[i] += s.rpe[i] * dpe;
        const float dri = s.pe1[i] > 0.f ? dpe * sp[L::W2 + i * C + c] : 0.f;
        dc1[i] += dri;
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) dA1[rr * 3 + i] += s.rel[rr] * dri;
      }
    }
    if (active) dq[r * C + c] = dqc;
  }

  // one packed partial row per row group
  float* pr = dparams + ((long long)blockIdx.x * rpb + g) * L::PROW;
#pragma unroll
  for (int i = 0; i < 3; ++i) pr[L::PW2 + i * C + c] = dW2[i];
  pr[L::PB2 + c] = db2;
  pr[L::PG1 + c] = dg1;
  pr[L::PH1 + c] = dh1;
#pragma unroll
  for (int jj = 0; jj < CS; ++jj) pr[L::PW3 + c * CS + jj] = dW3[jj];
#pragma unroll
  for (int t = 0; t < L::NW4; ++t) {
    const int e = c + t * C;
    if (e < CS * CS) pr[L::PW4 + e] = dW4[t];
  }
  if (c < CS) {
    pr[L::PB3 + c] = db3;
    pr[L::PG2 + c] = dg2;
    pr[L::PH2 + c] = dh2;
    pr[L::PB4 + c] = db4;
  }
  // dA1 and dc1: every thread holds a share; summed over the group in
  // channel order through the scratch
  for (int v = 0; v < 12; ++v) {
    scr[L::R1 + c] = v < 9 ? dA1[v] : dc1[v - 9];
    __syncthreads();
    if (c == 0) {
      float t = 0.f;
      for (int i = 0; i < C; ++i) t += scr[L::R1 + i];
      pr[v < 9 ? L::PA1 + v : L::PC1 + v - 9] = t;
    }
    __syncthreads();
  }
}

template <int CS>
int launch(bool bwd, const float* q, const float* kv, const float* rel,
           const int32_t* li, const int32_t* starts, const Params& P,
           const float* gout, float* out, float* stats, float* dkv,
           float* dparams, long long rows, int m, int k, int tile, int w_sz,
           int grid, int rpb, cudaStream_t stream) {
  using L = Lay<CS>;
  const int threads = L::C * rpb;
  const size_t bytes = (size_t)(L::PARAMS + rpb * L::SCRATCH) * sizeof(float);
  if (bwd) {
    cudaFuncSetAttribute(pt_attn_bwd_kernel<CS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    pt_attn_bwd_kernel<CS><<<grid, threads, bytes, stream>>>(
        q, kv, rel, li, starts, P, gout, out, dkv, dparams, rows, m, k, tile,
        w_sz);
  } else {
    cudaFuncSetAttribute(pt_attn_fwd_kernel<CS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    pt_attn_fwd_kernel<CS><<<grid, threads, bytes, stream>>>(
        q, kv, rel, li, starts, P, out, stats, rows, m, k, tile, w_sz);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool bwd, const float* q, const float* kv, const float* rel,
             const int32_t* li, const int32_t* starts, const float* const* p,
             const float* gout, float* out, float* stats, float* dkv,
             float* dparams, int b, int m, int k, int c, int tile, int width,
             int grid, int rpb, void* stream) {
  const Params P{p[0], p[1], p[2], p[3], p[4], p[5],
                 p[6], p[7], p[8], p[9], p[10], p[11]};
  const long long rows = (long long)b * m;
  const int w_sz = width * tile;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
#define PT_ATTN_CASE(CS_)                                                   \
  case CS_ * SHARES:                                                        \
    return launch<CS_>(bwd, q, kv, rel, li, starts, P, gout, out, stats,    \
                       dkv, dparams, rows, m, k, tile, w_sz, grid, rpb, s);
    PT_ATTN_CASE(2)
    PT_ATTN_CASE(4)
    PT_ATTN_CASE(8)
    PT_ATTN_CASE(16)
    PT_ATTN_CASE(32)
    PT_ATTN_CASE(64)
#undef PT_ATTN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, M, C], kv [B, M, 2C], rel [B, M, K, 3] f32; li [B, M, K] int32
// window-relative; starts [M / tile] int32 (tiles); params: 12 pointers;
// out [B, M, C]; stats [grid * rpb, 2C + 2CS] per-group sums.
extern "C" int cbl_pt_attn_fwd(const float* q, const float* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               float* out, float* stats, int b, int m, int k,
                               int c, int tile, int width, int grid, int rpb,
                               void* stream) {
  return dispatch(false, q, kv, rel, li, starts, params, nullptr, out, stats,
                  nullptr, nullptr, b, m, k, c, tile, width, grid, rpb,
                  stream);
}

// As the forward, plus gout [B, M, C]; dq [B, M, C] written, dkv [B, M, 2C]
// zeroed by the caller and added to; dparams [grid * rpb, prow] per-group
// packed gradients (dA1 9 | dc1 3 | dW2 3C | db2 C | dg1 C | dh1 C |
// dW3 C*CS | db3 CS | dg2 CS | dh2 CS | dW4 CS*CS | db4 CS).
extern "C" int cbl_pt_attn_bwd(const float* q, const float* kv,
                               const float* rel, const int32_t* li,
                               const int32_t* starts, const float* const* params,
                               const float* gout, float* dq, float* dkv,
                               float* dparams, int b, int m, int k, int c,
                               int tile, int width, int grid, int rpb,
                               void* stream) {
  return dispatch(true, q, kv, rel, li, starts, params, gout, dq, nullptr, dkv,
                  dparams, b, m, k, c, tile, width, grid, rpb, stream);
}
