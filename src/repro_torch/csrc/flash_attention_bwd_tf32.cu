// Backward of the float32 prefill attention on Hopper's tensor cores
// (sm_90a), for training: dq, dk and dv of
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i when causal (sq == skv), over all j otherwise, in
// error-compensated TF32 (3xTF32) on mma.sync, as the forward
// (flash_attention_tf32.cu) computes it.
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (autograd of src/repro/kernels/ref.py attention_ref) and has no Pallas
// backward. It is the backward of flash_attention_tf32.cu, whose training
// entry (flash_attention_tf32_lse) saves each row's log-sum-exp (lse), so P
// is recomputed here without a second softmax pass.
//
// Bound on the H100: operations. The essential work is five products of
// 2 d flops per visible (query, key) pair (Q K^T, dO V^T, P^T dO, dS^T Q,
// dS K), each done three times over (lo.hi + hi.lo + hi.hi) at 495
// TFLOP/s dense TF32; q, k, v, o, dO, lse in and dq, dk, dv out cross HBM
// once. At qwen3-1.7b's step shape (q [2, 16, 4096, 128], causal) that is
// 2.08 ms. The kernels issue seven products: the dK/dV kernel four (S^T,
// dP^T, P^T dO, dS^T Q), the dQ kernel three (S and dP again, dS K); at
// d = 256 fifteen, since several warps compute the same S^T and dP^T (S
// and dP; below).
//
// Precision (tests/test_torch_tf32_bwd_split.py emulates it): every
// operand, P and dS included, is split into hi = cvt.rna.tf32(x) and lo =
// x - hi and each product is lo.hi + hi.lo + hi.hi, the small products
// first (tf32x3.cuh, the forward's split and products bit for bit). A
// tensor core adds into its accumulator rounding toward zero, so a long
// sum through it drifts: every two d steps of S^T, dP^T, S and dP go into
// a fresh fragment added to the f32 value (round to nearest), and so does
// each query tile's P^T dO and dS^T Q before it is added to dV or dK, and
// each key tile's dS K before it is added to dQ. dK and dV sum over every
// query row of every head of the GQA group (16 x 4096 terms a value at
// 16:1), so this matters more here than in the forward.
//
// Design (mma.sync.m16n8k8.tf32 for every product, not wgmma: wgmma takes
// TF32 operands K-major only, and P^T dO, dS^T Q and dS K read one operand
// MN-major; CUDA cores do the splits, exp2 and dS):
// - bwd_pre_kernel: D[row] = sum_d dO * O in f32, one warp a row, float4
//   reads.
// - bwd_dkdv_kernel: a CTA owns BK keys of one (b, kv head), K and V staged
//   once; each warp owns 16 keys. Q, dO, lse (in log2 units) and D tiles of
//   BQ query rows stream through a cp.async ring of two stages (rows past s
//   zero-filled, lse = +inf, D = 0, so their P and dS are 0), over each
//   query head of the group in turn and, under causal, from the tile of the
//   CTA's first key; the key tiles are the grid's slowest dimension, so
//   under causal the longest run first. Per stage a warp computes S^T =
//   K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2 e - lse log2 e) and
//   dS^T = P^T (dP^T - D) in registers, then dV += P^T dO and dK += dS^T Q.
//   The S^T accumulator's fragment is P^T's A fragment with its query order
//   permuted (queries 2t and 2t + 1 of each 8 as k indices t and t + 4), so
//   P^T and dS^T never leave registers; dO's and Q's B fragments then read
//   rows 2t and 2t + 1. dK is written times the scale.
// - d = 256: dK and dV of 16 keys over all of d would take 256 registers a
//   thread, so the dK/dV kernel's warps w, w + 2, w + 4 and w + 6 own the
//   same 16 keys and a quarter of d each (64 registers of dK and dV), and
//   the dQ kernel's warps w and w + 4 own the same 16 rows and half of d
//   each (64 of dQ). Each warp computes S^T and dP^T (S and dP) over all
//   of d, so the kernels issue fifteen products where seven would do.
//   ptxas spilled 4 to 44 bytes in each arrangement with more registers
//   of accumulators a warp (d halves of dK/dV, dV and dK on two warps,
//   dQ on one warp; stages of 8 and 16, loops rolled or not, PERF.md).
// - bwd_dq_kernel: a CTA owns BQ rows of one (b, q head), Q and dO staged
//   once, each warp 16 rows; K and V tiles of BKQ keys stream through the
//   ring, under causal up to the CTA's last row, the longest q tiles first.
//   Per tile S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K (K's B
//   fragment rows 2t and 2t + 1, as the forward reads V). Keys past s are
//   zero-filled and masked.
// - Shared memory: every tile is f32 with rows D + 4 floats apart, which
//   makes both reads conflict-free: a fragment of a row-major operand at
//   (row g, column t) and one of an MN-major operand at (row 2t, column g),
//   with 4-byte loads. Per CTA, with S = D + 4 floats a row:
//     dK/dV: K and V (2 BK S) and two stages of Q and dO (2 x 2 BQ S) and
//       lse, D (2 x 2 BQ):
//       d = 64: BK 64, BQ 32: 34,816 + 35,328 B;
//       d = 128: BK 64, BQ 16: 67,584 + 34,048 B;
//       d = 256: 8 warps (2 groups of 16 keys, 4 d parts), BK 32, BQ 8:
//         66,560 + 33,408 B.
//     dQ: Q and dO (2 BQ S) and two stages of K and V (2 x 2 BKQ S):
//       d = 64: BQ 64, BKQ 32: 34,816 + 34,816 B;
//       d = 128: BQ 64, BKQ 16: 67,584 + 33,792 B;
//       d = 256: 8 warps (4 groups of 16 rows, 2 d halves), BQ 64,
//         BKQ 8: 133,120 + 33,280 B.
// - Registers: dK and dV take 2 x 16 x DW / 32 f32 a thread, DW the
//   warp's d columns (64 registers at d = 64 and 256, 128 at d = 128), dQ
//   16 x its d columns / 32 (32, 64 and 64); the stage's P^T and dS^T hi
//   and lo fragments 16 BQ / 8. At d = 128 the dK/dV kernel keeps its loop
//   over d in KG-step groups rolled (unrolled, ptxas spilled 8 bytes;
//   rolled at d = 256 it ran about 15% slower). ptxas reports no spill in
//   any kernel.
// - No atomics and no split reductions: each output element is summed by
//   one thread in a fixed order, so every launch gives the same bits (a
//   resumed training run must reproduce its state byte for byte).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;
constexpr int KG = 2;   // d steps of S^T, dP^T, S, dP a fresh fragment
constexpr int NG = 4;   // d steps of dK, dV or dQ a group of fragments
constexpr float LOG2E = 1.4426950408889634f;

// lse in log2 units; a row with lse = -inf (no visible key) takes +inf,
// so its P is 0
__device__ __forceinline__ float lse2_of(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

// the A fragment at a (row g, column t of a row-major f32 tile) of one
// d step: rows g and g + 8, columns t and t + 4, split into hi and lo
template <int S>
__device__ __forceinline__ void a_frag(const float* a, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  split(a[0], h[0], l[0]);
  split(a[8 * S], h[1], l[1]);
  split(a[4], h[2], l[2]);
  split(a[8 * S + 4], h[3], l[3]);
}

// one mma3 of A (h, l) and the B fragment of two f32 values at x[0] and
// x[step]
__device__ __forceinline__ void mma3_at(float (&d)[4], const uint32_t (&h)[4],
                                        const uint32_t (&l)[4],
                                        const float* x, int step,
                                        bool fresh) {
  uint32_t bh0, bl0, bh1, bl1;
  split(x[0], bh0, bl0);
  split(x[step], bh1, bl1);
  mma3(d, h, l, bh0, bh1, bl0, bl1, fresh);
}

// an accumulator fragment's four values (x[e]: row g + 8 (e >> 1), column
// 2 t + (e & 1)) as the A fragment of the next product, hi and lo: its
// columns 2 t and 2 t + 1 become k indices t and t + 4
__device__ __forceinline__ void a_of_acc(const float (&x)[4],
                                         uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(x[0], h[0], l[0]);
  split(x[2], h[1], l[1]);
  split(x[1], h[2], l[2]);
  split(x[3], h[3], l[3]);
}

// rows ra and ra + 8 of NN accumulator fragments (d step n: columns
// 8 n + 2 t, + 1) times mul to a row-major [s][D] tile at p; rows past s
// not written
template <int D, int NN>
__device__ __forceinline__ void store_rows(float* p, const float (&acc)[NN][4],
                                           int ra, int s, int t, float mul) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = 8 * n + 2 * t;
    if (ra < s)
      *reinterpret_cast<float2*>(p + (int64_t)ra * D + col) =
          make_float2(acc[n][0] * mul, acc[n][1] * mul);
    if (ra + 8 < s)
      *reinterpret_cast<float2*>(p + (int64_t)(ra + 8) * D + col) =
          make_float2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// KG d steps from d step k0 of A0 B0^T and A1 B1^T into fresh fragments
// f0 and f1 (the two products interleaved): A's rows g and g + 8 at a
// (column t), B's row 8 j + g at b (column t), NJ 16 x 8 fragments. The k
// index t (t + 4) of d step kk is column 8 kk + t (+ 4); rows D + 4
// floats apart make every load conflict-free.
template <int NJ, int S>
__device__ __forceinline__ void d_steps(float (&f0)[NJ][4], const float* a0,
                                        const float* b0, float (&f1)[NJ][4],
                                        const float* a1, const float* b1,
                                        int k0) {
#pragma unroll
  for (int kk = k0; kk < k0 + KG; ++kk) {
    uint32_t h0[4], l0[4], h1[4], l1[4];
    a_frag<S>(a0 + 8 * kk, h0, l0);
    a_frag<S>(a1 + 8 * kk, h1, l1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma3_at(f0[j], h0, l0, b0 + 8 * (j * S + kk), 4, kk == k0);
      mma3_at(f1[j], h1, l1, b1 + 8 * (j * S + kk), 4, kk == k0);
    }
  }
}

// acc0 = A0 B0^T and acc1 = A1 B1^T over the D columns: the first KG d
// steps straight into acc, then each KG steps in fresh fragments added in
// f32 (d_steps). ROLLED keeps the groups a loop (ptxas otherwise spills
// the dK/dV kernel at d = 128, whose accumulators take 128 registers).
template <int D, int NJ, int S, bool ROLLED>
__device__ __forceinline__ void over_d2(float (&acc0)[NJ][4],
                                        const float* a0, const float* b0,
                                        float (&acc1)[NJ][4],
                                        const float* a1, const float* b1) {
  d_steps<NJ, S>(acc0, a0, b0, acc1, a1, b1, 0);
  auto group = [&](int k0) {
    float f0[NJ][4], f1[NJ][4];
    d_steps<NJ, S>(f0, a0, b0, f1, a1, b1, k0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[j][e] += f0[j][e];
        acc1[j][e] += f1[j][e];
      }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int k0 = KG; k0 < D / 8; k0 += KG) group(k0);
  } else {
#pragma unroll
    for (int k0 = KG; k0 < D / 8; k0 += KG) group(k0);
  }
}

// acc[n] += A B over a stage: A the stage's NJ hi and lo A fragments (k
// indices t and t + 4 of step j: rows 8 j + 2 t and 8 j + 2 t + 1 of B),
// B a row-major f32 tile read MN-major at b (row 2 t, column g): d step n
// is B's columns 8 n + g. The stage's products go into fresh fragments,
// NG d steps at a time, added to acc in f32. over_stage2 runs two such
// products interleaved.
template <int NN, int NJ, int S>
__device__ __forceinline__ void over_stage(float (&acc)[NN][4],
                                           const uint32_t (&hi)[NJ][4],
                                           const uint32_t (&lo)[NJ][4],
                                           const float* b) {
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float f[NG][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int nn = 0; nn < NG; ++nn)
        mma3_at(f[nn], hi[j], lo[j], b + 8 * (j * S + n0 + nn), S, j == 0);
#pragma unroll
    for (int nn = 0; nn < NG; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + nn][e] += f[nn][e];
  }
}

template <int NN, int NJ, int S>
__device__ __forceinline__ void over_stage2(
    float (&acc0)[NN][4], const uint32_t (&hi0)[NJ][4],
    const uint32_t (&lo0)[NJ][4], const float* b0, float (&acc1)[NN][4],
    const uint32_t (&hi1)[NJ][4], const uint32_t (&lo1)[NJ][4],
    const float* b1) {
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float f0[NG][4], f1[NG][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int nn = 0; nn < NG; ++nn) {
        const int at = 8 * (j * S + n0 + nn);
        mma3_at(f0[nn], hi0[j], lo0[j], b0 + at, S, j == 0);
        mma3_at(f1[nn], hi1[j], lo1[j], b1 + at, S, j == 0);
      }
#pragma unroll
    for (int nn = 0; nn < NG; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[n0 + nn][e] += f0[nn][e];
        acc1[n0 + nn][e] += f1[nn][e];
      }
  }
}

// ---- D = rowsum(dO * O) ----------------------------------------------------

__global__ void __launch_bounds__(256)
bwd_pre_kernel(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float4* op = reinterpret_cast<const float4*>(o + row * d);
  const float4* dp = reinterpret_cast<const float4*>(dout + row * d);
  float acc = 0.f;
  for (int i = lane; i < d / 4; i += 32) {
    const float4 a = op[i], b = dp[i];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- dK, dV --------------------------------------------------------------

// warps a CTA, query rows a stage, warps a 16-key group (each takes
// 1 / SPLIT of dK's and dV's d columns), and whether S^T and dP^T keep
// their loop over d rolled (over_d2)
template <int D>
struct KvCfg;
template <>
struct KvCfg<64> {
  static constexpr int NW = 4, BQ = 32, SPLIT = 1;
  static constexpr bool ROLLED = false;
};
template <>
struct KvCfg<128> {
  static constexpr int NW = 4, BQ = 16, SPLIT = 1;
  static constexpr bool ROLLED = true;
};
template <>
struct KvCfg<256> {
  static constexpr int NW = 8, BQ = 8, SPLIT = 4;
  static constexpr bool ROLLED = false;
};

template <int D>
struct KvGeo {
  static constexpr int NW = KvCfg<D>::NW, BQ = KvCfg<D>::BQ;
  static constexpr int SPLIT = KvCfg<D>::SPLIT, THREADS = 32 * NW;
  static constexpr int BK = 16 * NW / SPLIT;   // keys a CTA
  static constexpr int S = D + 4;              // row stride (floats)
  static constexpr int KV_FLOATS = BK * S;     // K or V
  static constexpr int ROW_FLOATS = BQ * S;    // a stage's Q or dO
  static constexpr int STAGE_FLOATS = 2 * ROW_FLOATS + 2 * BQ;  // + lse, D
  static constexpr int SMEM =
      (int)sizeof(float) * (2 * KV_FLOATS + STAGES * STAGE_FLOATS);
};

template <int D>
__global__ void __launch_bounds__(KvGeo<D>::THREADS, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int hq, int hkv, int s, int causal,
                float scale_log2, float scale) {
  using G = KvGeo<D>;
  constexpr int BQ = G::BQ, BK = G::BK, S = G::S, NT = G::THREADS;
  constexpr int DW = D / G::SPLIT;  // d columns of a warp's dK and dV
  constexpr int NJ = BQ / 8;        // query steps of 8 in a stage
  constexpr int NN = DW / 8;        // d steps of the warp's dK and dV
  constexpr int CPR = D / 4;        // 16-byte copies a row
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [BK][S]
  float* Vs = Ks + G::KV_FLOATS;      // [BK][S]
  float* ring = Vs + G::KV_FLOATS;    // [STAGES]: Q, dO [BQ][S], lse2, D [BQ]

  const int hk = blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // under causal the first tiles are the
  const int group = hq / hkv;      // longest: they start first
  const int64_t kv_off = ((int64_t)bi * hkv + hk) * s * D;
  const int64_t bh0 = (int64_t)bi * hq + hk * group;  // the group's 1st head
  // the walk: each query head of the group, over query tiles qt_begin ..
  // qt_end - 1 (under causal from the tile of the CTA's first key)
  const int qt_begin = causal ? k0 / BQ : 0, qt_end = (s + BQ - 1) / BQ;
  const int n_qt = qt_end - qt_begin, n_iter = group * n_qt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kgrp = warp % (G::NW / G::SPLIT);         // which 16 keys
  const int dc0 = (warp / (G::NW / G::SPLIT)) * DW;  // first d column
  const int kw = k0 + 16 * kgrp;                     // the first key

  // K and V (rows past s zero-filled) with stage 0: one copy group
  {
    const float* kp = k + kv_off;
    const float* vp = v + kv_off;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = k0 + r < s;
      const int64_t go = in ? (int64_t)(k0 + r) * D + col : 0;
      cp_async16(smem_addr(Ks + r * S + col), kp + go, in ? 16 : 0);
      cp_async16(smem_addr(Vs + r * S + col), vp + go, in ? 16 : 0);
    }
  }
  auto load_stage = [&](int it) {
    float* qs = ring + (it % STAGES) * G::STAGE_FLOATS;
    float* ds = qs + G::ROW_FLOATS;
    float* ls = ds + G::ROW_FLOATS;
    float* es = ls + BQ;
    const int hh = it / n_qt;
    const int q0 = (qt_begin + it - hh * n_qt) * BQ;
    const int64_t bh = bh0 + hh;
    const float* qp = q + bh * s * D;
    const float* dp = dout + bh * s * D;
    for (int c = tid; c < BQ * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = q0 + r < s;
      const int64_t go = in ? (int64_t)(q0 + r) * D + col : 0;
      cp_async16(smem_addr(qs + r * S + col), qp + go, in ? 16 : 0);
      cp_async16(smem_addr(ds + r * S + col), dp + go, in ? 16 : 0);
    }
    for (int r = tid; r < BQ; r += NT) {
      const int row = q0 + r;
      ls[r] = row < s ? lse2_of(lse[bh * s + row]) : CUDART_INF_F;
      es[r] = row < s ? delta[bh * s + row] : 0.f;
    }
  };
  if (n_iter > 0) load_stage(0);
  cp_async_commit();

  float dva[NN][4], dka[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;
  const float* ka = Ks + (16 * kgrp + g) * S + t;  // A rows g, g + 8
  const float* va = Vs + (16 * kgrp + g) * S + t;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();  // this thread's copies of stage it
    __syncthreads();     // everyone's, and stage it - 1 is done
    if (it + 1 < n_iter) load_stage(it + 1);
    cp_async_commit();
    const int q0 = (qt_begin + it % n_qt) * BQ;
    if (kw >= s || (causal && q0 + BQ - 1 < kw)) continue;  // nothing seen
    const float* qs = ring + (it % STAGES) * G::STAGE_FLOATS;
    const float* ds = qs + G::ROW_FLOATS;
    const float* ls = ds + G::ROW_FLOATS;
    const float* es = ls + BQ;

    // S^T = K Q^T, dP^T = V dO^T (16 keys x BQ queries)
    float st[NJ][4], dpt[NJ][4];
    over_d2<D, NJ, S, KvCfg<D>::ROLLED>(st, ka, qs + g * S + t, dpt, va,
                                        ds + g * S + t);

    // P^T and dS^T as A fragments, hi and lo; st[j][e] is (key kw + g +
    // (e < 2 ? 0 : 8), query q0 + 8 j + 2 t + (e & 1)), and the fragment's
    // k indices t and t + 4 are queries 2 t and 2 t + 1
    const bool mask = causal && q0 < kw + 15;  // a query before a key
    uint32_t ph[NJ][4], pl[NJ][4], sh[NJ][4], sl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(es + 8 * j + 2 * t);
      float p[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(st[j][e], scale_log2, -(e & 1 ? l2.y : l2.x)));
        if (mask) {
          const int key = kw + g + (e < 2 ? 0 : 8);
          if (key > q0 + 8 * j + 2 * t + (e & 1)) p[e] = 0.f;
        }
        x[e] = p[e] * (dpt[j][e] - (e & 1 ? d2.y : d2.x));
      }
      a_of_acc(p, ph[j], pl[j]);
      a_of_acc(x, sh[j], sl[j]);
    }

    // dV += P^T dO and dK += dS^T Q over the warp's DW columns (B: rows
    // 8 j + 2 t and 8 j + 2 t + 1, column dc0 + 8 n + g)
    over_stage2<NN, NJ, S>(dva, ph, pl, ds + 2 * t * S + dc0 + g,
                                  dka, sh, sl, qs + 2 * t * S + dc0 + g);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // rows kw + g and kw + g + 8, the warp's columns; dK times the scale
  store_rows<D>(dv + kv_off + dc0, dva, kw + g, s, t, 1.f);
  store_rows<D>(dk + kv_off + dc0, dka, kw + g, s, t, scale);
}

// ---- dQ --------------------------------------------------------------------

// warps a CTA, keys a stage, and warps a 16-row group (2: each takes half
// of dQ's d columns)
template <int D>
struct QCfg;
template <>
struct QCfg<64> {
  static constexpr int NW = 4, BKQ = 32, SPLIT = 1;
};
template <>
struct QCfg<128> {
  static constexpr int NW = 4, BKQ = 16, SPLIT = 1;
};
template <>
struct QCfg<256> {
  static constexpr int NW = 8, BKQ = 8, SPLIT = 2;
};

template <int D>
struct QGeo {
  static constexpr int NW = QCfg<D>::NW, BKQ = QCfg<D>::BKQ;
  static constexpr int SPLIT = QCfg<D>::SPLIT;
  static constexpr int BQ = 16 * NW / SPLIT, THREADS = 32 * NW;
  static constexpr int S = D + 4;
  static constexpr int ROW_FLOATS = BQ * S;    // Q or dO
  static constexpr int KEY_FLOATS = BKQ * S;   // a stage's K or V
  static constexpr int STAGE_FLOATS = 2 * KEY_FLOATS;
  static constexpr int SMEM =
      (int)sizeof(float) * (2 * ROW_FLOATS + STAGES * STAGE_FLOATS);
};

template <int D>
__global__ void __launch_bounds__(QGeo<D>::THREADS, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int hq, int hkv, int s, int causal,
              float scale_log2, float scale) {
  using G = QGeo<D>;
  constexpr int BQ = G::BQ, BKQ = G::BKQ, S = G::S, NT = G::THREADS;
  constexpr int NJ = BKQ / 8;   // key steps of 8 in a stage
  constexpr int NK = D / 8 / G::SPLIT;  // d steps of the warp's dQ
  constexpr int CPR = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BQ][S]
  float* Ds = Qs + G::ROW_FLOATS;      // [BQ][S] (dO)
  float* ring = Ds + G::ROW_FLOATS;    // [STAGES]: K, V [BKQ][S]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int64_t bh = (int64_t)bi * hq + h;
  const int64_t kv_off = ((int64_t)bi * hkv + h / (hq / hkv)) * s * D;
  const int kv_end = causal ? min(s, q0 + BQ) : s;
  const int n_tiles = (kv_end + BKQ - 1) / BKQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_tile = [&](int i) {
    float* ks = ring + (i % STAGES) * G::STAGE_FLOATS;
    float* vs = ks + G::KEY_FLOATS;
    const int kv0 = i * BKQ;
    for (int c = tid; c < BKQ * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = kv0 + r < s;
      const int64_t go = kv_off + (in ? (int64_t)(kv0 + r) * D + col : 0);
      cp_async16(smem_addr(ks + r * S + col), k + go, in ? 16 : 0);
      cp_async16(smem_addr(vs + r * S + col), v + go, in ? 16 : 0);
    }
  };
  // Q and dO with tile 0: one copy group
  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, col = (c - r * CPR) * 4;
    const bool in = q0 + r < s;
    const int64_t go = bh * s * D + (in ? (int64_t)(q0 + r) * D + col : 0);
    cp_async16(smem_addr(Qs + r * S + col), q + go, in ? 16 : 0);
    cp_async16(smem_addr(Ds + r * S + col), dout + go, in ? 16 : 0);
  }
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // this warp's rows: ra (fragment entries 0, 1) and rb = ra + 8 (2, 3),
  // and its first d column of dQ
  const int rgrp = warp % (G::NW / G::SPLIT);
  const int dc0 = (warp / (G::NW / G::SPLIT)) * (D / G::SPLIT);
  const int w0 = q0 + 16 * rgrp;
  const int ra = w0 + g, rb = ra + 8;
  const bool live = w0 < s;
  const int w_last = causal ? min(w0 + 15, s - 1) : s - 1;
  const float la = ra < s ? lse2_of(lse[bh * s + ra]) : CUDART_INF_F;
  const float lb = rb < s ? lse2_of(lse[bh * s + rb]) : CUDART_INF_F;
  const float da = ra < s ? delta[bh * s + ra] : 0.f;
  const float db = rb < s ? delta[bh * s + rb] : 0.f;
  const float* qa = Qs + (16 * rgrp + g) * S + t;   // A rows g, g + 8
  const float* oa = Ds + (16 * rgrp + g) * S + t;

  float dqa[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // this thread's copies of tile i
    __syncthreads();     // everyone's, and tile i - 1 is done
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    const int kb0 = i * BKQ;
    if (!live || kb0 > w_last) continue;  // no row of the warp sees a key
    const float* ks = ring + (i % STAGES) * G::STAGE_FLOATS;
    const float* vs = ks + G::KEY_FLOATS;

    // S = Q K^T, dP = dO V^T (16 rows x BKQ keys)
    float sc[NJ][4], dp[NJ][4];
    over_d2<D, NJ, S, false>(sc, qa, ks + g * S + t, dp, oa,
                             vs + g * S + t);

    // dS as A fragments, hi and lo; sc[j][e] is (row e < 2 ? ra : rb, key
    // kb0 + 8 j + 2 t + (e & 1)), the fragment's k indices t and t + 4
    // keys 2 t and 2 t + 1
    const bool mask = kb0 + BKQ > s || (causal && kb0 + BKQ - 1 > w0);
    uint32_t hi[NJ][4], lo[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[j][e], scale_log2, -(e < 2 ? la : lb)));
        if (mask) {
          const int key = kb0 + 8 * j + 2 * t + (e & 1);
          if (key >= s || (causal && key > (e < 2 ? ra : rb))) p = 0.f;
        }
        x[e] = p * (dp[j][e] - (e < 2 ? da : db));
      }
      a_of_acc(x, hi[j], lo[j]);
    }

    // dQ += dS K (B: K rows 8 j + 2 t and 8 j + 2 t + 1, column 8 n + g)
    over_stage<NK, NJ, S>(dqa, hi, lo, ks + 2 * t * S + dc0 + g);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  store_rows<D>(dq + bh * s * D + dc0, dqa, ra, s, t, scale);
}

// ---- host side ------------------------------------------------------------

template <int D>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv, int b,
                        int hq, int hkv, int s, int causal, float scale_log2,
                        float scale, cudaStream_t stream) {
  using G = KvGeo<D>;
  static bool ready = false;  // the shared-memory opt-in, once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid(hkv, b, (s + G::BK - 1) / G::BK);
  bwd_dkdv_kernel<D><<<grid, G::THREADS, G::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, hq, hkv, s, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dq, int b, int hq, int hkv,
                      int s, int causal, float scale_log2, float scale,
                      cudaStream_t stream) {
  using G = QGeo<D>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid(hq, b, (s + G::BQ - 1) / G::BQ);
  bwd_dq_kernel<D><<<grid, G::THREADS, G::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, hq, hkv, s, causal, scale_log2, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int hq, int hkv, int s, int d) {
  return b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
         (d != 64 && d != 128 && d != 256);
}

}  // namespace

// delta[r] = sum_d o[r, d] * dout[r, d] over rows r < rows of contiguous
// [rows, d] float32 (d a multiple of 4, 16-byte aligned), in float32.
// Returns cudaGetLastError().
extern "C" int flash_attention_bwd_tf32_pre(const void* o, const void* dout,
                                            float* delta, int64_t rows,
                                            int d, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 4) return (int)cudaErrorInvalidValue;
  bwd_pre_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      rows, d);
  return (int)cudaGetLastError();
}

// q, dout [b, hq, s, d], k, v, dk, dv [b, hkv, s, d], all contiguous
// float32, 16-byte aligned; lse, delta [b, hq, s] float32; d in {64, 128,
// 256}; hq % hkv == 0. dk and dv are summed over each KV head's group of
// query heads. scale_log2 = softmax scale * log2(e). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_tf32_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s, int d, int causal, float scale_log2, float scale,
    void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (d == 64)
    return (int)launch_dkdv<64>(qf, kf, vf, of, lse, delta, dkf, dvf, b, hq,
                                hkv, s, causal, scale_log2, scale, st);
  if (d == 128)
    return (int)launch_dkdv<128>(qf, kf, vf, of, lse, delta, dkf, dvf, b, hq,
                                 hkv, s, causal, scale_log2, scale, st);
  return (int)launch_dkdv<256>(qf, kf, vf, of, lse, delta, dkf, dvf, b, hq,
                               hkv, s, causal, scale_log2, scale, st);
}

// dq [b, hq, s, d] float32; the other arguments as for the dk/dv entry.
extern "C" int flash_attention_bwd_tf32_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int hq, int hkv,
    int s, int d, int causal, float scale_log2, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  if (d == 64)
    return (int)launch_dq<64>(qf, kf, vf, of, lse, delta, dqf, b, hq, hkv, s,
                              causal, scale_log2, scale, st);
  if (d == 128)
    return (int)launch_dq<128>(qf, kf, vf, of, lse, delta, dqf, b, hq, hkv, s,
                               causal, scale_log2, scale, st);
  return (int)launch_dq<256>(qf, kf, vf, of, lse, delta, dqf, b, hq, hkv, s,
                             causal, scale_log2, scale, st);
}
