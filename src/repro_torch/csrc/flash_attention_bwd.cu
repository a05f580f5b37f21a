// Backward of the bfloat16 prefill attention on Hopper's tensor cores
// (sm_90a), for training: dq, dk and dv of
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i when causal (sq == skv), over all j otherwise.
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (autograd of src/repro/kernels/ref.py attention_ref) and has no Pallas
// backward. It is the backward of flash_attention_wgmma.cu, whose training
// forward saves each row's log-sum-exp (lse), so P is recomputed here
// without a second softmax pass.
//
// Bound on the H100: operations. The essential work is five products of
// 2 s^2 d flops a head (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), halved when
// causal, at 989 TFLOP/s dense bf16; q, k, v, o, dO, lse in and dq, dk, dv
// out cross HBM once.
//
// Design (simple, right and deterministic; wgmma and TMA are later work):
// - bwd_pre_kernel: D[row] = sum_d dO * O in f32, one warp a row.
// - bwd_dkdv_kernel: a CTA of 4 warps owns 64 keys of one (b, kv head),
//   16 keys a warp, and walks the group's query heads and their query
//   tiles of 32 rows (under causal from the tile of its first key), the
//   tiles streamed by cp.async into two stages. Per tile each warp forms
//   S^T = K Q^T and dP^T = V dO^T (keys as rows), P^T =
//   exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D), then
//   dV += P^T dO and dK += dS^T Q in f32 registers, written once at the
//   end (dK times the softmax scale).
// - bwd_dq_kernel: a CTA of 4 warps owns 64 query rows of one (b, q head)
//   and walks the key tiles of 32 (under causal up to its last row),
//   recomputing S, dP, P and dS the same way and accumulating dQ += dS K.
//   The longest tiles run first (the tile index reversed).
// - Products: mma.sync.m16n8k16 bf16 with f32 accumulators. Fragments of
//   row-major tiles (K, V, Q, dO as the operand whose reduction runs over
//   d) are 4-byte shared-memory loads; the operand whose reduction runs
//   over rows (dO and Q for dV and dK, K for dQ) is read transposed by
//   ldmatrix.trans. Rows are D + 8 elements apart: both are free of bank
//   conflicts.
// - Precision: P and dS enter their second product as A fragments built
//   from the f32 accumulators, split into bf16 hi + lo parts (two mmas
//   each), as the forward splits P: products exact to about 2^-16 of each
//   term, so the result is the f32 plain version's up to its final bf16
//   rounding.
// - No atomics, no split reductions: each output element is summed by one
//   thread in a fixed order, so every launch gives the same bits (a resumed
//   training run must reproduce its state byte for byte).
// - Masks: keys past s and, under causal, keys past the query row give
//   P = 0; query rows past s and rows whose lse is -inf (no visible key)
//   take lse = +inf, so their P, and their gradient, is 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;   // 4 warps of 16 rows
constexpr int BKV = 64;        // keys a dk/dv CTA
constexpr int BQ_KV = 32;      // query rows a dk/dv step
constexpr int BQ = 64;         // query rows a dq CTA
constexpr int BK_Q = 32;       // keys a dq step

typedef __nv_bfloat16 bf16;

template <int D>
struct Geo {
  static constexpr int S = D + 8;  // smem row stride (elements)
  static constexpr int KV_SMEM =
      (2 * BKV * S + 2 * 2 * BQ_KV * S) * 2 + 2 * 2 * BQ_KV * 4;
  static constexpr int Q_SMEM = (2 * BQ * S + 2 * 2 * BK_Q * S) * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of two n-tiles of 8 columns from a row-major [k][n]
// tile: lane gives the address of row (lane & 15), column block lane >> 4
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a bf16 pair
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// A fragments (hi, lo) of k-step kk of a [16 x 8 n] accumulator row:
// tiles 2 kk and 2 kk + 1 hold its 16 columns
__device__ __forceinline__ void a_frags(const float (&c)[4][4], int kk,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// A fragment of rows r0 .. r0 + 15, d columns 16 kk .. 16 kk + 15 of a
// row-major tile
template <int S>
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk, int g, int t) {
  const bf16* p = tile + (r0 + g) * S + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// rows row0 .. row0 + rows - 1 of a [s][D] head into a tile of stride S;
// rows past s zero-filled
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* head,
                                          int row0, int s, int rows,
                                          int tid) {
  constexpr int CPR = D / 8, S = Geo<D>::S;
  for (int c = tid; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, col = (c - r * CPR) * 8;
    const bool in = row0 + r < s;
    const bf16* src = in ? head + (int64_t)(row0 + r) * D + col : head;
    cp_async16(smem_u32(dst + r * S + col), src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float lse2_of(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

// ---- D = rowsum(dO * O) ----------------------------------------------------

__global__ void __launch_bounds__(256)
bwd_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* op = reinterpret_cast<const uint4*>(o + row * d);
  const uint4* dp = reinterpret_cast<const uint4*>(dout + row * d);
  float acc = 0.f;
  for (int i = lane; i < d / 8; i += 32) {
    const uint4 a = op[i], b = dp[i];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(a2[j]);
      const float2 fb = __bfloat1622float2(b2[j]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- dK, dV --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int hq, int hkv, int s, int causal,
                float scale_log2, float scale) {
  constexpr int S = Geo<D>::S, NKD = D / 16, NND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][S]
  bf16* Vs = Ks + BKV * S;                        // [BKV][S]
  bf16* Qs = Vs + BKV * S;                        // [2][BQ_KV][S]
  bf16* dOs = Qs + 2 * BQ_KV * S;                 // [2][BQ_KV][S]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ_KV * S);  // [2][BQ_KV]
  float* Ds = Ls + 2 * BQ_KV;                                  // [2][BQ_KV]

  const int k0 = blockIdx.x * BKV;  // under causal the first tiles are the
  const int hk = blockIdx.y, bi = blockIdx.z;  // longest: they start first
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t kv_head = ((int64_t)bi * hkv + hk) * s * D;

  load_rows<D>(Ks, k + kv_head, k0, s, BKV, tid);
  load_rows<D>(Vs, v + kv_head, k0, s, BKV, tid);
  cp_async_commit();

  const int qt_begin = causal ? k0 / BQ_KV : 0;
  const int n_q = (s + BQ_KV - 1) / BQ_KV - qt_begin;
  const int n_iter = group * n_q;
  auto issue = [&](int it) {
    const int64_t bh = (int64_t)bi * hq + hk * group + it / n_q;
    const int q0 = (qt_begin + it % n_q) * BQ_KV;
    const int st = it & 1;
    load_rows<D>(Qs + st * BQ_KV * S, q + bh * s * D, q0, s, BQ_KV, tid);
    load_rows<D>(dOs + st * BQ_KV * S, dout + bh * s * D, q0, s, BQ_KV,
                 tid);
    if (tid < BQ_KV) {
      const int r = q0 + tid;
      Ls[st * BQ_KV + tid] = r < s ? lse2_of(lse[bh * s + r]) : CUDART_INF_F;
      Ds[st * BQ_KV + tid] = r < s ? delta[bh * s + r] : 0.f;
    }
  };

  float dv_acc[NND][4], dk_acc[NND][4];
#pragma unroll
  for (int n = 0; n < NND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.f;
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;

  issue(0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt_begin + it % n_q) * BQ_KV;
    const bf16* Qt = Qs + st * BQ_KV * S;
    const bf16* dOt = dOs + st * BQ_KV * S;
    const float* Lt = Ls + st * BQ_KV;
    const float* Dt = Ds + st * BQ_KV;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
    float sT[4][4], dpT[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      uint32_t ak[4], av[4];
      a_rows<S>(ak, Ks, warp * 16, kk, g, t);
      a_rows<S>(av, Vs, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* qr = Qt + (j * 8 + g) * S + kk * 16 + 2 * t;
        const bf16* dr = dOt + (j * 8 + g) * S + kk * 16 + 2 * t;
        mma(sT[j], ak, ld32(qr), ld32(qr + 8));
        mma(dpT[j], av, ld32(dr), ld32(dr + 8));
      }
    }
    // P^T and dS^T; entry e of tile j: key (e < 2 ? key_a : key_b), query
    // q0 + 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int key = e < 2 ? key_a : key_b;
        const bool vis = !causal || key <= q0 + col;
        const float p =
            vis ? exp2f(fmaf(sT[j][e], scale_log2, -Lt[col])) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - Dt[col]);
      }
    }
    // dV += P^T dO, dK += dS^T Q: the reduction runs over the 32 queries
#pragma unroll
    for (int kq = 0; kq < BQ_KV / 16; ++kq) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_frags(sT, kq, ph, pl);
      a_frags(dpT, kq, sh, sl);
      const int row = kq * 16 + (lane & 15), cb = (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < NND / 2; ++nd) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(dOt + row * S + nd * 16 + cb));
        mma(dv_acc[2 * nd], pl, b[0], b[1]);
        mma(dv_acc[2 * nd], ph, b[0], b[1]);
        mma(dv_acc[2 * nd + 1], pl, b[2], b[3]);
        mma(dv_acc[2 * nd + 1], ph, b[2], b[3]);
        ldsm_x4_trans(b, smem_u32(Qt + row * S + nd * 16 + cb));
        mma(dk_acc[2 * nd], sl, b[0], b[1]);
        mma(dk_acc[2 * nd], sh, b[0], b[1]);
        mma(dk_acc[2 * nd + 1], sl, b[2], b[3]);
        mma(dk_acc[2 * nd + 1], sh, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dkp = dk + kv_head;
  bf16* dvp = dv + kv_head;
#pragma unroll
  for (int n = 0; n < NND; ++n) {
    const int col = n * 8 + 2 * t;
    if (key_a < s) {
      *reinterpret_cast<uint32_t*>(dvp + (int64_t)key_a * D + col) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dkp + (int64_t)key_a * D + col) =
          pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
    }
    if (key_b < s) {
      *reinterpret_cast<uint32_t*>(dvp + (int64_t)key_b * D + col) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dkp + (int64_t)key_b * D + col) =
          pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    }
  }
}

// ---- dQ --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int hq, int hkv, int s, int causal,
              float scale_log2, float scale) {
  constexpr int S = Geo<D>::S, NKD = D / 16, NND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][S]
  bf16* dOs = Qs + BQ * S;                        // [BQ][S]
  bf16* Ks = dOs + BQ * S;                        // [2][BK_Q][S]
  bf16* Vs = Ks + 2 * BK_Q * S;                   // [2][BK_Q][S]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = (int64_t)bi * hq + h;
  const int64_t kv_head = ((int64_t)bi * hkv + hk) * s * D;

  load_rows<D>(Qs, q + bh * s * D, q0, s, BQ, tid);
  load_rows<D>(dOs, dout + bh * s * D, q0, s, BQ, tid);
  cp_async_commit();

  const int kv_end = causal ? min(s, q0 + BQ) : s;
  const int n_iter = (kv_end + BK_Q - 1) / BK_Q;
  auto issue = [&](int it) {
    const int st = it & 1;
    load_rows<D>(Ks + st * BK_Q * S, k + kv_head, it * BK_Q, s, BK_Q, tid);
    load_rows<D>(Vs + st * BK_Q * S, v + kv_head, it * BK_Q, s, BK_Q, tid);
  };

  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const float la = ra < s ? lse2_of(lse[bh * s + ra]) : CUDART_INF_F;
  const float lb = rb < s ? lse2_of(lse[bh * s + rb]) : CUDART_INF_F;
  const float da = ra < s ? delta[bh * s + ra] : 0.f;
  const float db = rb < s ? delta[bh * s + rb] : 0.f;
  float dq_acc[NND][4];
#pragma unroll
  for (int n = 0; n < NND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  issue(0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1, kb0 = it * BK_Q;
    const bf16* Kt = Ks + st * BK_Q * S;
    const bf16* Vt = Vs + st * BK_Q * S;

    // S = Q K^T and dP = dO V^T: 16 queries x 32 keys a warp
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      uint32_t aq[4], ad[4];
      a_rows<S>(aq, Qs, warp * 16, kk, g, t);
      a_rows<S>(ad, dOs, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* kr = Kt + (j * 8 + g) * S + kk * 16 + 2 * t;
        const bf16* vr = Vt + (j * 8 + g) * S + kk * 16 + 2 * t;
        mma(sc[j], aq, ld32(kr), ld32(kr + 8));
        mma(dp[j], ad, ld32(vr), ld32(vr + 8));
      }
    }
    // dS; entry e of tile j: row (e < 2 ? ra : rb), key kb0 + 8 j + 2 t +
    // (e & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? ra : rb;
        const bool vis = key < s && (!causal || key <= row);
        const float p = vis ? exp2f(fmaf(sc[j][e], scale_log2,
                                         -(e < 2 ? la : lb)))
                            : 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? da : db));
      }
    }
    // dQ += dS K: the reduction runs over the 32 keys
#pragma unroll
    for (int kk = 0; kk < BK_Q / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_frags(dp, kk, hi, lo);
      const int row = kk * 16 + (lane & 15), cb = (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < NND / 2; ++nd) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(Kt + row * S + nd * 16 + cb));
        mma(dq_acc[2 * nd], lo, b[0], b[1]);
        mma(dq_acc[2 * nd], hi, b[0], b[1]);
        mma(dq_acc[2 * nd + 1], lo, b[2], b[3]);
        mma(dq_acc[2 * nd + 1], hi, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dqp = dq + bh * s * D;
#pragma unroll
  for (int n = 0; n < NND; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < s)
      *reinterpret_cast<uint32_t*>(dqp + (int64_t)ra * D + col) =
          pack_bf16(dq_acc[n][0] * scale, dq_acc[n][1] * scale);
    if (rb < s)
      *reinterpret_cast<uint32_t*>(dqp + (int64_t)rb * D + col) =
          pack_bf16(dq_acc[n][2] * scale, dq_acc[n][3] * scale);
  }
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int b,
                        int hq, int hkv, int s, int causal, float scale_log2,
                        float scale, cudaStream_t stream) {
  constexpr int smem = Geo<D>::KV_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + BKV - 1) / BKV, hkv, b);
  bwd_dkdv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, s,
      causal, scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int hq, int hkv, int s, int causal,
                      float scale_log2, float scale, cudaStream_t stream) {
  constexpr int smem = Geo<D>::Q_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), hq, hkv, s, causal, scale_log2, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int hq, int hkv, int s, int d) {
  return b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
         (d != 64 && d != 128);
}

}  // namespace

// delta[r] = sum_d o[r, d] * dout[r, d] over rows r < rows of contiguous
// [rows, d] bfloat16 (d a multiple of 8, 16-byte aligned), in float32.
// Returns cudaGetLastError().
extern "C" int flash_attention_bwd_pre(const void* o, const void* dout,
                                       float* delta, int64_t rows, int d,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  bwd_pre_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      rows, d);
  return (int)cudaGetLastError();
}

// q, dout [b, hq, s, d], k, v, dk, dv [b, hkv, s, d], all contiguous
// bfloat16, 16-byte aligned; lse, delta [b, hq, s] float32; d in {64, 128};
// hq % hkv == 0. dk and dv are summed over each KV head's group of query
// heads. scale_log2 = softmax scale * log2(e). Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv, int b, int hq,
                                        int hkv, int s, int d, int causal,
                                        float scale_log2, float scale,
                                        void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                hkv, s, causal, scale_log2, scale, st);
  return (int)launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                               s, causal, scale_log2, scale, st);
}

// dq [b, hq, s, d] bfloat16; the other arguments as for the dk/dv entry.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int b, int hq, int hkv,
                                      int s, int d, int causal,
                                      float scale_log2, float scale,
                                      void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, s,
                              causal, scale_log2, scale, st);
  return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, s,
                             causal, scale_log2, scale, st);
}
