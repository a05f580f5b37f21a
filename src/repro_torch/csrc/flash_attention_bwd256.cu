// Backward of the bfloat16 prefill attention at head dim 256 (gemma), for
// training, on Hopper's tensor cores (sm_90a) by mma.sync: dq, dk and dv of
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i when causal (sq == skv), over all j otherwise. The pre
// pass D = rowsum(dO * O) is flash_attention_bwd.cu's, which takes any d.
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (autograd of src/repro/kernels/ref.py attention_ref) and has no Pallas
// backward. It is the d = 256 counterpart of flash_attention_bwd.cu's dK/dV
// and dQ kernels, whose geometry does not fit at this width: 128-row K and
// V tiles and their stages need 264,256 B of shared memory for dK/dV and
// 394,304 B for dQ, against the 232,448 B a block can have, and 64 keys'
// dK and dV in float32 are 128 KB, 256 registers a thread of one
// warpgroup.
//
// Bound on the H100: operations. The essential work is five products of
// 2 s^2 d flops a head (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), halved when
// causal, at 989 TFLOP/s dense bf16. These kernels issue fourteen such
// units: in dK/dV, S^T and dP^T are computed by both warps that share 16
// keys (each owns half of d for dK and dV; 4 units) and dV and dK take hi
// and lo parts (4); in dQ, S and dP again by both halves (4) and dQ as hi
// + lo (2). mma.sync reaches well under wgmma's rate; this is the simple
// form, right first (wgmma, TMA and one S per key tile are later work).
//
// Design:
// - bwd256_dkdv_kernel: a block of 8 warps owns 64 keys of one (b, kv head)
//   (the key tiles the grid's slowest dimension, so under causal the
//   longest run first). K and V stay in shared memory; Q and dO tiles of
//   BQ = 32 query rows stream through two stages by cp.async, for each query
//   head of the GQA group in turn and each query tile (under causal from the
//   tile of the block's first key), with each stage's lse (times log2 e,
//   +inf for rows past s so their P is 0) and D. Warp w owns keys 16 (w % 4)
//   .. + 15 and columns 128 (w / 4) .. + 127 of dK and dV: 64 + 64 float32
//   accumulators a thread. Per stage it computes S^T = K Q^T and dP^T = V
//   dO^T over all of d (16 keys x 32 queries), P^T and dS^T = P^T (dP^T -
//   D) in registers (the accumulator's layout is the A fragment's), then
//   dV += P^T dO and dK += dS^T Q over its 128 columns, B read transposed
//   by ldmatrix.
// - bwd256_dq_kernel: a block owns 64 query rows of one (b, q head), the
//   tiles reversed so the longest first; Q and dO stay in shared memory, K
//   and V tiles of BKV = 32 keys stream through two stages (under causal up
//   to the block's last row). Warp w owns rows 16 (w % 4) .. + 15 and
//   columns 128 (w / 4) .. + 127 of dQ: S = Q K^T, dP = dO V^T, dS, then
//   dQ += dS K.
// - Shared rows are padded to 264 values (528 B), so the 8 rows an
//   ldmatrix reads fall in 8 distinct bank groups.
// - Precision: P and dS enter their second products as A fragments split
//   into bf16 hi + lo parts (two mma each), as flash_attention_bwd.cu does:
//   rounding them once to bf16 puts dq, dk and dv outside the tolerance the
//   plain version is held to (tests/test_torch_bwd_split.py).
// - Masks only where a tile crosses the diagonal or the end of s. Rows and
//   keys past s are zero-filled by cp.async; their rows of the outputs are
//   never written, and keys past s are masked in dQ.
// - No atomics and no split reductions: each output element is summed by
//   one thread in a fixed order (dK and dV over the group's query heads in
//   turn), so every launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int D = 256;
constexpr int DP = D + 8;      // a shared row, padded
constexpr int THREADS = 256;   // 8 warps
constexpr int BK = 64;         // keys a dK/dV block
constexpr int BQ = 32;         // query rows a dK/dV stage
constexpr int BR = 64;         // query rows a dQ block
constexpr int BKV = 32;        // keys a dQ stage
constexpr int CHUNKS = D / 8;  // 16-byte chunks a row

typedef __nv_bfloat16 bf16;

// K, V, two stages of Q and dO, and each stage's lse and D
constexpr int KV_SMEM = (2 * BK + 4 * BQ) * DP * 2 + 4 * BQ * 4;
// Q, dO, two stages of K and V
constexpr int Q_SMEM = (2 * BR + 4 * BKV) * DP * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lse2_of(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 pairs hi and lo = (x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix addresses in a [rows][DP] tile, for lane `lane`:
// the A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int m0, int k0,
                                           int lane) {
  return smem_u32(t + (m0 + (lane & 15)) * DP + k0 + (lane >> 4) * 8);
}
// the B fragments of two n-tiles n0 and n0 + 8, k0 .. k0 + 15, B^T stored
// as rows n (the tile is [n][k]): registers b0, b1 of n0 then of n0 + 8
__device__ __forceinline__ uint32_t bn_addr(const bf16* t, int n0, int k0,
                                            int lane) {
  return smem_u32(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * DP + k0 +
                  ((lane >> 3) & 1) * 8);
}
// the same with B stored as rows k (the tile is [k][n]), for .trans
__device__ __forceinline__ uint32_t bk_addr(const bf16* t, int k0, int n0,
                                            int lane) {
  return smem_u32(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP + n0 +
                  (lane >> 4) * 8);
}

// rows row0 .. row0 + ROWS - 1 of a [s][D] head into a [ROWS][DP] tile,
// rows past s zero-filled; every thread of the block takes part
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* head,
                                          int row0, int s) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool valid = row0 + r < s;
    cp_async16(smem_u32(tile + r * DP + col),
               valid ? head + (int64_t)(row0 + r) * D + col : head, valid);
  }
}

// acc[4 n-tiles] = A B^T over all of d: A rows m0 .. + 15 of `a`, B rows
// 0 .. 31 of `b` (both [rows][DP])
__device__ __forceinline__ void product_over_d(float (&acc)[4][4],
                                               const bf16* a, int m0,
                                               const bf16* b, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t fa[4], fb[4];
    ldsm_x4(fa, a_addr(a, m0, kd, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      ldsm_x4(fb, bn_addr(b, np * 16, kd, lane));
      mma(acc[2 * np], fa, fb[0], fb[1]);
      mma(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[16 n-tiles] += (hi + lo) B over 32 k: B rows 0 .. 31 of `b` ([k][DP]),
// columns c0 .. c0 + 127
__device__ __forceinline__ void product_split(float (&acc)[16][4],
                                              const uint32_t (&hi)[2][4],
                                              const uint32_t (&lo)[2][4],
                                              const bf16* b, int c0,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t fb[4];
      ldsm_x4_t(fb, bk_addr(b, kk * 16, c0 + np * 16, lane));
      mma(acc[2 * np], hi[kk], fb[0], fb[1]);
      mma(acc[2 * np], lo[kk], fb[0], fb[1]);
      mma(acc[2 * np + 1], hi[kk], fb[2], fb[3]);
      mma(acc[2 * np + 1], lo[kk], fb[2], fb[3]);
    }
}

// rows ra and rb = ra + 8 of a [16 x 128] accumulator (tile n: columns
// 8 n + 2 (lane % 4), + 1) times `mul` in bf16 into columns c0 .. of a
// [s][D] head; rows past s not written
__device__ __forceinline__ void store_rows(bf16* head, const float (&acc)[16][4],
                                           int ra, int c0, int s, int lane,
                                           float mul) {
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = c0 + 8 * n + 2 * (lane & 3);
    if (ra < s)
      *reinterpret_cast<uint32_t*>(head + (int64_t)ra * D + col) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (rb < s)
      *reinterpret_cast<uint32_t*>(head + (int64_t)rb * D + col) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// ---- dK, dV --------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
bwd256_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int hq, int hkv, int s, int causal,
                   float scale_log2, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);     // [BK][DP]
  bf16* sV = sK + BK * DP;                      // [BK][DP]
  bf16* sQ = sV + BK * DP;                      // [2][BQ][DP]
  bf16* sdO = sQ + 2 * BQ * DP;                 // [2][BQ][DP]
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * DP);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                  // [2][BQ]

  const int hk = blockIdx.x, bi = blockIdx.y, k0 = blockIdx.z * BK;
  const int group = hq / hkv;
  const int64_t head_kv = ((int64_t)bi * hkv + hk) * s * D;
  // the walk: each query head of the group, over query tiles qt_begin ..
  // qt_end - 1 (under causal from the tile of the block's first key)
  const int qt_begin = causal ? k0 / BQ : 0, qt_end = (s + BQ - 1) / BQ;
  const int per_head = qt_end - qt_begin;
  const int n_iter = group * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp & 3) * 16, c0 = (warp >> 2) * 128;
  const int kw = k0 + m0;                   // this warp's first key
  const int ka = kw + lane / 4, kb = ka + 8;

  load_rows<BK>(sK, k + head_kv, k0, s);
  load_rows<BK>(sV, v + head_kv, k0, s);
  auto issue = [&](int it) {
    const int qt = qt_begin + it % per_head;
    const int64_t bh = (int64_t)bi * hq + hk * group + it / per_head;
    const int st = it & 1, q0 = qt * BQ;
    load_rows<BQ>(sQ + st * BQ * DP, q + bh * s * D, q0, s);
    load_rows<BQ>(sdO + st * BQ * DP, dout + bh * s * D, q0, s);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      sL[st * BQ + threadIdx.x] =
          row < s ? lse2_of(lse[bh * s + row]) : CUDART_INF_F;
      sD[st * BQ + threadIdx.x] = row < s ? delta[bh * s + row] : 0.f;
    }
  };
  issue(0);
  cp_async_commit();

  float dv_acc[16][4], dk_acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dv_acc[n][j] = dk_acc[n][j] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1, q0 = (qt_begin + it % per_head) * BQ;
    if (!(causal && kw > q0 + BQ - 1)) {  // else every key after every query
      const bf16* Qs = sQ + st * BQ * DP;
      const bf16* dOs = sdO + st * BQ * DP;
      // S^T = K Q^T, dP^T = V dO^T: 16 keys x 32 queries
      float sT[4][4], dpT[4][4];
      product_over_d(sT, sK, m0, Qs, lane);
      product_over_d(dpT, sV, m0, dOs, lane);
      // P^T and dS^T as A fragments, hi and lo: tile n (queries 8 n ..)
      // gives k-step n / 2, registers 2 (n % 2) (row ka) and + 1 (row kb)
      const bool mask = causal && kw + 15 > q0;
      const float* Lt = sL + st * BQ;
      const float* Dt = sD + st * BQ;
      uint32_t ph[2][4], pl[2][4], sh[2][4], sl[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        const float l0 = Lt[col], l1 = Lt[col + 1];
        const float d0 = Dt[col], d1 = Dt[col + 1];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(fmaf(sT[n][2 * e], scale_log2, -l0));
          float p1 = exp2f(fmaf(sT[n][2 * e + 1], scale_log2, -l1));
          if (mask) {
            const int key = e ? kb : ka;
            if (key > q0 + col) p0 = 0.f;
            if (key > q0 + col + 1) p1 = 0.f;
          }
          const int kk = n >> 1, r = 2 * (n & 1) + e;
          split(p0, p1, ph[kk][r], pl[kk][r]);
          split(p0 * (dpT[n][2 * e] - d0), p1 * (dpT[n][2 * e + 1] - d1),
                sh[kk][r], sl[kk][r]);
        }
      }
      // dV += P^T dO, dK += dS^T Q over this warp's 128 columns
      product_split(dv_acc, ph, pl, dOs, c0, lane);
      product_split(dk_acc, sh, sl, Qs, c0, lane);
    }
    __syncthreads();
  }

  store_rows(dv + head_kv, dv_acc, ka, c0, s, lane, 1.f);
  store_rows(dk + head_kv, dk_acc, ka, c0, s, lane, scale);
}

// ---- dQ --------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
bwd256_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int hq, int hkv, int s, int causal, float scale_log2,
                 float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);     // [BR][DP]
  bf16* sdO = sQ + BR * DP;                     // [BR][DP]
  bf16* sK = sdO + BR * DP;                     // [2][BKV][DP]
  bf16* sV = sK + 2 * BKV * DP;                 // [2][BKV][DP]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BR;  // longest tiles first
  const int64_t bh = (int64_t)bi * hq + h;
  const int64_t head_kv = ((int64_t)bi * hkv + h / (hq / hkv)) * s * D;
  const int kv_end = causal ? min(s, q0 + BR) : s;
  const int n_iter = (kv_end + BKV - 1) / BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp & 3) * 16, c0 = (warp >> 2) * 128;
  const int r0 = q0 + m0;                   // this warp's first row
  const int ra = r0 + lane / 4, rb = ra + 8;
  const float la = ra < s ? lse2_of(lse[bh * s + ra]) : CUDART_INF_F;
  const float lb = rb < s ? lse2_of(lse[bh * s + rb]) : CUDART_INF_F;
  const float da = ra < s ? delta[bh * s + ra] : 0.f;
  const float db = rb < s ? delta[bh * s + rb] : 0.f;

  load_rows<BR>(sQ, q + bh * s * D, q0, s);
  load_rows<BR>(sdO, dout + bh * s * D, q0, s);
  auto issue = [&](int it) {
    const int st = it & 1;
    load_rows<BKV>(sK + st * BKV * DP, k + head_kv, it * BKV, s);
    load_rows<BKV>(sV + st * BKV * DP, v + head_kv, it * BKV, s);
  };
  issue(0);
  cp_async_commit();

  float dq_acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[n][j] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kb0 = it * BKV;
    if (!(causal && kb0 > r0 + 15)) {  // else every key after every row
      const bf16* Ks = sK + (it & 1) * BKV * DP;
      const bf16* Vs = sV + (it & 1) * BKV * DP;
      // S = Q K^T, dP = dO V^T: 16 rows x 32 keys
      float sc[4][4], dp[4][4];
      product_over_d(sc, sQ, m0, Ks, lane);
      product_over_d(dp, sdO, m0, Vs, lane);
      const bool mask =
          kb0 + BKV > s || (causal && kb0 + BKV - 1 > r0);
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int key = kb0 + 8 * n + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? lb : la, dd = e ? db : da;
          float p0 = exp2f(fmaf(sc[n][2 * e], scale_log2, -l));
          float p1 = exp2f(fmaf(sc[n][2 * e + 1], scale_log2, -l));
          if (mask) {
            const int row = e ? rb : ra;
            if (key >= s || (causal && key > row)) p0 = 0.f;
            if (key + 1 >= s || (causal && key + 1 > row)) p1 = 0.f;
          }
          const int kk = n >> 1, r = 2 * (n & 1) + e;
          split(p0 * (dp[n][2 * e] - dd), p1 * (dp[n][2 * e + 1] - dd),
                hi[kk][r], lo[kk][r]);
        }
      }
      // dQ += dS K over this warp's 128 columns
      product_split(dq_acc, hi, lo, Ks, c0, lane);
    }
    __syncthreads();
  }

  store_rows(dq + bh * s * D, dq_acc, ra, c0, s, lane, scale);
}

bool bad_shape(int b, int hq, int hkv, int s, int d) {
  return b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || d != D;
}

}  // namespace

// q, dout [b, hq, s, 256], k, v, dk, dv [b, hkv, s, 256], all contiguous
// bfloat16, 16-byte aligned; lse, delta [b, hq, s] float32 (delta from
// flash_attention_bwd_pre); hq % hkv == 0. dk and dv are summed over each KV
// head's group of query heads. scale_log2 = softmax scale * log2(e). The
// arguments of flash_attention_bwd_dkdv, with d = 256 only. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd256_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s, int d, int causal, float scale_log2, float scale,
    void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bwd256_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hkv, b, (s + BK - 1) / BK);
  bwd256_dkdv_kernel<<<grid, THREADS, KV_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, s, causal,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// dq [b, hq, s, 256] bfloat16; the other arguments as for the dk/dv entry.
extern "C" int flash_attention_bwd256_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int hq, int hkv,
    int s, int d, int causal, float scale_log2, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bwd256_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hq, b, (s + BR - 1) / BR);
  bwd256_dq_kernel<<<grid, THREADS, Q_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), hq, hkv, s, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}
