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
// out cross HBM once. The kernels issue ten: the dK/dV kernel six (S^T,
// dP^T, and dV and dK as hi + lo parts), the dQ kernel four (S and dP
// again, dQ as hi + lo).
//
// Design (warp-specialised, TMA-fed, wgmma for every product, as the
// forward; the PTX wrappers and tensor maps are in wgmma.cuh):
// - bwd_pre_kernel: D[row] = sum_d dO * O in f32, one warp a row.
// - bwd_dkdv_kernel: a CTA of 3 warpgroups owns 128 keys of one (b, kv
//   head); the key tiles are the grid's slowest dimension, so under causal
//   the longest run first. Warpgroup 0 is the producer (setmaxnreg 24):
//   one thread loads the K and V tiles once by TMA, then Q and dO tiles of
//   BN = 64 query rows into a ring of STAGES stages, for each query head
//   of the GQA group and each query tile (under causal from the tile of
//   the CTA's first key); warp 1 writes each stage's lse (times log2 e,
//   +inf for rows past s or with lse = -inf, so their P is 0) and D into
//   shared memory. Each stage completes on its `full` mbarrier (the TMA
//   bytes and warp 1's 32 arrivals) and is released on `empty` by the
//   consumers. Warpgroups 1 and 2 (setmaxnreg 240) own 64 keys each: per
//   stage S^T = K Q^T and dP^T = V dO^T by wgmma with both operands in
//   shared memory, K-major as stored (N = 64 queries); P^T = exp2(S^T
//   scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D) in registers (the
//   S^T accumulator's layout is the A operand's); then dV += P^T dO and
//   dK += dS^T Q by wgmma with A from registers and B, dO or Q, read
//   MN-major from the same swizzled tiles. dV and dK are 64 x d f32
//   accumulators a warpgroup (128 registers a thread at d = 128, plus 64
//   for S^T and dP^T), written once at the end, dK times the scale.
// - bwd_dq_kernel: a CTA owns 128 query rows of one (b, q head), the
//   tiles reversed so the longest run first; the producer loads Q and dO
//   once and streams K and V tiles of BKQ = 128 keys through the ring
//   (under causal up to the CTA's last row); each consumer
//   recomputes S = Q K^T and dP = dO V^T (SS wgmma, N = 128), dS in
//   registers, and dQ += dS K (RS wgmma, K MN-major).
// - P^T, dS^T (and dS) go from the f32 accumulators to hi + lo A
//   fragments one k-step of 16 at a time, so the f32 tiles die as the
//   fragments fill.
// - Registers: the dK/dV producer steps its ring and its (head, tile) walk
//   by counters (`Ring`); the divisions of an iteration index spilled its
//   24 registers at d = 128. The dQ loops take stage and parity from the
//   index (a mask and a shift). Timed by launch/attention_bwd.py on the
//   H100 at qwen3's training shape, each against this source in the same
//   call: dQ 4% slower with 64-key tiles and 5 to 10% slower with the
//   counters; dK/dV 1% slower with three stages.
// - Masks only on the tiles that cross the diagonal or the end of s; a
//   consumer skips a stage none of whose pairs is visible. Rows past s are
//   zero-filled by TMA and take lse = +inf, so their P and gradients are 0;
//   keys past s give dK/dV rows that are never written, and are masked in
//   the dQ kernel.
// - Precision: P and dS enter their second products as A fragments split
//   into bf16 hi + lo parts (two wgmmas each), as the forward splits P:
//   products exact to about 2^-16 of each term, so the result is the f32
//   plain version's up to its final bf16 rounding. Rounding P and dS once
//   to bf16 puts dq, dk and dv outside the tolerance the plain version is
//   held to (tests/test_torch_bwd_split.py emulates both).
// - No atomics, no split reductions: each output element is summed by one
//   thread in a fixed order, so every launch gives the same bits (a resumed
//   training run must reproduce its state byte for byte). dQ therefore has
//   its own kernel rather than an ordered reduction across dK/dV CTAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int BM = 128;        // keys (dK/dV) or query rows (dQ) a CTA
constexpr int BN = 64;         // query rows a dK/dV stage
constexpr int BKQ = 128;       // keys a dQ stage
constexpr int STAGES = 2;      // the ring of streamed tiles

typedef __nv_bfloat16 bf16;

template <int D>
struct Geo {
  static constexpr int NSUB = D / SUB;            // sub-tiles per row
  static constexpr int BIG = BM * D * 2;          // a 128-row tile
  static constexpr int ROWS = BN * D * 2;         // a dK/dV stage's Q or dO
  static constexpr int KEYS = BKQ * D * 2;        // a dQ stage's K or V
  // K, V, the Q and dO stages, lse and D of each stage, the mbarriers;
  // +1024 to align to the swizzle's period
  static constexpr int KV_SMEM =
      2 * BIG + STAGES * 2 * (ROWS + BN * 4) + 64 + 1024;
  // Q, dO, the K and V stages, the mbarriers
  static constexpr int Q_SMEM = 2 * BIG + STAGES * 2 * KEYS + 64 + 1024;
};

__device__ __forceinline__ float lse2_of(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

// a position in a ring of N stages: the stage, and the parity of the
// phase its mbarriers are in (counters, not divisions: the producer has
// 24 registers)
template <int N>
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++st == N) {
      st = 0;
      ph ^= 1;
    }
  }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// (x0, x1) as bf16 pairs hi and lo = (x - hi): the A operand's register
// for a pair of an accumulator's entries, in two parts
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
}

// acc = A B^T over d: A rows a_addr (a tile of a_rows rows), B rows b_addr
// (b_rows rows, N of them used), both K-major [NSUB][rows][64]
template <int D, int N>
__device__ __forceinline__ void ss_over_d(float (&acc)[N / 2],
                                          uint32_t a_addr, int a_rows,
                                          uint32_t b_addr, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t sub = kk / 4, within = (kk % 4) * 32;
    MMA<N>::ss(acc,
               desc(a_addr + sub * a_rows * SUB_BYTES_PER_ROW + within, 16,
                    1024),
               desc(b_addr + sub * b_rows * SUB_BYTES_PER_ROW + within, 16,
                    1024),
               kk > 0);
  }
}

// acc += (hi + lo) B over K: B a [K rows][D] tile read MN-major
template <int D, int K>
__device__ __forceinline__ void rs_split(float (&acc)[D / 2],
                                         const uint32_t (&hi)[K / 16][4],
                                         const uint32_t (&lo)[K / 16][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc(b_addr + kk * 16 * SUB_BYTES_PER_ROW,
                             K * SUB_BYTES_PER_ROW, 1024);
    MMA<D>::rs(acc, hi[kk], db);
    MMA<D>::rs(acc, lo[kk], db);
  }
}

// rows ra and rb = ra + 8 of a [64 x D] accumulator (entry 4 j + e: row
// ra, column 8 j + 2 (lane % 4) + e; 4 j + 2 + e: row rb) times `mul` in
// bf16 to a [s][D] head; rows past s not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* head, const float (&acc)[D / 2],
                                           int ra, int s, int lane,
                                           float mul) {
  const int rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (ra < s)
      *reinterpret_cast<uint32_t*>(head + (int64_t)ra * D + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (rb < s)
      *reinterpret_cast<uint32_t*>(head + (int64_t)rb * D + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
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
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int hq, int hkv, int s, int causal,
                float scale_log2, float scale) {
  using G = Geo<D>;
  constexpr int NSUB = G::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);           // [NSUB][BM][64]
  uint8_t* sV = sK + G::BIG;                   // [NSUB][BM][64]
  uint8_t* sQ = sV + G::BIG;                   // [STAGES][NSUB][BN][64]
  uint8_t* sdO = sQ + STAGES * G::ROWS;        // [STAGES][NSUB][BN][64]
  float* sL = reinterpret_cast<float*>(sdO + STAGES * G::ROWS);  // [STAGES][BN]
  float* sD = sL + STAGES * BN;                                   // [STAGES][BN]
  // mbarriers: kv_full, full[STAGES], empty[STAGES]
  const uint32_t bars = smem_u32(sD + STAGES * BN);
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };

  const int hk = blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * BM;  // under causal the first tiles are the
  const int group = hq / hkv;      // longest: they start first
  const int bh_kv = bi * hkv + hk;
  // the walk: each query head of the group, over query tiles qt_begin
  // .. qt_end - 1 (under causal from the tile of the CTA's first key)
  const int qt_begin = causal ? k0 / BN : 0, qt_end = (s + BN - 1) / BN;
  const int n_iter = group * (qt_end - qt_begin);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1 + 32);  // the TMA thread and warp 1's lanes
      mbar_init(empty(st), 8);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 lse and D ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * G::BIG);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sK + c * BM * SUB_BYTES_PER_ROW), &tm_k, kv_full,
                 c * SUB, k0, bh_kv);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sV + c * BM * SUB_BYTES_PER_ROW), &tm_v, kv_full,
                 c * SUB, k0, bh_kv);
      Ring<STAGES> ring;
      int bh = bi * hq + hk * group, qt = qt_begin;
      for (int it = 0; it < n_iter; ++it, ring.next()) {
        const int st = ring.st;
        mbar_wait(empty(st), ring.ph ^ 1);
        uint8_t* q = sQ + st * G::ROWS;
        uint8_t* d = sdO + st * G::ROWS;
        mbar_expect_tx(full(st), 2 * G::ROWS);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(q + c * BN * SUB_BYTES_PER_ROW), &tm_q, full(st),
                   c * SUB, qt * BN, bh);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(d + c * BN * SUB_BYTES_PER_ROW), &tm_do,
                   full(st), c * SUB, qt * BN, bh);
        if (++qt == qt_end) {
          qt = qt_begin;
          ++bh;
        }
      }
    } else if (warp == 1) {
      Ring<STAGES> ring;
      const int64_t bh0 = (int64_t)bi * hq + hk * group;
      const float* lp = lse + bh0 * s;
      const float* dp = delta + bh0 * s;
      int qt = qt_begin;
      for (int it = 0; it < n_iter; ++it, ring.next()) {
        const int st = ring.st;
        mbar_wait(empty(st), ring.ph ^ 1);
        for (int r = lane; r < BN; r += 32) {
          const int row = qt * BN + r;
          sL[st * BN + r] = row < s ? lse2_of(lp[row]) : CUDART_INF_F;
          sD[st * BN + r] = row < s ? dp[row] : 0.f;
        }
        mbar_arrive(full(st));
        if (++qt == qt_end) {
          qt = qt_begin;
          lp += s;
          dp += s;
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cons = wg - 1;
    const int t = threadIdx.x - wg * 128;
    const int warp = t / 32, lane = t % 32;
    const int kw = k0 + cons * 64;  // this warpgroup's first key
    // this thread's keys (rows of S^T, dK, dV): ka and kb = ka + 8
    const int ka = kw + warp * 16 + lane / 4, kb = ka + 8;
    const uint32_t k_addr = smem_u32(sK) + cons * 64 * SUB_BYTES_PER_ROW;
    const uint32_t v_addr = k_addr + G::BIG;
    float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dv_acc[j] = dk_acc[j] = 0.f;
    mbar_wait(kv_full, 0);

    Ring<STAGES> ring;
    int qt = qt_begin;
    for (int it = 0; it < n_iter; ++it, ring.next()) {
      const int st = ring.st;
      const int q0 = qt * BN;
      if (++qt == qt_end) qt = qt_begin;
      mbar_wait(full(st), ring.ph);
      if (causal && kw > q0 + BN - 1) {  // every key after every query
        if (lane == 0) mbar_arrive(empty(st));
        continue;
      }
      const uint32_t q_addr = smem_u32(sQ + st * G::ROWS);
      const uint32_t do_addr = smem_u32(sdO + st * G::ROWS);

      // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 queries
      float sT[BN / 2], dpT[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sT[j] = dpT[j] = 0.f;
      wgmma_fence();
      ss_over_d<D, BN>(sT, k_addr, BM, q_addr, BN);
      ss_over_d<D, BN>(dpT, v_addr, BM, do_addr, BN);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sT);
      fence_regs(dpT);

      // P^T and dS^T as A fragments, hi and lo, one k-step of 16 queries
      // at a time: register r of k-step kk holds entries 8 kk + 2 r, + 1,
      // of key ka (r even) or kb (r odd) and queries q0 + col, + 1
      const bool mask = causal && kw + 63 > q0;
      const float* Lt = sL + st * BN;
      const float* Dt = sD + st * BN;
      uint32_t ph[BN / 16][4], pl[BN / 16][4], sh[BN / 16][4], sl[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const int col = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
          const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
          float p0 = exp2f(fmaf(sT[i], scale_log2, -l2.x));
          float p1 = exp2f(fmaf(sT[i + 1], scale_log2, -l2.y));
          if (mask) {
            const int key = r & 1 ? kb : ka;
            if (key > q0 + col) p0 = 0.f;
            if (key > q0 + col + 1) p1 = 0.f;
          }
          split(p0, p1, ph[kk][r], pl[kk][r]);
          split(p0 * (dpT[i] - d2.x), p1 * (dpT[i + 1] - d2.y), sh[kk][r],
                sl[kk][r]);
        }
      }

      // dV += P^T dO, dK += dS^T Q: the reduction runs over the 64 queries
      wgmma_fence();
      rs_split<D, BN>(dv_acc, ph, pl, do_addr);
      rs_split<D, BN>(dk_acc, sh, sl, q_addr);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(empty(st));
    }

    const int64_t head = (int64_t)bh_kv * s * D;
    store_rows<D>(dv + head, dv_acc, ka, s, lane, 1.f);
    store_rows<D>(dk + head, dk_acc, ka, s, lane, scale);
  }
}

// ---- dQ --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int hq, int hkv, int s, int causal,
              float scale_log2, float scale) {
  using G = Geo<D>;
  constexpr int NSUB = G::NSUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);           // [NSUB][BM][64]
  uint8_t* sdO = sQ + G::BIG;                  // [NSUB][BM][64]
  uint8_t* sK = sdO + G::BIG;                  // [STAGES][NSUB][BKQ][64]
  uint8_t* sV = sK + STAGES * G::KEYS;         // [STAGES][NSUB][BKQ][64]
  // mbarriers: q_full, full[STAGES], empty[STAGES]
  const uint32_t bars = smem_u32(sV + STAGES * G::KEYS);
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest tiles first
  const int bh = bi * hq + h, bh_kv = bi * hkv + h / (hq / hkv);
  const int kv_end = causal ? min(s, q0 + BM) : s;
  const int n_iter = (kv_end + BKQ - 1) / BKQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * G::BIG);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sQ + c * BM * SUB_BYTES_PER_ROW), &tm_q, q_full,
                 c * SUB, q0, bh);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sdO + c * BM * SUB_BYTES_PER_ROW), &tm_do, q_full,
                 c * SUB, q0, bh);
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % STAGES;
        mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        uint8_t* k = sK + st * G::KEYS;
        uint8_t* v = sV + st * G::KEYS;
        mbar_expect_tx(full(st), 2 * G::KEYS);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(k + c * BKQ * SUB_BYTES_PER_ROW), &tm_k, full(st),
                   c * SUB, it * BKQ, bh_kv);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(v + c * BKQ * SUB_BYTES_PER_ROW), &tm_v, full(st),
                   c * SUB, it * BKQ, bh_kv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cons = wg - 1;
    const int t = threadIdx.x - wg * 128;
    const int warp = t / 32, lane = t % 32;
    const int r0 = q0 + cons * 64;
    // this thread's rows of S, dP and dQ: ra and rb = ra + 8
    const int ra = r0 + warp * 16 + lane / 4, rb = ra + 8;
    const float* lp = lse + (int64_t)bh * s;
    const float* dp_ = delta + (int64_t)bh * s;
    const float la = ra < s ? lse2_of(lp[ra]) : CUDART_INF_F;
    const float lb = rb < s ? lse2_of(lp[rb]) : CUDART_INF_F;
    const float da = ra < s ? dp_[ra] : 0.f;
    const float db = rb < s ? dp_[rb] : 0.f;
    const uint32_t q_addr = smem_u32(sQ) + cons * 64 * SUB_BYTES_PER_ROW;
    const uint32_t do_addr = q_addr + G::BIG;
    float dq_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      const int kb0 = it * BKQ;
      mbar_wait(full(st), (it / STAGES) & 1);
      if (causal && kb0 > r0 + 63) {  // every key after every row
        if (lane == 0) mbar_arrive(empty(st));
        continue;
      }
      const uint32_t k_addr = smem_u32(sK + st * G::KEYS);
      const uint32_t v_addr = smem_u32(sV + st * G::KEYS);

      // S = Q K^T, dP = dO V^T: 64 rows x BKQ keys
      float sc[BKQ / 2], dp[BKQ / 2];
#pragma unroll
      for (int j = 0; j < BKQ / 2; ++j) sc[j] = dp[j] = 0.f;
      wgmma_fence();
      ss_over_d<D, BKQ>(sc, q_addr, BM, k_addr, BKQ);
      ss_over_d<D, BKQ>(dp, do_addr, BM, v_addr, BKQ);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);

      // dS as A fragments, hi and lo, one k-step of 16 keys at a time:
      // register r of k-step kk holds entries 8 kk + 2 r, + 1, of row ra
      // (r even) or rb (r odd) and keys kb0 + col, + 1
      const bool mask = kb0 + BKQ > s || (causal && kb0 + BKQ - 1 > r0);
      uint32_t hi[BKQ / 16][4], lo[BKQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float l = r & 1 ? lb : la, dd = r & 1 ? db : da;
          float p0 = exp2f(fmaf(sc[i], scale_log2, -l));
          float p1 = exp2f(fmaf(sc[i + 1], scale_log2, -l));
          if (mask) {
            const int row = r & 1 ? rb : ra;
            const int key = kb0 + 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
            if (key >= s || (causal && key > row)) p0 = 0.f;
            if (key + 1 >= s || (causal && key + 1 > row)) p1 = 0.f;
          }
          split(p0 * (dp[i] - dd), p1 * (dp[i + 1] - dd), hi[kk][r],
                lo[kk][r]);
        }
      }

      // dQ += dS K: the reduction runs over the BKQ keys
      wgmma_fence();
      rs_split<D, BKQ>(dq_acc, hi, lo, k_addr);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(empty(st));
    }

    store_rows<D>(dq + (int64_t)bh * s * D, dq_acc, ra, s, lane, scale);
  }
}

// ---- host side ------------------------------------------------------------

// the four tensor maps of a launch: q and dO over [b * hq, s, d] with boxes
// of q_rows rows, k and v over [b * hkv, s, d] with boxes of kv_rows
template <int D>
cudaError_t make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                      const void* v, const void* dout, int b, int hq,
                      int hkv, int s, int q_rows, int kv_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  if (!make_map(fn, &m[0], q, (int64_t)b * hq, s, D, q_rows) ||
      !make_map(fn, &m[1], k, (int64_t)b * hkv, s, D, kv_rows) ||
      !make_map(fn, &m[2], v, (int64_t)b * hkv, s, D, kv_rows) ||
      !make_map(fn, &m[3], dout, (int64_t)b * hq, s, D, q_rows))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int b,
                        int hq, int hkv, int s, int causal, float scale_log2,
                        float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t e = make_maps<D>(m, q, k, v, dout, b, hq, hkv, s, BN, BM);
  if (e != cudaSuccess) return e;
  constexpr int smem = Geo<D>::KV_SMEM;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, b, (s + BM - 1) / BM);
  bwd_dkdv_kernel<D><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, s, causal, scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int hq, int hkv, int s, int causal,
                      float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t e = make_maps<D>(m, q, k, v, dout, b, hq, hkv, s, BM, BKQ);
  if (e != cudaSuccess) return e;
  constexpr int smem = Geo<D>::Q_SMEM;
  e = cudaFuncSetAttribute(bwd_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(hq, b, (s + BM - 1) / BM);
  bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq), hq, hkv,
      s, causal, scale_log2, scale);
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
// heads. scale_log2 = softmax scale * log2(e). Returns cudaGetLastError()
// after the launch (cudaErrorNotSupported if the driver has no tensor maps).
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
