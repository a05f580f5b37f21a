// Backward of the bfloat16 prefill attention on Hopper's tensor cores
// (sm_90a) at head dims 16, 32, 64 and 128, for training: dq, dk and dv of
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
// again, dQ as hi + lo). At d = 16 and 32 the hi + lo products run at N =
// 64 over zero columns (below), 64 / d times a product's work each.
// kernels/flash_attention.py's BWD_PRODUCTS["bfloat16"] mirrors this line:
// products (dK/dV, dQ) by d: 16: 18, 10; 32: 10, 6; 64: 6, 4; 128: 6, 4
//
// Design (warp-specialised, TMA-fed, wgmma for every product, as the
// forward; the PTX wrappers and tensor maps are in wgmma.cuh, the helpers
// shared with flash_attention_bwd256.cu in flash_attention_bwd.cuh):
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
// - bwd_dq_kernel (in flash_attention_bwd.cuh, which the d = 256 backward
//   shares with 32-key stages): a CTA owns 128 query rows of one (b, q
//   head), the tiles reversed so the longest run first; the producer loads
//   Q and dO once and streams K and V tiles of BKQ = 128 keys through the
//   ring (under causal up to the CTA's last row); each consumer recomputes
//   S = Q K^T and dP = dO V^T (SS wgmma, N = 128), dS in registers, and
//   dQ += dS K (RS wgmma, K MN-major).
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
// - Head dims 16 and 32 (the reference's smoke configs; route (a) of the
//   small dims: these kernels at D = 16 and 32): every tile is one TMA box
//   of 64 columns, wider than the tensor's d, and TMA zero-fills the
//   columns past d in shared memory (HBM is read for d columns only; the
//   transaction bytes count the whole box, as expect_tx arms them). S^T,
//   dP^T, S and dP run over d's k-steps only (1 or 2 of 16); dV, dK and dQ
//   accumulate at N = 64 over the zero columns of dO, Q and K (`padded`),
//   and only d columns are written. The swizzle and the descriptors are
//   d = 64's, so the layouts need no other case.
// - No atomics, no split reductions: each output element is summed by one
//   thread in a fixed order, so every launch gives the same bits (a resumed
//   training run must reproduce its state byte for byte). dQ therefore has
//   its own kernel rather than an ordered reduction across dK/dV CTAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_bwd.cuh"
#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BN = 64;         // query rows a dK/dV stage
constexpr int BKQ = 128;       // keys a dQ stage

template <int D>
struct Geo {
  static constexpr int DP = padded(D);            // columns a tile holds
  static constexpr int NSUB = DP / SUB;           // sub-tiles per row
  static constexpr int BIG = BM * DP * 2;         // a 128-row tile
  static constexpr int ROWS = BN * DP * 2;        // a dK/dV stage's Q or dO
  // K, V, the Q and dO stages, lse and D of each stage, the mbarriers;
  // +1024 to align to the swizzle's period
  static constexpr int KV_SMEM =
      2 * BIG + STAGES * 2 * (ROWS + BN * 4) + 64 + 1024;
};

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
  constexpr int NSUB = G::NSUB, DP = G::DP;
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
    float dv_acc[DP / 2], dk_acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dv_acc[j] = dk_acc[j] = 0.f;
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
      rs_split<DP, BN>(dv_acc, ph, pl, do_addr);
      rs_split<DP, BN>(dk_acc, sh, sl, q_addr);
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

// ---- host side ------------------------------------------------------------

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

bool bad_shape(int b, int hq, int hkv, int s, int d) {
  return b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
         (d != 16 && d != 32 && d != 64 && d != 128);
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
// bfloat16, 16-byte aligned; lse, delta [b, hq, s] float32; d in {16, 32,
// 64, 128};
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
  switch (d) {
    case 16:
      return (int)launch_dkdv<16>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s, causal, scale_log2, scale, st);
    case 32:
      return (int)launch_dkdv<32>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s, causal, scale_log2, scale, st);
    case 64:
      return (int)launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                  hkv, s, causal, scale_log2, scale, st);
    default:
      return (int)launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, b, hq,
                                   hkv, s, causal, scale_log2, scale, st);
  }
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
  switch (d) {
    case 16:
      return (int)launch_dq<16, BKQ>(q, k, v, dout, lse, delta, dq, b, hq,
                                     hkv, s, causal, scale_log2, scale, st);
    case 32:
      return (int)launch_dq<32, BKQ>(q, k, v, dout, lse, delta, dq, b, hq,
                                     hkv, s, causal, scale_log2, scale, st);
    case 64:
      return (int)launch_dq<64, BKQ>(q, k, v, dout, lse, delta, dq, b, hq,
                                     hkv, s, causal, scale_log2, scale, st);
    default:
      return (int)launch_dq<128, BKQ>(q, k, v, dout, lse, delta, dq, b, hq,
                                      hkv, s, causal, scale_log2, scale, st);
  }
}
