// Backward of the bfloat16 prefill attention at head dim 256 (gemma), for
// training, on Hopper's tensor cores (sm_90a): dq, dk and dv of
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i when causal (sq == skv), over all j otherwise. The pre
// pass D = rowsum(dO * O) is flash_attention_bwd.cu's, which takes any d.
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (autograd of src/repro/kernels/ref.py attention_ref) and has no Pallas
// backward. It is the d = 256 counterpart of flash_attention_bwd.cu's dK/dV
// and dQ kernels and is built the same way (a producer warpgroup feeding
// two consumer warpgroups by TMA through an mbarrier ring, every product on
// wgmma; the helpers are in flash_attention_bwd.cuh and wgmma.cuh), but
// that file's geometry does not fit at this width: 128-key K and V tiles
// with two stages of Q and dO need 256 KB of shared memory against the
// 232,448 B a block can have, and 64 keys' dK and dV in float32 over all
// of d are 128 KB, 256 registers a thread of one warpgroup (setmaxnreg
// gives a consumer 240). So the dK/dV kernel gives dV to one consumer and
// dK to the other.
//
// Bound on the H100: operations. The essential work is five products of
// 2 s^2 d flops a head (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), halved when
// causal, at 989 TFLOP/s dense bf16. These kernels issue ten such units:
// dK/dV six (S^T and dP^T once each, dV and dK as hi + lo parts), dQ four
// (S and dP again, dQ as hi + lo).
//
// Design:
// - bwd256_dkdv_kernel: a CTA of 3 warpgroups (384 threads) owns BK = 64
//   keys of one (b, kv head); the key tiles are the grid's slowest
//   dimension, so under causal the longest run first. Warpgroup 0 is the
//   producer (setmaxnreg 24): one thread loads K and V once by TMA (4
//   swizzled 64-column sub-tiles each), then Q and dO tiles of BN = 64
//   query rows into a ring of 2 stages, for each query head of the GQA
//   group in turn and each query tile (under causal from the tile of the
//   CTA's first key); warp 1 writes each stage's lse (times log2 e, +inf
//   for rows past s) and D. Consumer 1 (setmaxnreg 240) owns dV, consumer
//   2 dK: 64 x 256 float32, 128 registers a thread. Per stage consumer 1
//   computes S^T = K Q^T and consumer 2 dP^T = V dO^T (SS wgmma, N = 64
//   queries, 16 k-steps over d: each product once). Consumer 1 forms P^T =
//   exp2(S^T scale log2 e - lse log2 e) as hi + lo A fragments and also
//   writes it in f32 to one of two exchange buffers in shared memory (pair
//   p of thread t at [p][t]: both consumers' accumulators have the same
//   layout, so consumer 2's thread t reads what consumer 1's thread t
//   wrote, without bank conflicts); consumer 2 reads it and forms dS^T =
//   P^T (dP^T - D) as hi + lo fragments. Then dV += P^T dO and dK += dS^T
//   Q (RS wgmma, N = 256, B read MN-major), and right behind it in the
//   same commit group the next stage's S^T or dP^T, so the tensor cores
//   have both queued while the other consumer forms its fragments. Named
//   barriers over the 256 consumer threads order the exchange (ids 1 to 4;
//   0 is __syncthreads'): BAR_READY + b (consumer 1 arrives, 2 waits),
//   BAR_FREE + b (2 arrives, 1 waits before reusing buffer b).
// - dQ: flash_attention_bwd.cuh's bwd_dq_kernel, the d = 64 / 128 dQ
//   kernel, at BKQ = 32: a CTA owns BM = 128 query rows of one (b, q
//   head), the tiles reversed so the longest first; the producer loads Q
//   and dO once (64 KB each) and streams K and V tiles of 32 keys through a
//   ring of 2 stages (under causal up to the CTA's last row). Each consumer
//   owns 64 rows over all 256 columns: S = Q K^T and dP = dO V^T (SS wgmma,
//   N = 32), dS in registers as hi + lo A fragments, dQ += dS K (RS wgmma,
//   N = 256, K read MN-major). Nothing is computed twice and nothing is
//   exchanged.
// - Chosen by A/Bs on the H100 at gemma's shape (launch/attention_bwd.py
//   --shape gemma; PERF.md): this dK/dV against d split across the
//   consumers with P^T and dS^T exchanged as swizzled bf16 hi + lo tiles
//   (SS wgmma, N = 128), 4% faster, and 15% faster again with the next
//   first product queued; dQ with 32-key stages in a ring of two against
//   64-key tiles in one stage 2% faster, and 13% slower with its next
//   products queued behind dQ's. A dQ kernel of its own, with ring
//   counters, was 3% faster than the shared one, whose index arithmetic
//   measured faster at d = 128; one kernel was kept. The dK/dV consumers
//   pass K's or V's address through an empty asm statement before each
//   first product, so ptxas recomputes its sixteen descriptors per stage
//   instead of holding them across the loop: held, they spilled.
// - Registers (reckoned): a dK/dV consumer holds 128 accumulators, 32 for
//   S^T or dP^T and 32 for the fragments in flight; a dQ consumer 128 for
//   dQ, 16 each for S and dP and 16 for the fragments. ptxas's report
//   (kept by _build) shows no spills.
// - Shared memory (reckoned): dK/dV 65,536 (K, V) + 131,072 (two stages of
//   Q and dO) + 32,768 (two f32 P^T buffers) + 1,024 (lse and D) + 64
//   (mbarriers) + 1,024 (alignment to the swizzle's period) = 231,488 B;
//   dQ 131,072 (Q, dO) + 65,536 (two stages of K and V) + 64 + 1,024 =
//   197,696 B, of the 232,448 B a block can have.
// - Precision: P and dS enter their second products as bf16 hi + lo parts,
//   formed from their f32 values, as flash_attention_bwd.cu does
//   (tests/test_torch_bwd_split.py emulates it): rounding them once to
//   bf16 puts dq, dk and dv outside the tolerance the plain version is
//   held to.
// - Masks only on the tiles that cross the diagonal or the end of s. A
//   dK/dV CTA's first query tile starts at its first key, so none of its
//   stages lacks a visible pair; a dQ consumer skips the stages after its
//   last row. Rows past s are zero-filled by TMA and take lse = +inf, so
//   their P and gradients are 0; keys past s give dK/dV rows that are
//   never written, and are masked in the dQ kernel.
// - No atomics, no split reductions: each output element is summed by one
//   thread in a fixed order (dK and dV over the group's query heads in
//   turn), so every launch gives the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_bwd.cuh"
#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr int D = 256;
constexpr int NSUB = D / SUB;    // swizzled sub-tiles a row
constexpr int BK = 64;           // keys a dK/dV CTA
constexpr int BN = 64;           // query rows a dK/dV stage
constexpr int BKQ = 32;          // keys a dQ stage

constexpr int TILE_K = BK * D * 2;     // K or V of a dK/dV CTA
constexpr int TILE_N = BN * D * 2;     // a dK/dV stage's Q or dO
constexpr int TILE_X = BK * BN * 4;    // a buffer of P^T in f32
// K, V, the Q and dO stages, the two P^T buffers, lse and D of each
// stage, the mbarriers; +1024 to align to the swizzle's period
constexpr int KV_SMEM = 2 * TILE_K + STAGES * 2 * (TILE_N + BN * 4) +
                        2 * TILE_X + 64 + 1024;
static_assert(KV_SMEM <= 232448 && DqGeo<D, BKQ>::SMEM <= 232448,
              "a block has 232,448 B of shared memory");
// a dK/dV CTA's first query tile starts at its first key, so every stage
// has a visible pair and neither consumer skips one
static_assert(BK == BN, "dK/dV stages without a visible pair");
static_assert(STAGES == 2, "the last stage is st ^ 1");

// named barriers between the two consumer warpgroups of a dK/dV CTA (256
// threads; id 0 is __syncthreads'): BAR_READY + b, P^T written to buffer
// b; BAR_FREE + b, buffer b read
constexpr int BAR_READY = 1, BAR_FREE = 3;

// barrier BASE + buf, the id an immediate (with the id in a register,
// ptxas reserves all 16 barriers, and the dK/dV kernel ran 2% slower)
template <int BASE>
__device__ __forceinline__ void bar_arrive(int buf) {
  if (buf)
    asm volatile("bar.arrive %0, 256;\n" ::"n"(BASE + 1) : "memory");
  else
    asm volatile("bar.arrive %0, 256;\n" ::"n"(BASE) : "memory");
}

template <int BASE>
__device__ __forceinline__ void bar_sync(int buf) {
  if (buf)
    asm volatile("bar.sync %0, 256;\n" ::"n"(BASE + 1) : "memory");
  else
    asm volatile("bar.sync %0, 256;\n" ::"n"(BASE) : "memory");
}

// ---- dK, dV --------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
bwd256_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int hq, int hkv, int s, int causal,
                   float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);          // [NSUB][BK][64]
  uint8_t* sV = sK + TILE_K;                  // [NSUB][BK][64]
  uint8_t* sQ = sV + TILE_K;                  // [STAGES][NSUB][BN][64]
  uint8_t* sdO = sQ + STAGES * TILE_N;     // [STAGES][NSUB][BN][64]
  // two buffers of P^T in f32: pair p of consumer thread t at [p][t]
  float2* sX = reinterpret_cast<float2*>(sdO + STAGES * TILE_N);
  float* sL = reinterpret_cast<float*>(sX + 2 * TILE_X / 8);  // [STAGES][BN]
  float* sD = sL + STAGES * BN;                         // [STAGES][BN]
  // mbarriers: kv_full, full[STAGES], empty[STAGES]
  const uint32_t bars = smem_u32(sD + STAGES * BN);
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };

  const int hk = blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // under causal the first tiles are the
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
      mbar_expect_tx(kv_full, 2 * TILE_K);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sK + c * BK * SUB_BYTES_PER_ROW), &tm_k, kv_full,
                 c * SUB, k0, bh_kv);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sV + c * BK * SUB_BYTES_PER_ROW), &tm_v, kv_full,
                 c * SUB, k0, bh_kv);
      Ring<STAGES> ring;
      int bh = bi * hq + hk * group, qt = qt_begin;
      for (int it = 0; it < n_iter; ++it, ring.next()) {
        const int st = ring.st;
        mbar_wait(empty(st), ring.ph ^ 1);
        uint8_t* q = sQ + st * TILE_N;
        uint8_t* d = sdO + st * TILE_N;
        mbar_expect_tx(full(st), 2 * TILE_N);
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
    // ---- consumers: all 64 keys and all of d; dV (1), dK (2) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cons = wg - 1;
    const int t = threadIdx.x - wg * 128;
    const int warp = t / 32, lane = t % 32;
    // this thread's keys (rows of S^T, dP^T, dV, dK): ka and ka + 8
    const int ka = k0 + warp * 16 + lane / 4;
    // consumer 1 forms S^T from K, consumer 2 dP^T from V
    const uint32_t kv_addr = smem_u32(cons ? sV : sK);
    float out[D / 2];  // dV or dK
#pragma unroll
    for (int j = 0; j < D / 2; ++j) out[j] = 0.f;
    mbar_wait(kv_full, 0);

    // S^T = K Q^T (consumer 1) or dP^T = V dO^T (consumer 2) of a stage:
    // 64 keys x 64 queries, SS wgmma over d (not committed)
    auto first_product = [&](float (&acc)[BN / 2], int st) {
      // opaque, so the descriptors of K or V are not kept across stages
      uint32_t a = kv_addr;
      asm volatile("" : "+r"(a));
      ss_over_d<D, BN>(acc, a, BK,
                       smem_u32((cons ? sdO : sQ) + st * TILE_N), BN);
    };
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    Ring<STAGES> ring;
    mbar_wait(full(0), 0);
    wgmma_fence();
    first_product(acc, 0);
    wgmma_commit();
    int qt = qt_begin;
    for (int it = 0; it < n_iter; ++it) {
      const int st = ring.st;
      const int q0 = qt * BN;
      if (++qt == qt_end) qt = qt_begin;
      // this stage's first product and the last stage's second are done
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(out);
      if (it > 0 && lane == 0) mbar_arrive(empty(st ^ 1));

      // P^T (consumer 1) or dS^T (consumer 2) as A fragments, hi and lo,
      // one k-step of 16 queries at a time: register r of k-step kk holds
      // entries i = 8 kk + 2 r, + 1 (pair i / 2 of the P^T buffer), of key
      // ka (r even) or ka + 8 (r odd) and queries q0 + col, + 1
      const int buf = it & 1;
      float2* x = sX + buf * (TILE_X / 8) + t;
      const bool mask = causal && k0 + BK - 1 > q0;
      uint32_t hi[BN / 16][4], lo[BN / 16][4];
      if (cons == 0) {
        if (it >= 2) bar_sync<BAR_FREE>(buf);
        const float* Lt = sL + st * BN;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const int col = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
            const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
            float p0 = exp2f(fmaf(acc[i], scale_log2, -l2.x));
            float p1 = exp2f(fmaf(acc[i + 1], scale_log2, -l2.y));
            if (mask) {
              const int key = ka + 8 * (r & 1);
              if (key > q0 + col) p0 = 0.f;
              if (key > q0 + col + 1) p1 = 0.f;
            }
            x[(i / 2) * 128] = make_float2(p0, p1);
            split(p0, p1, hi[kk][r], lo[kk][r]);
          }
        }
        bar_arrive<BAR_READY>(buf);
      } else {
        const float* Dt = sD + st * BN;
        bar_sync<BAR_READY>(buf);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kk + 2 * r;
            const int col = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
            const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
            const float2 p = x[(i / 2) * 128];
            split(p.x * (acc[i] - d2.x), p.y * (acc[i + 1] - d2.y),
                  hi[kk][r], lo[kk][r]);
          }
        }
        if (it + 2 < n_iter) bar_arrive<BAR_FREE>(buf);
      }

      // dV += P^T dO or dK += dS^T Q (the reduction runs over the 64
      // queries), then the next stage's first product behind it in the
      // same group, so the tensor cores have both queued
      wgmma_fence();
      rs_split<D, BN>(out, hi, lo,
                      smem_u32((cons ? sQ : sdO) + st * TILE_N));
      ring.next();
      if (it + 1 < n_iter) {
        mbar_wait(full(ring.st), ring.ph);
        first_product(acc, ring.st);
      }
      wgmma_commit();
    }
    wgmma_wait0();
    fence_regs(out);
    if (lane == 0) mbar_arrive(empty(ring.st ^ 1));

    const int64_t head = (int64_t)bh_kv * s * D;
    if (cons == 0)
      store_rows<D>(dv + head, out, ka, s, lane, 1.f);
    else
      store_rows<D>(dk + head, out, ka, s, lane, scale);
  }
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
// cudaGetLastError() after the launch (cudaErrorNotSupported without
// cuTensorMapEncodeTiled).
extern "C" int flash_attention_bwd256_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s, int d, int causal, float scale_log2, float scale,
    void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps<D>(m, q, k, v, dout, b, hq, hkv, s, BN, BK);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd256_dkdv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hkv, b, (s + BK - 1) / BK);
  bwd256_dkdv_kernel<<<grid, THREADS, KV_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, s, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

// dq [b, hq, s, 256] bfloat16; the other arguments as for the dk/dv entry.
extern "C" int flash_attention_bwd256_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int hq, int hkv,
    int s, int d, int causal, float scale_log2, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  return (int)launch_dq<D, BKQ>(q, k, v, dout, lse, delta, dq, b, hq, hkv, s,
                                causal, scale_log2, scale,
                                static_cast<cudaStream_t>(stream));
}
