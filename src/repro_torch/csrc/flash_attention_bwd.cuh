// What the attention backward's sources, flash_attention_bwd.cu (d 64 and
// 128) and flash_attention_bwd256.cu (d 256), share: the ring of mbarrier
// stages, the hi + lo split of A fragments, the wgmma loops over d and over
// a streamed tile, the store of an accumulator's rows, the dQ kernel (the
// same at every d but for its stage of BKQ keys) and, on the host, a
// launch's four tensor maps and the dQ launch. Tiles and descriptors are
// wgmma.cuh's; the dQ kernel's design is described in
// flash_attention_bwd.cu. At d = 16 and 32 a tile holds `padded(d)` = 64
// columns, those past d zero-filled by TMA (flash_attention_bwd.cu's
// header), and the products that write d's columns run at N = 64.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int BM = 128;        // query rows a dQ CTA (keys a d 64 / 128
                               // dK/dV CTA)
constexpr int STAGES = 2;      // the ring of streamed tiles

typedef __nv_bfloat16 bf16;

// the columns a shared-memory tile holds at head dim d: one 64-column box
// at d < 64, its columns past d zero-filled by TMA; d otherwise
constexpr int padded(int d) { return d < SUB ? SUB : d; }

// lse in log2 units; a row with lse = -inf (no visible key) takes +inf,
// so its P is 0
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
// ra, column 8 j + 2 (lane % 4) + e; 4 j + 2 + e: row rb; A / 2 columns
// held, D of them written) times `mul` in bf16 to a [s][D] head; rows
// past s not written
template <int D, int A>
__device__ __forceinline__ void store_rows(bf16* head, const float (&acc)[A],
                                           int ra, int s, int lane,
                                           float mul) {
  static_assert(2 * A >= D, "the accumulator holds d's columns");
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

// ---- dQ --------------------------------------------------------------------

// the dQ kernel's tiles: Q and dO of a CTA, a stage's K or V; its shared
// memory holds Q, dO, the K and V stages and the mbarriers (+1024 to align
// to the swizzle's period)
template <int D, int BKQ>
struct DqGeo {
  static constexpr int DP = padded(D);            // columns a tile holds
  static constexpr int NSUB = DP / SUB;           // sub-tiles per row
  static constexpr int BIG = BM * DP * 2;         // a 128-row tile
  static constexpr int KEYS = BKQ * DP * 2;       // a stage's K or V
  static constexpr int SMEM = 2 * BIG + STAGES * 2 * KEYS + 64 + 1024;
};

template <int D, int BKQ>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int hq, int hkv, int s, int causal,
              float scale_log2, float scale) {
  using G = DqGeo<D, BKQ>;
  constexpr int NSUB = G::NSUB, DP = G::DP;
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
    float dq_acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dq_acc[j] = 0.f;
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
      rs_split<DP, BKQ>(dq_acc, hi, lo, k_addr);
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

template <int D, int BKQ>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int hq, int hkv, int s, int causal,
                      float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t e = make_maps<D>(m, q, k, v, dout, b, hq, hkv, s, BM, BKQ);
  if (e != cudaSuccess) return e;
  constexpr int smem = DqGeo<D, BKQ>::SMEM;
  e = cudaFuncSetAttribute(bwd_dq_kernel<D, BKQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(hq, b, (s + BM - 1) / BM);
  bwd_dq_kernel<D, BKQ><<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq), hq, hkv,
      s, causal, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace
