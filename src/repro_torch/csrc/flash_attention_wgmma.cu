// Prefill attention on Hopper's tensor cores (sm_90a) for bfloat16 q, k
// and v: warp-specialised, TMA-fed, wgmma for both products.
//
// Replaces `_attn_kernel` of src/repro/kernels/flash_attention.py (via
// flash_attention_pallas) for bf16 inputs at head dims 16, 32, 64, 128 and
// 256:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i + (skv - sq) when causal (the mask is aligned to the
// end), over all j otherwise; a row with no visible key gives 0; any sq
// and skv. float32 inputs go to flash_attention_tf32.cu (error-compensated
// TF32 on mma.sync).
//
// Bound on the H100: operations. 4 d flops per visible (query, key) pair
// at 989 TFLOP/s dense bf16; q, k, v and out cross HBM once.
//
// Design (one CTA of 3 warpgroups per 128 query rows of one head):
// - Warpgroup 0 is the producer. It gives up registers (setmaxnreg 24),
//   and one thread issues the TMA loads: the CTA's Q tile once, then K
//   and V tiles of BK keys into a ring of STAGES stages, each signalled
//   on its own mbarrier (the transaction bytes), each stage released by
//   the consumers on an `empty` mbarrier. The tensor maps are 3-D over
//   [b * heads, s, d] with the 128-byte swizzle and boxes of 64 columns,
//   so rows past sq or skv are zero-filled and never read from the next
//   head; they are built on the host (cuTensorMapEncodeTiled) and passed
//   as __grid_constant__ parameters. The PTX wrappers and the tensor maps
//   are in wgmma.cuh, shared with the backward (flash_attention_bwd.cu).
// - Warpgroups 1 and 2 are consumers of 64 query rows each (setmaxnreg
//   240). Per KV tile: S = Q K^T by wgmma with both operands in shared
//   memory (K-major as stored), f32 accumulators in registers; the
//   online softmax in exp2 form with the scale folded in, the row max
//   over the 4 lanes that share a row by shuffles; then O += P V by wgmma
//   with P from registers (the S accumulator's fragment layout is the A
//   operand's) and V from shared memory MN-major (transposed).
// - Precision: P is split into bf16 hi + lo parts, two wgmmas each, so
//   P V is exact to about 2^-16 of each p, as the float32 plain version
//   computes it; rounding P once to bf16 puts the output 5 to 11 times
//   outside rtol 1e-2 / atol 1e-4 on random inputs.
// - Causal: a CTA visits only the KV tiles up to its last row's last
//   visible key, masks only the tiles that cross the diagonal or the end
//   of the keys, and the grid runs the longest q tiles first (the q-tile
//   index is the grid's slowest dimension, reversed).
// - Head dims 16 and 32 (the reference's smoke configs; route (a) of the
//   small dims: the same kernel): a tile is one box of SUB = 64 columns,
//   wider than the tensor's d, and TMA zero-fills the columns past d in
//   shared memory (HBM is read for d columns only; the transaction bytes
//   count the whole box). S runs over d's k-steps only (1 or 2 of 16),
//   P V at N = 64 over the zero columns of V, and only d columns of O are
//   written. The 128-byte swizzle and the descriptors are d = 64's.
// - Epilogue: O / l (0 where l = 0) in bf16 straight from registers; rows
//   past sq are not written. With an lse pointer (the training forward),
//   each row's natural log-sum-exp of its visible scaled scores,
//   (m * scale_log2 + log2 l) * ln 2, goes to lse[b, h, row] in f32, -inf
//   where l = 0; with a null pointer (serving) nothing more is written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 128;        // query rows per CTA: 2 consumers x 64
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int STAGES = 2;

template <int D>
struct Cfg {
  static constexpr int BK = D >= 256 ? 64 : 128;       // keys per tile
  static constexpr int DP = D < SUB ? SUB : D;         // columns a tile holds
  static constexpr int NSUB = DP / SUB;                // sub-tiles per row
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;         // one K or V tile
  // Q, then K stages, then V stages, then the mbarriers; +1024 to align
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

// ---- the kernel -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int hq, int hkv, int sq, int skv, int causal,
                  float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NSUB = C::NSUB, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                         // [NSUB][BQ][64]
  uint8_t* sK = sQ + C::Q_BYTES;              // [STAGES][NSUB][BK][64]
  uint8_t* sV = sK + STAGES * C::KV_BYTES;    // [STAGES][NSUB][BK][64]
  // mbarriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  const uint32_t bars = smem_u32(sV + STAGES * C::KV_BYTES);
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int off = skv - sq;  // query row i sees keys j <= i + off
  const int bh_q = bi * hq + h, bh_kv = bi * hkv + h / (hq / hkv);
  int kv_end = skv;
  if (causal) {
    const int last = min(q0 + BQ, sq) - 1 + off;  // last row's last key
    kv_end = max(0, min(skv, last + 1));
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < NSUB; ++c)
        tma_load(smem_u32(sQ + c * BQ * SUB_BYTES_PER_ROW), &tm_q, q_full,
                 c * SUB, q0, bh_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        uint8_t* k = sK + s * C::KV_BYTES;
        uint8_t* v = sV + s * C::KV_BYTES;
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(k + c * BK * SUB_BYTES_PER_ROW), &tm_k, k_full(s),
                   c * SUB, i * BK, bh_kv);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int c = 0; c < NSUB; ++c)
          tma_load(smem_u32(v + c * BK * SUB_BYTES_PER_ROW), &tm_v, v_full(s),
                   c * SUB, i * BK, bh_kv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cons = wg - 1;
    const int t = threadIdx.x - wg * 128;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + cons * 64;
    // this thread's rows of S and O: ra and rb = ra + 8
    const int ra = row0 + warp * 16 + lane / 4;
    const int rb = ra + 8;
    float o[DP / 2];  // DP - D columns of zeros at d < 64
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
    float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
    const uint32_t q_addr = smem_u32(sQ) + cons * 64 * SUB_BYTES_PER_ROW;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int kv0 = i * BK;
      const uint32_t k_addr = smem_u32(sK + s * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(sV + s * C::KV_BYTES);

      // S = Q K^T: D / 16 steps of 16 columns of d
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t sub = kk / 4, within = (kk % 4) * 32;
        const uint64_t da =
            desc(q_addr + sub * BQ * SUB_BYTES_PER_ROW + within, 16, 1024);
        const uint64_t db =
            desc(k_addr + sub * BK * SUB_BYTES_PER_ROW + within, 16, 1024);
        MMA<BK>::ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // online softmax; entry 4j + e is (row ra, key kv0 + 8j + 2 (lane % 4)
      // + e), entry 4j + 2 + e the same key for row rb
      const bool mask =
          kv0 + BK > skv || (causal && kv0 + BK - 1 > row0 + off);
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (mask) {
            const int col = kv0 + 8 * j + 2 * (lane & 3) + e;
            if (col >= skv || (causal && col > ra + off))
              sc[4 * j + e] = -CUDART_INF_F;
            if (col >= skv || (causal && col > rb + off))
              sc[4 * j + 2 + e] = -CUDART_INF_F;
          }
          mx_a = fmaxf(mx_a, sc[4 * j + e]);
          mx_b = fmaxf(mx_b, sc[4 * j + 2 + e]);
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, x));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float mu_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
      const float mu_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
      const float alpha_a = exp2f((m_a - mu_a) * scale_log2);
      const float alpha_b = exp2f((m_b - mu_b) * scale_log2);
      const float ms_a = mu_a * scale_log2, ms_b = mu_b * scale_log2;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa = exp2f(fmaf(sc[4 * j + e], scale_log2, -ms_a));
          const float pb = exp2f(fmaf(sc[4 * j + 2 + e], scale_log2, -ms_b));
          sc[4 * j + e] = pa;
          sc[4 * j + 2 + e] = pb;
          sum_a += pa;
          sum_b += pb;
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // P as the A operand, split into bf16 hi + lo: entries 8 kk + 2 r and
      // 8 kk + 2 r + 1 are register r of k-step kk
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
          hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[kk][r] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
        }
      }

      // O += P V: BK / 16 steps of 16 keys; V is MN-major, its 64-column
      // sub-tiles BK * 128 bytes apart
      mbar_wait(v_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc(v_addr + kk * 16 * SUB_BYTES_PER_ROW,
                                 BK * SUB_BYTES_PER_ROW, 1024);
        MMA<DP>::rs(o, hi[kk], db);
        MMA<DP>::rs(o, lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: the row sums over the 4 lanes of a row, O / l in bf16
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_a += __shfl_xor_sync(FULL, l_a, x);
      l_b += __shfl_xor_sync(FULL, l_b, x);
    }
    const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
    const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
    if (lse != nullptr && (lane & 3) == 0) {
      constexpr float LN2 = 0.69314718055994531f;
      float* lp = lse + (int64_t)bh_q * sq;
      if (ra < sq)
        lp[ra] = l_a == 0.f ? -CUDART_INF_F
                            : fmaf(m_a, scale_log2, log2f(l_a)) * LN2;
      if (rb < sq)
        lp[rb] = l_b == 0.f ? -CUDART_INF_F
                            : fmaf(m_b, scale_log2, log2f(l_b)) * LN2;
    }
    __nv_bfloat16* op = out + (int64_t)bh_q * sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (ra < sq)
        *reinterpret_cast<uint32_t*>(op + (int64_t)ra * D + col) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (rb < sq)
        *reinterpret_cast<uint32_t*>(op + (int64_t)rb * D + col) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

// ---- host side ------------------------------------------------------------

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int hq, int hkv, int sq, int skv,
                   int causal, float scale_log2, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(fn, &mq, q, (int64_t)b * hq, sq, D, BQ) ||
      !make_map(fn, &mk, k, (int64_t)b * hkv, skv, D, C::BK) ||
      !make_map(fn, &mv, v, (int64_t)b * hkv, skv, D, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  attn_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, hq, hkv, sq, skv,
      causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [b, hq, sq, d], k and v [b, hkv, skv, d], out [b, hq, sq, d], all
// contiguous bfloat16, 16-byte aligned; d in {16, 32, 64, 128, 256};
// hq % hkv == 0. scale_log2 = softmax scale * log2(e). lse: null, or
// [b, hq, sq] float32 contiguous for each row's log-sum-exp. Returns
// cudaGetLastError() after the launch (cudaErrorNotSupported if the
// driver has no tensor maps).
extern "C" int flash_attention_wgmma_lse(const void* q, const void* k,
                                         const void* v, void* out,
                                         float* lse, int b, int hq, int hkv,
                                         int sq, int skv, int d, int causal,
                                         float scale_log2, void* stream) {
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skv <= 0) {  // no key: every row gives 0 (no lse to give)
    if (lse != nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaMemsetAsync(out, 0, (size_t)b * hq * sq * d * 2, s);
  }
  switch (d) {
    case 16:
      return (int)launch<16>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                             scale_log2, s);
    case 32:
      return (int)launch<32>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                             scale_log2, s);
    case 64:
      return (int)launch<64>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                             scale_log2, s);
    case 128:
      return (int)launch<128>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                              scale_log2, s);
    case 256:
      return (int)launch<256>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                              scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The serving entry: flash_attention_wgmma_lse without the lse output.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hkv, int sq, int skv, int d,
                                     int causal, float scale_log2,
                                     void* stream) {
  return flash_attention_wgmma_lse(q, k, v, out, nullptr, b, hq, hkv, sq, skv,
                                   d, causal, scale_log2, stream);
}
