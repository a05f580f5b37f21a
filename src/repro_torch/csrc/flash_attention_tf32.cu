// Prefill attention on Hopper's tensor cores (sm_90a) for float32 q, k and
// v: error-compensated TF32 (3xTF32) with mma.sync for both products.
//
// Replaces `_attn_kernel` of src/repro/kernels/flash_attention.py (via
// flash_attention_pallas) for float32 inputs at head dims 16, 32, 64, 128
// and 256:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i + (skv - sq) when causal (the mask is aligned to the
// end), over all j otherwise; a row with no visible key gives 0; any sq
// and skv. bfloat16 inputs go to flash_attention_wgmma.cu.
//
// Bound on the H100: operations. 4 d flops per visible (query, key) pair,
// done three times over (below) at 495 TFLOP/s dense TF32; the f32 FMA
// bound of a CUDA-core kernel (67 TFLOP/s) is 2.5 times higher. q, k, v
// and out cross HBM once.
//
// Precision: a tensor core in TF32 mode reads an f32 register and ignores
// its low 13 bits (truncation), so one TF32 pass keeps 11 significant bits
// and misses the float32 tolerance by orders of magnitude once scores span
// tens of units (tests/test_torch_tf32_split.py). Each operand x is split
// into hi = cvt.rna.tf32.f32(x), with the low 13 bits cleared so that the
// hardware uses exactly hi, and lo = x - hi (exact in f32; the hardware
// keeps its top 11 bits), and a . b = lo_a hi_b + hi_a lo_b + hi_a hi_b,
// the small products first, about 22 significant bits. Accumulation: a
// tensor core adds into its accumulator rounding toward zero, which over
// many steps biases a long sum (Q K^T accumulated straight into S misses
// the tolerance at d = 128 and 256 on scores spanning +-60, PERF.md), so
// every two d steps of Q K^T go into a fresh fragment that is added to S
// in f32 (round to nearest), and each KV tile's P V goes into a fresh
// fragment merged into O by one FMA with the softmax rescale.
//
// Design (one CTA of NW warps, 16 query rows a warp, per (q tile, head,
// batch); CUDA cores do the splits and the softmax, the tensor cores the
// products):
// - mma.sync.m16n8k8.tf32 for both products: its fragments are read from
//   row-major tiles in shared memory, so V needs no transposed copy (wgmma
//   takes TF32 operands K-major only, and V is stored MN-major for P V).
//   The splits are done on the fragments in registers, so shared memory
//   holds each tile once, in f32, and a d = 128 CTA fits twice on an SM.
// - Q K^T: the k index of a fragment maps to the d columns 2t and 2t + 1
//   of an 8-column step (t = lane % 4), the same for Q and K, so each
//   fragment pair is one 8-byte load; Q and K rows are D + 8 floats apart,
//   which makes those loads conflict-free.
// - P V: the S accumulator's fragment is P's A fragment with its key
//   order permuted (keys 2t and 2t + 1 of each 8), so P never leaves
//   registers; V's B fragment then reads rows 2t and 2t + 1, D + 4 floats
//   apart (conflict-free 4-byte loads).
// - Copies: Q is staged once per CTA; K and V tiles of BK keys stream
//   through a ring of STAGES stages with cp.async (16 bytes a copy, rows
//   past skv zero-filled), tile i + STAGES - 1 in flight while tile i is
//   computed, one barrier a tile to recycle a stage.
// - Online softmax in exp2 form with scale * log2(e) folded into Q; the row
//   max over the 4 lanes that share a row by shuffles, the row sum kept per
//   lane and reduced once at the end.
// - Causal: a CTA visits only the KV tiles up to its last row's last
//   visible key; a warp skips the tiles past its own last visible key and
//   masks only the tiles that cross its diagonal or the end of the keys;
//   the grid runs the longest q tiles first (the q-tile index is the
//   grid's slowest dimension, reversed). No atomics: the same bits on
//   every run.
// - Epilogue: O / l, rows past sq not written. With an lse pointer (the
//   training forward, whose backward is flash_attention_bwd_tf32.cu; the
//   kernel's LSE instantiation) lane t = 0 of each row also writes the
//   row's natural log-sum-exp, from the m and l the epilogue already holds;
//   serving (a null pointer) runs the instantiation without the store,
//   whose code and outputs are the kernel's without an lse.
// - The copies, the split and the three products live in tf32x3.cuh, which
//   the backward shares.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;

// warps per CTA (16 query rows each), keys per KV tile, and CTAs an SM
// holds (launch bound; MINB_LSE for the instantiation that writes the
// lse, which spilled 12 bytes at d = 64 under 4): d = 64 and 128 fit
// several CTAs per SM in shared memory; d = 256 takes one CTA of 8 warps
// with 16-key tiles. d = 16 and 32 (the reference's smoke configs): rows
// this short leave registers and shared memory to spare, so d = 16 takes
// 64-key tiles (its S needs no fresh fragment: NK = KG) and both fit 4
// CTAs an SM. The row strides D + 8 and D + 4 stay conflict-free there:
// at D + 8 = 24 or 40 floats the 8-byte loads of a half warp's 4 rows
// start 0, 24, 16, 8 (or 0, 8, 16, 24) banks apart, and at D + 4 = 20 or
// 36 the 4-byte loads of rows 2t start 0, 8, 16, 24 banks apart.
template <int D>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int NW = 4, BK = 64, MINB = 4, MINB_LSE = 4;
};
template <>
struct Cfg<32> {
  static constexpr int NW = 4, BK = 32, MINB = 4, MINB_LSE = 4;
};
template <>
struct Cfg<64> {
  static constexpr int NW = 4, BK = 32, MINB = 4, MINB_LSE = 3;
};
template <>
struct Cfg<128> {
  static constexpr int NW = 4, BK = 32, MINB = 2, MINB_LSE = 2;
};
template <>
struct Cfg<256> {
  static constexpr int NW = 8, BK = 16, MINB = 1, MINB_LSE = 1;
};

template <int D>
struct Geo {
  static constexpr int NW = Cfg<D>::NW, BK = Cfg<D>::BK;
  static constexpr int BQ = 16 * NW, THREADS = 32 * NW;
  static constexpr int QS = D + 8, KS = D + 8, VS = D + 4;  // row strides
  static constexpr int Q_FLOATS = BQ * QS;
  static constexpr int K_FLOATS = BK * KS, V_FLOATS = BK * VS;
  static constexpr int STAGE_FLOATS = K_FLOATS + V_FLOATS;
  static constexpr int SMEM =
      (int)sizeof(float) * (Q_FLOATS + STAGES * STAGE_FLOATS);
};

template <int D, bool LSE>
__global__ void __launch_bounds__(Geo<D>::THREADS,
                                  LSE ? Cfg<D>::MINB_LSE : Cfg<D>::MINB)
attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 int causal, float scale_log2) {
  using G = Geo<D>;
  constexpr int BK = G::BK, BQ = G::BQ, NT = G::THREADS;
  constexpr int QS = G::QS, KS = G::KS, VS = G::VS;
  constexpr int NJ = BK / 8;  // key steps of 8 in a tile
  constexpr int NK = D / 8;   // d steps of 8
  constexpr int KG = 2;       // d steps of Q K^T a fragment
  constexpr int NG = NK < 4 ? NK : 4;  // d steps of O merged together
  constexpr int CPR = D / 4;  // 16-byte copies per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][QS]
  float* ring = smem + G::Q_FLOATS;   // [STAGES][K: BK][KS], V: [BK][VS]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int off = skv - sq;  // query row i sees keys j <= i + off
  const int kvh = h / (hq / hkv);
  const float* qp = q + ((int64_t)bi * hq + h) * sq * D;
  const float* kp = k + ((int64_t)bi * hkv + kvh) * skv * D;
  const float* vp = v + ((int64_t)bi * hkv + kvh) * skv * D;
  int kv_end = skv;
  if (causal) {
    const int last = min(q0 + BQ, sq) - 1 + off;  // last row's last key
    kv_end = max(0, min(skv, last + 1));
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_tile = [&](int i) {
    float* ks = ring + (i % STAGES) * G::STAGE_FLOATS;
    float* vs = ks + G::K_FLOATS;
    const int kv0 = i * BK;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = kv0 + r < skv;
      const int64_t go = in ? (int64_t)(kv0 + r) * D + col : 0;
      cp_async16(smem_addr(ks + r * KS + col), kp + go, in ? 16 : 0);
      cp_async16(smem_addr(vs + r * VS + col), vp + go, in ? 16 : 0);
    }
  };

  // Q with tile 0, then tiles 1 .. STAGES - 2: one copy group each
  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, col = (c - r * CPR) * 4;
    const bool in = q0 + r < sq;
    cp_async16(smem_addr(Qs + r * QS + col),
               qp + (in ? (int64_t)(q0 + r) * D + col : 0), in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // this warp's rows: ra (fragment entries 0, 1) and rb = ra + 8 (2, 3)
  const int w0 = q0 + 16 * warp;
  const int ra = w0 + g, rb = ra + 8;
  const bool live = w0 < sq;
  const int w_last = causal ? min(w0 + 15, sq - 1) + off : skv - 1;

  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  const float* qa = Qs + (16 * warp + g) * QS + 2 * t;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i
    __syncthreads();              // everyone's, and tile i - 1 is done
    if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
    cp_async_commit();
    const int kv0 = i * BK;
    if (i == 0 && live) {  // the warp's own Q rows, scaled in place once
      for (int c = lane; c < 16 * CPR; c += 32) {
        float4* x = reinterpret_cast<float4*>(
            Qs + (16 * warp + c / CPR) * QS + (c % CPR) * 4);
        float4 y = *x;
        y.x *= scale_log2;
        y.y *= scale_log2;
        y.z *= scale_log2;
        y.w *= scale_log2;
        *x = y;
      }
      __syncwarp();
    }
    if (!live || kv0 > w_last) continue;  // no row of the warp sees a key
    const float* ks = ring + (i % STAGES) * G::STAGE_FLOATS;
    const float* vs = ks + G::K_FLOATS;

    // S = (Q scale_log2) K^T; after the first KG d steps, each KG steps
    // go into a fresh fragment that is added to S in f32
    float s[NJ][4], f[NJ][4];
    const float* kb = ks + g * KS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(qa + 8 * QS + 8 * kk);
      uint32_t ah[4], al[4];
      split(x0.x, ah[0], al[0]);
      split(x1.x, ah[1], al[1]);
      split(x0.y, ah[2], al[2]);
      split(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(kb + 8 * j * KS + 8 * kk);
        uint32_t bh0, bl0, bh1, bl1;
        split(y.x, bh0, bl0);
        split(y.y, bh1, bl1);
        mma3(kk < KG ? s[j] : f[j], ah, al, bh0, bh1, bl0, bl1,
             kk % KG == 0);
        if (kk >= KG && kk % KG == KG - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += f[j][e];
        }
      }
    }

    // online softmax; s[j][e] is (row e < 2 ? ra : rb, key kv0 + 8 j +
    // 2 t + (e & 1))
    if (kv0 + BK > skv || (causal && kv0 + BK - 1 > w0 + off)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? ra : rb;
          if (col >= skv || (causal && col > row + off))
            s[j][e] = -CUDART_INF_F;
        }
    }
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float mu_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float mu_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - mu_a), alpha_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    // P as the A fragment of P V (keys 2t and 2t + 1 of each step of 8 as
    // the fragment's k indices t and t + 4), split into hi and lo
    uint32_t ph[NJ][4], pl[NJ][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p0 = exp2f(s[j][0] - mu_a), p1 = exp2f(s[j][1] - mu_a);
      const float p2 = exp2f(s[j][2] - mu_b), p3 = exp2f(s[j][3] - mu_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      split(p0, ph[j][0], pl[j][0]);
      split(p2, ph[j][1], pl[j][1]);
      split(p1, ph[j][2], pl[j][2]);
      split(p3, ph[j][3], pl[j][3]);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;

    // O = O alpha + P V, the tile's P V in fresh fragments, NG d steps at
    // a time; V's B fragment: rows 8 j + 2 t and 8 j + 2 t + 1, column
    // 8 n + g
    const float* vb = vs + 2 * t * VS + g;
#pragma unroll
    for (int n0 = 0; n0 < NK; n0 += NG) {
      float f[NG][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int nn = 0; nn < NG; ++nn) {
          const float* p = vb + 8 * j * VS + 8 * (n0 + nn);
          uint32_t bh0, bl0, bh1, bl1;
          split(p[0], bh0, bl0);
          split(p[VS], bh1, bl1);
          mma3(f[nn], ph[j], pl[j], bh0, bh1, bl0, bl1, j == 0);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NG; ++nn) {
        o[n0 + nn][0] = fmaf(o[n0 + nn][0], alpha_a, f[nn][0]);
        o[n0 + nn][1] = fmaf(o[n0 + nn][1], alpha_a, f[nn][1]);
        o[n0 + nn][2] = fmaf(o[n0 + nn][2], alpha_b, f[nn][2]);
        o[n0 + nn][3] = fmaf(o[n0 + nn][3], alpha_b, f[nn][3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // epilogue: the row sums over the 4 lanes of a row, O / l
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, x);
    l_b += __shfl_xor_sync(FULL, l_b, x);
  }
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
  float* op = out + ((int64_t)bi * hq + h) * sq * D;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int col = 8 * n + 2 * t;
    if (ra < sq)
      *reinterpret_cast<float2*>(op + (int64_t)ra * D + col) =
          make_float2(o[n][0] * inv_a, o[n][1] * inv_a);
    if (rb < sq)
      *reinterpret_cast<float2*>(op + (int64_t)rb * D + col) =
          make_float2(o[n][2] * inv_b, o[n][3] * inv_b);
  }
  // after O, whose registers are free by then; m is in log2 units (Q was
  // scaled)
  if (LSE && t == 0) {
    constexpr float LN2 = 0.69314718055994531f;
    float* lp = lse + ((int64_t)bi * hq + h) * sq;
    if (ra < sq)
      lp[ra] = l_a == 0.f ? -CUDART_INF_F : (m_a + log2f(l_a)) * LN2;
    if (rb < sq)
      lp[rb] = l_b == 0.f ? -CUDART_INF_F : (m_b + log2f(l_b)) * LN2;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int b, int hq, int hkv, int sq,
                   int skv, int causal, float scale_log2,
                   cudaStream_t stream) {
  using G = Geo<D>;
  const bool with_lse = lse != nullptr;
  const auto kernel = with_lse ? attn_tf32_kernel<D, true>
                               : attn_tf32_kernel<D, false>;
  static bool ready[2] = {false, false};  // the shared-memory opt-in, once
  if (!ready[with_lse]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    ready[with_lse] = true;
  }
  const dim3 grid(hq, b, (sq + G::BQ - 1) / G::BQ);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      q, k, v, out, lse, hq, hkv, sq, skv, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [b, hq, sq, d], k and v [b, hkv, skv, d], out [b, hq, sq, d], all
// contiguous float32, 16-byte aligned; d in {16, 32, 64, 128, 256};
// hq % hkv == 0. scale_log2 = softmax scale * log2(e). lse: null
// (serving: nothing more is written), or [b, hq, sq] float32 contiguous
// for each row's natural log-sum-exp of its visible scaled scores, (m +
// log2 l) * ln 2 with m the row's largest score in log2 units (scale_log2
// folded in), -inf where the row sees no key. Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_tf32_lse(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int b, int hq, int hkv, int sq,
                                        int skv, int d, int causal,
                                        float scale_log2, void* stream) {
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skv <= 0) {  // no key: every row gives 0 (no lse to give)
    if (lse != nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaMemsetAsync(out, 0, (size_t)b * hq * sq * d * 4, s);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (d) {
    case 16:
      return (int)launch<16>(qf, kf, vf, of, lse, b, hq, hkv, sq, skv,
                             causal, scale_log2, s);
    case 32:
      return (int)launch<32>(qf, kf, vf, of, lse, b, hq, hkv, sq, skv,
                             causal, scale_log2, s);
    case 64:
      return (int)launch<64>(qf, kf, vf, of, lse, b, hq, hkv, sq, skv,
                             causal, scale_log2, s);
    case 128:
      return (int)launch<128>(qf, kf, vf, of, lse, b, hq, hkv, sq, skv,
                              causal, scale_log2, s);
    case 256:
      return (int)launch<256>(qf, kf, vf, of, lse, b, hq, hkv, sq, skv,
                              causal, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The serving entry: flash_attention_tf32_lse without the lse output.
extern "C" int flash_attention_tf32(const void* q, const void* k,
                                    const void* v, void* out, int b, int hq,
                                    int hkv, int sq, int skv, int d,
                                    int causal, float scale_log2,
                                    void* stream) {
  return flash_attention_tf32_lse(q, k, v, out, nullptr, b, hq, hkv, sq, skv,
                                  d, causal, scale_log2, stream);
}
