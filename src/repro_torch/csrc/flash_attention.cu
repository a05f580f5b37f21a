// Split-KV decode attention (float32 or bf16 cache) for Hopper (sm_90a),
// GQA by head index, f32 arithmetic. The prefill kernels live beside it:
// flash_attention_wgmma.cu (bfloat16) and flash_attention_tf32.cu
// (float32), both on the tensor cores.
//
// flash_decode_split + flash_decode_combine replace `_decode_kernel` of
// src/repro/kernels/flash_attention.py (via flash_decode_pallas): one query token per sequence against a
// [b, hkv, S, d] cache whose positions >= kv_len[b] are masked
// (kv_len = 0 gives 0).
//
// Bound on the H100: bytes, the valid K and V rows read once. The
// design streams those bytes and keeps the SM's load path busy:
// - One CTA serves all `group` query heads of one KV head (up to 16 of
//   them; larger groups take several CTAs), so K and V are read once per
//   KV head, and the cache length is split across CTAs (decode_splits),
//   because b * hkv CTAs alone (64 in the served model) would leave most
//   of the 132 SMs idle. Each split writes its unnormalised (m, l, acc)
//   in f32; the combine kernel merges the splits of a (b, h) row.
// - A producer warp streams the split's K rows and V rows, each
//   contiguous in [b, hkv, S, d], in the cache's own type through a ring
//   of 3 stages of 16 KB of K plus 16 KB of V, with 1-D bulk copies
//   (cp.async.bulk, completion on a `full` mbarrier) of exactly the
//   valid rows; the consumers free a stage on an `empty` mbarrier. Two
//   CTAs fit on an SM: 192 KB of K/V in flight per SM.
// - Four consumer warps read each row from shared memory 16 bytes per
//   lane (a 128-wide bf16 row is 16 lanes, so a warp covers two rows),
//   dot it with q held in registers in f32 and sum over the row's lanes
//   with xor-shuffles. Each group of lanes runs its own online softmax
//   (exp2 form) over its rows and accumulates P.V into registers.
//   Groups of one or two heads split the keys over the warps; larger
//   groups (chatglm3's 16) split the heads, 4 a warp, over the whole
//   stage, so q and acc stay in registers.
// - At the end of a split the lane groups merge by a fixed butterfly and
//   the warps once through shared memory in warp order: no
//   __syncthreads per stage, and the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int DWARPS = 4;                     // consumer warps
constexpr int DTHREADS = (DWARPS + 1) * 32;   // and one producer warp
constexpr int STAGES = 3;                     // depth of the K/V ring
constexpr int STAGE_BYTES = 16384;            // of K, and as much of V
constexpr int UK = 4;                         // row steps per max update
constexpr int DECODE_SMEM = 2 * STAGES * STAGE_BYTES + 2 * STAGES * 8;

// 16 bytes at p (shared or global memory) as floats
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// How a warp reads a K or V row of a stage: 16 bytes a lane, LPR lanes
// a row (VPL vectors each when a row is wider than a warp), so one warp
// step covers RPW rows.
template <typename T, int D>
struct Dec {
  static constexpr int RB = D * (int)sizeof(T);       // bytes per row
  static constexpr int KT = STAGE_BYTES / RB;         // rows per stage
  static constexpr int LPR = RB / 16 < 32 ? RB / 16 : 32;
  static constexpr int VPL = RB / 16 / LPR;
  static constexpr int E16 = 16 / (int)sizeof(T);     // values per vector
  static constexpr int EPL = VPL * E16;               // columns per lane
  static constexpr int RPW = 32 / LPR;
};

// One CTA per (split, KV head and chunk of its query heads, sequence).
// Warp DWARPS streams the split's K and V rows into the ring; consumer
// warp w = hs * KS + ks serves HG query heads (slice hs of the chunk)
// over the rows of key slice ks of every stage, each group of LPR lanes
// keeping its own online softmax over its rows.
template <typename T, int D, int HG>
__global__ void __launch_bounds__(DTHREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ kv_len, float* part_m,
                    float* part_l, float* part_acc, int hq, int hkv, int S,
                    int split_len, int head_slices, float scale_log2) {
  using C = Dec<T, D>;
  constexpr int KT = C::KT, LPR = C::LPR, VPL = C::VPL, E16 = C::E16;
  constexpr int EPL = C::EPL, RPW = C::RPW;
  const float NEG_INF = -CUDART_INF_F;
  extern __shared__ __align__(128) unsigned char dsm[];
  T* k_ring = reinterpret_cast<T*>(dsm);            // [STAGES][KT][D]
  T* v_ring = reinterpret_cast<T*>(dsm + STAGES * STAGE_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(dsm + 2 * STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int group = hq / hkv;
  const int per_cta = head_slices * HG;
  const int chunks = (group + per_cta - 1) / per_cta;
  const int split = blockIdx.x, bi = blockIdx.z;
  const int kvh = blockIdx.y / chunks, chunk = blockIdx.y - kvh * chunks;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(kv_len[bi], 0), S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const int ntiles = end > start ? (end - start + KT - 1) / KT : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), DWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DWARPS) {     // the producer: one lane issues the copies
    if (lane == 0) {
      const int64_t off = ((int64_t)bi * hkv + kvh) * S * D;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)    // every consumer warp is done with the stage
          mbar_wait(smem_u32(&empty[s]), ((i / STAGES) - 1) & 1);
        const int t0 = start + i * KT;
        const uint32_t bytes = (uint32_t)(min(KT, end - t0) * C::RB);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, 2 * bytes);
        bulk_load(smem_u32(k_ring + s * KT * D), k + off + (int64_t)t0 * D,
                  bytes, bar);
        bulk_load(smem_u32(v_ring + s * KT * D), v + off + (int64_t)t0 * D,
                  bytes, bar);
      }
    }
    return;
  }

  const int KS = DWARPS / head_slices;
  const int hs = warp / KS, ksl = warp - hs * KS;
  const int sub = lane / LPR, c = lane - sub * LPR;
  const int g0 = chunk * per_cta + hs * HG;   // this warp's first head
  const int h0 = kvh * group;

  float qf[HG][EPL], acc[HG][EPL], m[HG], l[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const bool live = g0 + j < group;
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv) {
      float t[E16];
      const T* qp = q + ((int64_t)bi * hq + h0 + g0 + j) * D +
                    (vv * LPR + c) * E16;
      if (live) load16(qp, t);
#pragma unroll
      for (int e = 0; e < E16; ++e) {
        qf[j][vv * E16 + e] = live ? t[e] * scale_log2 : 0.f;
        acc[j][vv * E16 + e] = 0.f;
      }
    }
    m[j] = NEG_INF;
    l[j] = 0.f;
  }

  const int steps = KT / (KS * RPW);    // a warp's row steps per stage
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
    const int nr = min(KT, end - (start + i * KT));   // rows in the stage
    const T* ks = k_ring + s * KT * D;
    const T* vs = v_ring + s * KT * D;
    for (int st = 0; st < steps; st += UK) {
      if ((st * KS + ksl) * RPW >= nr) break;   // past the tile's end
      float sc[UK][HG];
      int row[UK];
#pragma unroll
      for (int u = 0; u < UK; ++u) {
        row[u] = ((st + u) * KS + ksl) * RPW + sub;
#pragma unroll
        for (int j = 0; j < HG; ++j) sc[u][j] = 0.f;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          float kf[E16];
          load16(ks + row[u] * D + (vv * LPR + c) * E16, kf);
#pragma unroll
          for (int j = 0; j < HG; ++j)
#pragma unroll
            for (int e = 0; e < E16; ++e)
              sc[u][j] = fmaf(qf[j][vv * E16 + e], kf[e], sc[u][j]);
        }
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
#pragma unroll
        for (int u = 0; u < UK; ++u)
#pragma unroll
          for (int j = 0; j < HG; ++j)
            sc[u][j] += __shfl_xor_sync(FULL, sc[u][j], o);
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        float mt = NEG_INF;
#pragma unroll
        for (int u = 0; u < UK; ++u) {
          sc[u][j] = row[u] < nr ? sc[u][j] : NEG_INF;
          mt = fmaxf(mt, sc[u][j]);
        }
        const float m_new = fmaxf(m[j], mt);
        const float m_use = m_new == NEG_INF ? 0.f : m_new;
        const float alpha = exp2f(m[j] - m_use);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < UK; ++u) {
          sc[u][j] = exp2f(sc[u][j] - m_use);
          ps += sc[u][j];
        }
        l[j] = l[j] * alpha + ps;
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < UK; ++u) {
        if (row[u] >= nr) continue;     // stale rows of the stage
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          float vf[E16];
          load16(vs + row[u] * D + (vv * LPR + c) * E16, vf);
#pragma unroll
          for (int j = 0; j < HG; ++j)
#pragma unroll
            for (int e = 0; e < E16; ++e)
              acc[j][vv * E16 + e] =
                  fmaf(sc[u][j], vf[e], acc[j][vv * E16 + e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // merge the warp's row groups (a fixed butterfly)...
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      const float mo = __shfl_xor_sync(FULL, m[j], o);
      const float lo = __shfl_xor_sync(FULL, l[j], o);
      const float m_new = fmaxf(m[j], mo);
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      const float a = exp2f(m[j] - m_use), b = exp2f(mo - m_use);
      l[j] = l[j] * a + lo * b;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[j][e], o);
        acc[j][e] = acc[j][e] * a + ao * b;
      }
      m[j] = m_new;
    }
  }
  // ...then the key slices, once, through the drained ring, in slice
  // order. Only the consumer warps meet at these barriers.
  asm volatile("bar.sync 1, %0;\n" ::"n"(DWARPS * 32) : "memory");
  float* scr_acc = reinterpret_cast<float*>(dsm);     // [DWARPS][HG][D]
  float* scr_m = scr_acc + DWARPS * HG * D;           // [DWARPS][HG]
  float* scr_l = scr_m + DWARPS * HG;
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < HG; ++j) {
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < E16; ++e)
          scr_acc[(warp * HG + j) * D + (vv * LPR + c) * E16 + e] =
              acc[j][vv * E16 + e];
      if (lane == 0) {
        scr_m[warp * HG + j] = m[j];
        scr_l[warp * HG + j] = l[j];
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(DWARPS * 32) : "memory");
  // parts [b, hq, n_splits] and [b, hq, n_splits, D]
  for (int idx = tid; idx < per_cta * D; idx += DWARPS * 32) {
    const int hl = idx / D, col = idx - hl * D;   // head within the chunk
    const int g = chunk * per_cta + hl;
    if (g >= group) break;
    const int hsl = hl / HG, j = hl - hsl * HG;
    float mt = NEG_INF;
    for (int kk = 0; kk < KS; ++kk)
      mt = fmaxf(mt, scr_m[(hsl * KS + kk) * HG + j]);
    const float m_use = mt == NEG_INF ? 0.f : mt;
    float ls = 0.f, a = 0.f;
    for (int kk = 0; kk < KS; ++kk) {
      const int w = (hsl * KS + kk) * HG + j;
      const float wt = exp2f(scr_m[w] - m_use);
      ls += scr_l[w] * wt;
      a += scr_acc[w * D + col] * wt;
    }
    const int64_t prow = ((int64_t)bi * hq + h0 + g) * n_splits + split;
    part_acc[prow * D + col] = a;
    if (col == 0) {
      part_m[prow] = mt;
      part_l[prow] = ls;
    }
  }
}

// one CTA of D threads per (b, h) row: merge the splits' (m, l, acc)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int d,
                                      int n_splits) {
  const int64_t row = blockIdx.x;
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, pm[s]);
  const float m_use = mx == -CUDART_INF_F ? 0.f : mx;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = exp2f(pm[s] - m_use);
      l += pl[s] * w;
      a += part_acc[(row * n_splits + s) * d + c] * w;
    }
    out[row * d + c] = from_f32<T>(l == 0.f ? 0.f : a / l);
  }
}

template <typename T, int D, int HG>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int32_t* kv_len, float* pm, float* pl,
                          float* pacc, int b, int hq, int hkv, int S,
                          int n_splits, int split_len, int head_slices,
                          float scale_log2, cudaStream_t stream) {
  static bool ready = false;    // the shared-memory opt-in, once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, D, HG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DECODE_SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int per_cta = head_slices * HG;
  const int chunks = (hq / hkv + per_cta - 1) / per_cta;
  const dim3 grid(n_splits, hkv * chunks, b);
  decode_split_kernel<T, D, HG><<<grid, DTHREADS, DECODE_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, pm, pl, pacc, hq, hkv, S, split_len,
      head_slices, scale_log2);
  return cudaGetLastError();
}

// Heads per warp and head slices per CTA for a GQA group: one or two
// heads ride with every key slice; larger groups take 4 heads a warp and
// split the heads over the warps (a group of 16: 4 x 4, each warp over
// the whole stage), so q and acc stay within registers.
template <typename T, int D>
cudaError_t decode_by_group(const void* q, const void* k, const void* v,
                            const int32_t* kv_len, float* pm, float* pl,
                            float* pacc, int b, int hq, int hkv, int S,
                            int n_splits, int split_len, float scale_log2,
                            cudaStream_t s) {
  const int group = hq / hkv;
  if (group == 1)
    return launch_decode<T, D, 1>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv,
                                  S, n_splits, split_len, 1, scale_log2, s);
  if (group == 2)
    return launch_decode<T, D, 2>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv,
                                  S, n_splits, split_len, 1, scale_log2, s);
  const int slices = group <= 4 ? 1 : group <= 8 ? 2 : 4;
  return launch_decode<T, D, 4>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv, S,
                                n_splits, split_len, slices, scale_log2, s);
}

template <typename T>
cudaError_t decode_by_dim(int d, const void* q, const void* k, const void* v,
                          const int32_t* kv_len, float* pm, float* pl,
                          float* pacc, int b, int hq, int hkv, int S,
                          int n_splits, int split_len, float scale_log2,
                          cudaStream_t s) {
  switch (d) {
    case 64:
      return decode_by_group<T, 64>(q, k, v, kv_len, pm, pl, pacc, b, hq,
                                    hkv, S, n_splits, split_len, scale_log2,
                                    s);
    case 128:
      return decode_by_group<T, 128>(q, k, v, kv_len, pm, pl, pacc, b, hq,
                                     hkv, S, n_splits, split_len,
                                     scale_log2, s);
    case 256:
      return decode_by_group<T, 256>(q, k, v, kv_len, pm, pl, pacc, b, hq,
                                     hkv, S, n_splits, split_len,
                                     scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, hq, d], k and v [b, hkv, S, d], kv_len [b] int32; splits of
// split_len positions; part_m, part_l [b, hq, n_splits] and part_acc
// [b, hq, n_splits, d] f32 scratch. Returns cudaGetLastError().
extern "C" int flash_decode_split(const void* q, const void* k,
                                  const void* v, const void* kv_len,
                                  void* part_m, void* part_l,
                                  void* part_acc, int is_bf16, int b,
                                  int hq, int hkv, int S, int d,
                                  int n_splits, int split_len,
                                  float scale_log2, void* stream) {
  if (hkv <= 0 || hq % hkv || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(kv_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  return is_bf16 ? (int)decode_by_dim<__nv_bfloat16>(
                       d, q, k, v, len, pm, pl, pa, b, hq, hkv, S, n_splits,
                       split_len, scale_log2, s)
                 : (int)decode_by_dim<float>(d, q, k, v, len, pm, pl, pa, b,
                                             hq, hkv, S, n_splits, split_len,
                                             scale_log2, s);
}

// out [b, hq, d] from the parts of flash_decode_split.
extern "C" int flash_decode_combine(const void* part_m, const void* part_l,
                                    const void* part_acc, void* out,
                                    int is_bf16, int rows, int d,
                                    int n_splits, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  const int threads = d < 256 ? d : 256;
  if (is_bf16)
    decode_combine_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), d, n_splits);
  else
    decode_combine_kernel<float><<<rows, threads, 0, s>>>(
        pm, pl, pa, static_cast<float*>(out), d, n_splits);
  return (int)cudaGetLastError();
}
