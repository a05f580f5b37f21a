// Blocked online-softmax attention (float32) and split-KV decode
// attention (float32 or bf16) for Hopper (sm_90a), GQA by head index, f32
// arithmetic.
//
// flash_attention replaces `_attn_kernel` of
// src/repro/kernels/flash_attention.py (via flash_attention_pallas) for
// float32 inputs; bfloat16 inputs go to the tensor-core kernel of
// flash_attention_wgmma.cu, since wgmma on float32 would be TF32:
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i + (skv - sq) when causal (the mask is aligned to the
// end), over all j otherwise. A row with no visible key gives 0.
//
// Bound on the H100: operations. The causal prefill does about
// sq * skv * d multiply-adds per head (half of the full product's
// 2 * sq * skv * d: QK^T and P.V, each d per visible pair); the inputs
// are read once.
// This kernel uses the CUDA cores (f32 FMA): its ceiling is the 67
// TFLOP/s float32 peak.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, head, batch).
// Q (pre-scaled by scale * log2 e) and each K tile are staged transposed
// in shared memory as f32, so a thread reads 4 query rows and BK / 16
// keys with one vector load each and keeps a 4 x (BK / 16) score tile in
// registers. The running max m, sum l and the 4 x (d / 16) output tile
// stay in registers; the 16 threads that share a row reduce with
// xor-shuffles, which give every lane the same value. P goes through
// shared memory (transposed) to the P . V product. Only the KV tiles up
// to the last visible key of the tile's last row are visited, and tails
// that are not tile multiples are masked, so any sq and skv work.
//
// flash_decode_split + flash_decode_combine replace `_decode_kernel`
// (via flash_decode_pallas): one query token per sequence against a
// [b, hkv, S, d] cache whose positions >= kv_len[b] are masked
// (kv_len = 0 gives 0).
//
// Bound on the H100: bytes, the valid K and V rows read once. One CTA
// serves all `group` query heads of one KV head, so K and V are read
// once per KV head, and the cache length is split across CTAs, because
// b * hkv CTAs alone (64 in the served model) would leave most of the
// 132 SMs idle. Each split writes its unnormalised (m, l, acc) in f32;
// the combine kernel merges the splits of a (b, h) row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// prefill

constexpr int BQ = 64;        // query rows per CTA
constexpr int TM = 4;         // query rows per thread
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int QPAD = BQ + 4;  // row length of the transposed Q and P tiles

template <int D>
struct Tile {
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per KV tile
  static constexpr int TN = BK / 16;             // keys per thread
  static constexpr int KPAD = BK + 4;
  static constexpr int DN = D / 16;              // output columns per thread
  // Qt [D][QPAD], Kt [D][KPAD], Vs [BK][D], Pt [BK][QPAD], all f32
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)D * QPAD + (size_t)D * KPAD +
                       (size_t)BK * D + (size_t)BK * QPAD);
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
            int sq, int skv, int causal, float scale_log2) {
  using C = Tile<D>;
  constexpr int BK = C::BK, TN = C::TN, KPAD = C::KPAD, DN = C::DN;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][QPAD]
  float* Kt = Qt + D * QPAD;           // [D][KPAD]
  float* Vs = Kt + D * KPAD;           // [BK][D]
  float* Pt = Vs + BK * D;             // [BK][QPAD]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int off = skv - sq;  // query row i sees keys j <= i + off

  const T* qp = q + ((int64_t)bi * hq + h) * sq * D;
  const T* kp = k + ((int64_t)bi * hkv + kvh) * skv * D;
  const T* vp = v + ((int64_t)bi * hkv + kvh) * skv * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const float x = q0 + r < sq ? to_f32(qp[(int64_t)(q0 + r) * D + c]) : 0.f;
    Qt[c * QPAD + r] = x * scale_log2;
  }

  int kv_end = skv;
  if (causal) {
    const int last = min(q0 + BQ, sq) - 1 + off;  // last row's last key
    kv_end = max(0, min(skv, last + 1));
  }

  float m[TM], l[TM], acc[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const bool in = kv0 + r < skv;
      const int64_t g = (int64_t)(kv0 + r) * D + c;
      Kt[c * KPAD + r] = in ? to_f32(kp[g]) : 0.f;
      Vs[idx] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[TM], b[TN];
      load_vec<TM>(Qt + c * QPAD + ty * TM, a);
      load_vec<TN>(Kt + c * KPAD + tx * TN, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i + off;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = kv0 + tx * TN + j;
        const bool ok = kpos < skv && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        ps += p;
        Pt[(tx * TN + j) * QPAD + ty * TM + i] = p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < BK; ++t) {
      float p[TM];
      load_vec<TM>(Pt + t * QPAD + ty * TM, p);
#pragma unroll
      for (int jj = 0; jj < DN / 4; ++jj) {
        float w[4];
        load_vec<4>(Vs + t * D + jj * 64 + tx * 4, w);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][jj * 4 + e] = fmaf(p[i], w[e], acc[i][jj * 4 + e]);
      }
    }
  }

  T* op = out + ((int64_t)bi * hq + h) * sq * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DN / 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[(int64_t)r * D + jj * 64 + tx * 4 + e] =
            from_f32<T>(acc[i][jj * 4 + e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_attn(const void* q, const void* k, const void* v,
                        void* out, int b, int hq, int hkv, int sq, int skv,
                        int causal, float scale_log2, cudaStream_t stream) {
  const size_t smem = Tile<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  attn_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
      causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attn_by_dim(int d, const void* q, const void* k, const void* v,
                        void* out, int b, int hq, int hkv, int sq, int skv,
                        int causal, float scale_log2, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch_attn<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                                scale_log2, s);
    case 128:
      return launch_attn<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                                 scale_log2, s);
    case 256:
      return launch_attn<T, 256>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                                 scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// decode

constexpr int DTHREADS = 128;
constexpr int TK = 32;  // keys per tile: one per lane in the softmax step

template <int D>
size_t decode_smem(int group) {
  // qs [G][D], ks [TK][D + 1], vs [TK][D], ss [G][TK], acc [G][D],
  // m, l, alpha [G]
  return sizeof(float) * ((size_t)group * D + (size_t)TK * (D + 1) +
                          (size_t)TK * D + (size_t)group * TK +
                          (size_t)group * D + 3 * (size_t)group);
}

template <typename T, int D>
__global__ void __launch_bounds__(DTHREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ kv_len, float* part_m,
                    float* part_l, float* part_acc, int hq, int hkv, int S,
                    int split_len, float scale_log2) {
  const int group = hq / hkv;
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int n_splits = gridDim.x;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [G][D]
  float* ks = qs + group * D;          // [TK][D + 1]
  float* vs = ks + TK * (D + 1);       // [TK][D]
  float* ss = vs + TK * D;             // [G][TK]
  float* acc = ss + group * TK;        // [G][D]
  float* ms = acc + group * D;         // [G]
  float* ls = ms + group;
  float* alpha = ls + group;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = kvh * group;
  const T* qp = q + ((int64_t)bi * hq + h0) * D;
  for (int idx = tid; idx < group * D; idx += DTHREADS) {
    qs[idx] = to_f32(qp[idx]) * scale_log2;
    acc[idx] = 0.f;
  }
  for (int g = tid; g < group; g += DTHREADS) {
    ms[g] = -CUDART_INF_F;
    ls[g] = 0.f;
  }
  const int len = min(max(kv_len[bi], 0), S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const T* kp = k + ((int64_t)bi * hkv + kvh) * S * D;
  const T* vp = v + ((int64_t)bi * hkv + kvh) * S * D;

  for (int t0 = start; t0 < end; t0 += TK) {
    __syncthreads();
    for (int idx = tid; idx < TK * D; idx += DTHREADS) {
      const int r = idx / D, c = idx - r * D;
      const bool in = t0 + r < end;
      const int64_t g = (int64_t)(t0 + r) * D + c;
      ks[r * (D + 1) + c] = in ? to_f32(kp[g]) : 0.f;
      vs[idx] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < group * TK; idx += DTHREADS) {
      const int g = idx / TK, t = idx - g * TK;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c)
        s = fmaf(qs[g * D + c], ks[t * (D + 1) + c], s);
      ss[idx] = t0 + t < end ? s : -CUDART_INF_F;
    }
    __syncthreads();
    for (int g = warp; g < group; g += DTHREADS / 32) {
      const float s = ss[g * TK + lane];
      float mt = s;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mt);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float p = exp2f(s - m_use);
      ss[g * TK + lane] = p;
      float ps = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) ps += __shfl_xor_sync(FULL, ps, o);
      __syncwarp();
      if (lane == 0) {
        const float a = exp2f(m_old - m_use);
        alpha[g] = a;
        ls[g] = ls[g] * a + ps;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < group * D; idx += DTHREADS) {
      const int g = idx / D, c = idx - g * D;
      float a = acc[idx] * alpha[g];
#pragma unroll 8
      for (int t = 0; t < TK; ++t) a = fmaf(ss[g * TK + t], vs[t * D + c], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  // parts [b, hq, n_splits] and [b, hq, n_splits, D]
  for (int idx = tid; idx < group * D; idx += DTHREADS) {
    const int g = idx / D, c = idx - g * D;
    const int64_t row = ((int64_t)bi * hq + h0 + g) * n_splits + split;
    part_acc[row * D + c] = acc[idx];
  }
  for (int g = tid; g < group; g += DTHREADS) {
    const int64_t row = ((int64_t)bi * hq + h0 + g) * n_splits + split;
    part_m[row] = ms[g];
    part_l[row] = ls[g];
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

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int32_t* kv_len, float* pm, float* pl,
                          float* pacc, int b, int hq, int hkv, int S,
                          int n_splits, int split_len, float scale_log2,
                          cudaStream_t stream) {
  const size_t smem = decode_smem<D>(hq / hkv);
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_splits, hkv, b);
  decode_split_kernel<T, D><<<grid, DTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, pm, pl, pacc, hq, hkv, S, split_len,
      scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode_by_dim(int d, const void* q, const void* k, const void* v,
                          const int32_t* kv_len, float* pm, float* pl,
                          float* pacc, int b, int hq, int hkv, int S,
                          int n_splits, int split_len, float scale_log2,
                          cudaStream_t s) {
  switch (d) {
    case 64:
      return launch_decode<T, 64>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv,
                                  S, n_splits, split_len, scale_log2, s);
    case 128:
      return launch_decode<T, 128>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv,
                                   S, n_splits, split_len, scale_log2, s);
    case 256:
      return launch_decode<T, 256>(q, k, v, kv_len, pm, pl, pacc, b, hq, hkv,
                                   S, n_splits, split_len, scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, hq, sq, d], k and v [b, hkv, skv, d], out [b, hq, sq, d], all
// contiguous float32; d in {64, 128, 256}; hq % hkv == 0. scale_log2 =
// softmax scale * log2(e). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int hq, int hkv, int sq,
                               int skv, int d, int causal, float scale_log2,
                               void* stream) {
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return 0;
  return (int)attn_by_dim<float>(d, q, k, v, out, b, hq, hkv, sq, skv,
                                 causal, scale_log2,
                                 static_cast<cudaStream_t>(stream));
}

// Shared memory (bytes) the split kernel needs for `group` query heads
// per KV head at head dim d; 0 for a d it does not instantiate.
extern "C" int64_t flash_decode_smem(int d, int group) {
  switch (d) {
    case 64: return (int64_t)decode_smem<64>(group);
    case 128: return (int64_t)decode_smem<128>(group);
    case 256: return (int64_t)decode_smem<256>(group);
    default: return 0;
  }
}

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
