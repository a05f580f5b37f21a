// Factorization-machine 2-way interaction for Hopper (sm_90a).
//
// Replaces `_fm_kernel` of src/repro/kernels/fm_interaction.py:20
// (reached through `fm_interaction_pallas`, :34). Per row b:
//   out[b] = 0.5 * sum_j ( (sum_f x[b,f] v[f,j])^2 - sum_f (x[b,f] v[f,j])^2 )
// with v either one [F, K] matrix for every row (the Pallas kernel's
// form) or one [F, K] matrix per row (the FM model's `jax.vmap` of it,
// written out as a batch dimension). f32 or bf16 in, f32 arithmetic, out
// in the inputs' type.
//
// Bound on the H100: bytes. The per-row form reads B*F*K values of v once
// (409 MB in f32 at the FM config's serve_bulk batch, 262,144 x 39 x 10)
// and does 4 flops per value, far below the 67 TFLOP/s f32 rate; at
// 3.35 TB/s that is 0.122 ms. x is all ones with stride 0 on that path.
//
// Design. A block of 256 threads owns R = 256 / KP rows, KP being K
// rounded up to a power of two (K <= 32), and walks the fields in chunks
// of FC (sized by the host so that the chunk fits SMEM_FLOATS):
// 1. stage x[rows, chunk] and v into shared memory as f32. In the per-row
//    form each warp copies whole rows of the chunk, lane i taking values
//    i, i + 32, ... of the row's FC*K contiguous ones, so neighbouring
//    lanes read neighbouring addresses. In the shared form v's chunk is
//    staged once per block and every row reads it from shared memory.
// 2. thread (r, j) of its row's group of KP lanes adds p = x[r,f] v[f,j]
//    and p*p over the chunk's fields into two f32 registers.
// After the last chunk each lane holds S_j^2 - Q_j (0 for j >= K), and an
// xor-shuffle tree over the KP lanes of the group, whose order depends
// only on K, sums them: the result is deterministic, without atomics.
// Strides: x by element (stride 0 broadcasts), v by batch only (0 for the
// shared form); each [F, K] matrix is row-major and contiguous.
//
// Backward (fm_interaction_bwd; the training path's, replacing XLA's
// autograd of the reference's FM interaction, which has no Pallas
// backward): for output gradient g[b], with S_j = sum_f x[b,f] v[f,j],
//   dv[b,f,j] = g[b] x[b,f] (S_j - x[b,f] v[f,j])
//   dx[b,f]   = g[b] sum_j v[f,j] (S_j - x[b,f] v[f,j])   (only if asked)
// one [F, K] gradient per row (the wrapper sums them for a shared v).
// Bound: bytes, v read once and dv written once (2 * B*F*K values). The
// same blocks and staging as the forward: pass 1 sums S_j per (row, j)
// thread over the fields; pass 2 forms dv over the staged chunk (restaged
// only when the fields take more than one chunk), writes it into the
// staged tile in place (each thread overwrites the value only it reads)
// and copies the tile out row by row, neighbouring lanes on neighbouring
// addresses; dx is summed over the KP lanes of a row by the same fixed
// xor-shuffle tree. No atomics: the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr int SMEM_FLOATS = 8192;  // 32 KB of dynamic shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// fields per chunk: x takes R values and v R*K (per row) or K (shared)
// values per field
int chunk_fields(int64_t f, int k, int rows, bool shared) {
  const int per_field = rows + (shared ? k : rows * k);
  int64_t fc = SMEM_FLOATS / per_field;
  if (fc > f) fc = f;
  return fc < 1 ? 1 : (int)fc;
}

// stage x[rows, chunk] and v's chunk into shared memory as f32
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int64_t sx_b,
                                      int64_t sx_f, const T* __restrict__ v,
                                      int64_t sv_b, int64_t b, int k,
                                      int rows, int fc, int64_t row0,
                                      int64_t f0, int nf, float* xs,
                                      float* vs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const bool shared_v = sv_b == 0;
  const int vs_row = shared_v ? 0 : fc * k;
  for (int rr = warp; rr < rows; rr += WARPS) {
    const int64_t row = row0 + rr;
    const bool live = row < b;
    for (int i = lane; i < nf; i += 32)
      xs[rr * fc + i] = live ? to_f32(x[row * sx_b + (f0 + i) * sx_f]) : 0.0f;
    if (!shared_v) {
      const T* src = v + row * sv_b + f0 * k;
#pragma unroll 4
      for (int i = lane; i < nf * k; i += 32)
        vs[rr * vs_row + i] = live ? to_f32(src[i]) : 0.0f;
    }
  }
  if (shared_v) {
    for (int i = threadIdx.x; i < nf * k; i += THREADS)
      vs[i] = to_f32(v[f0 * k + i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fm_kernel(const T* __restrict__ x, int64_t sx_b, int64_t sx_f,
          const T* __restrict__ v, int64_t sv_b, int64_t b, int64_t f,
          int k, int kp, int fc, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int rows = THREADS / kp;
  const bool shared_v = sv_b == 0;
  float* xs = smem;                  // [rows, fc]
  float* vs = smem + rows * fc;      // [fc, k] or [rows, fc, k]
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int r = threadIdx.x / kp, j = threadIdx.x % kp;
  const int vs_row = shared_v ? 0 : fc * k;
  float s = 0.0f, q = 0.0f;
  for (int64_t f0 = 0; f0 < f; f0 += fc) {
    const int nf = (int)(f - f0 < fc ? f - f0 : fc);
    stage(x, sx_b, sx_f, v, sv_b, b, k, rows, fc, row0, f0, nf, xs, vs);
    __syncthreads();
    if (j < k) {
      const float* xr = xs + r * fc;
      const float* vr = vs + r * vs_row + j;
      for (int i = 0; i < nf; ++i) {
        const float p = xr[i] * vr[i * k];
        s += p;
        q += p * p;
      }
    }
    __syncthreads();
  }
  float t = j < k ? s * s - q : 0.0f;
  for (int off = kp / 2; off > 0; off >>= 1)
    t += __shfl_xor_sync(FULL, t, off);
  const int64_t row = row0 + r;
  if (j == 0 && row < b) store(out + row, 0.5f * t);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fm_bwd_kernel(const T* __restrict__ x, int64_t sx_b, int64_t sx_f,
              const T* __restrict__ v, int64_t sv_b,
              const T* __restrict__ gout, int64_t b, int64_t f, int k,
              int kp, int fc, T* __restrict__ dv, T* __restrict__ dx) {
  extern __shared__ float smem[];
  const int rows = THREADS / kp;
  const bool shared_v = sv_b == 0;
  float* xs = smem;                  // [rows, fc]
  float* vs = smem + rows * fc;      // [fc, k] or [rows, fc, k]
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r = threadIdx.x / kp, j = threadIdx.x % kp;
  const int vs_row = shared_v ? 0 : fc * k;
  const int64_t row = row0 + r;
  const bool one_chunk = fc >= f;
  float sj = 0.0f;
  for (int64_t f0 = 0; f0 < f; f0 += fc) {
    const int nf = (int)(f - f0 < fc ? f - f0 : fc);
    stage(x, sx_b, sx_f, v, sv_b, b, k, rows, fc, row0, f0, nf, xs, vs);
    __syncthreads();
    if (j < k) {
      const float* xr = xs + r * fc;
      const float* vr = vs + r * vs_row + j;
      for (int i = 0; i < nf; ++i) sj += xr[i] * vr[i * k];
    }
    if (!one_chunk) __syncthreads();
  }
  const float gr = row < b ? to_f32(gout[row]) : 0.0f;
  for (int64_t f0 = 0; f0 < f; f0 += fc) {
    const int nf = (int)(f - f0 < fc ? f - f0 : fc);
    if (!one_chunk) {
      stage(x, sx_b, sx_f, v, sv_b, b, k, rows, fc, row0, f0, nf, xs, vs);
      __syncthreads();
    }
    const float* xr = xs + r * fc;
    float* vr = vs + r * vs_row + j;
    for (int i = 0; i < nf; ++i) {
      const float xv = xr[i];
      const float vv = j < k ? vr[i * k] : 0.0f;
      const float res = sj - xv * vv;
      if (dx != nullptr) {
        float t = vv * res;
        for (int off = kp / 2; off > 0; off >>= 1)
          t += __shfl_xor_sync(FULL, t, off);
        if (j == 0 && row < b) store(dx + row * f + f0 + i, gr * t);
      }
      if (j < k) {
        const float d = gr * xv * res;
        if (shared_v) {
          if (row < b) store(dv + (row * f + f0 + i) * k + j, d);
        } else {
          vr[i * k] = d;   // only this thread reads this value
        }
      }
    }
    if (!shared_v) {
      __syncthreads();
      for (int rr = warp; rr < rows; rr += WARPS) {
        const int64_t orow = row0 + rr;
        if (orow >= b) continue;
        T* dst = dv + (orow * f + f0) * k;
        for (int i = lane; i < nf * k; i += 32)
          store(dst + i, vs[rr * vs_row + i]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* x, int64_t sx_b, int64_t sx_f, const void* v,
            int64_t sv_b, int64_t b, int64_t f, int k, void* out,
            cudaStream_t stream) {
  const int kp = pow2_at_least(k);
  const int rows = THREADS / kp;
  const int fc = chunk_fields(f, k, rows, sv_b == 0);
  const int64_t blocks = (b + rows - 1) / rows;
  const size_t smem =
      sizeof(float) * ((size_t)rows * fc +
                       (size_t)(sv_b == 0 ? 1 : rows) * fc * k);
  fm_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), sx_b, sx_f, static_cast<const T*>(v), sv_b,
      b, f, k, kp, fc, static_cast<T*>(out));
}

template <typename T>
void launch_bwd(const void* x, int64_t sx_b, int64_t sx_f, const void* v,
                int64_t sv_b, const void* g, int64_t b, int64_t f, int k,
                void* dv, void* dx, cudaStream_t stream) {
  const int kp = pow2_at_least(k);
  const int rows = THREADS / kp;
  const int fc = chunk_fields(f, k, rows, sv_b == 0);
  const int64_t blocks = (b + rows - 1) / rows;
  const size_t smem =
      sizeof(float) * ((size_t)rows * fc +
                       (size_t)(sv_b == 0 ? 1 : rows) * fc * k);
  fm_bwd_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), sx_b, sx_f, static_cast<const T*>(v), sv_b,
      static_cast<const T*>(g), b, f, k, kp, fc, static_cast<T*>(dv),
      static_cast<T*>(dx));
}

}  // namespace

// x: [b, f] at element strides (sx_b, sx_f); v: b matrices [f, k], each
// row-major and contiguous, sv_b elements apart (0: one shared matrix);
// out: [b] contiguous. All float32 (bf16 = 0) or all bfloat16 (bf16 = 1).
// b >= 1, f >= 1, 1 <= k <= MAX_K. Returns cudaGetLastError().
extern "C" int fm_interaction(const void* x, int64_t sx_b, int64_t sx_f,
                              const void* v, int64_t sv_b, int bf16,
                              int64_t b, int64_t f, int k, void* out,
                              void* stream) {
  if (b < 1 || f < 1 || k < 1 || k > MAX_K || sv_b < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(x, sx_b, sx_f, v, sv_b, b, f, k, out, st);
  else
    launch<float>(x, sx_b, sx_f, v, sv_b, b, f, k, out, st);
  return (int)cudaGetLastError();
}

// The backward: x, v, bf16, b, f, k as for fm_interaction; g: [b]
// contiguous; dv: [b, f, k] contiguous (one gradient matrix per row, for
// the shared form too); dx: [b, f] contiguous, or null to skip it.
// Returns cudaGetLastError().
extern "C" int fm_interaction_bwd(const void* x, int64_t sx_b, int64_t sx_f,
                                  const void* v, int64_t sv_b, const void* g,
                                  int bf16, int64_t b, int64_t f, int k,
                                  void* dv, void* dx, void* stream) {
  if (b < 1 || f < 1 || k < 1 || k > MAX_K || sv_b < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_bwd<__nv_bfloat16>(x, sx_b, sx_f, v, sv_b, g, b, f, k, dv, dx, st);
  else
    launch_bwd<float>(x, sx_b, sx_f, v, sv_b, g, b, f, k, dv, dx, st);
  return (int)cudaGetLastError();
}
