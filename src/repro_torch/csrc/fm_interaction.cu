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
// Bound: bytes, v read once and dv written once (2 * B*F*K values). Two
// routes, picked before the launch by the wrapper's plan
// (kernels/fm_interaction.py, bwd_plan) from shapes, strides and
// alignment; the entry refuses a plan that does not fit, it never falls
// back:
// - bulk (fm_bwd_stream_kernel): per-row v contiguous across rows with
//   16-byte aligned v and dv, and a tile of R rows (R*F*K values, R picked
//   so that the tile is a multiple of 16 bytes) that fits a ring of 2 to 4
//   stages. A persistent grid of equal shares of the tiles; in each CTA
//   one producer thread streams tiles into the ring with 1-D bulk copies
//   (completion on a `full` mbarrier) and, once 256 consumer threads have
//   turned a stage into dv in place (a `done` mbarrier), sends it out
//   with a 1-D bulk store and refills the stage when the store has read
//   it. The consumers sum S_j per (row, j) over the fields in order, dx
//   per (row, field) over j in order, and form dv over the whole tile 16
//   bytes a thread, every lane busy whatever K is. The tail tile's bytes
//   past its last multiple of 16 move by plain loads and stores.
// - staged (fm_bwd_kernel): every other form (shared v, other batch
//   strides, an unaligned v, rows too large for two stages), the
//   forward's blocks and staging: pass 1 sums S_j per (row, j) thread
//   over the fields; pass 2 forms dv over the staged chunk (restaged only
//   when the fields take more than one chunk), writes it into the staged
//   tile in place (each thread overwrites the value only it reads) and
//   copies the tile out row by row; dx is summed over the KP lanes of a
//   row by the same fixed xor-shuffle tree.
// No atomics on either route: the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

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

// -- the bulk route ---------------------------------------------------------

constexpr int CONSUMERS = 256;                  // 8 consumer warps
constexpr int STREAM_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 8;                   // the ring's most stages
constexpr size_t SMEM_MAX = 232448;             // 227 KB a block

__host__ __device__ constexpr size_t round_up(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}

// Shared memory of the bulk route: the ring of `stages` tiles of R rows
// (each stage 128-byte aligned), then S [R, K], g [R], x [R, F] in f32 and
// the `full` and `done` barriers. bwd_plan in kernels/fm_interaction.py
// reckons the same sizes.
struct Layout {
  size_t stage, s_off, g_off, x_off, bar_off, total;
};
__host__ __device__ inline Layout stream_layout(int rows, int f, int k,
                                                size_t item, int stages) {
  Layout l;
  l.stage = round_up((size_t)rows * f * k * item, 128);
  l.s_off = (size_t)stages * l.stage;
  l.g_off = l.s_off + round_up((size_t)rows * k * 4, 16);
  l.x_off = l.g_off + round_up((size_t)rows * 4, 16);
  l.bar_off = l.x_off + round_up((size_t)rows * f * 4, 16);
  l.total = l.bar_off + 2 * (size_t)stages * 8;
  return l;
}

// floor(n / d) by one multiply, exact while n * d <= 2**32 (the plan keeps
// R * (F*K)**2 under it; the other quotients are far smaller)
struct Div {
  uint32_t d, m;
  __device__ explicit Div(uint32_t d_)
      : d(d_), m(d_ > 1 ? (uint32_t)((0x100000000ull + d_ - 1) / d_) : 0u) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, m);
  }
};

// 16 bytes of shared memory as floats, and back
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}
__device__ __forceinline__ void store16(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    out[2 * i] = t.x;
    out[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&in)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16(in[2 * i]),
                              __float2bfloat16(in[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = a;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// CTA c takes tiles c, c + gridDim.x, ...; tile t holds rows [t R, t R + R)
// of v (and of dv), one contiguous span. XC: x is one value (both strides
// 0, the FM model's ones), read once.
template <typename T, bool XC>
__global__ void __launch_bounds__(STREAM_THREADS)
fm_bwd_stream_kernel(const T* __restrict__ x, int64_t sx_b, int64_t sx_f,
                     const T* __restrict__ v, const T* __restrict__ gout,
                     int64_t b, int f, int k, int rows, int stages,
                     T* __restrict__ dv, T* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char ring[];
  const Layout lay = stream_layout(rows, f, k, sizeof(T), stages);
  float* ss = reinterpret_cast<float*>(ring + lay.s_off);   // S [R, K]
  float* gs = reinterpret_cast<float*>(ring + lay.g_off);   // g [R]
  float* xs = reinterpret_cast<float*>(ring + lay.x_off);   // x [R, F]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + lay.bar_off);
  uint64_t* done = full + stages;
  const int L = f * k;                      // values a row
  const int64_t tiles = (b + rows - 1) / rows;
  const int n = tiles > (int64_t)blockIdx.x
                    ? (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1)
                    : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&done[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {     // the producer: one thread issues every copy
    if (tid != CONSUMERS) return;
    // the tile's row 0 and the bytes of its span that a bulk copy moves
    auto span = [&](int i, int64_t& row0) -> uint32_t {
      row0 = ((int64_t)blockIdx.x + (int64_t)i * gridDim.x) * rows;
      const int64_t nr = b - row0 < rows ? b - row0 : rows;
      return (uint32_t)((size_t)(nr * L) * sizeof(T)) & ~15u;
    };
    auto load = [&](int i) {
      int64_t row0;
      const uint32_t bytes = span(i, row0);
      const int s = i % stages;
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, bytes);
      if (bytes)
        bulk_load(smem_u32(ring + s * lay.stage), v + row0 * L, bytes, bar);
    };
    for (int i = 0; i < n && i < stages; ++i) load(i);
    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      mbar_wait(smem_u32(&done[s]), (i / stages) & 1);
      int64_t row0;
      const uint32_t bytes = span(i, row0);
      if (bytes) bulk_store(dv + row0 * L, smem_u32(ring + s * lay.stage),
                            bytes);
      bulk_commit();
      if (i + stages < n) {     // refill the stage once the store has read it
        bulk_wait_read<0>();
        load(i + stages);
      }
    }
    bulk_wait<0>();
    return;
  }

  constexpr int E = 16 / (int)sizeof(T);    // values in 16 bytes
  const Div divk(k), divf(f), divl(L);
  const float x0 = XC ? to_f32(x[0]) : 0.0f;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    T* st = reinterpret_cast<T*>(ring + s * lay.stage);
    const int64_t row0 = ((int64_t)blockIdx.x + (int64_t)i * gridDim.x) * rows;
    const int nr = (int)(b - row0 < rows ? b - row0 : rows);
    const int ne = nr * L;
    const int pre = (int)(((size_t)ne * sizeof(T)) & ~(size_t)15) /
                    (int)sizeof(T);         // values the bulk copies move
    consumer_sync();            // the last tile's readers of S, g, x are done
    for (int t = tid; t < nr; t += CONSUMERS) gs[t] = to_f32(gout[row0 + t]);
    if (!XC) {
      for (int t = tid; t < nr * f; t += CONSUMERS) {
        const int r = (int)divf((uint32_t)t);
        xs[t] = to_f32(x[(row0 + r) * sx_b + (int64_t)(t - r * f) * sx_f]);
      }
    }
    mbar_wait(smem_u32(&full[s]), (i / stages) & 1);
    for (int t = pre + tid; t < ne; t += CONSUMERS) st[t] = v[row0 * L + t];
    consumer_sync();
    // S_j per (row, j) over the fields in order
    for (int p = tid; p < nr * k; p += CONSUMERS) {
      const int r = (int)divk((uint32_t)p);
      const T* vr = st + r * L + (p - r * k);
      const float* xr = xs + r * f;
      float acc = 0.0f;
#pragma unroll 4
      for (int fi = 0; fi < f; ++fi)
        acc += (XC ? x0 : xr[fi]) * to_f32(vr[fi * k]);
      ss[p] = acc;
    }
    consumer_sync();
    if (dx != nullptr) {        // dx per (row, field) over j in order
      for (int p = tid; p < nr * f; p += CONSUMERS) {
        const int r = (int)divf((uint32_t)p);
        const float xv = XC ? x0 : xs[p];
        const T* vr = st + r * L + (p - r * f) * k;
        const float* sr = ss + r * k;
        float acc = 0.0f;
        for (int j = 0; j < k; ++j) {
          const float vv = to_f32(vr[j]);
          acc += vv * (sr[j] - xv * vv);
        }
        store(dx + (row0 + r) * f + (p - r * f), gs[r] * acc);
      }
      consumer_sync();          // dv overwrites the values dx read
    }
    // dv in place, 16 bytes a thread over the bulk-copied prefix
    for (int q = tid; q < pre / E; q += CONSUMERS) {
      const int e0 = q * E;
      int r = (int)divl((uint32_t)e0);
      const int rem = e0 - r * L;
      int fi = (int)divk((uint32_t)rem);
      int j = rem - fi * k;
      float val[E];
      load16(st + e0, val);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float xv = XC ? x0 : xs[r * f + fi];
        const float res = ss[r * k + j] - xv * val[u];
        val[u] = gs[r] * xv * res;
        if (++j == k) {
          j = 0;
          if (++fi == f) {
            fi = 0;
            ++r;
          }
        }
      }
      store16(st + e0, val);
    }
    // the tail's values past the prefix go out by plain stores
    for (int t = pre + tid; t < ne; t += CONSUMERS) {
      const int r = (int)divl((uint32_t)t);
      const int rem = t - r * L;
      const int fi = (int)divk((uint32_t)rem);
      const float xv = XC ? x0 : xs[r * f + fi];
      const float res = ss[r * k + (rem - fi * k)] - xv * to_f32(st[t]);
      store(dv + row0 * L + t, gs[r] * xv * res);
    }
    fence_proxy_async();        // dv in the stage, before the bulk store
    mbar_arrive(smem_u32(&done[s]));
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

template <typename T, bool XC>
int launch_stream(const T* x, int64_t sx_b, int64_t sx_f, const T* v,
                  const T* g, int64_t b, int f, int k, int rows, int stages,
                  int ctas, T* dv, T* dx, size_t smem, cudaStream_t stream) {
  auto kernel = fm_bwd_stream_kernel<T, XC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<ctas, STREAM_THREADS, smem, stream>>>(x, sx_b, sx_f, v, g, b, f, k,
                                                 rows, stages, dv, dx);
  return (int)cudaGetLastError();
}

// the bulk route's plan, checked: a span of R rows is whole 16-byte units
// starting 16-byte aligned, the ring fits, the quotients are exact
template <typename T>
int launch_bulk(const void* x, int64_t sx_b, int64_t sx_f, const void* v,
                int64_t sv_b, const void* g, int64_t b, int64_t f, int k,
                void* dv, void* dx, int rows, int stages, int ctas,
                cudaStream_t stream) {
  const int64_t L = f * k;
  const Layout lay = stream_layout(rows, (int)f, k, sizeof(T), stages);
  if (rows < 1 || stages < 1 || stages > MAX_STAGES || ctas < 1 ||
      (b > 1 && sv_b != L) || reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(dv) % 16 ||
      ((size_t)rows * L * sizeof(T)) % 16 || lay.total > SMEM_MAX ||
      (uint64_t)rows * L * L > 0x100000000ull)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  if (sx_b == 0 && sx_f == 0)
    return launch_stream<T, true>(xt, sx_b, sx_f, static_cast<const T*>(v),
                                  static_cast<const T*>(g), b, (int)f, k,
                                  rows, stages, ctas, static_cast<T*>(dv),
                                  static_cast<T*>(dx), lay.total, stream);
  return launch_stream<T, false>(xt, sx_b, sx_f, static_cast<const T*>(v),
                                 static_cast<const T*>(g), b, (int)f, k,
                                 rows, stages, ctas, static_cast<T*>(dv),
                                 static_cast<T*>(dx), lay.total, stream);
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
// the shared form too); dx: [b, f] contiguous, or null to skip it. route
// 0 is the staged kernel (rows, stages, ctas unused), route 1 the bulk
// stream with `rows` rows a tile, `stages` stages and `ctas` CTAs, as the
// wrapper's plan gives them; a bulk plan that the shapes, strides or
// alignment do not allow returns cudaErrorInvalidValue. Returns
// cudaGetLastError().
extern "C" int fm_interaction_bwd(const void* x, int64_t sx_b, int64_t sx_f,
                                  const void* v, int64_t sv_b, const void* g,
                                  int bf16, int64_t b, int64_t f, int k,
                                  void* dv, void* dx, int route, int rows,
                                  int stages, int ctas, void* stream) {
  if (b < 1 || f < 1 || k < 1 || k > MAX_K || sv_b < 0 || route < 0 ||
      route > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return bf16 ? launch_bulk<__nv_bfloat16>(x, sx_b, sx_f, v, sv_b, g, b, f,
                                             k, dv, dx, rows, stages, ctas,
                                             st)
                : launch_bulk<float>(x, sx_b, sx_f, v, sv_b, g, b, f, k, dv,
                                     dx, rows, stages, ctas, st);
  if (bf16)
    launch_bwd<__nv_bfloat16>(x, sx_b, sx_f, v, sv_b, g, b, f, k, dv, dx, st);
  else
    launch_bwd<float>(x, sx_b, sx_f, v, sv_b, g, b, f, k, dv, dx, st);
  return (int)cudaGetLastError();
}
