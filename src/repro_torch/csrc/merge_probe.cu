// Rank probe over sorted multi-word int64 keys, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_probe_kernel` (W = 1) and
// `_probe_multi_kernel` (W >= 2) of src/repro/kernels/merge_probe.py.
// For every probe key it returns the lower and upper rank in the sorted
// build keys: lo = #{build < probe}, hi = #{build <= probe}, the
// `searchsorted` left and right ranks, under word-wise lexicographic
// order of W int64 words.
//
// Bound on the H100: bytes. The least traffic is one read of each build
// and probe word and one write of each int32 rank, at 3.35 TB/s; the
// compares are a few integer operations per byte. A search reads far
// more than that, a dependent load per level, so the kernel is bound by
// memory latency: what it can do is read fewer levels from device
// memory and keep more of them in flight.
//
// Design (two-level search, galloping upper rank):
// - Persistent CTAs, as many as fit on the SMs, each stage a sample of
//   the build keys in shared memory once: every `stride`-th key,
//   build[j * stride] for j < n_samples, at most 32 KB (the wrapper's
//   `sample_plan` picks stride and count for m and W). A search of the
//   sample gives c = #{samples < q}, so the lower rank lies in the
//   window [(c - 1) * stride + 1, c * stride] (c = 0: lo = 0; c =
//   n_samples: up to m), whose right end is a sample key known to be
//   >= q. Only the window's log2(stride) levels touch device memory.
// - Both searches are branchless, over 32-bit indices (m < 2^31), with
//   a step count that is the same for every probe; each thread carries
//   PER_THREAD probes through them side by side, so as many independent
//   loads are in flight per thread.
// - The upper rank gallops from lo: build[m - 1] <= q gives hi = m
//   without a load (KEY_PAD probes and probes above every key), else
//   build[lo] > q gives hi = lo, else lo + 1, lo + 2, lo + 4, ... until
//   a key > q, and a binary search of the last gap. Most runs of equal
//   keys are short, so the upper rank costs one or two loads.
// Binary search needs no sorted probes, so the ranks are exact for
// every probe in any order, KEY_PAD included; sorted probes (the merge
// of two arrangements) touch neighbouring windows and run faster. A
// null `hi` skips the upper rank. One template serves W = 1..4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;   // probes carried side by side per thread

template <int W>
struct Key {
  int64_t w[W];
};

template <int W>
__device__ __forceinline__ Key<W> load_key(const int64_t* p) {
  Key<W> k;
#pragma unroll
  for (int i = 0; i < W; ++i) k.w[i] = p[i];
  return k;
}

// a < b under word-wise lexicographic order, without branches
template <int W>
__device__ __forceinline__ bool less(const Key<W>& a, const Key<W>& b) {
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    lt = lt | (eq & (a.w[i] < b.w[i]));
    eq = eq & (a.w[i] == b.w[i]);
  }
  return lt;
}

// ceil(log2(x)) for x >= 1: the halvings n -> n - n / 2 that bring any
// n <= x to 1
__device__ __forceinline__ int halvings(int x) {
  return x <= 1 ? 0 : 32 - __clz(x - 1);
}

template <int W>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const int64_t* __restrict__ build, int m, int stride,
             int n_samples, const int64_t* __restrict__ probe, int64_t n,
             int32_t* __restrict__ lo_out, int32_t* __restrict__ hi_out) {
  constexpr int P = PER_THREAD;
  extern __shared__ __align__(16) int64_t smem[];
  Key<W>* sample = reinterpret_cast<Key<W>*>(smem);
  for (int j = threadIdx.x; j < n_samples; j += THREADS)
    sample[j] = load_key<W>(build + (int64_t)j * stride * W);
  Key<W> last = {};
  if (m > 0) last = load_key<W>(build + (int64_t)(m - 1) * W);
  __syncthreads();
  const int sample_steps = halvings(n_samples + 1);
  const int window_steps = halvings(stride);

  const int64_t chunk = (int64_t)THREADS * P;
  for (int64_t c0 = (int64_t)blockIdx.x * chunk; c0 < n;
       c0 += (int64_t)gridDim.x * chunk) {
    Key<W> q[P];
    int b[P], len[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int64_t i = c0 + threadIdx.x + k * THREADS;
      q[k] = i < n ? load_key<W>(probe + i * W) : Key<W>{};
      b[k] = 0;
    }
    // c = #{samples < q}: first j in [0, n_samples] whose sample is
    // >= q (j = n_samples stands for "past the end")
    int sn = n_samples + 1;
    for (int s = 0; s < sample_steps; ++s) {
      const int half = sn >> 1;
#pragma unroll
      for (int k = 0; k < P; ++k)
        b[k] = less<W>(sample[b[k] + half - 1], q[k]) ? b[k] + half : b[k];
      sn -= half;
    }
    // the window: lo lies in [base, end], and build[end] >= q (or
    // end = m)
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = b[k];
      if (c == 0) {
        len[k] = 1;
      } else {
        const int base = (c - 1) * stride + 1;
        const int end = c == n_samples ? m : c * stride;
        b[k] = base;
        len[k] = end - base + 1;
      }
    }
    // lower rank: first j in [b, b + len) with build[j] >= q
    for (int s = 0; s < window_steps; ++s) {
      Key<W> x[P];
      int half[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        half[k] = len[k] >> 1;
        if (half[k])
          x[k] = load_key<W>(build + (int64_t)(b[k] + half[k] - 1) * W);
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (half[k] && less<W>(x[k], q[k])) b[k] += half[k];
        len[k] -= half[k];
      }
    }

    // upper rank, galloping from lo
    bool need[P];
    Key<W> at_lo[P];
    if (hi_out != nullptr) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        need[k] = m > 0 && less<W>(q[k], last);   // else hi = m
        if (need[k]) at_lo[k] = load_key<W>(build + (int64_t)b[k] * W);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int64_t i = c0 + threadIdx.x + k * THREADS;
      if (i >= n) continue;
      const int lo = b[k];
      lo_out[i] = lo;
      if (hi_out == nullptr) continue;
      int hi = m;
      if (need[k]) {     // build[m - 1] > q, so lo <= m - 1
        hi = lo;
        if (!less<W>(q[k], at_lo[k])) {   // build[lo] == q: a run
          int a = lo;                     // build[a] <= q
          int64_t d = 1;
          int gt;                         // build[gt] > q
          for (;;) {
            const int p = d >= (int64_t)(m - 1 - lo) ? m - 1 : lo + (int)d;
            if (less<W>(q[k], load_key<W>(build + (int64_t)p * W))) {
              gt = p;
              break;
            }
            a = p;
            d <<= 1;
          }
          // first j in [a + 1, gt] with build[j] > q
          int base = a + 1, cnt = gt - a;
          while (cnt > 1) {
            const int h = cnt >> 1;
            const Key<W> x = load_key<W>(build + (int64_t)(base + h - 1) * W);
            if (!less<W>(q[k], x)) base += h;
            cnt -= h;
          }
          hi = base;
        }
      }
      hi_out[i] = hi;
    }
  }
}

template <int W>
int launch(const int64_t* build, int m, int stride, int n_samples,
           const int64_t* probe, int64_t n, int32_t* lo, int32_t* hi,
           cudaStream_t stream) {
  const size_t smem = (size_t)n_samples * W * sizeof(int64_t);
  static int resident = 0;   // CTAs of this template that fit on the card
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // the occupancy at the largest sample (32 KB) holds for every m
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_kernel<W>, THREADS, 32768);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t chunk = (int64_t)THREADS * PER_THREAD;
  const int64_t want = (n + chunk - 1) / chunk;
  const int blocks = (int)(want < resident ? want : resident);
  probe_kernel<W><<<blocks, THREADS, smem, stream>>>(
      build, m, stride, n_samples, probe, n, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// build: [m, w] int64 row-major, sorted word-wise ascending, m < 2^31.
// probe: [n, w] int64 row-major, any order.
// stride, n_samples: the sample build[j * stride], j < n_samples, with
// (n_samples - 1) * stride < m <= n_samples * stride and at most 32 KB
// of keys (0 samples for m = 0).
// lo, hi: [n] int32 (hi may be null). Returns cudaGetLastError().
extern "C" int merge_probe(const void* build, int64_t m, const void* probe,
                           int64_t n, int w, int64_t stride,
                           int64_t n_samples, void* lo, void* hi,
                           void* stream) {
  if (m < 0 || m >= ((int64_t)1 << 31) || n < 0 || stride < 1 ||
      n_samples < 0 || n_samples * w * (int64_t)sizeof(int64_t) > 32768 ||
      (m > 0 && (n_samples < 1 || (n_samples - 1) * stride >= m ||
                 n_samples * stride < m)) ||
      (m == 0 && n_samples != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t* b = static_cast<const int64_t*>(build);
  const int64_t* p = static_cast<const int64_t*>(probe);
  int32_t* l = static_cast<int32_t*>(lo);
  int32_t* h = static_cast<int32_t*>(hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, st = (int)stride, ns = (int)n_samples;
  switch (w) {
    case 1: return launch<1>(b, mi, st, ns, p, n, l, h, s);
    case 2: return launch<2>(b, mi, st, ns, p, n, l, h, s);
    case 3: return launch<3>(b, mi, st, ns, p, n, l, h, s);
    case 4: return launch<4>(b, mi, st, ns, p, n, l, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
