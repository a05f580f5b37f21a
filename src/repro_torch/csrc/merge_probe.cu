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
// compares are a few integer operations per byte.
//
// Design: one thread per probe key runs two binary searches over the
// build keys in global memory (the upper search starts at the lower
// rank). Hopper compares int64 natively, so there is no int32 split as
// on the TPU. Binary search needs no sorted probes, so the ranks are
// exact for every probe in any order, KEY_PAD probes included. Passing
// a null `hi` skips the upper search (the lower-rank-only lookup).
// Each search step is a dependent global load, so the kernel is bound
// by memory latency, not by bandwidth; a blocked merge-path with shared
// memory staging is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a < b under word-wise lexicographic order
template <int W>
__device__ __forceinline__ bool lex_less(const int64_t* a, const int64_t* b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

template <int W>
__global__ void probe_kernel(const int64_t* __restrict__ build, int64_t m,
                             const int64_t* __restrict__ probe, int64_t n,
                             int32_t* __restrict__ lo_out,
                             int32_t* __restrict__ hi_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = probe[i * W + w];

  // lower rank: first j with build[j] >= q
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (lex_less<W>(build + mid * W, q)) lo = mid + 1; else hi = mid;
  }
  lo_out[i] = (int32_t)lo;
  if (hi_out == nullptr) return;
  // upper rank: first j >= lo with build[j] > q
  int64_t l2 = lo, h2 = m;
  while (l2 < h2) {
    const int64_t mid = (l2 + h2) >> 1;
    if (lex_less<W>(q, build + mid * W)) h2 = mid; else l2 = mid + 1;
  }
  hi_out[i] = (int32_t)l2;
}

template <int W>
void launch(const int64_t* build, int64_t m, const int64_t* probe,
            int64_t n, int32_t* lo, int32_t* hi, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      build, m, probe, n, lo, hi);
}

}  // namespace

// build: [m, w] int64 row-major, sorted word-wise ascending.
// probe: [n, w] int64 row-major, any order.
// lo, hi: [n] int32 (hi may be null). Returns cudaGetLastError().
extern "C" int merge_probe(const void* build, int64_t m, const void* probe,
                           int64_t n, int w, void* lo, void* hi,
                           void* stream) {
  const int64_t* b = static_cast<const int64_t*>(build);
  const int64_t* p = static_cast<const int64_t*>(probe);
  int32_t* l = static_cast<int32_t*>(lo);
  int32_t* h = static_cast<int32_t*>(hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: launch<1>(b, m, p, n, l, h, s); break;
    case 2: launch<2>(b, m, p, n, l, h, s); break;
    case 3: launch<3>(b, m, p, n, l, h, s); break;
    case 4: launch<4>(b, m, p, n, l, h, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
