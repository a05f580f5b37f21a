// Sorted-segment reduction (sum / min / max) for Hopper (sm_90a).
//
// Replaces both TPU kernels of src/repro/kernels/segment_reduce.py:
// `_resident_kernel` (num_segments <= 8192) and `_tiled_kernel`
// (larger). out[s, c] = op over rows r with seg_ids[r] == s of
// values[r, c]; ids outside [0, num_segments) are dropped; an empty
// segment gets the identity (0, the int32 extremes, or +-inf).
//
// Bound on the H100: bytes. The least traffic is one read of seg_ids and
// values and one write of the [num_segments, d] output, at 3.35 TB/s;
// the reduction is one operation per value read.
//
// Design: one warp per segment. seg_ids are sorted, so the warp finds
// its row range [start, end) with two warp-cooperative 32-way searches
// (each round the 32 lanes test 32 evenly spaced rows and a ballot cuts
// the range 32-fold), which drops out-of-range ids without a separate
// pass. The warp then reduces the range column by column: lane k takes
// rows start + k, start + k + 32, ..., and a fixed shuffle tree combines
// the lanes. The order of the additions depends only on the range, so
// float sums are deterministic, and int32 sums wrap (added as uint32),
// as jax.ops.segment_sum does. There is no atomic and no shared memory.
// Most engine segments hold 0 or 1 rows, so the two searches, which are
// dependent loads, set the time; staging seg_ids in shared memory or
// giving a warp a run of segments is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

enum Op { SUM = 0, MIN = 1, MAX = 2 };

// first index in [lo, hi) whose id is >= target (hi if none); every lane
// of the warp returns the same value
__device__ __forceinline__ int64_t warp_lower_bound(
    const int32_t* __restrict__ seg, int64_t lo, int64_t hi, int64_t target,
    int lane) {
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    int64_t p = lo + (int64_t)(lane + 1) * step - 1;
    const bool less = p < hi && (int64_t)seg[p] < target;
    const int c = __popc(__ballot_sync(FULL, less));
    // sorted ids: the lanes that saw a smaller id form a prefix
    const int64_t new_lo = lo + (int64_t)c * step;
    const int64_t cap = lo + (int64_t)(c + 1) * step - 1;
    hi = cap < hi ? cap : hi;
    lo = new_lo;
  }
  const int64_t p = lo + lane;
  const bool less = p < hi && (int64_t)seg[p] < target;
  return lo + __popc(__ballot_sync(FULL, less));
}

template <typename T, int OP>
struct Reducer;

template <int OP>
struct Reducer<int32_t, OP> {
  __device__ static int32_t identity() {
    return OP == SUM ? 0 : (OP == MIN ? INT32_MAX : INT32_MIN);
  }
  __device__ static int32_t combine(int32_t a, int32_t b) {
    if (OP == SUM) return (int32_t)((uint32_t)a + (uint32_t)b);
    if (OP == MIN) return a < b ? a : b;
    return a > b ? a : b;
  }
};

template <int OP>
struct Reducer<float, OP> {
  __device__ static float identity() {
    return OP == SUM ? 0.0f : (OP == MIN ? CUDART_INF_F : -CUDART_INF_F);
  }
  __device__ static float combine(float a, float b) {
    if (OP == SUM) return a + b;
    if (OP == MIN) return fminf(a, b);
    return fmaxf(a, b);
  }
};

template <typename T, int OP>
__global__ void segment_reduce_kernel(const T* __restrict__ values,
                                      const int32_t* __restrict__ seg,
                                      int64_t n, int64_t d,
                                      int64_t num_segments,
                                      T* __restrict__ out) {
  const int64_t s =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (s >= num_segments) return;  // uniform across the warp
  const int64_t start = warp_lower_bound(seg, 0, n, s, lane);
  const int64_t end = warp_lower_bound(seg, start, n, s + 1, lane);
  using R = Reducer<T, OP>;
  for (int64_t c = 0; c < d; ++c) {
    T acc = R::identity();
    for (int64_t r = start + lane; r < end; r += 32)
      acc = R::combine(acc, values[r * d + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = R::combine(acc, __shfl_xor_sync(FULL, acc, off));
    if (lane == 0) out[s * d + c] = acc;
  }
}

template <typename T>
void launch(const void* values, const int32_t* seg, int64_t n, int64_t d,
            int64_t num_segments, int op, void* out, cudaStream_t stream) {
  const int threads = 256;  // 8 warps, 8 segments per block
  const int64_t blocks = (num_segments * 32 + threads - 1) / threads;
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  if (op == SUM)
    segment_reduce_kernel<T, SUM><<<(unsigned)blocks, threads, 0, stream>>>(
        v, seg, n, d, num_segments, o);
  else if (op == MIN)
    segment_reduce_kernel<T, MIN><<<(unsigned)blocks, threads, 0, stream>>>(
        v, seg, n, d, num_segments, o);
  else
    segment_reduce_kernel<T, MAX><<<(unsigned)blocks, threads, 0, stream>>>(
        v, seg, n, d, num_segments, o);
}

}  // namespace

// values: [n, d] row-major, int32 (is_float = 0) or float32 (is_float = 1).
// seg: [n] int32 sorted ascending. out: [num_segments, d], same type as
// values. op: 0 sum, 1 min, 2 max. Returns cudaGetLastError().
extern "C" int segment_reduce(const void* values, int is_float,
                              const void* seg, int64_t n, int64_t d,
                              int64_t num_segments, int op, void* out,
                              void* stream) {
  if (op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float)
    launch<float>(values, s, n, d, num_segments, op, out, st);
  else
    launch<int32_t>(values, s, n, d, num_segments, op, out, st);
  return (int)cudaGetLastError();
}
