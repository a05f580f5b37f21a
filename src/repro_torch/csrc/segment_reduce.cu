// Sorted-segment reduction (sum / min / max) for Hopper (sm_90a).
//
// Replaces both TPU kernels of src/repro/kernels/segment_reduce.py:
// `_resident_kernel` (num_segments <= 8192) and `_tiled_kernel`
// (larger). out[s, c] = op over rows r with seg_ids[r] == s of
// values[r, c]; ids outside [0, num_segments) are dropped; an empty
// segment gets the identity (0, the int32 extremes, or +-inf); int32
// sums wrap (added as uint32); float sums are deterministic.
//
// Bound on the H100: bytes. The least traffic is one read of seg_ids and
// values and one write of the [num_segments, d] output, at 3.35 TB/s;
// the reduction is one operation per value read.
//
// Design: a row-parallel pass whose work is proportional to the rows and
// the output, never to a search per segment.
// 1. fill_identity writes the identity over all of `out` with 16-byte
//    stores. The engine passes num_segments = the buffer's capacity, and
//    its live ids are a dense prefix, so the empty segments form one gap
//    as long as the buffer: a pass over the output spreads that over the
//    whole card, where filling each tile's gaps would leave one CTA to
//    write it alone. It costs one more write of the output (4/3 of the
//    bound's bytes when n = num_segments and d = 1).
// 2. reduce_tiles: each CTA takes a tile of tile_rows(d) consecutive
//    rows and marks segment heads by comparing each id with the one
//    before (the tile also reads the id on each side of it). A segmented
//    scan gives each thread the partial of the run its rows start in; a
//    second pass over its rows yields each run's value at its last row.
//    Runs that start and end inside the tile are packed into a list in
//    shared memory and written with consecutive threads on consecutive
//    entries; the tile's first run, if it began in an earlier tile, and
//    its last run, if it goes on past the tile, go to a scratch buffer
//    of 2 partials per tile.
//    d = 1 (the engine's calls), reduce_tiles_d1: 512 threads of 4 rows,
//    one 16-byte load of ids and one of values a thread, neighbouring
//    threads on neighbouring addresses; rows stay in registers; the scan
//    runs over the lanes by shuffles, then over the warps.
//    d > 1: the tile's ids and values are staged in shared memory with
//    16-byte loads; each row's flags (head, where its run's value goes)
//    are worked out once; thread (p, c) owns column c of chunk p, R
//    rows, and the scan over the chunks is a Hillis-Steele pass in
//    shared memory.
// 3. combine_crossing: one warp per tile that holds the first row of a
//    run which goes on past it. The warp walks the following tiles 32 at
//    a time and finds where the run ends with a ballot; for d = 1 it
//    combines their partials with a fixed shuffle tree, for d > 1 each
//    lane combines its columns tile by tile.
// Every combine happens in an order fixed by the row positions alone
// (the scan trees, the chunk order, the walk), and no atomic is used, so
// float sums give the same bits on every run.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // reduce_tiles (d > 1)
constexpr int R = 32;         // rows per chunk of reduce_tiles
constexpr int T1 = 512;       // reduce_tiles_d1 (d = 1)
constexpr int R1 = 4;         // rows per thread of reduce_tiles_d1

enum Op { SUM = 0, MIN = 1, MAX = 2 };

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

// columns per chunk group: d rounded up to a power of two, at most THREADS
__host__ __device__ inline int col_width(int64_t d) {
  int cw = 1;
  while (cw < d && cw < THREADS) cw <<= 1;
  return cw;
}

__host__ __device__ inline int tile_rows(int64_t d) {
  return d == 1 ? T1 * R1 : THREADS / col_width(d) * R;
}

// one padding word every 32: chunk p's rows p * R + k fall on distinct
// banks across a warp
__host__ __device__ inline int pad(int x) { return x + (x >> 5); }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// shared memory words: seg [pad(TR + 2)], values [pad(TR * d)], scan
// flags, values and counts [3 * THREADS], list ids [TR], list values
// [pad(TR * cw)], list length [4], row flags [TR bytes]
__host__ __device__ inline int64_t smem_words(int64_t d) {
  const int tr = tile_rows(d), cw = col_width(d);
  return round4(pad(tr + 2)) + round4(pad(tr * d)) + 3 * THREADS + tr +
         round4(pad(tr * cw)) + 4 + round4(tr) / 4;
}

// reduce_tiles' row flags: a run's first row, and where the value of a
// run that ends at the row goes
constexpr uint8_t HEAD = 1, WHERE = 6, LIST = 2, FIRST = 4, LAST = 6;

// copy `count` 4-byte words from global `src` to shared `dst[pad(i)]`,
// 16 bytes a thread where `src` is aligned
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const uint32_t* __restrict__ src,
                                      int count, int dst0) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = count >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int q = threadIdx.x; q < quads; q += THREADS) {
      const uint4 x = __ldg(s4 + q);
      const int o = dst0 + 4 * q;
      dst[pad(o)] = x.x;
      dst[pad(o + 1)] = x.y;
      dst[pad(o + 2)] = x.z;
      dst[pad(o + 3)] = x.w;
    }
    head = quads << 2;
  }
  for (int i = head + threadIdx.x; i < count; i += THREADS)
    dst[pad(dst0 + i)] = __ldg(src + i);
}

template <typename T, int OP>
__global__ void fill_identity(T* __restrict__ out, int64_t count) {
  using Red = Reducer<T, OP>;
  const T id = Red::identity();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int64_t quads = count >> 2;
    uint4 v;
    v.x = v.y = v.z = v.w = *reinterpret_cast<const uint32_t*>(&id);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t q = i0; q < quads; q += stride) o4[q] = v;
    head = quads << 2;
  }
  for (int64_t i = head + i0; i < count; i += stride) out[i] = id;
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
reduce_tiles(const T* __restrict__ values, const int32_t* __restrict__ seg,
             int64_t n, int d, int64_t num_segments, T* __restrict__ out,
             T* __restrict__ first_part, T* __restrict__ last_part) {
  using Red = Reducer<T, OP>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int cw = col_width(d), nc = THREADS / cw, TR = nc * R;
  int32_t* sseg = reinterpret_cast<int32_t*>(smem);       // [pad(TR + 2)]
  T* svals = reinterpret_cast<T*>(smem + round4(pad(TR + 2)));
  int* sflag = reinterpret_cast<int*>(svals + round4(pad(TR * d)));
  T* sval = reinterpret_cast<T*>(sflag + THREADS);
  int* scnt = reinterpret_cast<int*>(sval + THREADS);
  int32_t* lseg = scnt + THREADS;                         // [TR]
  T* lval = reinterpret_cast<T*>(lseg + TR);              // [pad(TR * cw)]
  int* lcount = reinterpret_cast<int*>(lval + round4(pad(TR * cw)));
  uint8_t* sfl = reinterpret_cast<uint8_t*>(lcount + 4);  // [TR]

  const int64_t t = blockIdx.x;
  const int64_t r0 = t * TR;
  const int rows = (int)min((int64_t)TR, n - r0);
  const int tid = threadIdx.x;

  // sseg[pad(0)] = seg[r0 - 1], sseg[pad(1 + i)] = seg[r0 + i],
  // sseg[pad(rows + 1)] = seg[r0 + rows] (where those rows exist)
  stage(reinterpret_cast<uint32_t*>(sseg),
        reinterpret_cast<const uint32_t*>(seg + r0), rows, 1);
  stage(reinterpret_cast<uint32_t*>(svals),
        reinterpret_cast<const uint32_t*>(values + r0 * d), rows * d, 0);
  if (tid == 0 && r0 > 0) sseg[pad(0)] = seg[r0 - 1];
  if (tid == 1 && r0 + rows < n) sseg[pad(rows + 1)] = seg[r0 + rows];
  __syncthreads();

  const bool first_cont = r0 > 0 && sseg[pad(0)] == sseg[pad(1)];
  const bool last_cont =
      r0 + rows < n && sseg[pad(rows + 1)] == sseg[pad(rows)];
  const int32_t first_id = sseg[pad(1)];

  // each row's flags, once for all columns: HEAD, and where the value of
  // a run that ends at the row goes (LIST, FIRST or LAST partial)
  for (int i = tid; i < rows; i += THREADS) {
    const int32_t s = sseg[pad(i + 1)];
    const bool head = i == 0 ? !first_cont : s != sseg[pad(i)];
    const bool end = i == rows - 1 || s != sseg[pad(i + 2)];
    uint8_t fl = head ? HEAD : 0;
    if (end && s >= 0 && s < num_segments) {
      if (first_cont && s == first_id)  // a run through the whole tile
        fl |= FIRST;                    // is kept as its first run
      else if (i == rows - 1 && last_cont)
        fl |= LAST;
      else
        fl |= LIST;
    }
    sfl[i] = fl;
  }
  __syncthreads();

  const int p = tid / cw;
  for (int c0 = 0; c0 < d; c0 += cw) {
    const int c = c0 + tid % cw;
    const bool active = c < d;
    const int i0 = p * R, n_mine = max(0, min(R, rows - i0));

    // pass 1: the chunk's flag (a head among its rows), the partial of
    // its last run, and the number of runs it completes inside the tile
    bool f = false;
    T v = Red::identity();
    int cnt = 0;
    for (int k = 0; k < n_mine; ++k) {
      const uint8_t fl = sfl[i0 + k];
      const T x = active ? svals[pad((i0 + k) * d + c)] : Red::identity();
      v = (fl & HEAD) ? x : Red::combine(v, x);
      f |= (fl & HEAD) != 0;
      cnt += (fl & WHERE) == LIST;
    }

    // inclusive segmented scan over the chunks of column c
    sflag[tid] = f;
    sval[tid] = v;
    scnt[tid] = cnt;
    __syncthreads();
    for (int off = 1; off < nc; off <<= 1) {
      int f2 = 0, c2 = 0;
      T v2 = Red::identity();
      const bool take = p >= off;
      if (take) {
        const int j = tid - off * cw;
        f2 = sflag[j] | sflag[tid];
        v2 = sflag[tid] ? sval[tid] : Red::combine(sval[j], sval[tid]);
        c2 = scnt[j] + scnt[tid];
      }
      __syncthreads();
      if (take) {
        sflag[tid] = f2;
        sval[tid] = v2;
        scnt[tid] = c2;
      }
      __syncthreads();
    }
    T acc = Red::identity();
    int slot = 0;
    if (p > 0) {
      acc = sval[tid - cw];
      slot = scnt[tid - cw];
    }
    if (tid == 0) lcount[0] = scnt[(nc - 1) * cw];

    // pass 2: each run's value at its last row in the tile
    for (int k = 0; k < n_mine; ++k) {
      const int i = i0 + k;
      const uint8_t fl = sfl[i];
      const T x = active ? svals[pad(i * d + c)] : Red::identity();
      acc = (fl & HEAD) ? x : Red::combine(acc, x);
      const int where = fl & WHERE;
      if (where == LIST) {
        if (tid % cw == 0) lseg[slot] = sseg[pad(i + 1)];
        if (active) lval[pad(slot * cw + (c - c0))] = acc;
        ++slot;
      } else if (where != 0 && active) {
        (where == FIRST ? first_part : last_part)[t * d + c] = acc;
      }
    }
    __syncthreads();

    // the tile's complete runs, consecutive threads on consecutive ids
    const int total = lcount[0];
    const int width = min(cw, d - c0);
    for (int x = tid; x < total * width; x += THREADS) {
      const int e = x / width, cc = x - e * width;
      out[(int64_t)lseg[e] * d + c0 + cc] = lval[pad(e * cw + cc)];
    }
    __syncthreads();
  }
}

// The d = 1 form of reduce_tiles (the engine's): 512 threads of R1 = 4
// consecutive rows each over the same 2048-row tile, loaded with one
// 16-byte load per array, neighbouring threads on neighbouring
// addresses; ids and values stay in registers; the neighbouring ids come
// from the next lanes by shuffles; the segmented scan runs over the lanes
// by shuffles and over the warps in shared memory.
template <typename T, int OP>
struct Carry {
  int f;  // a head among the rows
  T v;    // the partial of the last run
  int c;  // runs completed inside the tile
};

// (earlier) then (later)
template <typename T, int OP>
__device__ __forceinline__ Carry<T, OP> join(const Carry<T, OP>& a,
                                             const Carry<T, OP>& b) {
  return {a.f | b.f, b.f ? b.v : Reducer<T, OP>::combine(a.v, b.v),
          a.c + b.c};
}

template <typename T, int OP>
__device__ __forceinline__ Carry<T, OP> shfl_up(const Carry<T, OP>& a,
                                                int off) {
  return {__shfl_up_sync(FULL, a.f, off), __shfl_up_sync(FULL, a.v, off),
          __shfl_up_sync(FULL, a.c, off)};
}

template <typename T, int OP>
__global__ void __launch_bounds__(T1)
reduce_tiles_d1(const T* __restrict__ values, const int32_t* __restrict__ seg,
                int64_t n, int64_t num_segments, T* __restrict__ out,
                T* __restrict__ first_part, T* __restrict__ last_part) {
  using Red = Reducer<T, OP>;
  using Cr = Carry<T, OP>;
  constexpr int TR = T1 * R1, WARPS = T1 / 32;
  __shared__ int32_t lseg[TR];
  __shared__ T lval[TR];
  __shared__ int wf[WARPS], wc[WARPS];
  __shared__ T wv[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = blockIdx.x, r0 = t * TR;
  const int rows = (int)min((int64_t)TR, n - r0);
  const int i0 = tid * R1;                 // first tile row of this thread
  const int nv = max(0, min(R1, rows - i0));
  const int64_t g = r0 + i0;

  int32_t s[R1];
  T x[R1];
  if (nv == R1 && ((reinterpret_cast<uintptr_t>(seg) |
                    reinterpret_cast<uintptr_t>(values)) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(seg + g));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(values + g));
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    const uint32_t u[R1] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < R1; ++k) x[k] = *reinterpret_cast<const T*>(&u[k]);
  } else {
#pragma unroll
    for (int k = 0; k < R1; ++k) {
      s[k] = k < nv ? seg[g + k] : 0;
      x[k] = k < nv ? values[g + k] : Red::identity();
    }
  }
  const int32_t first_id = seg[r0];
  const bool first_cont = r0 > 0 && seg[r0 - 1] == first_id;
  const int64_t r1 = r0 + rows;
  const bool last_cont = r1 < n && seg[r1] == seg[r1 - 1];
  // the ids on either side of this thread's rows
  int32_t prev = __shfl_up_sync(FULL, s[R1 - 1], 1);
  int32_t next = __shfl_down_sync(FULL, s[0], 1);
  if (lane == 0 && nv > 0 && g > 0) prev = seg[g - 1];
  if (lane == 31 && nv == R1 && g + R1 < n) next = seg[g + R1];

  bool head[R1], end[R1];
#pragma unroll
  for (int k = 0; k < R1; ++k) {
    const int i = i0 + k;
    head[k] = k > 0 ? s[k] != s[k - 1]
                    : (i == 0 ? !first_cont : s[0] != prev);
    end[k] = i == rows - 1 || (k < R1 - 1 ? s[k] != s[k + 1] : s[k] != next);
  }

  // pass 1: this thread's carry
  Cr mine = {0, Red::identity(), 0};
#pragma unroll
  for (int k = 0; k < R1; ++k) {
    if (k < nv) {
      mine.v = head[k] ? x[k] : Red::combine(mine.v, x[k]);
      mine.f |= head[k];
      const int i = i0 + k;
      if (end[k] && s[k] >= 0 && s[k] < num_segments &&
          !(i == rows - 1 && last_cont) && !(first_cont && s[k] == first_id))
        ++mine.c;
    }
  }
  // inclusive scan over the lanes, then over the warps
  Cr inc = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Cr up = shfl_up(inc, off);
    if (lane >= off) inc = join(up, inc);
  }
  if (lane == 31) {
    wf[warp] = inc.f;
    wv[warp] = inc.v;
    wc[warp] = inc.c;
  }
  __syncthreads();
  if (warp == 0) {
    Cr w = lane < WARPS ? Cr{wf[lane], wv[lane], wc[lane]}
                        : Cr{0, Red::identity(), 0};
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const Cr up = shfl_up(w, off);
      if (lane >= off) w = join(up, w);
    }
    if (lane < WARPS) {
      wf[lane] = w.f;
      wv[lane] = w.v;
      wc[lane] = w.c;
    }
  }
  __syncthreads();
  Cr ex = shfl_up(inc, 1);
  if (lane == 0) ex = {0, Red::identity(), 0};
  if (warp > 0) ex = join(Cr{wf[warp - 1], wv[warp - 1], wc[warp - 1]}, ex);
  const int total = wc[WARPS - 1];

  // pass 2: each run's value at its last row in the tile
  T acc = ex.v;
  int slot = ex.c;
#pragma unroll
  for (int k = 0; k < R1; ++k) {
    if (k < nv) {
      acc = head[k] ? x[k] : Red::combine(acc, x[k]);
      if (end[k] && s[k] >= 0 && s[k] < num_segments) {
        const bool cross_r = i0 + k == rows - 1 && last_cont;
        const bool cross_l = first_cont && s[k] == first_id;
        if (cross_l) {
          first_part[t] = acc;
        } else if (cross_r) {
          last_part[t] = acc;
        } else {
          lseg[slot] = s[k];
          lval[slot] = acc;
          ++slot;
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < total; e += T1) out[lseg[e]] = lval[e];
}

// one warp per tile; the warps of tiles that hold no run's first row
// (or whose last run ends inside them) return at once
template <typename T, int OP>
__global__ void combine_crossing(const T* __restrict__ first_part,
                                 const T* __restrict__ last_part,
                                 const int32_t* __restrict__ seg, int64_t n,
                                 int64_t d, int64_t num_segments,
                                 int64_t tile, int64_t num_tiles,
                                 T* __restrict__ out) {
  using Red = Reducer<T, OP>;
  const int64_t t =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;
  const int64_t r0 = t * tile, r1 = min(r0 + tile, n);
  if (r1 >= n) return;
  const int32_t s = seg[r1 - 1];
  if (seg[r1] != s || s < 0 || s >= num_segments) return;
  // the run's first row lies in this tile unless the tile is all one run
  // that began earlier
  if (r0 > 0 && seg[r0 - 1] == s && seg[r0] == s) return;
  // tiles t + 1 .. e hold the rest of the run; e is the first whose
  // last row ends it
  int64_t e = num_tiles - 1;
  for (int64_t base = t + 1; base < num_tiles; base += 32) {
    const int64_t u = base + lane;
    const int64_t u1 = min((u + 1) * tile, n);
    const bool stop = u < num_tiles && (u1 >= n || seg[u1] != s);
    const unsigned b = __ballot_sync(FULL, stop);
    if (b) {
      e = base + __ffs(b) - 1;
      break;
    }
  }
  if (d == 1) {  // the lanes take 32 tiles at a time
    T acc = last_part[t];
    for (int64_t base = t + 1; base <= e; base += 32) {
      const int64_t u = base + lane;
      T x = u <= e ? first_part[u] : Red::identity();
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = Red::combine(x, __shfl_xor_sync(FULL, x, off));
      acc = Red::combine(acc, x);
    }
    if (lane == 0) out[s] = acc;
  } else {  // the lanes take the columns, the tiles go in order
    for (int64_t c = lane; c < d; c += 32) {
      T acc = last_part[t * d + c];
      for (int64_t u = t + 1; u <= e; ++u)
        acc = Red::combine(acc, first_part[u * d + c]);
      out[(int64_t)s * d + c] = acc;
    }
  }
}

template <typename T, int OP>
cudaError_t launch(const void* values, const int32_t* seg, int64_t n,
                   int64_t d, int64_t num_segments, void* out, void* scratch,
                   cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  const int64_t count = num_segments * d;
  if (count > 0) {
    const int64_t want = (count / 4 + THREADS - 1) / THREADS;
    const int blocks = (int)max((int64_t)1, min(want, (int64_t)132 * 16));
    fill_identity<T, OP><<<blocks, THREADS, 0, stream>>>(o, count);
  }
  if (n == 0 || count == 0) return cudaGetLastError();
  const int64_t tile = tile_rows(d);
  const int64_t num_tiles = (n + tile - 1) / tile;
  T* first = static_cast<T*>(scratch);
  T* last = first + num_tiles * d;
  const size_t smem = (size_t)smem_words(d) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      reduce_tiles<T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  if (d == 1)
    reduce_tiles_d1<T, OP><<<(unsigned)num_tiles, T1, 0, stream>>>(
        static_cast<const T*>(values), seg, n, num_segments, o, first, last);
  else
    reduce_tiles<T, OP><<<(unsigned)num_tiles, THREADS, smem, stream>>>(
        static_cast<const T*>(values), seg, n, (int)d, num_segments, o, first,
        last);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (num_tiles * 32 + THREADS - 1) / THREADS;
  combine_crossing<T, OP><<<(unsigned)blocks, THREADS, 0, stream>>>(
      first, last, seg, n, d, num_segments, tile, num_tiles, o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_op(int op, const void* values, const int32_t* seg, int64_t n,
                  int64_t d, int64_t num_segments, void* out, void* scratch,
                  cudaStream_t stream) {
  if (op == SUM)
    return launch<T, SUM>(values, seg, n, d, num_segments, out, scratch,
                          stream);
  if (op == MIN)
    return launch<T, MIN>(values, seg, n, d, num_segments, out, scratch,
                          stream);
  return launch<T, MAX>(values, seg, n, d, num_segments, out, scratch,
                        stream);
}

}  // namespace

// Elements of scratch (of the values' type) that segment_reduce needs
// for n rows of d columns: 2 partials per tile.
extern "C" int64_t segment_reduce_scratch(int64_t n, int64_t d) {
  const int64_t tile = tile_rows(d);
  return 2 * ((n + tile - 1) / tile) * d;
}

// Shared memory (bytes) of one reduce_tiles block for d columns.
extern "C" int64_t segment_reduce_smem(int64_t d) {
  return smem_words(d) * 4;
}

// values: [n, d] row-major, int32 (is_float = 0) or float32 (is_float = 1).
// seg: [n] int32 sorted ascending. out: [num_segments, d], same type as
// values. scratch: segment_reduce_scratch(n, d) elements of that type.
// op: 0 sum, 1 min, 2 max. Returns cudaGetLastError().
extern "C" int segment_reduce(const void* values, int is_float,
                              const void* seg, int64_t n, int64_t d,
                              int64_t num_segments, int op, void* out,
                              void* scratch, void* stream) {
  if (op < 0 || op > 2 || n < 0 || d < 1 || num_segments < 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_float ? (int)by_op<float>(op, values, s, n, d, num_segments,
                                      out, scratch, st)
                  : (int)by_op<int32_t>(op, values, s, n, d, num_segments,
                                        out, scratch, st);
}
