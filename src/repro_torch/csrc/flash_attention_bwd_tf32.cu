// Backward of the float32 prefill attention on Hopper's tensor cores
// (sm_90a), for training: dq, dk and dv of
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / group, j] * scale)
//                  . v[b, h / group, j]
// over keys j <= i when causal (sq == skv), over all j otherwise, in
// error-compensated TF32 (3xTF32), as the forward
// (flash_attention_tf32.cu) computes it, on wgmma: one CTA a tile at d =
// 64 and 128, a cluster of two CTAs that split d at d = 256; at d = 16 and
// 32 on mma.sync (bwd_dkdv_mma, bwd_dq_mma; "head dims 16 and 32" below).
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (autograd of src/repro/kernels/ref.py attention_ref) and has no Pallas
// backward. It is the backward of flash_attention_tf32.cu, whose training
// entry (flash_attention_tf32_lse) saves each row's log-sum-exp (lse), so P
// is recomputed here without a second softmax pass.
//
// Bound on the H100: operations. The essential work is five products of
// 2 d flops per visible (query, key) pair (Q K^T, dO V^T, P^T dO, dS^T Q,
// dS K), each done three times over (lo.hi + hi.lo + hi.hi) at 495
// TFLOP/s dense TF32; q, k, v, o, dO, lse in and dq, dk, dv out cross HBM
// once. At qwen3-1.7b's step shape (q [2, 16, 4096, 128], causal) that is
// 2.08 ms, and the same at gemma-7b's (q [1, 16, 4096, 256]). Products
// issued, in units of the bound's five: seven at every d, the dK/dV kernel
// four (S^T, dP^T, P^T dO, dS^T Q) and the dQ kernel three (S and dP
// again, dS K); at d = 256 each CTA of a pair issues half of each over its
// half of d. kernels/flash_attention.py's BWD_PRODUCTS mirrors this line:
// products (dK/dV, dQ) by d: 16: 4, 3; 32: 4, 3; 64: 4, 3; 128: 4, 3;
// 256: 4, 3
//
// Precision (tests/test_torch_tf32_bwd_split.py emulates it, with the
// geometry of tests/tf32_emulation.py's BWD_GEOMETRY): every operand, P
// and dS included, is split into hi and lo and each product is lo.hi +
// hi.lo + hi.hi, the small products first. A B operand (read from shared
// memory) takes tf32x3.cuh's split, hi = cvt.rna.tf32(x) (computed as
// (bits + 0x1000) & ~0x1fff) and lo = x - hi; an A operand (K, V, Q, dO,
// P^T, dS^T, dS, in registers) passes its raw f32 bits as hi, which the
// tensor core truncates, and lo = x - trunc(x) (split_a): one register and
// one instruction less a value. Truncating one side keeps the emulation's
// worst error at 0.292 of the tolerance; both sides would reach 0.561. A
// tensor core adds into its accumulator rounding toward zero, so a long
// sum through it drifts: every KG = 2 k-steps of 8 of S^T, dP^T, S and dP
// go into a fresh fragment added to the f32 value (round to nearest), and
// so does each stage's P^T dO and dS^T Q before it is added to dV or dK,
// and each stage's dS K before it is added to dQ. At d = 256 each CTA of
// a pair sums its 128 columns so, and the two partials are added once in
// f32. dK and dV sum over every query row of every head of the GQA group
// (16 x 4096 terms a value at 16:1), so this matters more here than in the
// forward.
//
// Design (bwd_dkdv_wgmma, bwd_dq_wgmma; C columns of d a CTA: D at d = 64
// and 128, D / 2 = MAX_CTA_COLS at d = 256):
// - What held PR 27's mma.sync kernels to 21% of the bound at qwen3's
//   shape was issue slots: every operand fragment was read with 4-byte
//   shared loads and split into hi and lo on the CUDA cores at each use,
//   by each of four warps (about 76 instructions for 12 products of S^T
//   and dP^T). Here each streamed value is split once, by a producer, and
//   every product is one wgmma of a warpgroup.
// - wgmma takes TF32 operands K-major only (no transpose bit), so: S^T =
//   K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and dP = dO V^T (dQ) read
//   Q, dO, K, V as stored (rows of d); dV += P^T dO, dK += dS^T Q and dQ +=
//   dS K take P^T, dS^T, dS as register A fragments (RS) and read the
//   transposed tiles dO^T, Q^T, K^T, which the producer writes.
// - A CTA is 3 warpgroups (384 threads): a producer (setmaxnreg 56) and
//   two consumers (224). The CTA's fixed operand lives in the consumers'
//   registers as raw f32 A fragments (64 rows x C: C / 2 registers a
//   thread) and is split one k-step at a time (4 values a thread; an empty
//   asm statement keeps the compiler from hoisting the split of the whole
//   operand out of the stage loop, 128 registers). dK/dV (a CTA owns BM =
//   64 keys of one (b, kv head)): consumer 1 holds K and forms S^T, P^T and
//   dV, consumer 2 holds V and forms dP^T, dS^T and dK; P^T passes to
//   consumer 2 in f32 through one of two exchange buffers (thread t's pair
//   p at [p][t]: both accumulators have one layout), ordered by named
//   barriers over the 256 consumer threads: BAR_READY + b (1 arrives, 2
//   waits), BAR_FREE + b (2 arrives, 1 waits before reusing b). dQ (BM =
//   64 query rows of one (b, q head)): consumer 1 holds Q and forms S and
//   P, consumer 2 holds dO and forms dP and dS = P (dP - D), written back
//   in P's place (BAR_READY + b: P written, BAR_FREE + b: dS written), and
//   each consumer adds dS K into its half of dQ's columns, so both take a
//   share of the third product and no product sits on a branch that one
//   consumer alone takes (there ptxas serialized every product, C7520, and
//   dQ took 1.6 times as long).
// - The producer streams raw f32 tiles of R = 2048 / C rows x the CTA's C
//   columns (query rows for dK/dV over each query head of the group in
//   turn, under causal from the tile of the CTA's first key; keys for dQ,
//   under causal up to the CTA's last row) by TMA (128-byte swizzle, rows
//   past s zero-filled) into a ring of RAW = 4 slots, and writes each
//   value's hi and lo once into a ring of STAGES = 2 operand stages: at the
//   same swizzled offset (the K-major B of S^T, dP^T, S, dP) and, for Q, dO
//   (dK/dV) and K (dQ), transposed into core matrices without swizzle
//   ([C][R], the B of dV, dK, dQ), the rows' order permuted within each 8
//   (row 2 i + o at k index 4 o + i) so that an accumulator's column pair 2
//   t, 2 t + 1 is an A fragment's k indices t and t + 4: P^T, dS^T and dS
//   go from the accumulator to the next product without a shuffle. A warp
//   splits 4 rows x 8 columns a step (rows 8 b + o + 2 (lane / 8), columns
//   8 c + lane % 8): its swizzled reads and writes and its transposed
//   writes each hit 32 banks, at per-thread bases plus immediates, all of
//   a tile's loads before its stores. It also writes each dK/dV stage's lse
//   (times log2 e; +inf for rows past s, so their P is 0) and D, and fences
//   its writes to the async proxy before it arrives on the stage's barrier.
// - Per stage a consumer runs its first product over its C columns in
//   groups of KG k-steps, each group a fresh fragment (two in turn, so one
//   group runs on the tensor cores while the last is added), then its
//   second product over the stage's R rows by N = 64 blocks of its C
//   columns (dQ: one half a consumer), each block a fresh fragment added to
//   dV, dK or dQ.
// - The C = 128 reckoning, a consumer thread's registers: the fixed
//   operand 64 + dV or dK 64 (dQ's half 32) + the first product's
//   accumulator 8 and two fresh fragments 16 + two groups' lo A fragments
//   in flight 16 (hi is the operand's own register) + the stage's P^T lo 8
//   + a block's fresh fragment 32: about 190 of 224 at the peak, with loop
//   state. ptxas found too few registers for its wgmma pipeline at d = 128
//   (C7511, every product serialized) with KG = 4, and in dK/dV with the
//   warpgroup index broadcast by __shfl_sync (which dQ needs: without it
//   ptxas took the consumers' branches as divergent).
//   Shared memory (R = 16 at C = 128, 32 at C = 64: a tile is 8 KB at
//   both): dK/dV the raw ring 4 x 2 tiles + 2 stages of 8 tiles (Q, dO hi
//   and lo, their transposes) + 2 exchange buffers (64 x R f32) + lse, D
//   + barriers + 1,024 of alignment: 206,144 B at d = 128, 214,592 B at d
//   = 64; dQ 4 x 2 + 2 x 6 tiles (K, V hi and lo, K^T hi and lo) + the
//   exchange: 173,120 and 181,312 B. One CTA an SM.
// - What sets the pace (launch/wgmma_tf32_rate.py on the H100, PERF.md):
//   an RS wgmma in TF32 costs about 28 clocks of an SM's tensor pipe at N =
//   16 (29% of its peak; 31 clocks at N = 32, 32 at N = 64 with two
//   accumulators in flight, the peak). At C = 128 a stage's first products
//   are 2 x 48 such N = 16 instructions (its R = 16 rows are N), about
//   2,700 clocks, against 1,536 clocks of the stage's work at the peak.
//   Stages of 32 rows at C = 128 would need 2 x 128 KB of operand stages
//   (or a single-buffered transposed half and B operands split by
//   truncation, 209 KB) and about 230 registers a dK/dV consumer.
// - Masks only on stages that cross the diagonal or the end of s. Keys
//   past s give dK/dV rows that are never written, and are masked in dQ.
//
// d = 256: a cluster of two CTAs (bwd_dkdv_wgmma<256, 128>,
// bwd_dq_wgmma<256, 128>). One CTA cannot hold what a consumer needs
// there: the fixed operand (64 x 256 f32) takes 128 registers a thread and
// dV or dK 128 more (255 is a thread's most, 224 a consumer's here); held
// as hi and lo in shared memory instead, K and V would take 256 KB of the
// 232,448 B a block has; sharing a CTA's rows across warps instead, each
// warp forming S^T and dP^T over all of d, issues fifteen products where
// seven would do. So the two CTAs of a cluster own the same 64 keys
// (dK/dV) or query rows (dQ), and the CTA of rank r holds columns [128 r,
// 128 r + 128): its fixed operand
// and its columns of dV and dK (dQ) in registers; its producer streams
// those columns of Q and dO (K and V), the d = 128 kernel's tiles, and
// the stage's whole lse and D rows. Each consumer's first product is then
// a partial S^T or dP^T (S or dP) over 128 columns. The consumer writes
// it into the peer CTA's receive buffer (consumer, stage parity) with
// st.async (thread t's values 4 q .. 4 q + 3 at [q][t]), each store
// counted in bytes on the peer's barrier of that buffer, which the
// receiving consumer's thread 0 arms with the buffer's 4,096 bytes; every
// thread waits on its own barrier and adds the peer's partial to its own
// in f32, round to nearest: both CTAs hold the same bits, since addition
// commutes. From there each CTA is the d = 128 kernel: P^T and dS^T (P and
// dS) duplicated in the pair, then dV += P^T dO[:, r] and dK += dS^T Q[:,
// r] (dQ[:, r] += dS K[:, r]) over its own columns, with no exchange. Two
// receive buffers a consumer need no credit back: the peer writes buffer
// b again two stages later, after it has waited for the partial that this
// CTA sends one stage later, which this CTA sends after reading b. A
// cluster barrier follows the barriers' init, and one precedes the exit,
// so that no CTA leaves while its peer may still reach its shared memory.
// Reckoning: a consumer thread's registers are the d = 128 kernel's, and
// nothing of the pair may stay live across the stage loop: with the rank
// (or the column offset it gives) held in a register there, ptxas
// serialized dK/dV's products (C7511) and the backward took 11.7 ms
// instead of 8.0 at gemma's shape, so the rank is read where it is used.
// Shared memory is d = 128's plus the 4 receive buffers (64 x 16 f32) and
// their 4 barriers: dK/dV 222,560 B, dQ 189,536 B. At gemma's shape (q [1,
// 16, 4096, 256]) each kernel launches 2 x 16 x 64 = 2,048 CTAs, one an
// SM; the launch names the cluster (cudaLaunchKernelEx with
// cudaLaunchAttributeClusterDimension). The exchange costs about an
// eighth of the time (without it, wrong but timed, 7.0 ms against 8.0):
// the tensor pipe waits while the partials cross (PERF.md). Plain remote
// stores with a release arrive and an acquire wait at cluster scope took
// 13.5 ms. Staggering the consumers (consumer 2's first product after
// consumer 1's, ordered by a named barrier, so that each exchange runs
// beside the other's products) behind a branch that one consumer alone
// takes made ptxas serialize the products (C7520), 9.8 ms; with the
// barrier predicated instead, dK/dV took 4.3 ms against 4.4 and dQ 3.6
// against 3.4 (PERF.md), too little to keep.
//
// No atomics and no split reductions: each output element is summed by
// one thread in a fixed order (dK and dV over the group's query heads in
// turn, dQ over the key tiles in turn), so every launch gives the same
// bits (a resumed training run must reproduce its state byte for byte).
// ptxas reports no spill in any kernel (_build keeps the report).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;
constexpr int KG = 2;   // k-steps of S^T, dP^T, S, dP a fresh fragment
constexpr float LOG2E = 1.4426950408889634f;

// lse in log2 units; a row with lse = -inf (no visible key) takes +inf,
// so its P is 0
__device__ __forceinline__ float lse2_of(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * LOG2E;
}

// ---- D = rowsum(dO * O) ----------------------------------------------------

__global__ void __launch_bounds__(256)
bwd_pre_kernel(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float4* op = reinterpret_cast<const float4*>(o + row * d);
  const float4* dp = reinterpret_cast<const float4*>(dout + row * d);
  float acc = 0.f;
  for (int i = lane; i < d / 4; i += 32) {
    const float4 a = op[i], b = dp[i];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- the wgmma kernels ------------------------------------------------------

constexpr int WG_THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BM = 64;           // keys a dK/dV CTA, query rows a dQ CTA
constexpr int RAW = 4;           // slots of raw tiles
constexpr int MAX_CTA_COLS = 128;  // columns of d a CTA holds; a larger d
                                   // is split over a cluster of d / 128
constexpr int P_REGS = 56, C_REGS = 224;  // setmaxnreg: 56 + 2 x 224 =
                                          // 3 x 168, the launch's
// named barriers (0 is __syncthreads'): between the consumers, BAR_READY +
// b (P^T or P written to exchange buffer b) and BAR_FREE + b (dK/dV:
// buffer b read; dQ: dS written in P's place); among the producer's 128
// threads, BAR_RAW (a raw slot read)
constexpr int BAR_READY = 1, BAR_FREE = 3, BAR_RAW = 5;

// C columns of d a CTA; PAIR: a cluster of two CTAs splits d
template <int C, bool PAIR = false>
struct WgGeo {
  static constexpr int R = 2048 / C;       // streamed rows a stage
  static constexpr int TILE = R * C * 4;   // bytes of a streamed f32 tile
  static constexpr int XBUF = BM * R * 4;  // bytes of an exchange buffer
  // the peer's partials: [consumer][stage parity] buffers of XBUF
  static constexpr int RECV = PAIR ? 4 * XBUF : 0;
  static constexpr int BARS = 8 * (RAW + 2 * STAGES + (PAIR ? 4 : 0));
  // raw slots of two tiles, stages of 8 (dK/dV) or 6 (dQ) tiles, two
  // exchange buffers, the receive buffers, lse and D of each dK/dV stage,
  // the barriers; +1024 to align to the swizzle's period
  static constexpr int KV_SMEM = 1024 + RAW * 2 * TILE + STAGES * 8 * TILE +
                                 2 * XBUF + RECV + 2 * STAGES * R * 4 + BARS;
  static constexpr int Q_SMEM =
      1024 + RAW * 2 * TILE + STAGES * 6 * TILE + 2 * XBUF + RECV + BARS;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                "a block has 232,448 B of shared memory");
  static_assert(BM % R == 0, "a dK/dV CTA's first stage starts at its key");
};

// ---- the pair's exchange (thread block clusters, distributed shared
// memory) ----

// read where it is used (volatile: not kept in a register across the
// consumers' stage loop, where ptxas has none to spare)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster's CTAs; orders what each wrote before
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of a shared::cta location in CTA `rank`'s shared memory
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// an asynchronous store of four floats into another CTA's shared memory
// (a peer_addr), counted as 16 bytes on that CTA's barrier `bar` (a
// peer_addr too): no fence, the barrier's phase makes the data visible
__device__ __forceinline__ void st_async_peer(uint32_t addr, const float* x,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
      : "memory");
}

// acc (this CTA's partial of a first product over its half of d, R / 2
// values a thread) += the peer's: thread t's values 4 q .. 4 q + 3 go to
// [q][t] of the peer's receive buffer (buf, this thread's slot: the same
// offset in both CTAs) by st.async, counted on the peer's barrier `bar` of
// that buffer, which thread 0 of each side arms with the buffer's bytes;
// the peer's partial is read from this CTA's buffer once its own
// barrier's phase `parity` is done. own + peer: the same bits in both
// CTAs.
template <int R>
__device__ __forceinline__ void add_peer(float (&acc)[R / 2], float4* buf,
                                         uint32_t bar, uint32_t parity,
                                         int t) {
  const uint32_t peer = cluster_rank() ^ 1;
  const uint32_t to = peer_addr(smem_u32(buf), peer);
  const uint32_t to_bar = peer_addr(bar, peer);
  if (t == 0) mbar_expect_tx(bar, BM * R * 4);
#pragma unroll
  for (int q = 0; q < R / 8; ++q)
    st_async_peer(to + q * 128 * 16, acc + 4 * q, to_bar);
  mbar_wait(bar, parity);
#pragma unroll
  for (int q = 0; q < R / 8; ++q) {
    const float4 x = buf[q * 128];
    acc[4 * q] += x.x;
    acc[4 * q + 1] += x.y;
    acc[4 * q + 2] += x.z;
    acc[4 * q + 3] += x.w;
  }
}

// a position in a ring of N slots: the slot, and the parity of the phase
// its mbarriers are in
template <int N>
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++st == N) {
      st = 0;
      ph ^= 1;
    }
  }
};

// p advanced to the swizzle's period (1024 B) by pointer arithmetic, so
// that the compiler keeps the shared address space (32-bit addresses,
// shared loads and stores)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// barrier BASE + buf over the 256 consumer threads, the id an immediate
template <int BASE>
__device__ __forceinline__ void bar_arrive(int buf) {
  if (buf)
    asm volatile("bar.arrive %0, 256;\n" ::"n"(BASE + 1) : "memory");
  else
    asm volatile("bar.arrive %0, 256;\n" ::"n"(BASE) : "memory");
}
template <int BASE>
__device__ __forceinline__ void bar_sync(int buf) {
  if (buf)
    asm volatile("bar.sync %0, 256;\n" ::"n"(BASE + 1) : "memory");
  else
    asm volatile("bar.sync %0, 256;\n" ::"n"(BASE) : "memory");
}

// Tile layouts (byte offsets). A streamed tile as TMA writes it, [D /
// 32][R][32] f32 with the 128-byte swizzle: (row r, column c) at (c / 32) R
// 128 + 128 r + 16 ((c % 32 / 4) XOR (r % 8)) + 4 (c % 4). A transposed
// tile, K-major core matrices without swizzle ([N][R]: 8 rows x 4 k values
// of 128 B, R / 4 of them along k 128 B apart, 8-row groups R 32 B apart):
// (row n, k index k) at (n / 8) R 32 + (k / 4) 128 + 16 (n % 8) + 4 (k %
// 4).

// The producer's split of one raw tile of R rows x D columns (swizzled, as
// TMA wrote it): hi and lo at the same offsets and, with TRANS, the
// transposed hi and lo ([D][R] core matrices, row 8 b + 2 i + o at k index
// 8 b + 4 o + i). Warp w, lane l takes rows 8 b + o + 2 i (i = l >> 3) x
// columns 32 q + 8 w + (l & 7): each of its shared-memory accesses hits 32
// banks. Its offsets are per-thread bases (SplitAt) plus immediates, and
// all R D / 128 values of a thread are loaded before the first store (the
// compiler keeps shared loads behind earlier stores it cannot tell apart,
// which made each value wait out a load's latency).
struct SplitAt {
  int sw[2];  // swizzled offset of row o + 2 i, the thread's column (o = 0, 1)
  int tr;     // transposed offset of the thread's column and k index i
};

template <int R>
__device__ __forceinline__ SplitAt split_at(int warp, int lane) {
  const int i = lane >> 3, c7 = lane & 7;
  const int chunk = 2 * warp + (c7 >> 2);  // 16-byte chunk of the row
  const int col = (c7 & 3) << 2;
  SplitAt a;
#pragma unroll
  for (int o = 0; o < 2; ++o)
    a.sw[o] = (o + 2 * i) * 128 + ((chunk ^ (o + 2 * i)) << 4) + col;
  a.tr = warp * (R * 32) + (c7 << 4) + (i << 2);
  return a;
}

template <int D, int R, bool TRANS>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo, uint8_t* thi,
                                           uint8_t* tlo, const SplitAt& a) {
  float x[R / 8][2][D / 32];
#pragma unroll
  for (int rb = 0; rb < R / 8; ++rb)
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int q = 0; q < D / 32; ++q)
        x[rb][o][q] = *reinterpret_cast<const float*>(
            raw + a.sw[o] + q * (R * 128) + rb * 1024);
#pragma unroll
  for (int rb = 0; rb < R / 8; ++rb)
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int q = 0; q < D / 32; ++q) {
        const int at = a.sw[o] + q * (R * 128) + rb * 1024;
        uint32_t h, l;
        split(x[rb][o][q], h, l);
        *reinterpret_cast<uint32_t*>(hi + at) = h;
        *reinterpret_cast<uint32_t*>(lo + at) = l;
        if constexpr (TRANS) {
          const int tt = a.tr + 4 * q * (R * 32) + (2 * rb + o) * 128;
          *reinterpret_cast<uint32_t*>(thi + tt) = h;
          *reinterpret_cast<uint32_t*>(tlo + tt) = l;
        }
      }
}

// rows ra and ra + 8 of a 64-row head of rows LD floats apart, its first C
// columns at `head`, as A fragments (k-step kk: (ra, 8 kk + tq), (ra + 8,
// 8 kk + tq), (ra, 8 kk + tq + 4), (ra + 8, 8 kk + tq + 4)), raw; rows past
// s as 0
template <int C, int LD>
__device__ __forceinline__ void load_fixed(float (&af)[C / 8][4],
                                           const float* head, int ra, int s,
                                           int tq) {
  const bool a_in = ra < s, b_in = ra + 8 < s;
  const float* pa = head + (int64_t)(a_in ? ra : 0) * LD + tq;
  const float* pb = head + (int64_t)(b_in ? ra + 8 : 0) * LD + tq;
#pragma unroll
  for (int kk = 0; kk < C / 8; ++kk) {
    af[kk][0] = a_in ? pa[8 * kk] : 0.f;
    af[kk][1] = b_in ? pb[8 * kk] : 0.f;
    af[kk][2] = a_in ? pa[8 * kk + 4] : 0.f;
    af[kk][3] = b_in ? pb[8 * kk + 4] : 0.f;
  }
}

// An A operand split for wgmma: hi the raw f32 bits, which the tensor
// core truncates to TF32, and lo = x - trunc(x), exact in f32 and read
// truncated (a B operand keeps split's hi = rna(x): truncating both sides
// misses the emulation's margin, one side keeps it)
__device__ __forceinline__ void split_a(float x, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// KG k-steps from k-step k0 of acc (+)= A B^T: A the fixed operand's raw
// fragments, split here; B a swizzled [R][D] tile as hi (descriptor dh)
// and lo (dl); the group's first product overwrites acc. Small products
// first: lo.hi, hi.lo, hi.hi.
template <int D, int R>
__device__ __forceinline__ void rs_group(float (&acc)[R / 2],
                                         const float (&af)[D / 8][4], int k0,
                                         uint64_t dh, uint64_t dl) {
#pragma unroll
  for (int kk = k0; kk < k0 + KG; ++kk) {
    // opaque, so the split is not hoisted out of the stage loop (hi and
    // lo of the whole operand would take twice its registers)
    float x[4] = {af[kk][0], af[kk][1], af[kk][2], af[kk][3]};
    asm volatile("" : "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]));
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_a(x[e], h[e], l[e]);
    // k-step kk: sub-tile kk / 4, 32 bytes a k-step within it (the
    // descriptor's address field counts 16 bytes)
    const uint32_t off = ((kk >> 2) * (R * 128) + (kk & 3) * 32) >> 4;
    TF32<R>::rs(acc, l, dh + off, kk > k0);
    TF32<R>::rs(acc, h, dl + off, 1);
    TF32<R>::rs(acc, h, dh + off, 1);
  }
}

// acc = A B^T over d (64 rows x R columns): the first group straight into
// acc, each later group into a fresh fragment (two in turn: one runs while
// the last is added) added in f32, in order
template <int D, int R>
__device__ __forceinline__ void first_product(float (&acc)[R / 2],
                                              const float (&af)[D / 8][4],
                                              uint32_t bh, uint32_t bl) {
  constexpr int GROUPS = D / 8 / KG;
  const uint64_t dh = desc(bh, 16, 1024), dl = desc(bl, 16, 1024);
  float f[2][R / 2];
  wgmma_fence();
  rs_group<D, R>(acc, af, 0, dh, dl);
  wgmma_commit();
#pragma unroll
  for (int gi = 1; gi < GROUPS; ++gi) {
    wgmma_fence();
    rs_group<D, R>(f[gi & 1], af, gi * KG, dh, dl);
    wgmma_commit();
    wgmma_wait<1>();   // every group but this one is done
    if (gi >= 2) {
      fence_regs(f[(gi - 1) & 1]);
#pragma unroll
      for (int e = 0; e < R / 2; ++e) acc[e] += f[(gi - 1) & 1][e];
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (GROUPS > 1) {
    fence_regs(f[(GROUPS - 1) & 1]);
#pragma unroll
    for (int e = 0; e < R / 2; ++e) acc[e] += f[(GROUPS - 1) & 1][e];
  }
}

// an accumulator's R / 2 values as R / 8 A fragments, hi and lo
// (split_a): the columns 2 t and 2 t + 1 of k-step j are its k indices t
// and t + 4 (the transposed tiles' row order)
template <int R>
__device__ __forceinline__ void a_frags(const float (&x)[R / 2],
                                        uint32_t (&hi)[R / 8][4],
                                        uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    split_a(x[4 * j], hi[j][0], lo[j][0]);
    split_a(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_a(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_a(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// out[h] += A B over the stage's R rows for the N columns of d from col0 +
// N h, h < H, each into a fresh fragment added in f32: A the stage's hi and
// lo fragments, B a transposed [D][R] tile as hi (th) and lo (tl). (One
// descriptor a tile and the blocks looped here: with a descriptor a block,
// ptxas ran short of registers for its wgmma pipeline in dK/dV at d = 128
// and serialized the products, C7511.)
template <int R, int N, int H>
__device__ __forceinline__ void second_product(float (&out)[H][N / 2],
                                               const uint32_t (&hi)[R / 8][4],
                                               const uint32_t (&lo)[R / 8][4],
                                               uint32_t th, uint32_t tl,
                                               int col0) {
  // rows col0 of the tile: col0 / 8 core-matrix rows of R * 32 bytes
  const uint32_t row0 = (col0 / 8) * (R * 32);
  const uint64_t dh = desc_plain(th + row0, 128, R * 32);
  const uint64_t dl = desc_plain(tl + row0, 128, R * 32);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float f[N / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      // block h (N / 8 core-matrix rows), k-step j (two core matrices of
      // 128 bytes); the address field counts 16 bytes
      const uint32_t off = (h * (N / 8) * (R * 32) + j * 256) >> 4;
      TF32<N>::rs(f, lo[j], dh + off, j > 0);
      TF32<N>::rs(f, hi[j], dl + off, 1);
      TF32<N>::rs(f, hi[j], dh + off, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) out[h][e] += f[e];
  }
}

// rows ra and ra + 8 of a [64 x H N] accumulator kept as H blocks of N
// columns (block h, entry 4 j + e: row ra + 8 (e >> 1), column col0 + N h
// + 8 j + 2 tq + (e & 1)) times mul to a [s][D] head; rows past s not
// written
template <int D, int N, int H>
__device__ __forceinline__ void store_cols(float* head,
                                           const float (&out)[H][N / 2],
                                           int ra, int s, int tq, int col0,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + N * h + 8 * j + 2 * tq;
      if (ra < s)
        *reinterpret_cast<float2*>(head + (int64_t)ra * D + col) =
            make_float2(out[h][4 * j] * mul, out[h][4 * j + 1] * mul);
      if (ra + 8 < s)
        *reinterpret_cast<float2*>(head + (int64_t)(ra + 8) * D + col) =
            make_float2(out[h][4 * j + 2] * mul, out[h][4 * j + 3] * mul);
    }
}

// D columns of d in each row of q, k, v, dO, dk, dv; C of them a CTA: D,
// or D / 2 in a cluster of two CTAs that split d (the header)
template <int D, int C>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int hq, int hkv, int s, int causal,
               float scale_log2, float scale) {
  constexpr bool PAIR = C < D;
  static_assert(C == D || 2 * C == D, "one CTA or a pair");
  using G = WgGeo<C, PAIR>;
  constexpr int R = G::R, TILE = G::TILE, STAGE = 8 * TILE;
  extern __shared__ uint8_t smem_raw[];
  // raw slots [RAW][Q, dO]; stages [STAGES][Q hi, lo, dO hi, lo, Q^T hi,
  // lo, dO^T hi, lo]; exchange [2][R / 4][128] pairs; a pair's receive
  // buffers [consumer][stage parity][R / 8][128] quads; lse2, D [STAGES][R]
  uint8_t* sRaw = align1024(smem_raw);
  uint8_t* sStage = sRaw + RAW * 2 * TILE;
  float2* sX = reinterpret_cast<float2*>(sStage + STAGES * STAGE);
  float4* sRecv = reinterpret_cast<float4*>(sX + 2 * (G::XBUF / 8));
  float* sL = reinterpret_cast<float*>(sStage + STAGES * STAGE + 2 * G::XBUF +
                                       G::RECV);
  float* sD = sL + STAGES * R;
  const uint32_t bars = smem_u32(sD + STAGES * R);
  auto raw_full = [&](int i) { return bars + 8 * i; };
  auto full = [&](int st) { return bars + 8 * (RAW + st); };
  auto empty = [&](int st) { return bars + 8 * (RAW + STAGES + st); };
  // a pair's receive barriers, [consumer][stage parity]
  auto recv = [&](int i) { return bars + 8 * (RAW + 2 * STAGES + i); };

  // a pair is blockIdx.x 2 hk and 2 hk + 1; rank r holds d's columns
  // [C r, C r + C)
  const uint32_t rank = PAIR ? cluster_rank() : 0;
  const int col0 = rank * C;
  const int hk = PAIR ? blockIdx.x >> 1 : blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * BM;  // under causal the first tiles are the
  const int group = hq / hkv;      // longest: they start first
  const int bh0 = bi * hq + hk * group;  // the group's first query head
  // the walk: each query head of the group, over query tiles qt_begin ..
  // qt_end - 1 (under causal from the tile of the CTA's first key)
  const int qt_begin = causal ? k0 / R : 0, qt_end = (s + R - 1) / R;
  const int n_iter = group * (qt_end - qt_begin);

  if (threadIdx.x == 0) {
    for (int i = 0; i < RAW; ++i) mbar_init(raw_full(i), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);  // every producer thread
      mbar_init(empty(st), 8);   // lane 0 of each consumer warp
    }
    if (PAIR)
      for (int i = 0; i < 4; ++i) mbar_init(recv(i), 1);  // armed by thread 0
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a pair: the peer's barriers are ready before anything reaches them
  if constexpr (PAIR)
    cluster_sync();
  else
    __syncthreads();

  // the warpgroup (not broadcast through __shfl_sync as in the dQ kernel:
  // here ptxas then ran short of registers for the wgmma pipeline at d =
  // 128 and serialized the products, C7511)
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads raw tiles, everyone splits them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P_REGS));
    const int tid = threadIdx.x;
    const SplitAt at = split_at<R>(tid >> 5, tid & 31);
    int lbh = bh0, lqt = qt_begin;  // the next load's head and query tile
    auto load = [&](int slot) {
      const uint32_t bar = raw_full(slot);
      uint8_t* dst = sRaw + slot * 2 * TILE;
      mbar_expect_tx(bar, 2 * TILE);
      for (int c = 0; c < C / 32; ++c)
        tma_load(smem_u32(dst + c * R * 128), &tm_q, bar, col0 + c * 32,
                 lqt * R, lbh);
      for (int c = 0; c < C / 32; ++c)
        tma_load(smem_u32(dst + TILE + c * R * 128), &tm_do, bar,
                 col0 + c * 32, lqt * R, lbh);
      if (++lqt == qt_end) {
        lqt = qt_begin;
        ++lbh;
      }
    };
    if (tid == 0)
      for (int i = 0; i < RAW && i < n_iter; ++i) load(i);
    Ring<RAW> rr;
    Ring<STAGES> sr;
    const float* lp = lse + (int64_t)bh0 * s;
    const float* dp = delta + (int64_t)bh0 * s;
    int qt = qt_begin;
    for (int it = 0; it < n_iter; ++it) {
      // the stage's lse (log2 units, +inf past s) and D, read first
      const int row = qt * R + tid;
      float l2 = CUDART_INF_F, dd = 0.f;
      if (tid < R && row < s) {
        l2 = lse2_of(lp[row]);
        dd = dp[row];
      }
      if (++qt == qt_end) {
        qt = qt_begin;
        lp += s;
        dp += s;
      }
      mbar_wait(raw_full(rr.st), rr.ph);
      mbar_wait(empty(sr.st), sr.ph ^ 1);
      const uint8_t* raw = sRaw + rr.st * 2 * TILE;
      uint8_t* st = sStage + sr.st * STAGE;
      split_tile<C, R, true>(raw, st, st + TILE, st + 4 * TILE,
                             st + 5 * TILE, at);
      split_tile<C, R, true>(raw + TILE, st + 2 * TILE, st + 3 * TILE,
                             st + 6 * TILE, st + 7 * TILE, at);
      if (tid < R) {
        sL[sr.st * R + tid] = l2;
        sD[sr.st * R + tid] = dd;
      }
      fence_proxy_async();  // the writes, before wgmma reads them
      mbar_arrive(full(sr.st));
      // every producer thread has read the raw slot: refill it
      asm volatile("bar.sync %0, 128;\n" ::"n"(BAR_RAW) : "memory");
      if (tid == 0 && it + RAW < n_iter) load(rr.st);
      rr.next();
      sr.next();
    }
  } else {
    // ---- consumers: 64 keys; K, S^T, P^T, dV (1) and V, dP^T, dS^T, dK
    // (2) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C_REGS));
    const int cons = wg - 1, t = threadIdx.x - wg * 128;
    const int warp = t >> 5, lane = t & 31, tq = lane & 3;
    const int key = k0 + 16 * warp + (lane >> 2);  // rows key, key + 8
    const int64_t kv_off = ((int64_t)bi * hkv + hk) * s * D;
    float af[C / 8][4];
    load_fixed<C, D>(af, (cons ? v : k) + kv_off + col0, key, s, tq);
    float out[C / 64][32];
#pragma unroll
    for (int hf = 0; hf < C / 64; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) out[hf][e] = 0.f;
    Ring<STAGES> ring;
    int qt = qt_begin;
    for (int it = 0; it < n_iter; ++it) {
      const int q0 = qt * R;
      if (++qt == qt_end) qt = qt_begin;
      mbar_wait(full(ring.st), ring.ph);
      const uint32_t st = smem_u32(sStage + ring.st * STAGE);
      // S^T = K Q^T (1) or dP^T = V dO^T (2): 64 keys x R queries; entry
      // 4 j + e is (key + 8 (e >> 1), query q0 + 8 j + 2 tq + (e & 1))
      float acc[R / 2];
      first_product<C, R>(acc, af, st + (cons ? 2 : 0) * TILE,
                          st + (cons ? 3 : 1) * TILE);
      const int buf = it & 1;
      // a pair: the peer's partial over its half of d added
      if constexpr (PAIR)
        add_peer<R>(acc, sRecv + (2 * cons + buf) * (G::XBUF / 16) + t,
                    recv(2 * cons + buf), (it >> 1) & 1, t);
      float2* x = sX + buf * (G::XBUF / 8) + t;
      if (cons == 0) {
        const float* lt = sL + ring.st * R;
        const bool mask = causal && q0 < k0 + BM - 1;  // a query before
#pragma unroll                                         // a key
        for (int j = 0; j < R / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(acc[4 * j + e], scale_log2,
                                 -(e & 1 ? l2.y : l2.x)));
            if (mask && key + 8 * (e >> 1) > q0 + 8 * j + 2 * tq + (e & 1))
              p = 0.f;
            acc[4 * j + e] = p;
          }
        }
        if (it >= 2) bar_sync<BAR_FREE>(buf);
#pragma unroll
        for (int pi = 0; pi < R / 4; ++pi)
          x[pi * 128] = make_float2(acc[2 * pi], acc[2 * pi + 1]);
        bar_arrive<BAR_READY>(buf);
      } else {
        const float* dt = sD + ring.st * R;
        bar_sync<BAR_READY>(buf);
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dt + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float2 p = x[(2 * j + e / 2) * 128];
            acc[4 * j + e] = p.x * (acc[4 * j + e] - d2.x);
            acc[4 * j + e + 1] = p.y * (acc[4 * j + e + 1] - d2.y);
          }
        }
        if (it + 2 < n_iter) bar_arrive<BAR_FREE>(buf);
      }
      // dV += P^T dO (1) or dK += dS^T Q (2) over the stage's R queries
      uint32_t hi[R / 8][4], lo[R / 8][4];
      a_frags<R>(acc, hi, lo);
      second_product<R, 64, C / 64>(out, hi, lo, st + (cons ? 4 : 6) * TILE,
                                    st + (cons ? 5 : 7) * TILE, 0);
      if (lane == 0) mbar_arrive(empty(ring.st));
      ring.next();
    }
    // dK times the scale
    store_cols<D, 64, C / 64>((cons ? dk : dv) + kv_off, out, key, s, tq,
                              PAIR ? cluster_rank() * C : 0,
                              cons ? scale : 1.f);
  }
  // a pair: no CTA leaves while its peer may still reach its shared memory
  if constexpr (PAIR) cluster_sync();
}

// D and C as for bwd_dkdv_wgmma
template <int D, int C>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const float* __restrict__ q, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int hq, int hkv, int s, int causal,
             float scale_log2, float scale) {
  constexpr bool PAIR = C < D;
  static_assert(C == D || 2 * C == D, "one CTA or a pair");
  using G = WgGeo<C, PAIR>;
  constexpr int R = G::R, TILE = G::TILE, STAGE = 6 * TILE;
  extern __shared__ uint8_t smem_raw[];
  // raw slots [RAW][K, V]; stages [STAGES][K hi, lo, V hi, lo, K^T hi,
  // lo]; exchange [2][R / 4][128] pairs; a pair's receive buffers
  // [consumer][stage parity][R / 8][128] quads
  uint8_t* sRaw = align1024(smem_raw);
  uint8_t* sStage = sRaw + RAW * 2 * TILE;
  float2* sX = reinterpret_cast<float2*>(sStage + STAGES * STAGE);
  float4* sRecv = reinterpret_cast<float4*>(sX + 2 * (G::XBUF / 8));
  const uint32_t bars =
      smem_u32(sStage + STAGES * STAGE + 2 * G::XBUF + G::RECV);
  auto raw_full = [&](int i) { return bars + 8 * i; };
  auto full = [&](int st) { return bars + 8 * (RAW + st); };
  auto empty = [&](int st) { return bars + 8 * (RAW + STAGES + st); };
  auto recv = [&](int i) { return bars + 8 * (RAW + 2 * STAGES + i); };

  // a pair is blockIdx.x 2 h and 2 h + 1; rank r holds d's columns [C r,
  // C r + C)
  const uint32_t rank = PAIR ? cluster_rank() : 0;
  const int col0 = rank * C;
  const int h = PAIR ? blockIdx.x >> 1 : blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest tiles first
  const int bh = bi * hq + h, bh_kv = bi * hkv + h / (hq / hkv);
  const int kv_end = causal ? min(s, q0 + BM) : s;
  const int n_iter = (kv_end + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RAW; ++i) mbar_init(raw_full(i), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);
      mbar_init(empty(st), 8);
    }
    if (PAIR)
      for (int i = 0; i < 4; ++i) mbar_init(recv(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAIR)
    cluster_sync();
  else
    __syncthreads();

  // the warpgroup, broadcast so that the compiler knows it is uniform in
  // a warp: the consumers' branches are then not divergent, which made
  // ptxas serialize the products (C7520)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P_REGS));
    const int tid = threadIdx.x;
    const SplitAt at = split_at<R>(tid >> 5, tid & 31);
    int lkt = 0;  // the next load's key tile
    auto load = [&](int slot) {
      const uint32_t bar = raw_full(slot);
      uint8_t* dst = sRaw + slot * 2 * TILE;
      mbar_expect_tx(bar, 2 * TILE);
      for (int c = 0; c < C / 32; ++c)
        tma_load(smem_u32(dst + c * R * 128), &tm_k, bar, col0 + c * 32,
                 lkt * R, bh_kv);
      for (int c = 0; c < C / 32; ++c)
        tma_load(smem_u32(dst + TILE + c * R * 128), &tm_v, bar,
                 col0 + c * 32, lkt * R, bh_kv);
      ++lkt;
    };
    if (tid == 0)
      for (int i = 0; i < RAW && i < n_iter; ++i) load(i);
    Ring<RAW> rr;
    Ring<STAGES> sr;
    for (int it = 0; it < n_iter; ++it) {
      mbar_wait(raw_full(rr.st), rr.ph);
      mbar_wait(empty(sr.st), sr.ph ^ 1);
      const uint8_t* raw = sRaw + rr.st * 2 * TILE;
      uint8_t* st = sStage + sr.st * STAGE;
      split_tile<C, R, true>(raw, st, st + TILE, st + 4 * TILE,
                             st + 5 * TILE, at);
      split_tile<C, R, false>(raw + TILE, st + 2 * TILE, st + 3 * TILE,
                              nullptr, nullptr, at);
      fence_proxy_async();
      mbar_arrive(full(sr.st));
      asm volatile("bar.sync %0, 128;\n" ::"n"(BAR_RAW) : "memory");
      if (tid == 0 && it + RAW < n_iter) load(rr.st);
      rr.next();
      sr.next();
    }
  } else {
    // ---- consumers: 64 rows; Q, S, P (1) and dO, dP, dS, dQ (2) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C_REGS));
    const int cons = wg - 1, t = threadIdx.x - wg * 128;
    const int warp = t >> 5, lane = t & 31, tq = lane & 3;
    const int ra = q0 + 16 * warp + (lane >> 2), rb = ra + 8;
    const float* lp = lse + (int64_t)bh * s;
    const float* dp = delta + (int64_t)bh * s;
    const float la = ra < s ? lse2_of(lp[ra]) : CUDART_INF_F;
    const float lb = rb < s ? lse2_of(lp[rb]) : CUDART_INF_F;
    const float da = ra < s ? dp[ra] : 0.f;
    const float db = rb < s ? dp[rb] : 0.f;
    float af[C / 8][4];
    load_fixed<C, D>(af, (cons ? dout : q) + (int64_t)bh * s * D + col0, ra,
                     s, tq);
    // this consumer's half of the CTA's dQ columns: col0 + cons C / 2 ..
    // + C / 2
    float out[1][C / 4];
#pragma unroll
    for (int e = 0; e < C / 4; ++e) out[0][e] = 0.f;
    Ring<STAGES> ring;
    for (int it = 0; it < n_iter; ++it) {
      const int kb0 = it * R;
      mbar_wait(full(ring.st), ring.ph);
      const uint32_t st = smem_u32(sStage + ring.st * STAGE);
      // S = Q K^T (1) or dP = dO V^T (2): 64 rows x R keys; entry 4 j + e
      // is (row e < 2 ? ra : rb, key kb0 + 8 j + 2 tq + (e & 1))
      float acc[R / 2];
      first_product<C, R>(acc, af, st + (cons ? 2 : 0) * TILE,
                          st + (cons ? 3 : 1) * TILE);
      const int buf = it & 1;
      if constexpr (PAIR)
        add_peer<R>(acc, sRecv + (2 * cons + buf) * (G::XBUF / 16) + t,
                    recv(2 * cons + buf), (it >> 1) & 1, t);
      float2* x = sX + buf * (G::XBUF / 8) + t;
      if (cons == 0) {
        const bool mask = kb0 + R > s || (causal && kb0 + R - 1 > q0);
#pragma unroll
        for (int j = 0; j < R / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(
                fmaf(acc[4 * j + e], scale_log2, -(e < 2 ? la : lb)));
            if (mask) {
              const int key = kb0 + 8 * j + 2 * tq + (e & 1);
              if (key >= s || (causal && key > (e < 2 ? ra : rb))) p = 0.f;
            }
            acc[4 * j + e] = p;
          }
#pragma unroll
        for (int pi = 0; pi < R / 4; ++pi)
          x[pi * 128] = make_float2(acc[2 * pi], acc[2 * pi + 1]);
        bar_arrive<BAR_READY>(buf);   // P written
        bar_sync<BAR_FREE>(buf);      // dS written in its place
#pragma unroll
        for (int pi = 0; pi < R / 4; ++pi) {
          const float2 v = x[pi * 128];
          acc[2 * pi] = v.x;
          acc[2 * pi + 1] = v.y;
        }
      } else {
        bar_sync<BAR_READY>(buf);
#pragma unroll
        for (int j = 0; j < R / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float2 p = x[(2 * j + e / 2) * 128];
            const float dd = e < 2 ? da : db;
            acc[4 * j + e] = p.x * (acc[4 * j + e] - dd);
            acc[4 * j + e + 1] = p.y * (acc[4 * j + e + 1] - dd);
            x[(2 * j + e / 2) * 128] =
                make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
          }
        bar_arrive<BAR_FREE>(buf);
      }
      // dQ += dS K over the stage's R keys, this consumer's half of the
      // CTA's columns
      uint32_t hi[R / 8][4], lo[R / 8][4];
      a_frags<R>(acc, hi, lo);
      second_product<R, C / 2, 1>(out, hi, lo, st + 4 * TILE, st + 5 * TILE,
                                  cons * (C / 2));
      if (lane == 0) mbar_arrive(empty(ring.st));
      ring.next();
    }
    store_cols<D, C / 2, 1>(dq + (int64_t)bh * s * D, out, ra, s, tq,
                            (PAIR ? cluster_rank() * C : 0) + cons * (C / 2),
                            scale);
  }
  if constexpr (PAIR) cluster_sync();
}

// ---- head dims 16 and 32: the mma.sync route ------------------------------

// At d = 16 and 32 (the reference's smoke configs) the kernels above do not
// fit: a 32-float TMA box is d = 32's whole row and twice d = 16's, the
// stage of R = 2048 / C rows grows to 64 or 128, and the second products'
// N = 64 blocks exceed d. A (query, key) pair's tensor-core work shrinks
// with d while its CUDA-core work (exp2, the mask, the splits of P and
// dS) does not, so at these dims wgmma's rate would not set the pace, and
// they take the source's first design, on mma.sync.m16n8k8, the one that
// the wgmma kernels replaced at d >= 64 (route (b) of the small dims): no
// TMA, no swizzle, cp.async rings of f32 rows D + 4 floats apart, each
// operand split into hi = rna(x) and lo = x - hi at each use on the CUDA
// cores (A operands too: "rna" in tests/tf32_emulation.py's
// BWD_GEOMETRY), the same products (four in dK/dV, three in dQ) and
// fresh fragments: every KG d steps of S^T, dP^T, S and dP, and each
// stage's P^T dO, dS^T Q and dS K.
// - bwd_dkdv_mma: a CTA of NW warps owns 16 NW keys of one (b, kv head),
//   K and V staged once, each warp 16 keys over all of d. Q, dO, lse (in
//   log2 units) and D tiles of KV_ROWS query rows stream through a
//   two-stage cp.async ring (rows past s zero-filled, lse = +inf, D = 0,
//   so their P and dS are 0), over each query head of the group in turn
//   and, under causal, from the tile of the CTA's first key. Per stage a
//   warp forms S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2 e
//   - lse log2 e) and dS^T = P^T (dP^T - D) in registers (the S^T
//   accumulator's fragment is P^T's A fragment with its query order
//   permuted: queries 2t and 2t + 1 of each 8 as k indices t and t + 4),
//   then dV += P^T dO and dK += dS^T Q (B rows 2t and 2t + 1).
// - bwd_dq_mma: a CTA owns 16 NW query rows of one (b, q head), Q and dO
//   staged once; K and V tiles of Q_KEYS keys stream through the ring,
//   under causal up to the CTA's last row, the longest q tiles first. Per
//   tile S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K.
// - Rows D + 4 floats apart make both reads conflict-free: a row-major
//   fragment at (row g, column t), g * 20 or g * 36 + t, and an MN-major
//   one at (row 2t, column g), 2t * 20 or 2t * 36 + g, each covering 32
//   banks.
// - Shared memory (S = D + 4 floats a row): dK/dV K and V (2 x 64 S) and
//   two stages of Q, dO (2 x 2 x 32 S) and lse, D (2 x 2 x 32): 20,992 B
//   at d = 16, 37,376 B at d = 32; dQ Q and dO (2 x 64 S) and two stages
//   of K and V (2 x 2 x 32 S): 20,480 and 36,864 B.
template <int D>
struct MmaCfg;
template <>
struct MmaCfg<16> {
  static constexpr int NW = 4, KV_ROWS = 32, Q_KEYS = 32;
};
template <>
struct MmaCfg<32> {
  static constexpr int NW = 4, KV_ROWS = 32, Q_KEYS = 32;
};

template <int D>
struct MmaGeo {
  static_assert(D % 16 == 0 && D <= 32, "the mma.sync route's head dims");
  static constexpr int NW = MmaCfg<D>::NW, THREADS = 32 * NW;
  static constexpr int BQ = MmaCfg<D>::KV_ROWS, BKQ = MmaCfg<D>::Q_KEYS;
  static constexpr int BLK = 16 * NW;        // keys (dK/dV), rows (dQ) a CTA
  static constexpr int S = D + 4;            // row stride (floats)
  static constexpr int FIXED = BLK * S;      // K or V (dK/dV), Q or dO (dQ)
  static constexpr int KV_STAGE = 2 * BQ * S + 2 * BQ;  // Q, dO, lse, D
  static constexpr int Q_STAGE = 2 * BKQ * S;           // K, V
  static constexpr int KV_SMEM =
      (int)sizeof(float) * (2 * FIXED + STAGES * KV_STAGE);
  static constexpr int Q_SMEM =
      (int)sizeof(float) * (2 * FIXED + STAGES * Q_STAGE);
  static constexpr int NG = D / 8 < 4 ? D / 8 : 4;  // d steps a fresh group
  static_assert(KV_SMEM <= 48 * 1024 && Q_SMEM <= 48 * 1024,
                "under the default dynamic shared memory: no opt-in");
};

// the A fragment at a (row g, column t of a row-major f32 tile) of one
// d step: rows g and g + 8, columns t and t + 4, split into hi and lo
template <int S>
__device__ __forceinline__ void a_frag(const float* a, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  split(a[0], h[0], l[0]);
  split(a[8 * S], h[1], l[1]);
  split(a[4], h[2], l[2]);
  split(a[8 * S + 4], h[3], l[3]);
}

// one mma3 of A (h, l) and the B fragment of two f32 values at x[0] and
// x[step]
__device__ __forceinline__ void mma3_at(float (&d)[4], const uint32_t (&h)[4],
                                        const uint32_t (&l)[4],
                                        const float* x, int step,
                                        bool fresh) {
  uint32_t bh0, bl0, bh1, bl1;
  split(x[0], bh0, bl0);
  split(x[step], bh1, bl1);
  mma3(d, h, l, bh0, bh1, bl0, bl1, fresh);
}

// an accumulator fragment's four values (x[e]: row g + 8 (e >> 1), column
// 2 t + (e & 1)) as the A fragment of the next product, hi and lo: its
// columns 2 t and 2 t + 1 become k indices t and t + 4
__device__ __forceinline__ void a_of_acc(const float (&x)[4],
                                         uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(x[0], h[0], l[0]);
  split(x[2], h[1], l[1]);
  split(x[1], h[2], l[2]);
  split(x[3], h[3], l[3]);
}

// rows ra and ra + 8 of NN accumulator fragments (d step n: columns
// 8 n + 2 t, + 1) times mul to a row-major [s][D] tile at p; rows past s
// not written
template <int D, int NN>
__device__ __forceinline__ void store_rows(float* p,
                                           const float (&acc)[NN][4], int ra,
                                           int s, int t, float mul) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = 8 * n + 2 * t;
    if (ra < s)
      *reinterpret_cast<float2*>(p + (int64_t)ra * D + col) =
          make_float2(acc[n][0] * mul, acc[n][1] * mul);
    if (ra + 8 < s)
      *reinterpret_cast<float2*>(p + (int64_t)(ra + 8) * D + col) =
          make_float2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// KG d steps from d step k0 of A0 B0^T and A1 B1^T into fresh fragments
// f0 and f1 (the two products interleaved): A's rows g and g + 8 at a
// (column t), B's row 8 j + g at b (column t), NJ 16 x 8 fragments. The k
// index t (t + 4) of d step kk is column 8 kk + t (+ 4).
template <int NJ, int S>
__device__ __forceinline__ void d_steps(float (&f0)[NJ][4], const float* a0,
                                        const float* b0, float (&f1)[NJ][4],
                                        const float* a1, const float* b1,
                                        int k0) {
#pragma unroll
  for (int kk = k0; kk < k0 + KG; ++kk) {
    uint32_t h0[4], l0[4], h1[4], l1[4];
    a_frag<S>(a0 + 8 * kk, h0, l0);
    a_frag<S>(a1 + 8 * kk, h1, l1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma3_at(f0[j], h0, l0, b0 + 8 * (j * S + kk), 4, kk == k0);
      mma3_at(f1[j], h1, l1, b1 + 8 * (j * S + kk), 4, kk == k0);
    }
  }
}

// acc0 = A0 B0^T and acc1 = A1 B1^T over the D columns: the first KG d
// steps straight into acc, then each KG steps in fresh fragments added in
// f32
template <int D, int NJ, int S>
__device__ __forceinline__ void over_d2(float (&acc0)[NJ][4],
                                        const float* a0, const float* b0,
                                        float (&acc1)[NJ][4],
                                        const float* a1, const float* b1) {
  d_steps<NJ, S>(acc0, a0, b0, acc1, a1, b1, 0);
#pragma unroll
  for (int k0 = KG; k0 < D / 8; k0 += KG) {
    float f0[NJ][4], f1[NJ][4];
    d_steps<NJ, S>(f0, a0, b0, f1, a1, b1, k0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[j][e] += f0[j][e];
        acc1[j][e] += f1[j][e];
      }
  }
}

// acc[n] += A B over a stage: A the stage's NJ hi and lo A fragments (k
// indices t and t + 4 of step j: rows 8 j + 2 t and 8 j + 2 t + 1 of B),
// B a row-major f32 tile read MN-major at b (row 2 t, column g): d step n
// is B's columns 8 n + g. The stage's products go into fresh fragments,
// NG d steps at a time, added to acc in f32. With a second (acc1, hi1,
// lo1, b1), two such products interleaved.
template <int NN, int NJ, int S, int NG, bool TWO>
__device__ __forceinline__ void over_stage(
    float (&acc0)[NN][4], const uint32_t (&hi0)[NJ][4],
    const uint32_t (&lo0)[NJ][4], const float* b0, float (&acc1)[NN][4],
    const uint32_t (&hi1)[NJ][4], const uint32_t (&lo1)[NJ][4],
    const float* b1) {
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float f0[NG][4], f1[NG][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int nn = 0; nn < NG; ++nn) {
        const int at = 8 * (j * S + n0 + nn);
        mma3_at(f0[nn], hi0[j], lo0[j], b0 + at, S, j == 0);
        if constexpr (TWO)
          mma3_at(f1[nn], hi1[j], lo1[j], b1 + at, S, j == 0);
      }
#pragma unroll
    for (int nn = 0; nn < NG; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[n0 + nn][e] += f0[nn][e];
        if constexpr (TWO) acc1[n0 + nn][e] += f1[nn][e];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(MmaGeo<D>::THREADS)
bwd_dkdv_mma(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
             int s, int causal, float scale_log2, float scale) {
  using G = MmaGeo<D>;
  constexpr int BQ = G::BQ, BK = G::BLK, S = G::S, NT = G::THREADS;
  constexpr int NJ = BQ / 8;   // query steps of 8 in a stage
  constexpr int NN = D / 8;    // d steps of dK and dV
  constexpr int CPR = D / 4;   // 16-byte copies a row
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [BK][S]
  float* Vs = Ks + G::FIXED;         // [BK][S]
  float* ring = Vs + G::FIXED;       // [STAGES]: Q, dO [BQ][S], lse2, D [BQ]

  const int hk = blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // under causal the first tiles are the
  const int group = hq / hkv;      // longest: they start first
  const int64_t kv_off = ((int64_t)bi * hkv + hk) * s * D;
  const int64_t bh0 = (int64_t)bi * hq + hk * group;  // the group's 1st head
  // the walk: each query head of the group, over query tiles qt_begin ..
  // qt_end - 1 (under causal from the tile of the CTA's first key)
  const int qt_begin = causal ? k0 / BQ : 0, qt_end = (s + BQ - 1) / BQ;
  const int n_qt = qt_end - qt_begin, n_iter = group * n_qt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * warp;   // the warp's first key

  // K and V (rows past s zero-filled) with stage 0: one copy group
  for (int c = tid; c < BK * CPR; c += NT) {
    const int r = c / CPR, col = (c - r * CPR) * 4;
    const bool in = k0 + r < s;
    const int64_t go = kv_off + (in ? (int64_t)(k0 + r) * D + col : 0);
    cp_async16(smem_addr(Ks + r * S + col), k + go, in ? 16 : 0);
    cp_async16(smem_addr(Vs + r * S + col), v + go, in ? 16 : 0);
  }
  auto load_stage = [&](int it) {
    float* qs = ring + (it % STAGES) * G::KV_STAGE;
    float* ds = qs + BQ * S;
    float* ls = ds + BQ * S;
    float* es = ls + BQ;
    const int hh = it / n_qt;
    const int q0 = (qt_begin + it - hh * n_qt) * BQ;
    const int64_t bh = bh0 + hh;
    for (int c = tid; c < BQ * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = q0 + r < s;
      const int64_t go = bh * s * D + (in ? (int64_t)(q0 + r) * D + col : 0);
      cp_async16(smem_addr(qs + r * S + col), q + go, in ? 16 : 0);
      cp_async16(smem_addr(ds + r * S + col), dout + go, in ? 16 : 0);
    }
    for (int r = tid; r < BQ; r += NT) {
      const int row = q0 + r;
      ls[r] = row < s ? lse2_of(lse[bh * s + row]) : CUDART_INF_F;
      es[r] = row < s ? delta[bh * s + row] : 0.f;
    }
  };
  if (n_iter > 0) load_stage(0);
  cp_async_commit();

  float dva[NN][4], dka[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;
  const float* ka = Ks + (16 * warp + g) * S + t;  // A rows g, g + 8
  const float* va = Vs + (16 * warp + g) * S + t;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();  // this thread's copies of stage it
    __syncthreads();     // everyone's, and stage it - 1 is done
    if (it + 1 < n_iter) load_stage(it + 1);
    cp_async_commit();
    const int q0 = (qt_begin + it % n_qt) * BQ;
    if (kw >= s || (causal && q0 + BQ - 1 < kw)) continue;  // nothing seen
    const float* qs = ring + (it % STAGES) * G::KV_STAGE;
    const float* ds = qs + BQ * S;
    const float* ls = ds + BQ * S;
    const float* es = ls + BQ;

    // S^T = K Q^T, dP^T = V dO^T (16 keys x BQ queries)
    float st[NJ][4], dpt[NJ][4];
    over_d2<D, NJ, S>(st, ka, qs + g * S + t, dpt, va, ds + g * S + t);

    // P^T and dS^T as A fragments, hi and lo; st[j][e] is (key kw + g +
    // (e < 2 ? 0 : 8), query q0 + 8 j + 2 t + (e & 1))
    const bool mask = causal && q0 < kw + 15;  // a query before a key
    uint32_t ph[NJ][4], pl[NJ][4], sh[NJ][4], sl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(es + 8 * j + 2 * t);
      float p[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(st[j][e], scale_log2, -(e & 1 ? l2.y : l2.x)));
        if (mask) {
          const int key = kw + g + (e < 2 ? 0 : 8);
          if (key > q0 + 8 * j + 2 * t + (e & 1)) p[e] = 0.f;
        }
        x[e] = p[e] * (dpt[j][e] - (e & 1 ? d2.y : d2.x));
      }
      a_of_acc(p, ph[j], pl[j]);
      a_of_acc(x, sh[j], sl[j]);
    }

    // dV += P^T dO and dK += dS^T Q (B: rows 8 j + 2 t and 8 j + 2 t + 1,
    // column 8 n + g)
    over_stage<NN, NJ, S, G::NG, true>(dva, ph, pl, ds + 2 * t * S + g, dka,
                                       sh, sl, qs + 2 * t * S + g);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // rows kw + g and kw + g + 8; dK times the scale
  store_rows<D>(dv + kv_off, dva, kw + g, s, t, 1.f);
  store_rows<D>(dk + kv_off, dka, kw + g, s, t, scale);
}

template <int D>
__global__ void __launch_bounds__(MmaGeo<D>::THREADS)
bwd_dq_mma(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int hq, int hkv, int s, int causal,
           float scale_log2, float scale) {
  using G = MmaGeo<D>;
  constexpr int BQ = G::BLK, BKQ = G::BKQ, S = G::S, NT = G::THREADS;
  constexpr int NJ = BKQ / 8;   // key steps of 8 in a stage
  constexpr int NK = D / 8;     // d steps of dQ
  constexpr int CPR = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BQ][S]
  float* Ds = Qs + G::FIXED;         // [BQ][S] (dO)
  float* ring = Ds + G::FIXED;       // [STAGES]: K, V [BKQ][S]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int64_t bh = (int64_t)bi * hq + h;
  const int64_t kv_off = ((int64_t)bi * hkv + h / (hq / hkv)) * s * D;
  const int kv_end = causal ? min(s, q0 + BQ) : s;
  const int n_tiles = (kv_end + BKQ - 1) / BKQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_tile = [&](int i) {
    float* ks = ring + (i % STAGES) * G::Q_STAGE;
    float* vs = ks + BKQ * S;
    const int kv0 = i * BKQ;
    for (int c = tid; c < BKQ * CPR; c += NT) {
      const int r = c / CPR, col = (c - r * CPR) * 4;
      const bool in = kv0 + r < s;
      const int64_t go = kv_off + (in ? (int64_t)(kv0 + r) * D + col : 0);
      cp_async16(smem_addr(ks + r * S + col), k + go, in ? 16 : 0);
      cp_async16(smem_addr(vs + r * S + col), v + go, in ? 16 : 0);
    }
  };
  // Q and dO with tile 0: one copy group
  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, col = (c - r * CPR) * 4;
    const bool in = q0 + r < s;
    const int64_t go = bh * s * D + (in ? (int64_t)(q0 + r) * D + col : 0);
    cp_async16(smem_addr(Qs + r * S + col), q + go, in ? 16 : 0);
    cp_async16(smem_addr(Ds + r * S + col), dout + go, in ? 16 : 0);
  }
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // this warp's rows: ra (fragment entries 0, 1) and rb = ra + 8 (2, 3)
  const int w0 = q0 + 16 * warp;
  const int ra = w0 + g, rb = ra + 8;
  const bool live = w0 < s;
  const int w_last = causal ? min(w0 + 15, s - 1) : s - 1;
  const float la = ra < s ? lse2_of(lse[bh * s + ra]) : CUDART_INF_F;
  const float lb = rb < s ? lse2_of(lse[bh * s + rb]) : CUDART_INF_F;
  const float da = ra < s ? delta[bh * s + ra] : 0.f;
  const float db = rb < s ? delta[bh * s + rb] : 0.f;
  const float* qa = Qs + (16 * warp + g) * S + t;   // A rows g, g + 8
  const float* oa = Ds + (16 * warp + g) * S + t;

  float dqa[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // this thread's copies of tile i
    __syncthreads();     // everyone's, and tile i - 1 is done
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    const int kb0 = i * BKQ;
    if (!live || kb0 > w_last) continue;  // no row of the warp sees a key
    const float* ks = ring + (i % STAGES) * G::Q_STAGE;
    const float* vs = ks + BKQ * S;

    // S = Q K^T, dP = dO V^T (16 rows x BKQ keys)
    float sc[NJ][4], dp[NJ][4];
    over_d2<D, NJ, S>(sc, qa, ks + g * S + t, dp, oa, vs + g * S + t);

    // dS as A fragments, hi and lo; sc[j][e] is (row e < 2 ? ra : rb, key
    // kb0 + 8 j + 2 t + (e & 1))
    const bool mask = kb0 + BKQ > s || (causal && kb0 + BKQ - 1 > w0);
    uint32_t hi[NJ][4], lo[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[j][e], scale_log2, -(e < 2 ? la : lb)));
        if (mask) {
          const int key = kb0 + 8 * j + 2 * t + (e & 1);
          if (key >= s || (causal && key > (e < 2 ? ra : rb))) p = 0.f;
        }
        x[e] = p * (dp[j][e] - (e < 2 ? da : db));
      }
      a_of_acc(x, hi[j], lo[j]);
    }

    // dQ += dS K (B: K rows 8 j + 2 t and 8 j + 2 t + 1, column 8 n + g)
    over_stage<NK, NJ, S, G::NG, false>(dqa, hi, lo, ks + 2 * t * S + g, dqa,
                                        hi, lo, nullptr);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  store_rows<D>(dq + bh * s * D, dqa, ra, s, t, scale);
}

// ---- host side ------------------------------------------------------------

// columns of d a CTA holds at head dim D
constexpr int cta_cols(int d) { return d < MAX_CTA_COLS ? d : MAX_CTA_COLS; }

// the two tensor maps of a wgmma launch: [heads, s, D] f32 boxes of 32
// columns x the R rows of a CTA's C columns
template <int D, int C>
cudaError_t make_maps(CUtensorMap (&m)[2], const void* a, const void* b,
                      int64_t heads, int s) {
  EncodeTiled fn = encode_fn();
  if (!fn) return cudaErrorNotSupported;
  if (!make_map_f32(fn, &m[0], a, heads, s, D, WgGeo<C>::R) ||
      !make_map_f32(fn, &m[1], b, heads, s, D, WgGeo<C>::R))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// a launch of `kernel` in clusters of two CTAs along x; returns the launch's
// error, else cudaGetLastError()
template <typename... Params, typename... Args>
cudaError_t launch_pair(void (*kernel)(Params...), dim3 grid, int smem,
                        cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_wgmma(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse,
                              const float* delta, float* dk, float* dv,
                              int b, int hq, int hkv, int s, int causal,
                              float scale_log2, float scale,
                              cudaStream_t stream) {
  constexpr int C = cta_cols(D);
  using G = WgGeo<C, (C < D)>;
  CUtensorMap m[2];
  cudaError_t e = make_maps<D, C>(m, q, dout, (int64_t)b * hq, s);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkdv_wgmma<D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G::KV_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv * (D / C), b, (s + BM - 1) / BM);
  if constexpr (C < D) {
    return launch_pair(bwd_dkdv_wgmma<D, C>, grid, G::KV_SMEM, stream, m[0],
                       m[1], k, v, lse, delta, dk, dv, hq, hkv, s, causal,
                       scale_log2, scale);
  } else {
    bwd_dkdv_wgmma<D, C><<<grid, WG_THREADS, G::KV_SMEM, stream>>>(
        m[0], m[1], k, v, lse, delta, dk, dv, hq, hkv, s, causal, scale_log2,
        scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dq, int b, int hq,
                            int hkv, int s, int causal, float scale_log2,
                            float scale, cudaStream_t stream) {
  constexpr int C = cta_cols(D);
  using G = WgGeo<C, (C < D)>;
  CUtensorMap m[2];
  cudaError_t e = make_maps<D, C>(m, k, v, (int64_t)b * hkv, s);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq_wgmma<D, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G::Q_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(hq * (D / C), b, (s + BM - 1) / BM);
  if constexpr (C < D) {
    return launch_pair(bwd_dq_wgmma<D, C>, grid, G::Q_SMEM, stream, m[0],
                       m[1], q, dout, lse, delta, dq, hq, hkv, s, causal,
                       scale_log2, scale);
  } else {
    bwd_dq_wgmma<D, C><<<grid, WG_THREADS, G::Q_SMEM, stream>>>(
        m[0], m[1], q, dout, lse, delta, dq, hq, hkv, s, causal, scale_log2,
        scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dkdv_mma(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dk, float* dv, int b,
                            int hq, int hkv, int s, int causal,
                            float scale_log2, float scale,
                            cudaStream_t stream) {
  using G = MmaGeo<D>;
  const dim3 grid(hkv, b, (s + G::BLK - 1) / G::BLK);
  bwd_dkdv_mma<D><<<grid, G::THREADS, G::KV_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, hq, hkv, s, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, float* dq, int b, int hq,
                          int hkv, int s, int causal, float scale_log2,
                          float scale, cudaStream_t stream) {
  using G = MmaGeo<D>;
  const dim3 grid(hq, b, (s + G::BLK - 1) / G::BLK);
  bwd_dq_mma<D><<<grid, G::THREADS, G::Q_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, hq, hkv, s, causal, scale_log2, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int hq, int hkv, int s, int d) {
  return b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
         (d != 16 && d != 32 && d != 64 && d != 128 && d != 256);
}

}  // namespace

// delta[r] = sum_d o[r, d] * dout[r, d] over rows r < rows of contiguous
// [rows, d] float32 (d a multiple of 4, 16-byte aligned), in float32.
// Returns cudaGetLastError().
extern "C" int flash_attention_bwd_tf32_pre(const void* o, const void* dout,
                                            float* delta, int64_t rows,
                                            int d, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 4) return (int)cudaErrorInvalidValue;
  bwd_pre_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      rows, d);
  return (int)cudaGetLastError();
}

// q, dout [b, hq, s, d], k, v, dk, dv [b, hkv, s, d], all contiguous
// float32, 16-byte aligned; lse, delta [b, hq, s] float32; d in {16, 32,
// 64, 128, 256}; hq % hkv == 0. dk and dv are summed over each KV head's
// group of query heads. scale_log2 = softmax scale * log2(e). Returns
// cudaGetLastError() after the launch (cudaErrorNotSupported without
// cuTensorMapEncodeTiled).
extern "C" int flash_attention_bwd_tf32_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s, int d, int causal, float scale_log2, float scale,
    void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (d == 16)
    return (int)launch_dkdv_mma<16>(qf, kf, vf, of, lse, delta, dkf, dvf, b,
                                    hq, hkv, s, causal, scale_log2, scale,
                                    st);
  if (d == 32)
    return (int)launch_dkdv_mma<32>(qf, kf, vf, of, lse, delta, dkf, dvf, b,
                                    hq, hkv, s, causal, scale_log2, scale,
                                    st);
  if (d == 64)
    return (int)launch_dkdv_wgmma<64>(qf, kf, vf, of, lse, delta, dkf, dvf,
                                      b, hq, hkv, s, causal, scale_log2,
                                      scale, st);
  if (d == 128)
    return (int)launch_dkdv_wgmma<128>(qf, kf, vf, of, lse, delta, dkf, dvf,
                                       b, hq, hkv, s, causal, scale_log2,
                                       scale, st);
  return (int)launch_dkdv_wgmma<256>(qf, kf, vf, of, lse, delta, dkf, dvf, b,
                                     hq, hkv, s, causal, scale_log2, scale,
                                     st);
}

// dq [b, hq, s, d] float32; the other arguments as for the dk/dv entry.
extern "C" int flash_attention_bwd_tf32_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int hq, int hkv,
    int s, int d, int causal, float scale_log2, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  if (d == 16)
    return (int)launch_dq_mma<16>(qf, kf, vf, of, lse, delta, dqf, b, hq,
                                  hkv, s, causal, scale_log2, scale, st);
  if (d == 32)
    return (int)launch_dq_mma<32>(qf, kf, vf, of, lse, delta, dqf, b, hq,
                                  hkv, s, causal, scale_log2, scale, st);
  if (d == 64)
    return (int)launch_dq_wgmma<64>(qf, kf, vf, of, lse, delta, dqf, b, hq,
                                    hkv, s, causal, scale_log2, scale, st);
  if (d == 128)
    return (int)launch_dq_wgmma<128>(qf, kf, vf, of, lse, delta, dqf, b, hq,
                                     hkv, s, causal, scale_log2, scale, st);
  return (int)launch_dq_wgmma<256>(qf, kf, vf, of, lse, delta, dqf, b, hq,
                                   hkv, s, causal, scale_log2, scale, st);
}
