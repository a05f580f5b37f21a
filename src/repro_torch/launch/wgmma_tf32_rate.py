"""Measures the tensor-core rate of TF32 wgmma with A from registers (the RS
form the float32 attention backward's products use, csrc/wgmma_tf32.cuh)
on the card, by N and by the number of accumulators in flight.

    python src/repro_torch/launch/wgmma_tf32_rate.py

One CTA of two warpgroups an SM (132 CTAs), each warpgroup issuing 2,000
commit groups of 16 m64nNk8 products (B from shared memory, 128-byte
swizzle) into ACC accumulators in turn, one group in flight behind each
wait; the time is clock64 around the loop on thread 0 of each CTA, so a
product's clocks are the SM's tensor pipe time for it. The probe kernel
is built with nvcc from the source below into build/kernels at run time.
Prints one JSON object: per (N, ACC) the clocks a product and the flops a
clock of an SM (the H100's dense TF32 peak is 495 TFLOP/s over 132 SMs,
about 2,048 a clock at its 1,830 MHz boost).
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build

SOURCE = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "mbarrier.cuh"
#include "wgmma_tf32.cuh"
namespace {
template <int N, int ACC>
__global__ void __launch_bounds__(256, 1)
rate(float* out, long long* clk, int iters) {
  __shared__ __align__(1024) uint8_t sb[64 * 128];
  for (int i = threadIdx.x; i < 64 * 32; i += 256)
    reinterpret_cast<float*>(sb)[i] = 1.0f / (1 + i);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[ACC][N / 2];
  for (int c = 0; c < ACC; ++c)
    for (int e = 0; e < N / 2; ++e) d[c][e] = 0.f;
  uint32_t a[4] = {__float_as_uint(1.f), __float_as_uint(.5f),
                   __float_as_uint(.25f), __float_as_uint(.125f)};
  const uint64_t db = desc(smem_u32(sb), 16, 1024);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 16; ++k)
      TF32<N>::rs(d[k % ACC], a, db + (k & 3) * 2, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  for (int c = 0; c < ACC; ++c) fence_regs(d[c]);
  const long long t1 = clock64();
  float sum = 0.f;
  for (int c = 0; c < ACC; ++c)
    for (int e = 0; e < N / 2; ++e) sum += d[c][e];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}
}  // namespace
#define CASE(n, acc) \
  if (n_ == n && acc_ == acc) rate<n, acc><<<blocks, 256>>>(out, clk, iters);
extern "C" int run_rate(int n_, int acc_, float* out, long long* clk,
                        int iters, int blocks) {
  CASE(16, 1) CASE(16, 2) CASE(16, 4) CASE(32, 1) CASE(32, 2) CASE(64, 1)
  CASE(64, 2)
  return (int)cudaGetLastError();
}
"""
CASES = ((16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (64, 1), (64, 2))
BLOCKS, ITERS, PRODUCTS = 132, 2000, 16


def build() -> ctypes.CDLL:
    """The probe's library, compiled with the port's nvcc flags."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "wgmma_tf32_rate.cu"
    lib = _build.BUILD_DIR / "libwgmma_tf32_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_tf32_rate: needs a CUDA device")
    lib = build()
    out = torch.zeros(BLOCKS * 256, device="cuda")
    clk = torch.zeros(BLOCKS, dtype=torch.int64, device="cuda")
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip(), "rates": []}
    for n, acc in CASES:
        rc = lib.run_rate(n, acc, ctypes.c_void_p(out.data_ptr()),
                          ctypes.c_void_p(clk.data_ptr()), ITERS, BLOCKS)
        torch.cuda.synchronize()
        _build.check(rc, "wgmma_tf32_rate")
        products = 2 * PRODUCTS * ITERS          # two warpgroups a CTA
        cycles = float(clk.double().mean())
        result["rates"].append({
            "n": n, "accumulators": acc,
            "clocks_a_product": cycles / products,
            "flops_a_clock": products * 64 * n * 8 * 2 / cycles})
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
