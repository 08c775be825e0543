#!/usr/bin/env python3
"""The tensor pipe's rate for the LSTM kernels' product on this card, and
the TF32 split's cost: builds a small CUDA program (``nvcc`` with the
port's flags) and prints

- the SM cycles an ``mma.sync.m16n8k8`` TF32 takes a sub-partition with 4,
  8 and 16 warps a CTA, one CTA an SM, for the 3xTF32 pattern of
  ``csrc/lstm.cu`` (two MMAs chained on one accumulator and a third from
  zero, added by four f32 adds) and for three independent MMAs, and an
  ``m16n8k16`` bf16 beside them (nothing loaded, nothing split: the
  pipe's rate);
- whether ``cvt.rna.tf32.f32`` rounds as ``split`` in ``csrc/lstm.cu``
  (an integer add and mask) on 2^26 finite floats, a quarter of them exact
  ties, and the time of 4000 x 8 splits a thread either way.

    python3 scripts/probe_mma_tf32.py

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from text2pos_torch.ops import _build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdlib>

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2 m-tiles x 4 n-tiles x 3 MMAs an iteration, as a warp of the kernels.
template <int MODE>
__global__ void pipe(float* out, int iters, unsigned seed) {
  unsigned a[2][4], b[4][2];
  for (int i = 0; i < 4; ++i) { a[0][i] = seed * (threadIdx.x + i); a[1][i] = seed ^ i; }
  for (int i = 0; i < 4; ++i) { b[i][0] = seed + i; b[i][1] = seed * 3 + i; }
  float acc[2][4][4] = {}, acc2[2][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (MODE == 0) {
          mma(acc2[mt][nt], a[mt], b[nt][0], b[nt][1]);
          mma(acc2[mt][nt], a[mt], b[nt][1], b[nt][0]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma(part, a[mt], b[nt][0], b[nt][1]);
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
        } else if (MODE == 1) {
          mma(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
          mma(acc2[mt][nt], a[mt], b[nt][1], b[nt][0]);
          mma(acc[mt][nt], a[mt], b[nt][1], b[nt][1]);
        } else {
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
          mma_bf16(acc2[mt][nt], a[mt], b[nt][1], b[nt][0]);
          mma_bf16(acc[mt][nt], a[mt], b[nt][1], b[nt][1]);
        }
      }
  }
  float s = 0;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int q = 0; q < 4; ++q) s += acc[mt][nt][q] + acc2[mt][nt][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ void split_int(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ unsigned cvt(float x) {
  unsigned y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split_cvt(float x, unsigned& big, unsigned& small) {
  big = cvt(x);
  small = cvt(x - __uint_as_float(big));
}
__global__ void same(const unsigned* in, int n, unsigned long long* bad) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    unsigned b1, s1, b2, s2;
    split_int(__uint_as_float(in[i]), b1, s1);
    split_cvt(__uint_as_float(in[i]), b2, s2);
    if (b1 != b2 || s1 != s2) atomicAdd(bad, 1ull);
  }
}
template <bool CVT>
__global__ void splits(float* out, int iters) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 1.37f + i;
  unsigned acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unsigned b, s;
      if (CVT) split_cvt(x[i], b, s); else split_int(x[i], b, s);
      acc ^= b + s;
      x[i] = __uint_as_float(__float_as_uint(x[i]) ^ (acc & 0x3ff));
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = __uint_as_float(acc);
}

int main() {
  int sms, dev = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[3] = {"tf32 3xTF32 pattern", "tf32 independent", "bf16 m16n8k16"};
  for (int mode = 0; mode < 3; ++mode)
    for (int warps : {4, 8, 16}) {
      const int iters = 2000;
      auto run = [&]() {
        if (mode == 0) pipe<0><<<sms, warps * 32>>>(out, iters, 7);
        else if (mode == 1) pipe<1><<<sms, warps * 32>>>(out, iters, 7);
        else pipe<2><<<sms, warps * 32>>>(out, iters, 7);
      };
      run();
      cudaEventRecord(e0);
      run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      int khz;
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
      const double per_smsp = 24.0 * iters * warps / 4;
      printf("%s, %d warps a CTA: %.3f ms, %.2f cycles an MMA a sub-partition "
             "at %d MHz\n", names[mode], warps, ms,
             ms * 1e-3 * khz * 1e3 / per_smsp, khz / 1000);
    }
  const int n = 1 << 26;
  unsigned* h = (unsigned*)malloc((size_t)n * 4);
  srand(1);
  for (int i = 0; i < n; ++i) {
    unsigned r = ((unsigned)rand() << 16) ^ (unsigned)rand();
    if (i % 4 == 1) r = (r & 0xffffe000u) | 0x1000u;       // exact ties
    if (i % 4 == 2) r = (r & 0xffffe000u) | 0x0fffu;
    if ((r & 0x7f800000u) == 0x7f800000u) r &= 0xbfffffffu;  // finite
    h[i] = r;
  }
  unsigned* d;
  unsigned long long* bad;
  cudaMalloc(&d, (size_t)n * 4);
  cudaMalloc(&bad, 8);
  cudaMemcpy(d, h, (size_t)n * 4, cudaMemcpyHostToDevice);
  cudaMemset(bad, 0, 8);
  same<<<1024, 256>>>(d, n, bad);
  unsigned long long hb;
  cudaMemcpy(&hb, bad, 8, cudaMemcpyDeviceToHost);
  printf("cvt.rna.tf32.f32 split against the integer split: %llu of %d "
         "differ\n", hb, n);
  for (int c = 0; c < 2; ++c) {
    auto run = [&]() {
      if (c) splits<true><<<sms, 512>>>(out, 4000);
      else splits<false><<<sms, 512>>>(out, 4000);
    };
    run();
    cudaEventRecord(e0);
    run();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("%s split: %.3f ms for 4000 x 8 splits a thread, 512 threads an "
           "SM\n", c ? "cvt.rna" : "integer", ms);
  }
  return 0;
}
"""


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    tmp = tempfile.mkdtemp()
    cu, exe = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe")
    Path(cu).write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",
                                                       "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o", exe, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr)
        return 1
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
