#!/usr/bin/env python3
"""How the card's tensor cores and fast math round, read bit for bit, so
that a numpy emulation of the kernels' arithmetic (tests/
test_torch_port_tc_arith.py) can follow them.

    python3 scripts/probe_mma_rounding.py OUT.npz
    python3 scripts/probe_mma_rounding.py --fixture OUT.npz

The second form needs no card: it writes the first FIXTURE_TILES tiles of
each ``mma`` case of a card run's OUT.npz to ``text2pos_torch/fixtures/
mma_rounding.npz``, which the CPU tests hold the emulation to.

Builds a small CUDA library with the port's ``nvcc`` flags and runs, on
seeded inputs, one warp a tile of:

- ``mma.sync.m16n8k16`` and ``m16n8k8`` with bf16 operands and f32
  accumulators (the GNN's second form uses the first), from a zero
  accumulator and from a random one;
- ``mma.sync.m16n8k8`` with TF32 operands (the LSTM kernel's);
- ``__expf``, ``expf``, ``__fdividef(1, x)`` and ``1.0f / x`` on the
  softmax's arguments;
- PyTorch's f32 division of a tensor by a Python float on the card (the
  plain GNN's logit scale ``s / math.sqrt(D)``), against a division and
  against a multiply by the f32 reciprocal.

For each ``mma`` it prints the share of outputs that each candidate model
of the summation reproduces bit for bit: the exact sum rounded to nearest
or toward zero, and "blocked" sums: the products of b consecutive k (and
the accumulator, with the first block) aligned to the largest of their
exponents, each truncated x bits below that exponent's 24-bit significand,
added exactly, and the sum rounded toward zero or to nearest to f32. For
the fast math it prints the ulp differences from the correctly rounded
result. Writes the inputs and outputs to OUT.npz. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t pk(const uint16_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

// A [T, 16, K] bf16 row-major, B [T, K, 8] bf16, C and D [T, 16, 8] f32.
template <int K>
__global__ void mma_bf16(const uint16_t* A, const uint16_t* B, const float* C,
                         float* D, int T) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint16_t* a = A + (size_t)t * 16 * K;
  const uint16_t* b = B + (size_t)t * K * 8;
  const float* c = C + (size_t)t * 128;
  float d[4] = {c[g * 8 + 2 * q], c[g * 8 + 2 * q + 1],
                c[(g + 8) * 8 + 2 * q], c[(g + 8) * 8 + 2 * q + 1]};
  uint16_t bb[4];
  for (int i = 0; i < 2; ++i) bb[i] = b[(2 * q + i) * 8 + g];
  if (K == 16) {
    for (int i = 0; i < 2; ++i) bb[2 + i] = b[(2 * q + 8 + i) * 8 + g];
    uint32_t a0 = pk(a + g * K + 2 * q), a1 = pk(a + (g + 8) * K + 2 * q);
    uint32_t a2 = pk(a + g * K + 2 * q + 8), a3 = pk(a + (g + 8) * K + 2 * q + 8);
    uint32_t b0 = bb[0] | ((uint32_t)bb[1] << 16), b1 = bb[2] | ((uint32_t)bb[3] << 16);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    uint32_t a0 = pk(a + g * K + 2 * q), a1 = pk(a + (g + 8) * K + 2 * q);
    uint32_t b0 = bb[0] | ((uint32_t)bb[1] << 16);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
  }
  float* o = D + (size_t)t * 128;
  o[g * 8 + 2 * q] = d[0];
  o[g * 8 + 2 * q + 1] = d[1];
  o[(g + 8) * 8 + 2 * q] = d[2];
  o[(g + 8) * 8 + 2 * q + 1] = d[3];
}

// A [T, 16, 8] TF32 bit patterns (f32 with the low 13 bits clear), B [T, 8, 8].
__global__ void mma_tf32(const uint32_t* A, const uint32_t* B, const float* C,
                         float* D, int T) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint32_t* a = A + (size_t)t * 128;
  const uint32_t* b = B + (size_t)t * 64;
  const float* c = C + (size_t)t * 128;
  float d[4] = {c[g * 8 + 2 * q], c[g * 8 + 2 * q + 1],
                c[(g + 8) * 8 + 2 * q], c[(g + 8) * 8 + 2 * q + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[g * 8 + q]), "r"(a[(g + 8) * 8 + q]), "r"(a[g * 8 + q + 4]),
        "r"(a[(g + 8) * 8 + q + 4]), "r"(b[q * 8 + g]), "r"(b[(q + 4) * 8 + g]));
  float* o = D + (size_t)t * 128;
  o[g * 8 + 2 * q] = d[0];
  o[g * 8 + 2 * q + 1] = d[1];
  o[(g + 8) * 8 + 2 * q] = d[2];
  o[(g + 8) * 8 + 2 * q + 1] = d[3];
}

__global__ void fast_math(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __expf(x[i]);
  out[n + i] = expf(x[i]);
  out[2 * n + i] = __fdividef(1.0f, x[i]);
  out[3 * n + i] = 1.0f / x[i];
}

extern "C" int probe_mma_bf16(const void* A, const void* B, const void* C,
                              void* D, int T, int K) {
  const int blocks = (T + 7) / 8;
  if (K == 16)
    mma_bf16<16><<<blocks, 256>>>((const uint16_t*)A, (const uint16_t*)B,
                                  (const float*)C, (float*)D, T);
  else
    mma_bf16<8><<<blocks, 256>>>((const uint16_t*)A, (const uint16_t*)B,
                                 (const float*)C, (float*)D, T);
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe_mma_tf32(const void* A, const void* B, const void* C,
                              void* D, int T) {
  mma_tf32<<<(T + 7) / 8, 256>>>((const uint32_t*)A, (const uint32_t*)B,
                                 (const float*)C, (float*)D, T);
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe_fast_math(const void* x, void* out, int n) {
  fast_math<<<(n + 255) / 256, 256>>>((const float*)x, (float*)out, n);
  return (int)cudaDeviceSynchronize();
}
"""


def round_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """f32 values rounded to nearest (ties to even) to ``bits`` stored
    mantissa bits (7 for bf16, 10 for TF32)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    half = (1 << (drop - 1)) - 1 + ((u >> drop) & 1)
    return ((u + half) >> drop << drop).astype(np.uint32).view(np.float32)


def to_f32(x: np.ndarray, mode: str) -> np.ndarray:
    """float64 values to f32, to nearest ("rn") or toward zero ("rz")."""
    x = np.asarray(x, np.float64)
    r = x.astype(np.float32)
    if mode == "rn":
        return r
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def blocked_sum(prods: np.ndarray, pexp: np.ndarray, c: np.ndarray,
                block: int, extra: int, final: str) -> np.ndarray:
    """prods [..., K] float64 (exact products) with exponents pexp, c [...]
    f32: blocks of ``block`` products, the running value (c, then each
    block's result) joining the next block; every term truncated toward
    zero at 2^(e_max - 23 - extra), e_max the largest exponent of the
    block's terms, summed exactly, the sum rounded to f32 by ``final``."""
    acc = np.asarray(c, np.float64)
    for k0 in range(0, prods.shape[-1], block):
        terms = np.concatenate([acc[..., None], prods[..., k0:k0 + block]],
                               -1)
        exps = np.concatenate([exponent(acc)[..., None],
                               pexp[..., k0:k0 + block]], -1)
        q = np.exp2(exps.max(-1) - 23 - extra)[..., None]
        acc = to_f32((np.trunc(terms / q) * q).sum(-1),
                     final).astype(np.float64)
    return acc.astype(np.float32)


def exponent(x: np.ndarray) -> np.ndarray:
    """floor(log2|x|), and a very small exponent for 0."""
    m = np.abs(np.asarray(x, np.float64))
    return np.where(m > 0, np.floor(np.log2(np.where(m > 0, m, 1.0))),
                    -1000.0)


def models(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> dict:
    """Candidate f32 results of c + a·b for a [T, 16, K], b [T, K, 8]."""
    prods = np.einsum("tmk,tkn->tmnk", a.astype(np.float64),
                      b.astype(np.float64))
    exact = prods.sum(-1) + c
    out = {"exact, to nearest": to_f32(exact, "rn"),
           "exact, toward zero": to_f32(exact, "rz")}
    # The products' exponents: of their values, or the sum of the
    # operands' exponents (a product of significands in [1, 4)).
    raw = exponent(a)[:, :, None, :] + \
        exponent(b).transpose(0, 2, 1)[:, None, :, :]
    for block in (4, 8, 16):
        if block > prods.shape[-1]:
            continue
        for extra in (0, 1, 2, 3):
            for final in ("rz", "rn"):
                for how, pexp in (("value", exponent(prods)),
                                  ("operand", raw)):
                    out[f"blocked {block}, {extra} extra bits, {final}, "
                        f"exponents of the {how}s"] = blocked_sum(
                            prods, pexp, c, block, extra, final)
    return out


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.int32).astype(np.int64)
            - b.view(np.int32).astype(np.int64))


FIXTURE_TILES = 16
FIXTURE = ROOT / "text2pos_torch" / "fixtures" / "mma_rounding.npz"


def write_fixture(path: Path) -> int:
    src = np.load(path)
    cut = {k: src[k][:FIXTURE_TILES] for k in src.files
           if not k.startswith("fast_math")}
    np.savez_compressed(FIXTURE, **cut)
    print(f"# wrote {FIXTURE}: {len(cut)} arrays of {FIXTURE_TILES} tiles")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--fixture":
        return write_fixture(Path(sys.argv[2]))
    import torch

    from text2pos_torch.ops import _build

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    out_path = Path(sys.argv[1])
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {gpu}")
    with tempfile.TemporaryDirectory() as d:
        src, so = Path(d) / "probe.cu", Path(d) / "libprobe.so"
        src.write_text(SOURCE)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    for fn in (lib.probe_mma_bf16, lib.probe_mma_tf32, lib.probe_fast_math):
        fn.restype = ctypes.c_int
    lib.probe_mma_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.probe_mma_tf32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.probe_fast_math.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]

    rng = np.random.default_rng(0)
    T = 512
    saved = {}

    def operands(shape, spread):
        x = rng.standard_normal(shape) * np.exp2(
            rng.integers(-spread, spread + 1, shape))
        return x.astype(np.float32)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).cuda()

    for K in (16, 8):
        for spread, with_c in ((0, False), (3, False), (6, False),
                               (3, True)):
            a = round_mantissa(operands((T, 16, K), spread), 7)
            b = round_mantissa(operands((T, K, 8), spread), 7)
            c = (operands((T, 16, 8), spread) * 4 if with_c
                 else np.zeros((T, 16, 8), np.float32))
            ta, tb = (dev(x).to(torch.bfloat16).view(torch.int16)
                      for x in (a, b))
            tc, td = dev(c), torch.empty(T, 16, 8, device="cuda")
            _build.check(lib.probe_mma_bf16(ta.data_ptr(), tb.data_ptr(),
                                            tc.data_ptr(), td.data_ptr(), T,
                                            K), "probe_mma_bf16")
            got = td.cpu().numpy()
            tag = f"bf16 k{K} spread 2^{spread} c {'random' if with_c else 0}"
            saved[tag] = (a, b, c, got)
            res = {k: float((v == got).mean())
                   for k, v in models(a, b, c).items()}
            best = sorted(res.items(), key=lambda kv: -kv[1])[:4]
            print(f"mma {tag}: bit-identical share, best models: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in best))
    for spread, with_c in ((0, False), (3, False), (3, True)):
        a = round_mantissa(operands((T, 16, 8), spread), 10)
        b = round_mantissa(operands((T, 8, 8), spread), 10)
        c = (operands((T, 16, 8), spread) * 4 if with_c
             else np.zeros((T, 16, 8), np.float32))
        td = torch.empty(T, 16, 8, device="cuda")
        ta, tb, tc = dev(a), dev(b), dev(c)
        _build.check(lib.probe_mma_tf32(ta.data_ptr(), tb.data_ptr(),
                                        tc.data_ptr(), td.data_ptr(), T),
                     "probe_mma_tf32")
        got = td.cpu().numpy()
        tag = f"tf32 k8 spread 2^{spread} c {'random' if with_c else 0}"
        saved[tag] = (a, b, c, got)
        res = {k: float((v == got).mean())
               for k, v in models(a, b, c).items()}
        best = sorted(res.items(), key=lambda kv: -kv[1])[:4]
        print(f"mma {tag}: bit-identical share, best models: "
              + "; ".join(f"{k} {v:.4f}" for k, v in best))

    # The softmax's arguments: x - max in [-30, 0]; sums of exponentials
    # in [1, 40].
    x = np.concatenate([-rng.random(1 << 16) * 30,
                        1 + rng.random(1 << 16) * 39]).astype(np.float32)
    tx = dev(x)
    to = torch.empty(4 * len(x), device="cuda")
    _build.check(lib.probe_fast_math(tx.data_ptr(), to.data_ptr(), len(x)),
                 "probe_fast_math")
    fe, ex, fr, dv = to.cpu().numpy().reshape(4, -1)
    n = 1 << 16
    want_e = np.exp(x[:n].astype(np.float64)).astype(np.float32)
    y = (x[:n] * np.float32(np.log2(np.e))).astype(np.float32)
    via_ex2 = np.exp2(y.astype(np.float64)).astype(np.float32)
    want_r = (1.0 / x[n:].astype(np.float64)).astype(np.float32)
    for name, got, want in (("__expf vs exp", fe[:n], want_e),
                            ("__expf vs 2^rn(x*log2e)", fe[:n], via_ex2),
                            ("expf vs exp", ex[:n], want_e),
                            ("__fdividef(1, s) vs 1/s", fr[n:], want_r),
                            ("1.0f / s vs 1/s", dv[n:], want_r)):
        u = np.abs(ulps(got, want))
        print(f"{name}: ulps max {int(u.max())}, mean {u.mean():.3f}, "
              f"share exact {float((u == 0).mean()):.4f}")
    saved["fast_math"] = (x, fe, ex, fr, dv)

    s = (rng.standard_normal(1 << 16) * 10).astype(np.float32)
    got = (dev(s) / math.sqrt(75)).cpu().numpy()
    div = (s.astype(np.float64) / math.sqrt(75)).astype(np.float32)
    inv = np.float32(1) / np.float32(math.sqrt(75))
    mul = (s.astype(np.float64) * np.float64(inv)).astype(np.float32)
    print(f"torch f32 tensor / math.sqrt(75) on the card: equal to the "
          f"division {float((got == div).mean()):.4f}, to the multiply by "
          f"the f32 reciprocal {float((got == mul).mean()):.4f}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **{f"{k}|{i}": v for k, vs in saved.items()
                                     for i, v in enumerate(vs)})
    print(f"# wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
