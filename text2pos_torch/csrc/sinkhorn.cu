// Log-domain Sinkhorn: `iters` alternating row/column dual updates, then
// Z + u + v.
//
// Replaces the TPU kernel text2pos_tpu/ops/sinkhorn_pallas.py:51
// (log_sinkhorn_pallas, body _sinkhorn_kernel :26). The TPU version lays the
// batch along vector lanes; here one warp owns one batch element.
//
// Design. Lane i holds row i of the coupling (N <= 16 values) in registers
// for all iterations: one read of Z, one write of the result. The row
// log-sum-exp is a loop inside the lane; the column log-sum-exp is a warp
// reduction (max, then sum of exp) with shuffles. Lanes i >= M hold -inf,
// so they add exp(-inf) = 0 to every column sum and never win a max.
// All f32, with full-precision expf/logf as in the reference.
//
// Bound. 2·M·N exponentials per iteration per batch element (about 2.4e8
// for B=20480, 17×7, 50 iterations) against 2·B·M·N·4 bytes of traffic:
// operations bound it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXN = 16;
constexpr int WARPS_PER_CTA = 8;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS_PER_CTA * 32)
log_sinkhorn_kernel(const float* __restrict__ Z,       // [B, M, N]
                    const float* __restrict__ log_mu,  // [B, M]
                    const float* __restrict__ log_nu,  // [B, N]
                    float* __restrict__ out,           // [B, M, N]
                    int B, int M, int N, int iters) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  const bool row = lane < M;
  const float neg_inf = -INFINITY;

  const float* zb = Z + (size_t)b * M * N + (size_t)lane * N;
  float z[MAXN], nu[MAXN], v[MAXN];
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {
    z[j] = (row && j < N) ? zb[j] : neg_inf;
    nu[j] = j < N ? log_nu[(size_t)b * N + j] : 0.0f;
    v[j] = 0.0f;
  }
  const float mu = row ? log_mu[(size_t)b * M + lane] : 0.0f;
  float u = 0.0f;

  for (int it = 0; it < iters; ++it) {
    // u_i = log_mu_i - logsumexp_j(z_ij + v_j)
    float m = neg_inf;
#pragma unroll
    for (int j = 0; j < MAXN; ++j)
      if (j < N) m = fmaxf(m, z[j] + v[j]);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXN; ++j)
      if (j < N) s += expf(z[j] + v[j] - m);
    u = row ? mu - (m + logf(s)) : 0.0f;

    // v_j = log_nu_j - logsumexp_i(z_ij + u_i)
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      if (j < N) {
        const float x = row ? z[j] + u : neg_inf;
        const float cm = warp_max(x);
        const float cs = warp_sum(row ? expf(x - cm) : 0.0f);
        v[j] = nu[j] - (cm + logf(cs));
      }
    }
  }

  if (row) {
    float* ob = out + (size_t)b * M * N + (size_t)lane * N;
#pragma unroll
    for (int j = 0; j < MAXN; ++j)
      if (j < N) ob[j] = z[j] + u + v[j];
  }
}

}  // namespace

// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_log_sinkhorn(const void* Z, const void* log_mu,
                                const void* log_nu, void* out, int B, int M,
                                int N, int iters, void* stream) {
  if (M < 1 || M > 32 || N < 1 || N > MAXN || B < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS_PER_CTA - 1) / WARPS_PER_CTA;
  log_sinkhorn_kernel<<<grid, WARPS_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)log_mu, (const float*)log_nu,
      (float*)out, B, M, N, iters);
  return (int)cudaGetLastError();
}
