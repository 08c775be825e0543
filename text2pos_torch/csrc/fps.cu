// Farthest-point sampling of one PointNet++ set-abstraction level: for each
// object, start at point 0; each step takes the point whose distance to the
// selected set is largest, the first index on ties.
//
//   d[n]    = fma(dz, dz, fma(dy, dy, dx * dx)),  dx = x[n] - x[last], ...
//   mind[n] = min(mind[n], d[n]);  last = first argmax of mind
//
// Replaces text2pos_tpu/ops/fps.py:21 (farthest_point_sampling), a
// lax.fori_loop that XLA runs as one loop on the TPU; it has no Pallas
// kernel. Eager PyTorch runs that loop on the host, about 20 small kernels a
// step, 221 steps a PointNet forward; here the loop runs inside one launch.
//
// Arithmetic. Every step is rounded as XLA's CPU backend rounds it (the
// subtractions, the product, then two fused multiply-adds), with the
// intrinsics that forbid nvcc's own contraction, so that the distances, and
// with them the indices, are bit-identical to the JAX reference. Ties are
// the normal case (resampling with replacement duplicates points; a padding
// object has 8 distinct points), and the indices decide every later ball.
//
// Design. One warp per object, N <= 1024: lane l owns points l, l + 32, ...
// (P of them, a template parameter: ceil(N / 32) up to 8, then rounded up
// to 12, 16, 24 or 32; slots past N hold -1 and never win), their
// coordinates and running minima in registers (4·P of them). A step: each lane updates its minima and keeps its own largest
// in index order (strictly larger replaces, so its first index wins); then
// redux.sync takes the warp's largest value (distances are >= +0, so their
// bits order as unsigned integers) and, among the lanes holding it, the
// smallest index: the first index of the maximum, as argmax. The owner
// (index mod 32) shuffles its point to every lane. Lane 0 writes the index
// and the centroid, so the gather after FPS is gone.
//
// One launch per level, not one per forward for all three levels: level
// l+1's points are level l's centroids, so one launch could chain them, but
// the host's cost is 4 launches of some 800 a DB-encode step either way,
// and a launch per level keeps the JAX function's contract (one call, one
// level) and its tests.
//
// Bound. S - 1 dependent steps; within a step every object runs at once. By
// bytes (points in, indices and centroids out) and operations (about 8 f32
// operations a point a step) a DB-encode step's six launches need a few
// microseconds; the chain does not allow that: a step is a few hundred
// clocks of dependent latency (the minima, the lane's reduction, two
// redux.sync, the shuffles). So latency bounds it, and the figure to read is
// the time per dependent step (time / (S - 1)).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // objects per CTA
constexpr unsigned FULL = 0xffffffffu;

template <int P>
__global__ void __launch_bounds__(WARPS * 32)
fps_kernel(const float* __restrict__ points,  // [B, N, 3]
           long long* __restrict__ idx,       // [B, S]
           float* __restrict__ cent,          // [B, S, 3]
           int B, int N, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp
  const float* pb = points + (size_t)b * N * 3;
  long long* ib = idx + (size_t)b * S;
  float* cb = cent + (size_t)b * S * 3;

  // Slots past N hold -1: min(-1, d) stays -1 and never beats a distance.
  float x[P], y[P], z[P], mind[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int n = lane + 32 * j;
    const bool ok = n < N;
    x[j] = ok ? pb[3 * n] : 0.0f;
    y[j] = ok ? pb[3 * n + 1] : 0.0f;
    z[j] = ok ? pb[3 * n + 2] : 0.0f;
    mind[j] = ok ? INFINITY : -1.0f;
  }
  float xl = __shfl_sync(FULL, x[0], 0);
  float yl = __shfl_sync(FULL, y[0], 0);
  float zl = __shfl_sync(FULL, z[0], 0);
  if (lane == 0) {
    ib[0] = 0;
    cb[0] = xl, cb[1] = yl, cb[2] = zl;
  }

  for (int i = 1; i < S; ++i) {
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    unsigned bi = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float dx = __fsub_rn(x[j], xl);
      const float dy = __fsub_rn(y[j], yl);
      const float dz = __fsub_rn(z[j], zl);
      const float d = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
      mind[j] = fminf(mind[j], d);
      if (mind[j] > bv) {
        bv = mind[j];
        bi = lane + 32 * j;
        bx = x[j], by = y[j], bz = z[j];
      }
    }
    // A lane with no point past N keeps key 0 and index 0xffffffff, which
    // loses to any real point of equal key.
    const unsigned key = bv >= 0.0f ? __float_as_uint(bv) : 0u;
    const unsigned top = __reduce_max_sync(FULL, key);
    const unsigned win = __reduce_min_sync(FULL, key == top ? bi : 0xffffffffu);
    const int owner = win & 31;
    xl = __shfl_sync(FULL, bx, owner);
    yl = __shfl_sync(FULL, by, owner);
    zl = __shfl_sync(FULL, bz, owner);
    if (lane == 0) {
      ib[i] = win;
      float* c = cb + 3 * i;
      c[0] = xl, c[1] = yl, c[2] = zl;
    }
  }
}

template <int P>
int launch(const void* points, void* idx, void* cent, int B, int N, int S,
           cudaStream_t stream) {
  fps_kernel<P><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      (const float*)points, (long long*)idx, (float*)cent, B, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; 0 means the launch was accepted. N in [1, 1024],
// S in [1, N], B >= 1.
extern "C" int t2p_fps(const void* points, void* idx, void* cent, int B, int N,
                       int S, void* stream) {
  if (B < 1 || N < 1 || N > 1024 || S < 1 || S > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int p = (N + 31) / 32;
  switch (p) {
    case 1: return launch<1>(points, idx, cent, B, N, S, st);
    case 2: return launch<2>(points, idx, cent, B, N, S, st);
    case 3: return launch<3>(points, idx, cent, B, N, S, st);
    case 4: return launch<4>(points, idx, cent, B, N, S, st);
    case 5: return launch<5>(points, idx, cent, B, N, S, st);
    case 6: return launch<6>(points, idx, cent, B, N, S, st);
    case 7: return launch<7>(points, idx, cent, B, N, S, st);
    case 8: return launch<8>(points, idx, cent, B, N, S, st);
  }
  if (p <= 12) return launch<12>(points, idx, cent, B, N, S, st);
  if (p <= 16) return launch<16>(points, idx, cent, B, N, S, st);
  if (p <= 24) return launch<24>(points, idx, cent, B, N, S, st);
  return launch<32>(points, idx, cent, B, N, S, st);
}
