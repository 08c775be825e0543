// Farthest-point sampling of a PointNet++ forward's set-abstraction levels:
// for each object, start at point 0; each step takes the point whose
// distance to the selected set is largest, the first index on ties. Level
// l + 1 samples level l's centroids in selection order, as the tower chains
// them.
//
//   d[n]    = fma(dz, dz, fma(dy, dy, dx * dx)),  dx = x[n] - x[last], ...
//   mind[n] = min(mind[n], d[n]);  last = first argmax of mind
//
// Replaces text2pos_tpu/ops/fps.py:21 (farthest_point_sampling), a
// lax.fori_loop that XLA runs as one loop on the TPU; it has no Pallas
// kernel. Eager PyTorch runs that loop on the host, about 20 small kernels a
// step, 221 steps a PointNet forward; here a forward's three levels run in
// one launch (t2p_fps_levels); t2p_fps is the same kernel on one level.
//
// Arithmetic. Every step is rounded as XLA's CPU backend rounds it (the
// subtractions, the product, then two fused multiply-adds), with the
// intrinsics that forbid nvcc's own contraction, so that the distances, and
// with them the indices, are bit-identical to the JAX reference. Ties are
// the normal case (resampling with replacement duplicates points; a padding
// object has 8 distinct points), and the indices decide every later ball.
//
// Design. Distances are >= +0, so their bits order as integers; a slot with
// no point holds -1, whose bits are a negative integer and never win.
// - Up to 1024 points (the DB encode's 256 -> 128 -> 64): a warp an object.
//   Lane l owns the contiguous block [l·P, l·P + P) (P = ceil(N / 32), up to
//   4 exact, then 6, 8, 12, 16, 24 or 32), coordinates and running minima in
//   registers, so index order is (lane, slot) order. A step: the lane's
//   first maximum by a tree of depth log2 P that keeps the lower slot on
//   equal values and carries the point's index and coordinates; one
//   redux.sync for the warp's largest key; __ballot_sync(key == top) and
//   __ffs give the lowest lane holding it, which owns the first index of the
//   maximum; three shuffles from that lane bring its point to every lane,
//   and that lane writes the index and the centroid (the gather after FPS is
//   gone). Tried on an H100 and slower (PERF.md §6): two objects a warp,
//   on half a warp each or staggered by half a step on the whole warp, and
//   trees without coordinates, the winner's point read from memory.
// - Past 1024 points: a CTA an object (up to 8 warps of 16 points a lane,
//   N <= 4096). Each warp takes its first maximum as above, its owner puts
//   (key, index, point) into shared memory, and after one barrier every warp
//   takes the lowest warp holding the largest key (double-buffered, so one
//   barrier a step).
// - Past 4096 points the coordinates are read from global memory (L2) every
//   step and the minima live in a scratch buffer the caller gives; lanes own
//   strided points, so the lowest index among equal keys is a second
//   redux.sync (min). Slow but right: JAX's function takes any N.
// Level l + 1 reads level l's centroids from the output after a barrier of
// the warp (or CTA) that wrote them, so no level needs shared memory sized
// to it.
//
// Bound. S - 1 dependent steps a level; within a step every object runs at
// once. By bytes (points in, indices and centroids out) and operations
// (about 8 f32 operations a point a step) a DB-encode step's two launches
// need about 10 microseconds; the chain does not allow that. The part of a
// step's chain no design avoids (the last centroid's shuffle, the distance,
// the min, redux.sync, ballot, __ffs; t2p_fps_chain_clocks) is 142.5 clocks
// on an H100 (72 ns at 700 W), a floor of 16 us for a forward's 221 steps;
// the lane's tree and the issue of the distances (two warps share an SM
// sub-partition at 1024 objects) come on top. The figure to read is the
// time per dependent step.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // objects a CTA, a warp an object
constexpr int WARP_POINTS = 1024;
constexpr int CTA_P = 16;         // points a lane past WARP_POINTS
constexpr int CTA_WARPS = 8;
constexpr int REG_POINTS = CTA_P * CTA_WARPS * 32;  // past this: global
constexpr int MAX_LEVELS = 3;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int L;
  int S[MAX_LEVELS];
};

// A lane's candidate: its first maximum and that point's index and
// coordinates.
struct Best {
  float v, x, y, z;
  int n;
};

__device__ __forceinline__ float sqdist(float x, float y, float z, float xl,
                                        float yl, float zl) {
  const float dx = __fsub_rn(x, xl);
  const float dy = __fsub_rn(y, yl);
  const float dz = __fsub_rn(z, zl);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Strictly larger replaces, so the lower index wins on equal values.
__device__ __forceinline__ void keep_first(Best& a, const Best& b) {
  if (b.v > a.v) a = b;
}

// Points a lane for N points on a warp.
__host__ __device__ constexpr int lane_points(int N) {
  const int p = (N + 31) / 32;
  return p <= 4 ? p : p <= 6 ? 6 : p <= 8 ? 8 : p <= 12 ? 12 : p <= 16 ? 16
       : p <= 24 ? 24 : 32;
}

// The first maximum of slots [LO, HI) of a lane (slot j is point base + j):
// a tree of depth ceil(log2(HI - LO)) whose left half holds the lower
// slots, built depth first so that few partial results are live at once.
template <int LO, int HI, int P>
__device__ __forceinline__ Best lane_first_max(
    const float (&x)[P], const float (&y)[P], const float (&z)[P],
    const float (&mind)[P], int base) {
  if constexpr (HI - LO == 1) {
    return {mind[LO], x[LO], y[LO], z[LO], base + LO};
  } else {
    constexpr int MID = LO + (HI - LO + 1) / 2;
    Best a = lane_first_max<LO, MID, P>(x, y, z, mind, base);
    keep_first(a, lane_first_max<MID, HI, P>(x, y, z, mind, base));
    return a;
  }
}

// One level of one object on a warp: lane l owns points [l·P, l·P + P) of
// pts [N, 3].
template <int P>
__device__ void warp_level(const float* pts, int N, int S, long long* ib,
                           float* cb) {
  const int lane = threadIdx.x & 31;
  const int base = lane * P;
  float x[P], y[P], z[P], mind[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int n = base + j;
    const bool ok = n < N;
    x[j] = ok ? pts[3 * n] : 0.0f;
    y[j] = ok ? pts[3 * n + 1] : 0.0f;
    z[j] = ok ? pts[3 * n + 2] : 0.0f;
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
#pragma unroll
    for (int j = 0; j < P; ++j)
      mind[j] = fminf(mind[j], sqdist(x[j], y[j], z[j], xl, yl, zl));
    const Best b = lane_first_max<0, P, P>(x, y, z, mind, base);
    const int key = __float_as_int(b.v);
    const int top = __reduce_max_sync(FULL, key);
    const int owner = __ffs(__ballot_sync(FULL, key == top)) - 1;
    xl = __shfl_sync(FULL, b.x, owner);
    yl = __shfl_sync(FULL, b.y, owner);
    zl = __shfl_sync(FULL, b.z, owner);
    if (lane == owner) {
      ib[i] = b.n;
      float* c = cb + 3 * i;
      c[0] = xl, c[1] = yl, c[2] = zl;
    }
  }
}

#define T2P_FPS_LEVEL(P)                                               \
  if constexpr (PMAX >= P)                                             \
    if (p == P) return warp_level<P>(pts, N, S, ib, cb);

template <int PMAX>
__device__ void run_warp_level(int p, const float* pts, int N, int S,
                               long long* ib, float* cb) {
  T2P_FPS_LEVEL(1) T2P_FPS_LEVEL(2) T2P_FPS_LEVEL(3) T2P_FPS_LEVEL(4)
  T2P_FPS_LEVEL(6) T2P_FPS_LEVEL(8) T2P_FPS_LEVEL(12) T2P_FPS_LEVEL(16)
  T2P_FPS_LEVEL(24) T2P_FPS_LEVEL(32)
}

// Objects of up to WARP_POINTS points, a warp an object; PMAX is the first
// level's points a lane (later levels have fewer).
template <int PMAX>
__global__ void __launch_bounds__(WARPS * 32)
fps_warp_kernel(const float* points,  // [B, N, 3]
                long long* idx,       // level-major: [B, S_l] a level
                float* cent,          // level-major: [B, S_l, 3] a level
                int B, int N, Levels lv) {
  const int b = (blockIdx.x * (WARPS * 32) + (int)threadIdx.x) >> 5;
  if (b >= B) return;  // the whole warp
  const float* pts = points + (size_t)b * N * 3;
  int n = N;
  for (int l = 0; l < lv.L; ++l) {
    const int S = lv.S[l];
    long long* ib = idx + (size_t)b * S;
    float* cb = cent + (size_t)b * S * 3;
    run_warp_level<PMAX>(lane_points(n), pts, n, S, ib, cb);
    __syncwarp();  // the centroids, written lane by lane, are read next
    pts = cb, n = S;
    idx += (size_t)B * S, cent += (size_t)B * S * 3;
  }
}

// What each warp of a CTA hands the others in a step, double-buffered.
struct Exchange {
  int key[2][32];
  unsigned idx[2][32];
  float x[2][32], y[2][32], z[2][32];
};

// The CTA's winner from each warp's (key, index, point) in ex[buf]: the
// largest key, then the lowest index (warps own increasing index ranges in
// registers, so the lowest warp; in the global form their ranges
// interleave). Every thread gets the point; thread 0 writes.
__device__ __forceinline__ void cta_pick(const Exchange& ex, int buf, int i,
                                         long long* ib, float* cb, float& xl,
                                         float& yl, float& zl) {
  const int lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int k = lane < W ? ex.key[buf][lane] : INT_MIN;
  const unsigned id = lane < W ? ex.idx[buf][lane] : 0xffffffffu;
  const int top = __reduce_max_sync(FULL, k);
  const unsigned win = __reduce_min_sync(FULL, k == top ? id : 0xffffffffu);
  const int w = __ffs(__ballot_sync(FULL, k == top && id == win)) - 1;
  xl = ex.x[buf][w], yl = ex.y[buf][w], zl = ex.z[buf][w];
  if (threadIdx.x == 0) {
    ib[i] = win;
    float* c = cb + 3 * i;
    c[0] = xl, c[1] = yl, c[2] = zl;
  }
}

__device__ __forceinline__ void put(Exchange& ex, int buf, int key,
                                    unsigned n, float x, float y, float z) {
  const int warp = threadIdx.x >> 5;
  ex.key[buf][warp] = key, ex.idx[buf][warp] = n;
  ex.x[buf][warp] = x, ex.y[buf][warp] = y, ex.z[buf][warp] = z;
}

// One level of one object on the CTA, N <= 32 · W · CTA_P: thread t owns
// points [t·P, t·P + P) in registers.
__device__ void cta_level(const float* pts, int N, int S, long long* ib,
                          float* cb, Exchange& ex) {
  constexpr int P = CTA_P;
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x * P;
  float x[P], y[P], z[P], mind[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int n = base + j;
    const bool ok = n < N;
    x[j] = ok ? pts[3 * n] : 0.0f;
    y[j] = ok ? pts[3 * n + 1] : 0.0f;
    z[j] = ok ? pts[3 * n + 2] : 0.0f;
    mind[j] = ok ? INFINITY : -1.0f;
  }
  float xl = pts[0], yl = pts[1], zl = pts[2];
  if (threadIdx.x == 0) {
    ib[0] = 0;
    cb[0] = xl, cb[1] = yl, cb[2] = zl;
  }
  for (int i = 1; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      mind[j] = fminf(mind[j], sqdist(x[j], y[j], z[j], xl, yl, zl));
    const Best b = lane_first_max<0, P, P>(x, y, z, mind, base);
    const int key = __float_as_int(b.v);
    const int top = __reduce_max_sync(FULL, key);
    const int owner = __ffs(__ballot_sync(FULL, key == top)) - 1;
    if (lane == owner) put(ex, i & 1, key, b.n, b.x, b.y, b.z);
    __syncthreads();
    cta_pick(ex, i & 1, i, ib, cb, xl, yl, zl);
  }
}

// One level of one object on the CTA past REG_POINTS: thread t owns points
// t, t + T, ...; coordinates from pts every step, minima in mind [N].
__device__ void global_level(const float* pts, int N, int S, long long* ib,
                             float* cb, float* mind, Exchange& ex) {
  const int T = blockDim.x, lane = threadIdx.x & 31;
  for (int n = threadIdx.x; n < N; n += T) mind[n] = INFINITY;
  float xl = pts[0], yl = pts[1], zl = pts[2];
  if (threadIdx.x == 0) {
    ib[0] = 0;
    cb[0] = xl, cb[1] = yl, cb[2] = zl;
  }
  for (int i = 1; i < S; ++i) {
    Best b = {-1.0f, 0.0f, 0.0f, 0.0f, -1};
    for (int n = threadIdx.x; n < N; n += T) {
      const float x = pts[3 * n], y = pts[3 * n + 1], z = pts[3 * n + 2];
      const float m = fminf(mind[n], sqdist(x, y, z, xl, yl, zl));
      mind[n] = m;
      keep_first(b, {m, x, y, z, n});
    }
    const int key = __float_as_int(b.v);
    const int top = __reduce_max_sync(FULL, key);
    const unsigned first =
        __reduce_min_sync(FULL, key == top ? (unsigned)b.n : 0xffffffffu);
    const int owner =
        __ffs(__ballot_sync(FULL, key == top && (unsigned)b.n == first)) - 1;
    if (lane == owner) put(ex, i & 1, key, first, b.x, b.y, b.z);
    __syncthreads();
    cta_pick(ex, i & 1, i, ib, cb, xl, yl, zl);
  }
}

// Objects past WARP_POINTS points, a CTA an object. scratch holds B x N
// floats where N > REG_POINTS (else it may be null).
__global__ void __launch_bounds__(CTA_WARPS * 32)
fps_cta_kernel(const float* points, long long* idx, float* cent,
               float* scratch, int B, int N, Levels lv) {
  __shared__ Exchange ex;
  const int b = blockIdx.x;
  const float* pts = points + (size_t)b * N * 3;
  int n = N;
  for (int l = 0; l < lv.L; ++l) {
    const int S = lv.S[l];
    long long* ib = idx + (size_t)b * S;
    float* cb = cent + (size_t)b * S * 3;
    if (n > REG_POINTS)
      global_level(pts, n, S, ib, cb, scratch + (size_t)b * N, ex);
    else
      cta_level(pts, n, S, ib, cb, ex);
    __syncthreads();  // the centroids, written by thread 0, are read next
    pts = cb, n = S;
    idx += (size_t)B * S, cent += (size_t)B * S * 3;
  }
}

template <int PMAX>
int launch_warps(const void* points, void* idx, void* cent, int B, int N,
                 const Levels& lv, cudaStream_t st) {
  fps_warp_kernel<PMAX><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      (const float*)points, (long long*)idx, (float*)cent, B, N, lv);
  return (int)cudaGetLastError();
}

// The dependent chain of one step that no design avoids: the last
// centroid's shuffle, the subtraction, the product, two FMAs, the min, the
// warp's max, the ballot and __ffs for the next shuffle's lane. One warp.
__global__ void fps_chain_kernel(long long* out, int iters) {
  const int lane = threadIdx.x;
  float v = 0.5f * lane, m = INFINITY;
  int src = 0;
  long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const float dx = __fsub_rn(v, __shfl_sync(FULL, v, src));
    const float d = __fmaf_rn(dx, dx, __fmaf_rn(dx, dx, __fmul_rn(dx, dx)));
    m = fminf(m, d);
    const int key = __float_as_int(m);
    src = __ffs(__ballot_sync(FULL, key == __reduce_max_sync(FULL, key))) - 1;
    v = __fadd_rn(v, 1.0f);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (lane == 0) out[0] = c1 - c0, out[1] = t1 - t0, out[2] = src + (int)m;
}

}  // namespace

// One launch for L <= 3 chained levels: level 1 samples S1 of the N points
// of each of B objects, level l + 1 samples S_{l+1} of level l's S_l
// centroids. idx (int64) and cent (f32) are level-major: level l's
// [B, S_l] indices and [B, S_l, 3] centroids follow level l - 1's. scratch
// holds B x N floats when N > 4096 (else it may be null). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_fps_levels(const void* points, void* idx, void* cent,
                              void* scratch, int B, int N, int L, int S1,
                              int S2, int S3, void* stream) {
  const Levels lv = {L, {S1, S2, S3}};
  if (B < 1 || N < 1 || L < 1 || L > MAX_LEVELS ||
      (N > REG_POINTS && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int l = 0, n = N; l < L; n = lv.S[l++])
    if (lv.S[l] < 1 || lv.S[l] > n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= WARP_POINTS) {
    switch (lane_points(N)) {
      case 1: return launch_warps<1>(points, idx, cent, B, N, lv, st);
      case 2: return launch_warps<2>(points, idx, cent, B, N, lv, st);
      case 3: return launch_warps<3>(points, idx, cent, B, N, lv, st);
      case 4: return launch_warps<4>(points, idx, cent, B, N, lv, st);
      case 6: return launch_warps<6>(points, idx, cent, B, N, lv, st);
      case 8: return launch_warps<8>(points, idx, cent, B, N, lv, st);
      case 12: return launch_warps<12>(points, idx, cent, B, N, lv, st);
      case 16: return launch_warps<16>(points, idx, cent, B, N, lv, st);
      case 24: return launch_warps<24>(points, idx, cent, B, N, lv, st);
      default: return launch_warps<32>(points, idx, cent, B, N, lv, st);
    }
  }
  const int per_warp = 32 * CTA_P;
  const int warps = N > REG_POINTS ? CTA_WARPS : (N + per_warp - 1) / per_warp;
  fps_cta_kernel<<<B, warps * 32, 0, st>>>(
      (const float*)points, (long long*)idx, (float*)cent, (float*)scratch, B,
      N, lv);
  return (int)cudaGetLastError();
}

// One level, S of N points: idx [B, S] int64, cent [B, S, 3] f32. N in
// [1, 4096] (past that the levels entry takes a scratch buffer), S in
// [1, N], B >= 1.
extern "C" int t2p_fps(const void* points, void* idx, void* cent, int B, int N,
                       int S, void* stream) {
  return t2p_fps_levels(points, idx, cent, nullptr, B, N, 1, S, 0, 0, stream);
}

// out [3] int64 on the card: clocks and globaltimer nanoseconds of `iters`
// steps of fps_chain_kernel on one warp, and a value that keeps the chain
// live.
extern "C" int t2p_fps_chain_clocks(void* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  fps_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, iters);
  return (int)cudaGetLastError();
}
