// One PointNet++ set-abstraction level after the centroids are chosen
// (eval mode): ball query, the first k_cap in-ball points by index, the
// two-layer PointConv MLP on each selected neighbour and a max over them.
//
//   out[b, s, :] = max over the first k_cap points n (by index) with
//                  d2(cent[b, s], pos[b, n]) <= r2 of
//                  relu(BN1(relu(BN0(a[b, n] - c[b, s])) . W2 + b2))
//   and 0 where no point is in the ball.
//
// Replaces the TPU kernel text2pos_tpu/ops/pointconv_pallas.py:91
// (separable_pointconv_max, body _kernel :44). That kernel streams all N
// candidates of a centroid through the second layer and masks afterwards,
// N/K = 8x the matrix work, which made it slower than XLA on the TPU. Here
// the selection comes first and the MLP runs on the selected rows only.
//
// Design. One CTA of 8 warps per (object, tile of 8 centroids), one warp
// per centroid; the grid's x walks the centroid tiles of one object so that
// the object's rows of `a` stay in L2.
// - Selection: the warp computes d2 for 32 points at a time with the
//   model's expansion a2 - 2ab + b2, the norms and the dot as XLA's CPU
//   backend compiles them (fused multiply-adds in a fixed order), so the
//   ball boundary is bit-identical to the JAX reference. __ballot_sync and
//   popc(ballot & lanes below) give each in-ball point its exclusive rank;
//   ranks < k_cap are written to the warp's index list, and the warp stops
//   once k_cap points are found.
// - MLP: the warp builds its rows h = relu(BN0(a_n - c_s)) eight at a time
//   in shared memory, then each lane computes 8 rows x J output columns
//   (J = 4, or 2 when C2 is not a multiple of 128) with f32 FMAs: h is a
//   broadcast float4 read from shared memory, W2 a coalesced read through
//   L1 that the CTA's 8 warps share (W2 of sa3 is 256 KB f32 and does not
//   fit in shared memory). BN1, ReLU and the running max over rows finish
//   each column tile in registers; the warp's running maxima live in shared
//   memory. Warps never wait for each other.
// - bf16: a, c and W2 arrive in bf16; the kernel rounds where the JAX
//   package's compiled model rounds (XLA keeps f32 between matmuls): a - c
//   and BN0 in f32, BN0's output rounded as the second layer's input, the
//   product (accumulated in f32) rounded, then bias, BN1, ReLU and the max
//   in f32. The output is rounded to the input type.
//
// Bound. The second layer on the selected neighbours is 2 . B . S . K_valid
// . C1 . C2 FLOPs: at the K = 32 cap 218 MFLOP per object over sa1..sa3,
// 7.1 TFLOP for the fine bank (32,768 objects), about 107 ms at 67 TFLOP/s
// f32 or 7.2 ms on the bf16 tensor cores. Bytes: a, pos, c, cent, W2 and
// out, a few hundred KB per object. Operations bound it; this first kernel
// runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;   // centroids per CTA
constexpr int ROWS = 8;    // neighbour rows per register tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// fma(z2, z2, fma(y2, y2, x1 * x2)) with every step rounded as XLA's CPU
// backend rounds it.
__device__ __forceinline__ float dot3(float x1, float y1, float z1, float x2,
                                      float y2, float z2) {
  return __fmaf_rn(z1, z2, __fmaf_rn(y1, y2, __fmul_rn(x1, x2)));
}

template <typename T, int J>
__global__ void __launch_bounds__(WARPS * 32)
pointconv_max_kernel(const T* __restrict__ a,        // [B, N, C1]
                     const float* __restrict__ pos,  // [B, N, 3]
                     const T* __restrict__ c,        // [B, S, C1]
                     const float* __restrict__ cent, // [B, S, 3]
                     const float* __restrict__ s0,   // [C1] BN0 scale
                     const float* __restrict__ t0,   // [C1] BN0 shift
                     const T* __restrict__ w2,       // [C1, C2]
                     const float* __restrict__ b2,   // [C2]
                     const float* __restrict__ s1,   // [C2] BN1 scale
                     const float* __restrict__ t1,   // [C2] BN1 shift
                     T* __restrict__ out,            // [B, S, C2]
                     int N, int S, int C1, int C2, float r2, int k_cap) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= S) return;  // whole warp; no CTA-wide barrier follows

  float* H = smem + warp * ROWS * C1;                       // [ROWS][C1]
  float* runmax = smem + WARPS * ROWS * C1 + warp * C2;     // [C2]
  int* nbr = reinterpret_cast<int*>(smem + WARPS * ROWS * C1 + WARPS * C2)
             + warp * 32;                                   // [32]

  // Ball query: the first k_cap in-ball points by index.
  const float* cp = cent + ((size_t)b * S + s) * 3;
  const float cx = cp[0], cy = cp[1], cz = cp[2];
  const float a2 = dot3(cx, cy, cz, cx, cy, cz);
  const float* pb = pos + (size_t)b * N * 3;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int base = 0; base < N && cnt < k_cap; base += 32) {
    const int n = base + lane;
    bool in = false;
    if (n < N) {
      const float px = pb[n * 3], py = pb[n * 3 + 1], pz = pb[n * 3 + 2];
      const float b2n = dot3(px, py, pz, px, py, pz);
      const float ab = dot3(cx, cy, cz, px, py, pz);
      const float d2 = fmaxf(__fadd_rn(__fsub_rn(a2, __fmul_rn(2.0f, ab)), b2n),
                             0.0f);
      in = d2 <= r2;
    }
    const unsigned m = __ballot_sync(FULL, in);
    const int rank = cnt + __popc(m & below);
    if (in && rank < k_cap) nbr[rank] = n;
    cnt += __popc(m);
  }
  cnt = min(cnt, k_cap);
  for (int j = lane; j < C2; j += 32) runmax[j] = -INFINITY;
  __syncwarp();

  const T* crow = c + ((size_t)b * S + s) * C1;
  const T* ab_ = a + (size_t)b * N * C1;
  for (int r0 = 0; r0 < cnt; r0 += ROWS) {
    const int nrows = min(ROWS, cnt - r0);
    // Rows h = relu(BN0(a_n - c_s)); rows past the count are zero.
    for (int r = 0; r < ROWS; ++r) {
      float* hr = H + r * C1;
      if (r < nrows) {
        const T* arow = ab_ + (size_t)nbr[r0 + r] * C1;
        for (int ch = lane; ch < C1; ch += 32) {
          const float d = __fsub_rn(to_f(arow[ch]), to_f(crow[ch]));
          const float h = rnd<T>(__fadd_rn(__fmul_rn(d, s0[ch]), t0[ch]));
          hr[ch] = fmaxf(h, 0.0f);
        }
      } else {
        for (int ch = lane; ch < C1; ch += 32) hr[ch] = 0.0f;
      }
    }
    __syncwarp();

    for (int ct = 0; ct < C2; ct += 32 * J) {
      float acc[ROWS][J];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[r][j] = 0.0f;
      const T* wcol = w2 + ct + lane;
      for (int ch = 0; ch < C1; ch += 4) {
        float4 hv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          hv[r] = *reinterpret_cast<const float4*>(H + r * C1 + ch);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            w[j] = to_f(wcol[(size_t)(ch + q) * C2 + 32 * j]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float hq = q == 0 ? hv[r].x : q == 1 ? hv[r].y
                           : q == 2 ? hv[r].z : hv[r].w;
#pragma unroll
            for (int j = 0; j < J; ++j) acc[r][j] = __fmaf_rn(hq, w[j], acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = ct + lane + 32 * j;
        const float bj = b2[col], sj = s1[col], tj = t1[col];
        float m = runmax[col];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nrows) {
            const float z = __fadd_rn(rnd<T>(acc[r][j]), bj);
            const float y = __fadd_rn(__fmul_rn(z, sj), tj);
            m = fmaxf(m, fmaxf(y, 0.0f));
          }
        }
        runmax[col] = m;
      }
    }
    __syncwarp();
  }

  T* orow = out + ((size_t)b * S + s) * C2;
  for (int j = lane; j < C2; j += 32)
    orow[j] = from_f<T>(cnt > 0 ? runmax[j] : 0.0f);
}

template <typename T, int J>
int launch(const void* a, const void* pos, const void* c, const void* cent,
           const void* s0, const void* t0, const void* w2, const void* b2,
           const void* s1, const void* t1, void* out, int B, int N, int S,
           int C1, int C2, float r2, int k_cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)WARPS * ROWS * C1
                                       + (size_t)WARPS * C2)
                      + sizeof(int) * WARPS * 32;
  cudaError_t err = cudaFuncSetAttribute(
      pointconv_max_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + WARPS - 1) / WARPS, B);
  pointconv_max_kernel<T, J><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)a, (const float*)pos, (const T*)c, (const float*)cent,
      (const float*)s0, (const float*)t0, (const T*)w2, (const float*)b2,
      (const float*)s1, (const float*)t1, (T*)out, N, S, C1, C2, r2, k_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; 0 means the launch was accepted. C1 must be a
// multiple of 4 up to 512, C2 a multiple of 64 up to 1024, k_cap in
// [1, 32], B up to 65535 objects.
extern "C" int t2p_pointconv_max(const void* a, const void* pos, const void* c,
                                 const void* cent, const void* s0,
                                 const void* t0, const void* w2,
                                 const void* b2, const void* s1,
                                 const void* t1, void* out, int B, int N,
                                 int S, int C1, int C2, float r2, int k_cap,
                                 int bf16, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || S < 1 || C1 < 4 || C1 > 512 ||
      C1 % 4 || C2 < 64 || C2 > 1024 || C2 % 64 || k_cap < 1 || k_cap > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = C2 % 128 == 0;
  if (bf16)
    return wide ? launch<__nv_bfloat16, 4>(a, pos, c, cent, s0, t0, w2, b2, s1,
                                           t1, out, B, N, S, C1, C2, r2,
                                           k_cap, st)
                : launch<__nv_bfloat16, 2>(a, pos, c, cent, s0, t0, w2, b2, s1,
                                           t1, out, B, N, S, C1, C2, r2,
                                           k_cap, st);
  return wide ? launch<float, 4>(a, pos, c, cent, s0, t0, w2, b2, s1, t1, out,
                                 B, N, S, C1, C2, r2, k_cap, st)
              : launch<float, 2>(a, pos, c, cent, s0, t0, w2, b2, s1, t1, out,
                                 B, N, S, C1, C2, r2, k_cap, st);
}
