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
// Selection (both paths, ball_query below): a warp per centroid computes d2
// for 32 points at a time with the model's expansion a2 - 2ab + b2, the
// norms and the dot as XLA's CPU backend compiles them (fused multiply-adds
// in a fixed order), so the ball boundary is bit-identical to the JAX
// reference. __ballot_sync and popc(ballot & lanes below) give each in-ball
// point its exclusive rank; ranks < k_cap go to the warp's index list, and
// the warp stops after the pass of ballots that finds k_cap points.
//
// Bound. The second layer on the selected neighbours is 2 . B . S . K_valid
// . C1 . C2 operations (17.9-23.3 rows a centroid on the bench map): with
// row building and the epilogue in f32, 0.35 ms for the six launches of a
// 64-cell DB-encode step on the bf16 tensor cores, 3.7 ms at the f32 FMA
// rate. Bytes (a, pos, c, cent, W2, out) are a few hundred KB an object:
// operations bound it.
//
// bf16 (namespace tc): tensor cores, mma.sync.m16n8k16, bf16 in, f32
// accumulation.
//  - Persistent CTAs, as many as fit on the card, stage W2 once in shared
//    memory in the B operand's fragment order (ops/pointconv.py
//    w2_fragments packs it, once a level in the model,
//    [C2/8, C1/16, 32 lanes, 4 bf16]: a warp's B load of one n-tile and
//    k-step is 256 contiguous bytes), then walk the centroids; W2 of sa3 is
//    128 KB, so no warp re-reads it from L2. Consecutive warps take
//    consecutive centroids of one object, whose rows of `a` stay in L1.
//  - A warp per centroid. Its rows h = relu(BN0(a_n - c_s)) are built in
//    f32 and rounded to bf16 into the warp's own 32-row tile of shared
//    memory (row stride C1 + 8 values, so ldmatrix is free of bank
//    conflicts); rows from the count up to the tile's end are zero.
//  - The product: the centroid's rows as one or two 16-row m-tiles (two
//    when it has more than 16 neighbours), 64 output columns a pass (8
//    n-tiles, 32 or 64 accumulators), A by ldmatrix.x4, B from shared
//    memory, one B load serving both m-tiles.
//  - Epilogue, per pass: the max over the lane's valid rows of the product
//    (of its negation where BN1's scale is negative: the epilogue is
//    monotone), then over the 8 row groups by a reduce-scatter of xor
//    shuffles (7 a column pair, not 24) that leaves n-tile g with lane
//    (g, t); that lane rounds the product to bf16, adds b2, applies BN1
//    and ReLU and writes columns 2t, 2t + 1 of n-tile g, 128 contiguous
//    bytes a pass.
//  Each centroid owns its m-tiles, padded to 16 or 32 rows: about 1.6x the
//  multiply-adds the bound counts, against packing several centroids' rows
//  into shared tiles with a segmented max across lanes and tiles. The
//  padded layout keeps the max inside one fragment and seven shuffles and
//  the warps independent (no barrier after staging W2), at a bound of 0.35
//  ms a step.
//  Rounding is the JAX package's compiled model's (XLA keeps f32 between
//  matmuls): a - c and BN0 in f32, BN0's output rounded as the second
//  layer's input, the product (f32 accumulation) rounded, then bias, BN1,
//  ReLU and the max in f32; the output rounded to bf16.
//  C1 is one of 16, 32, 64, 128, 256, C2 a multiple of 64, C1 . C2 <= 65536
//  (W2 at most 128 KB, so at least 5 warps of rows fit beside it).
//
// f32 (namespace f32): f32 FMAs on the CUDA cores, one CTA of 8 warps per
// (object, tile of 8 centroids), a warp a centroid. It is the path held to
// the JAX package at 1e-4. Every output is one fmaf chain over C1 from 0,
// then bias, BN1, ReLU and the running max over rows (exact in any order),
// so the outputs are bit-identical to the form before this one's.
//  - Selection: ball_query<4>. Rows in 8-row tiles in the warp's shared
//    memory; the 2-column form builds them from 16-byte pieces, two a lane
//    in flight; the 4-column form with W2 up to 64 KB closes a centroid
//    with a 4-row tile where at most 4 rows remain (17.9-23.3 a centroid).
//  - Each lane computes 8 (or 4) rows x J consecutive output columns (J =
//    4, or 2 when C2 is not a multiple of 128), W2 one 16- or 8-byte load
//    through L1 a row of k that the CTA's 8 warps share (W2 of sa3 is 256
//    KB in f32). BN1, ReLU and the running max finish each column pass.
// Measured on an NVIDIA H100 80GB HBM3 (700 W;
// scripts/check_pointconv_kernel.py --f32, the DB step's six levels): 9.86
// ms against 10.89 before (bound 3.70); clocks at sa3 88% the product with
// its epilogue, 11% rows; at sa1 56%, 26%, 16% selection; W2 from shared
// memory saves at most 6%. Its CTAs keep W2 and the object's rows of a in
// L1 (two to three CTAs an SM at 64-93 registers); tried and slower
// (PERF.md §6): persistent CTAs holding a 128-column slice of W2 in
// shared memory over 64-row tiles of 32 centroids' rows (12.84 ms: one CTA
// an SM and the rows' gathers from L2), and this form with 171 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "mma_bf16.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// fma(z2, z2, fma(y2, y2, x1 * x2)) with every step rounded as XLA's CPU
// backend rounds it.
__device__ __forceinline__ float dot3(float x1, float y1, float z1, float x2,
                                      float y2, float z2) {
  return __fmaf_rn(z1, z2, __fmaf_rn(y1, y2, __fmul_rn(x1, x2)));
}

// The first k_cap in-ball points of centroid cp by index into the warp's
// nbr[32]; returns their count (the same in every lane). U ballots of 32
// points a pass: their loads and distances do not depend on each other, so
// they overlap; the warp stops after the pass that finds k_cap points. Both
// kernels take U = 4 (a third less time in the bf16 kernel's selection).
template <int U>
__device__ __forceinline__ int ball_query(const float* __restrict__ pb,
                                          const float* __restrict__ cp, int N,
                                          float r2, int k_cap, int* nbr) {
  const int lane = threadIdx.x & 31;
  const float cx = cp[0], cy = cp[1], cz = cp[2];
  const float a2 = dot3(cx, cy, cz, cx, cy, cz);
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int base = 0; base < N && cnt < k_cap; base += 32 * U) {
    unsigned m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = base + 32 * u + lane;
      bool in = false;
      if (n < N) {
        const float px = pb[n * 3], py = pb[n * 3 + 1], pz = pb[n * 3 + 2];
        const float b2n = dot3(px, py, pz, px, py, pz);
        const float ab = dot3(cx, cy, cz, px, py, pz);
        const float d2 = fmaxf(
            __fadd_rn(__fsub_rn(a2, __fmul_rn(2.0f, ab)), b2n), 0.0f);
        in = d2 <= r2;
      }
      m[u] = __ballot_sync(FULL, in);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rank = cnt + __popc(m[u] & below);
      if ((m[u] >> lane & 1u) && rank < k_cap) nbr[rank] = base + 32 * u + lane;
      cnt += __popc(m[u]);
    }
  }
  __syncwarp();
  return min(cnt, k_cap);
}

// relu(BN1(round(product) + b2)) of one output value. Each step rounds
// monotonically, so it is non-decreasing in the product where the BN1 scale
// s >= 0 and non-increasing where s < 0.
__device__ __forceinline__ float epilogue(float acc, float b, float s,
                                          float t) {
  const float z = __fadd_rn(rnd(acc), b);
  return fmaxf(__fadd_rn(__fmul_rn(z, s), t), 0.0f);
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
namespace tc {

constexpr int MAX_WARPS = 8;
constexpr int NT = 8;  // n-tiles (64 output columns) a pass

// With -DT2P_STAGE_CLOCKS every warp adds up the clocks it spends in each
// stage and its first lane adds them to g_stage_clocks when the warp ends:
// the card's tools cannot look inside a kernel.
// scripts/check_pointconv_kernel.py builds and reads it.
constexpr int N_STAGES = 5;  // W2 staging, selection, rows, product, epilogue
#ifdef T2P_STAGE_CLOCKS
__device__ unsigned long long g_stage_clocks[N_STAGES];
struct StageClocks {
  long long t0;
  unsigned long long sum[N_STAGES];
  __device__ StageClocks() {
    t0 = clock64();
    for (int i = 0; i < N_STAGES; ++i) sum[i] = 0;
  }
  __device__ void mark(int i) {
    __syncwarp();
    const long long t = clock64();
    sum[i] += (unsigned long long)(t - t0);
    t0 = t;
  }
  __device__ void flush() const {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < N_STAGES; ++i) atomicAdd(&g_stage_clocks[i], sum[i]);
  }
};
#else
struct StageClocks {
  __device__ void mark(int) {}
  __device__ void flush() const {}
};
#endif

template <int C1>
constexpr size_t warp_bytes() {  // a warp's 32 rows and its index list
  return 32 * (C1 + 8) * sizeof(__nv_bfloat16) + 32 * sizeof(int);
}

// One centroid's product and epilogue: rows [0, 16·TILES) of A (cnt valid)
// times W (fragment order), out[C2] in bf16.
template <int C1, int TILES>
__device__ __forceinline__ void mlp(const uint2* W, uint32_t abase, int C2,
                                    int cnt, const float* __restrict__ b2,
                                    const float* __restrict__ s1,
                                    const float* __restrict__ t1,
                                    __nv_bfloat16* __restrict__ orow,
                                    StageClocks& clk) {
  constexpr int KS = C1 / 16, LDA = C1 + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int nc = 0; nc < C2 / (8 * NT); ++nc) {
    float acc[TILES][NT][4];
#pragma unroll
    for (int m = 0; m < TILES; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
    const uint2* wp = W + (size_t)nc * NT * KS * 32 + lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[TILES][4];
#pragma unroll
      for (int m = 0; m < TILES; ++m)
        ldmatrix_x4(af[m], abase + 2u * (m * 16 * LDA + ks * 16));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 bf = wp[(j * KS + ks) * 32];
#pragma unroll
        for (int m = 0; m < TILES; ++m) mma_bf16(acc[m][j], af[m], bf.x, bf.y);
      }
    }
    clk.mark(3);
    // Lane (g, t) holds rows 16m + g and 16m + g + 8, columns 2t, 2t + 1 of
    // each n-tile. The epilogue is monotone in the product (see epilogue),
    // so the max over the valid rows of its value is its value at the
    // largest product, or at the smallest where BN1's scale is negative:
    // the max of +-product (negation is exact), then one epilogue a column.
    float v0[NT], v1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 s = __ldg(reinterpret_cast<const float2*>(
          s1 + (nc * NT + j) * 8 + 2 * t));
      const float g0 = s.x < 0.0f ? -1.0f : 1.0f;
      const float g1 = s.y < 0.0f ? -1.0f : 1.0f;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int m = 0; m < TILES; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (16 * m + 8 * h + g < cnt) {
            m0 = fmaxf(m0, g0 * acc[m][j][2 * h]);
            m1 = fmaxf(m1, g1 * acc[m][j][2 * h + 1]);
          }
      v0[j] = m0, v1[j] = m1;
    }
    // The max over the 8 row groups, scattered: at each xor step a lane
    // keeps half of its n-tiles and takes its partner's values of them
    // (4 + 2 + 1 shuffles a column, not 3 per n-tile); lane g ends with
    // n-tile g.
#pragma unroll
    for (int half = NT / 2; half >= 1; half >>= 1) {
      const int off = 4 * half;  // lane bit of g's bit log2(half)
      const bool hi = (lane & off) != 0;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float k0 = hi ? v0[k + half] : v0[k];
        const float k1 = hi ? v1[k + half] : v1[k];
        const float o0 = __shfl_xor_sync(FULL, hi ? v0[k] : v0[k + half], off);
        const float o1 = __shfl_xor_sync(FULL, hi ? v1[k] : v1[k + half], off);
        v0[k] = fmaxf(k0, o0), v1[k] = fmaxf(k1, o1);
      }
    }
    const int col = (nc * NT + g) * 8 + 2 * t;  // row 0 is valid: finite v
    const float2 s = __ldg(reinterpret_cast<const float2*>(s1 + col));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
    const float2 tt = __ldg(reinterpret_cast<const float2*>(t1 + col));
    *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
        epilogue(s.x < 0.0f ? -v0[0] : v0[0], bb.x, s.x, tt.x),
        epilogue(s.y < 0.0f ? -v1[0] : v1[0], bb.y, s.y, tt.y));
    clk.mark(4);
  }
}

// At most 128 registers where shared memory lets two CTAs of 8 warps share
// an SM (C1 up to 128); at C1 = 256, W2 leaves room for one CTA only.
template <int C1>
__global__ void __launch_bounds__(MAX_WARPS * 32, C1 < 256 ? 2 : 1)
pointconv_kernel(const __nv_bfloat16* __restrict__ a,  // [B, N, C1]
                 const float* __restrict__ pos,         // [B, N, 3]
                 const __nv_bfloat16* __restrict__ c,   // [B, S, C1]
                 const float* __restrict__ cent,        // [B, S, 3]
                 const float* __restrict__ s0,          // [C1] BN0 scale
                 const float* __restrict__ t0,          // [C1] BN0 shift
                 const uint4* __restrict__ w2f,         // W2, fragment order
                 const float* __restrict__ b2,          // [C2]
                 const float* __restrict__ s1,          // [C2] BN1 scale
                 const float* __restrict__ t1,          // [C2] BN1 shift
                 __nv_bfloat16* __restrict__ out,       // [B, S, C2]
                 int B, int N, int S, int C2, float r2, int k_cap) {
  constexpr int LDA = C1 + 8;
  constexpr int CH = C1 / 8;    // 16-byte chunks a row
  constexpr int RPI = 32 / CH;  // rows a warp builds at once
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  StageClocks clk;

  const size_t wbytes = (size_t)C1 * C2 * sizeof(__nv_bfloat16);
  {
    uint4* dst = reinterpret_cast<uint4*>(tc_smem);
    for (int i = threadIdx.x; i < (int)(wbytes / 16); i += blockDim.x)
      dst[i] = __ldg(w2f + i);
  }
  __syncthreads();  // the only CTA-wide barrier
  clk.mark(0);
  const uint2* W = reinterpret_cast<const uint2*>(tc_smem);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(tc_smem + wbytes) +
                     (size_t)warp * 32 * LDA;
  int* nbr = reinterpret_cast<int*>(tc_smem + wbytes +
                                    (size_t)warps * 32 * LDA * 2) + warp * 32;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k + 8.
  const uint32_t abase = smem_addr(A + (lane & 15) * LDA + ((lane >> 4) << 3));

  const int ch = (lane % CH) * 8;  // this lane's 8 channels of every row

  const long long items = (long long)B * S;
  for (long long item = (long long)blockIdx.x * warps + warp; item < items;
       item += (long long)gridDim.x * warps) {
    const int b = (int)(item / S);
    const int cnt = ball_query<4>(pos + (size_t)b * N * 3, cent + item * 3, N,
                                  r2, k_cap, nbr);
    clk.mark(1);
    __nv_bfloat16* orow = out + item * C2;
    if (cnt == 0) {
      for (int j = lane; j < C2 / 2; j += 32)
        reinterpret_cast<__nv_bfloat162*>(orow)[j] =
            __floats2bfloat162_rn(0.0f, 0.0f);
      continue;
    }
    const int rows = cnt > 16 ? 32 : 16;

    // The neighbours' rows of a, all in flight at once: each lane copies
    // its 16-byte chunks into the tile (cp.async, no registers held) and
    // later transforms the same chunks, so no other lane waits on them.
    const __nv_bfloat16* ab = a + (size_t)b * N * C1 + ch;
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += RPI) {
      const int r = r0 + lane / CH;
      if (r < cnt) cp_async16(A + r * LDA + ch, ab + (size_t)nbr[r] * C1);
    }
    cp_async_wait_all();
    // Rows h = relu(BN0(a_n - c_s)), rounded to bf16; zero past the count.
    // c and BN0 are read again for each centroid (from L1): held across
    // the product they would cost 24 registers.
    float cv[8], sv[8], tv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(c + item * C1 + ch)), cv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sv[e] = __ldg(s0 + ch + e), tv[e] = __ldg(t0 + ch + e);
#pragma unroll 4
    for (int r0 = 0; r0 < rows; r0 += RPI) {
      const int r = r0 + lane / CH;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < cnt) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(A + r * LDA + ch), f);
        // relu before the rounding: rounding is monotone and keeps 0, so
        // the packed value is the same, one conversion fewer.
        float h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(f[e], cv[e]), sv[e]),
                                 tv[e]), 0.0f);
        v = make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]),
                       pack2(h[6], h[7]));
      }
      *reinterpret_cast<uint4*>(A + r * LDA + ch) = v;
    }
    __syncwarp();
    clk.mark(2);
    if (rows == 32)
      mlp<C1, 2>(W, abase, C2, cnt, b2, s1, t1, orow, clk);
    else
      mlp<C1, 1>(W, abase, C2, cnt, b2, s1, t1, orow, clk);
    __syncwarp();  // A and nbr are rewritten for the next centroid
  }
  clk.flush();
}

// A launch's shape for one (device, C2): the warps a CTA (as many as fit
// beside W2, at most MAX_WARPS), its shared memory and the most CTAs that
// are resident at once. Worked out on the first call (device attributes,
// the function attribute, the occupancy query) and then read from a table:
// the encode launches this kernel a few hundred times a second.
struct Shape {
  int warps;
  size_t smem;
  long long resident;
};

template <int C1>
int shape(int C2, Shape* out) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, Shape> known;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({dev, C2});
  if (it != known.end()) {
    *out = it->second;
    return 0;
  }
  int smem_max, sms;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t wbytes = (size_t)C1 * C2 * sizeof(__nv_bfloat16);
  const long long fit = ((long long)smem_max - (long long)wbytes) /
                        (long long)warp_bytes<C1>();
  const int warps = (int)(fit < MAX_WARPS ? fit : MAX_WARPS);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = wbytes + warps * warp_bytes<C1>();
  // The function's limit is the device's, not this C2's: a smaller C2
  // worked out later must not lower it under a larger one in the table.
  err = cudaFuncSetAttribute(pointconv_kernel<C1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pointconv_kernel<C1>, warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const Shape sh{warps, smem, (long long)per_sm * sms};
  known.emplace(std::make_pair(dev, C2), sh);
  *out = sh;
  return 0;
}

template <int C1>
int launch(const void* a, const void* pos, const void* c, const void* cent,
           const void* s0, const void* t0, const void* w2f, const void* b2,
           const void* s1, const void* t1, void* out, int B, int N, int S,
           int C2, float r2, int k_cap, cudaStream_t stream) {
  Shape sh;
  const int err = shape<C1>(C2, &sh);
  if (err) return err;
  const long long items = (long long)B * S;
  const long long want = (items + sh.warps - 1) / sh.warps;
  const int grid = (int)(want < sh.resident ? want : sh.resident);
  pointconv_kernel<C1><<<grid, sh.warps * 32, sh.smem, stream>>>(
      (const __nv_bfloat16*)a, (const float*)pos, (const __nv_bfloat16*)c,
      (const float*)cent, (const float*)s0, (const float*)t0,
      (const uint4*)w2f, (const float*)b2, (const float*)s1, (const float*)t1,
      (__nv_bfloat16*)out, B, N, S, C2, r2, k_cap);
  return (int)cudaGetLastError();
}

int run(const void* a, const void* pos, const void* c, const void* cent,
        const void* s0, const void* t0, const void* w2f, const void* b2,
        const void* s1, const void* t1, void* out, int B, int N, int S, int C1,
        int C2, float r2, int k_cap, cudaStream_t st) {
  if (C2 % 64 || C1 * C2 > 65536) return (int)cudaErrorInvalidValue;
  switch (C1) {
    case 16: return launch<16>(a, pos, c, cent, s0, t0, w2f, b2, s1, t1, out,
                               B, N, S, C2, r2, k_cap, st);
    case 32: return launch<32>(a, pos, c, cent, s0, t0, w2f, b2, s1, t1, out,
                               B, N, S, C2, r2, k_cap, st);
    case 64: return launch<64>(a, pos, c, cent, s0, t0, w2f, b2, s1, t1, out,
                               B, N, S, C2, r2, k_cap, st);
    case 128: return launch<128>(a, pos, c, cent, s0, t0, w2f, b2, s1, t1, out,
                                 B, N, S, C2, r2, k_cap, st);
    case 256: return launch<256>(a, pos, c, cent, s0, t0, w2f, b2, s1, t1, out,
                                 B, N, S, C2, r2, k_cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ------------------------------------------------------------------------
// f32: CUDA cores
// ------------------------------------------------------------------------
namespace f32 {

constexpr int WARPS = 8;   // centroids per CTA
constexpr int ROWS = 8;    // neighbour rows per register tile

// The 4-column form (C2 a multiple of 128) closes a centroid's rows with a
// 4-row tile where at most 4 remain, while W2 is at most this many values
// (64 KB: past it W2's reads from L2 outweigh the FMAs saved, and the
// 4-row code alone, never run, slowed sa3's kernel by 5%).
constexpr int REM_MAX_W2 = 16384;

// With -DT2P_STAGE_CLOCKS every warp adds up the clocks it spends in each
// stage, as the bf16 kernel's do (selection, rows, the product with its
// epilogue, the output).
#ifdef T2P_STAGE_CLOCKS
constexpr int N_STAGES = 4;
__device__ unsigned long long g_stage_clocks[N_STAGES];
struct StageClocks {
  long long t0;
  unsigned long long sum[N_STAGES];
  __device__ StageClocks() {
    t0 = clock64();
    for (int i = 0; i < N_STAGES; ++i) sum[i] = 0;
  }
  __device__ void mark(int i) {
    __syncwarp();
    const long long t = clock64();
    sum[i] += (unsigned long long)(t - t0);
    t0 = t;
  }
  __device__ void flush() const {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < N_STAGES; ++i) atomicAdd(&g_stage_clocks[i], sum[i]);
  }
};
#else
struct StageClocks {
  __device__ void mark(int) {}
  __device__ void flush() const {}
};
#endif

// W2 row k at a lane's J consecutive columns from ct + lane·J, one vector
// load: from L2 through L1, or (the timing build) from shared memory.
template <int J>
__device__ __forceinline__ void ldw(const float* w2, const float* smem, int k,
                                    int C2, int ct, int lane, float (&w)[J]) {
#ifdef T2P_PC_W2_SMEM
  const float* src = smem + ((k * C2 + ct + lane * J) & 2047);
#pragma unroll
  for (int j = 0; j < J; ++j) w[j] = src[j];
#else
  const float* src = w2 + (size_t)k * C2 + ct + lane * J;
  if constexpr (J == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(src));
    w[0] = v.x, w[1] = v.y;
  }
#endif
}

// One column pass of an R-row tile: the product of H's R rows (C1 wide)
// with W2's pass columns, each an fmaf chain over C1 from 0, and the
// epilogue of its nrows valid rows into the running max.
template <int J, int R>
__device__ __forceinline__ void tile_pass(
    const float* H, const float* __restrict__ w2, const float* smem, int C1,
    int C2, int ct, int nrows, const float* __restrict__ b2,
    const float* __restrict__ s1, const float* __restrict__ t1,
    float* runmax, int lane) {
  float acc[R][J];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[r][j] = 0.0f;
  for (int ch = 0; ch < C1; ch += 4) {
    float4 hv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      hv[r] = *reinterpret_cast<const float4*>(H + r * C1 + ch);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[J];
      ldw<J>(w2, smem, ch + q, C2, ct, lane, w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hq = q == 0 ? hv[r].x : q == 1 ? hv[r].y
                       : q == 2 ? hv[r].z : hv[r].w;
#pragma unroll
        for (int j = 0; j < J; ++j) acc[r][j] = __fmaf_rn(hq, w[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = ct + lane * J + j;
    const float bj = b2[col], sj = s1[col], tj = t1[col];
    float m = runmax[col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        const float z = __fadd_rn(acc[r][j], bj);
        const float y = __fadd_rn(__fmul_rn(z, sj), tj);
        m = fmaxf(m, fmaxf(y, 0.0f));
      }
    }
    runmax[col] = m;
  }
}

// A tile's R rows h = relu(BN0(a_n - c_s)) of the neighbours nbr[0 ..
// nrows) into H; rows from nrows on are zero. The 2-column form takes them
// in 16-byte pieces, two a lane in flight at once; in the 4-column form
// that cost registers (115 a thread) and time at sa3, so it takes a
// channel a lane.
template <int J>
__device__ __forceinline__ void build_rows(
    float* H, const float* __restrict__ ab_, const float* __restrict__ crow,
    const float* __restrict__ s0, const float* __restrict__ t0,
    const int* nbr, int C1, int R, int nrows, int lane) {
  if constexpr (J == 2) {
    const int quads = C1 / 4;
    for (int it0 = lane; it0 < R * quads; it0 += 2 * 32) {
      float4 av[2], cv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int it = it0 + 32 * u, r = it / quads, k = 4 * (it - r * quads);
        if (it < R * quads && r < nrows) {
          av[u] = __ldg(reinterpret_cast<const float4*>(
              ab_ + (size_t)nbr[r] * C1 + k));
          cv[u] = __ldg(reinterpret_cast<const float4*>(crow + k));
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int it = it0 + 32 * u, r = it / quads, k = 4 * (it - r * quads);
        if (it < R * quads) {
          float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (r < nrows) {
            const float4 sv = __ldg(reinterpret_cast<const float4*>(s0 + k));
            const float4 tv = __ldg(reinterpret_cast<const float4*>(t0 + k));
            h.x = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(av[u].x, cv[u].x),
                                            sv.x), tv.x), 0.0f);
            h.y = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(av[u].y, cv[u].y),
                                            sv.y), tv.y), 0.0f);
            h.z = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(av[u].z, cv[u].z),
                                            sv.z), tv.z), 0.0f);
            h.w = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(av[u].w, cv[u].w),
                                            sv.w), tv.w), 0.0f);
          }
          *reinterpret_cast<float4*>(H + r * C1 + k) = h;
        }
      }
    }
  } else {
    for (int r = 0; r < R; ++r) {
      float* hr = H + r * C1;
      if (r < nrows) {
        const float* arow = ab_ + (size_t)nbr[r] * C1;
        for (int ch = lane; ch < C1; ch += 32) {
          const float d = __fsub_rn(arow[ch], crow[ch]);
          hr[ch] = fmaxf(__fadd_rn(__fmul_rn(d, s0[ch]), t0[ch]), 0.0f);
        }
      } else {
        for (int ch = lane; ch < C1; ch += 32) hr[ch] = 0.0f;
      }
    }
  }
}

template <int J, bool REM>
__global__ void __launch_bounds__(WARPS * 32)
pointconv_kernel(const float* __restrict__ a,     // [B, N, C1]
                 const float* __restrict__ pos,   // [B, N, 3]
                 const float* __restrict__ c,     // [B, S, C1]
                 const float* __restrict__ cent,  // [B, S, 3]
                 const float* __restrict__ s0,    // [C1] BN0 scale
                 const float* __restrict__ t0,    // [C1] BN0 shift
                 const float* __restrict__ w2,    // [C1, C2]
                 const float* __restrict__ b2,    // [C2]
                 const float* __restrict__ s1,    // [C2] BN1 scale
                 const float* __restrict__ t1,    // [C2] BN1 shift
                 float* __restrict__ out,         // [B, S, C2]
                 int N, int S, int C1, int C2, float r2, int k_cap) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= S) return;  // whole warp; no CTA-wide barrier follows
  StageClocks clk;

  float* H = smem + warp * ROWS * C1;                       // [ROWS][C1]
  float* runmax = smem + WARPS * ROWS * C1 + warp * C2;     // [C2]
  int* nbr = reinterpret_cast<int*>(smem + WARPS * ROWS * C1 + WARPS * C2)
             + warp * 32;                                   // [32]

  const int cnt = ball_query<4>(pos + (size_t)b * N * 3,
                                cent + ((size_t)b * S + s) * 3, N, r2, k_cap,
                                nbr);
  for (int j = lane; j < C2; j += 32) runmax[j] = -INFINITY;
  __syncwarp();
  clk.mark(0);

  const float* crow = c + ((size_t)b * S + s) * C1;
  const float* ab_ = a + (size_t)b * N * C1;
  for (int r0 = 0; r0 < cnt; r0 += ROWS) {
    const int nrows = min(ROWS, cnt - r0);
    const int R = REM && nrows <= 4 ? 4 : ROWS;
    build_rows<J>(H, ab_, crow, s0, t0, nbr + r0, C1, R, nrows, lane);
    __syncwarp();
    clk.mark(1);

    for (int ct = 0; ct < C2; ct += 32 * J) {
      if constexpr (REM) {
        if (R == 4) {
          tile_pass<J, 4>(H, w2, smem, C1, C2, ct, nrows, b2, s1, t1, runmax,
                          lane);
          clk.mark(2);
          continue;
        }
      }
      tile_pass<J, ROWS>(H, w2, smem, C1, C2, ct, nrows, b2, s1, t1, runmax,
                         lane);
      clk.mark(2);
    }
    __syncwarp();
  }

  float* orow = out + ((size_t)b * S + s) * C2;
  for (int j = lane; j < C2; j += 32) orow[j] = cnt > 0 ? runmax[j] : 0.0f;
  clk.mark(3);
  clk.flush();
}

template <int J, bool REM>
int launch(const void* a, const void* pos, const void* c, const void* cent,
           const void* s0, const void* t0, const void* w2, const void* b2,
           const void* s1, const void* t1, void* out, int B, int N, int S,
           int C1, int C2, float r2, int k_cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)WARPS * ROWS * C1
                                       + (size_t)WARPS * C2)
                      + sizeof(int) * WARPS * 32;
  cudaError_t err = cudaFuncSetAttribute(
      pointconv_kernel<J, REM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + WARPS - 1) / WARPS, B);
  pointconv_kernel<J, REM><<<grid, WARPS * 32, smem, stream>>>(
      (const float*)a, (const float*)pos, (const float*)c, (const float*)cent,
      (const float*)s0, (const float*)t0, (const float*)w2, (const float*)b2,
      (const float*)s1, (const float*)t1, (float*)out, N, S, C1, C2, r2, k_cap);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Returns a cudaError_t; 0 means the launch was accepted. k_cap in [1, 32],
// B up to 65535 objects. f32: C1 a multiple of 4 up to 512, C2 a multiple
// of 64 up to 1024, W2 row-major [C1, C2], a, c, s0, t0 and W2 16-byte
// aligned. bf16: C1 one of 16, 32, 64, 128, 256, C2 a multiple of 64 up to
// 1024 with C1 . C2 <= 65536, W2 in fragment order (see the header).
#ifdef T2P_STAGE_CLOCKS
// Copies the bf16 kernel's summed stage clocks to out[5] (reset == 0) or
// sets them to zero. Synchronizes the device.
extern "C" int t2p_pointconv_stage_clocks(unsigned long long* out,
                                          int reset) {
  if (reset) {
    const unsigned long long zero[tc::N_STAGES] = {};
    return (int)cudaMemcpyToSymbol(tc::g_stage_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, tc::g_stage_clocks,
                                   tc::N_STAGES * sizeof(unsigned long long));
}

// The same for the f32 kernel's stages (out[4]).
extern "C" int t2p_pointconv_f32_stage_clocks(unsigned long long* out,
                                              int reset) {
  if (reset) {
    const unsigned long long zero[f32::N_STAGES] = {};
    return (int)cudaMemcpyToSymbol(f32::g_stage_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, f32::g_stage_clocks,
                                   f32::N_STAGES * sizeof(unsigned long long));
}
#endif

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
  if (bf16)
    return tc::run(a, pos, c, cent, s0, t0, w2, b2, s1, t1, out, B, N, S, C1,
                   C2, r2, k_cap, st);
  if (C2 % 128)
    return f32::launch<2, false>(a, pos, c, cent, s0, t0, w2, b2, s1, t1, out,
                                 B, N, S, C1, C2, r2, k_cap, st);
  return C1 * C2 <= f32::REM_MAX_W2
             ? f32::launch<4, true>(a, pos, c, cent, s0, t0, w2, b2, s1, t1,
                                    out, B, N, S, C1, C2, r2, k_cap, st)
             : f32::launch<4, false>(a, pos, c, cent, s0, t0, w2, b2, s1, t1,
                                     out, B, N, S, C1, C2, r2, k_cap, st);
}
