// SuperGlue attention GNN in eval mode with calibrated per-set BatchNorm:
// all 2·num_layers weight-shared self/cross blocks, the final projection and
// the [N, T0, T1] score matrix, one launch.
//
// Replaces the TPU kernel text2pos_tpu/ops/superglue_gnn_pallas.py:253
// (gnn_scores_pallas, body _gnn_kernel :103, parameters from
// fold_gnn_params :45). The TPU kernel stacks pairs along matrix rows and
// masks a cross-pair [R, R] score matrix, and pads hints 6 -> 16, to satisfy
// Mosaic's tiling; none of that is carried over. Here a CTA holds a few
// pose-cell pairs' token rows in shared memory for all blocks, and attention
// runs per pair over real tokens only.
//
// Per block l and pair, for both sets at once (the weights are shared):
//   qkv = a·[Wq|Wk|Wv] + b            a = the residual stream, rounded
//   msg = per head h (4 × 32 contiguous channels), per query row:
//         softmax_j(q·k_j / sqrt(32)) · v_j over the source set's rows
//         (self blocks: own set; cross blocks: the other set)
//   m   = msg·Wm + bm
//   h1  = relu(([a | m]·W0) * s0[set] + t0[set])   (BN folded per set)
//   res = res + (h1·W1 + b1)
// then md = a·Wf + bf and scores = md0·md1^T / sqrt(128).
//
// Precision follows the JAX eval path: the residual stream stays f32;
// matmul inputs and outputs are rounded to the compute dtype (bf16 or f32)
// where flax's Dense rounds them; softmax, scores and all accumulation are
// f32.
//
// Bound. About 89 MFLOP per pair (1.8 TFLOP at N=20480), 98% of it the five
// dense products of a block, against 14.3 KB of descriptors in and 384 B of
// scores out per pair: operations bound it, and in bf16 only the tensor
// cores reach them. Two kernels, chosen by the weights' dtype:
//
// bf16 (namespace tc): tensor cores, mma.sync.m16n8k16 with bf16 inputs and
// f32 accumulation. mma.sync was taken over wgmma because its fragments are
// plain registers with a documented layout: the epilogues (bias, per-set BN,
// ReLU, residual) run on the accumulators with no trip through shared
// memory, B fragments come straight from global memory, and the logits of
// the attention feed P·V without leaving the registers.
//  - A CTA holds G=4 pairs, rows set-major: 64 object rows (m-tiles 0-3),
//    then 24 hint rows and 8 zero rows (m-tiles 4-5). A tile belongs to one
//    set, so the BN affine is uniform per tile, and the 16 objects of a pair
//    are one tile.
//  - Every value the eval path rounds to bf16 is stored as bf16: per row
//    [rounded residual | merge output] (256) and q|k|v (384), beside the f32
//    residual (128): 1856 B a row with pads, 174 KB a CTA, one CTA an SM.
//    Messages overwrite q in place, h1 and the final projection overwrite
//    q|k. Row strides are 16 B (bf16) and 32 B (f32) past a multiple of
//    128 B, so ldmatrix and the epilogue stores are free of bank conflicts.
//  - 8 warps, each with up to 253 registers, each a strip of output columns
//    over all six m-tiles (144 accumulators for q|k|v). A weight element is
//    so read once per CTA (3.9 MB per CTA, 20 GB a launch at N=20480, from
//    L2). The host stores each weight in the order of the B fragments
//    (pack_gnn_params), so a warp's load of one n-tile and k-step is 256
//    contiguous bytes, 8 a lane, into a ring of registers 1-3 k-steps ahead;
//    a product's first steps are fetched before the barrier that releases
//    its input. A fragments come by ldmatrix.x4 through a ring of six
//    results, five m-tiles ahead of their MMAs. No weight is staged in
//    shared memory.
//  - Attention runs on the tensor cores too: a warp takes a (pair, head,
//    query set) as one 16x16 tile (QK^T, softmax in registers, P·V).
// Every row goes through the same instruction sequence whatever its place
// in a tile, so duplicate hints keep bit-identical score columns.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) with the stage clocks below,
// the time splits 24% q|k|v, 10% attention, 10% merge, 28% W0, 24% W1, 3%
// loading the descriptors. What holds it back: each of the 8 warps reads
// all of A (8x redundant ldmatrix traffic, which takes the shared-memory
// pipe about as long as the MMAs take the tensor cores), and five barriers
// a block with only two warps a scheduler to hide them.
//
// f32 (namespace f32): f32 FMAs on the CUDA cores. It is the path whose
// top-k equals the JAX package's exactly; TF32 would break that. Every
// product output is one fmaf chain over k from 0 in ascending order, then
// its epilogue, and the attention keeps the plain version's dot, softmax
// and message chains, so no layout choice below moves a score by a bit.
//  - G = 4 pairs a CTA (88 rows, 256 threads), or 2 or 1 where fewer pairs
//    would leave SMs idle (pairs_per_cta: the evaluator's 80-pair chunks
//    take one a CTA). A row holds no second copy of the residual: [residual
//    | k, then m | q, then the messages, h1, the final projection | v, then
//    h1's second half], 516 floats, 181,632 bytes at G = 4.
//  - A thread owns 11 rows (half a pair) x G columns of each 128-column
//    pass, 44 accumulators at G = 4; a row's next 4 k-values are loaded as
//    soon as the current ones are taken.
//  - Each warp's 16 weight columns stream from L2 by cp.async into a ring
//    of 8 k-groups in shared memory of its own, 7 ahead, ordered by
//    __syncwarp alone, so the copies run on across the CTA's barriers.
//  - Attention: a thread per (head, query row), messages written over q.
// Measured on an NVIDIA H100 80GB HBM3 (700 W; scripts/check_gnn_kernel.py
// --f32 and ab_kernel_times.py against the form before it): 52.24 ms at
// 20,480 pairs x 12 blocks (before: 79.25; bound 27.13, 52%), 117.64 at
// 262,144 x 2 (182.61), 0.624 at 80 x 12 (1.040); clocks q|k|v 26.8%,
// attention 7.4%, merge 9.2%, W0 36.5%, W1 18.7%; weights from a tile
// already in shared memory -7.1%, no attention -7.3%. 230 registers at G =
// 4, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int E = 128;       // descriptor width
constexpr int HEADS = 4;
constexpr int D = E / HEADS;  // 32
constexpr int T0 = 16;       // objects per cell
constexpr int T1 = 6;        // hints per query

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
namespace tc {

constexpr int G = 4;               // pairs per CTA
constexpr int OBJ = G * T0;        // 64 object rows, m-tiles 0..3
constexpr int HINT = G * T1;       // 24 hint rows from row OBJ on
constexpr int ROWS = 96;           // rows 88..95 stay padding
constexpr int MT = ROWS / 16;      // 6 m-tiles, every warp owns all of them
constexpr int NT = 256;            // threads per CTA
constexpr int WARPS = NT / 32;     // 8 strips of output columns
static_assert(OBJ + HINT <= ROWS && ROWS % 16 == 0 && MT % 2 == 0,
              "row layout");
static_assert(2 * G * HEADS % WARPS == 0, "attention units per warp");

constexpr int LDR = E + 8;         // f32 residual stream, 544 B a row
constexpr int LDA = 2 * E + 8;     // bf16 [rounded residual | merge], 528 B
constexpr int LDQ = 3 * E + 8;     // bf16 q|k|v, then h1, then md, 784 B
constexpr size_t SMEM_BYTES =
    (size_t)ROWS * (LDR * sizeof(float) + (LDA + LDQ) * sizeof(__nv_bfloat16));

// With -DT2P_STAGE_CLOCKS the kernel adds up, over all CTAs, the clocks its
// first thread spends in each stage (a barrier closes a stage, so a stage
// ends when its slowest warp does): the card's tools cannot look inside a
// kernel. scripts/check_gnn_kernel.py --stages builds and reads it.
#ifdef T2P_STAGE_CLOCKS
constexpr int N_STAGES = 8;  // load, qkv, attention, merge, W0, W1, final, scores
__device__ unsigned long long g_stage_clocks[N_STAGES];
#define STAGE_BEGIN long long stage_t0 = clock64();
#define STAGE(i)                                                          \
  {                                                                       \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      const long long t = clock64();                                      \
      atomicAdd(&g_stage_clocks[i], (unsigned long long)(t - stage_t0));  \
      stage_t0 = t;                                                       \
    }                                                                     \
  }
#else
#define STAGE_BEGIN
#define STAGE(i)
#endif

struct Weights {
  // Matmul weights in fragment order, [.., N/8, K/16, 32 lanes] uint2.
  const uint2* wqkv;  // [L, 3E/8, E/16, 32]
  const float* bqkv;  // [L, 3E]
  const uint2* wm;    // [L, E/8, E/16, 32]
  const float* bm;    // [L, E]
  const uint2* w0;    // [L, 2E/8, 2E/16, 32]
  const float* s0;    // [L, 2, 2E]
  const float* t0;    // [L, 2, 2E]
  const uint2* w1;    // [L, E/8, 2E/16, 32]
  const float* b1;    // [L, E]
  const uint2* wf;    // [E/8, E/16, 32]
  const float* bf;    // [E]
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// A warp's B fragments of its NTW n-tiles: a ring of RB k-steps (16 k-values
// each), so that RB − 1 steps of weights are in flight from L2 while one
// multiplies.
template <int NTW, int RB>
struct BRing {
  uint2 b[RB][NTW];
};

template <int NTW, int K>
__device__ __forceinline__ void load_b(const uint2* __restrict__ W, int ks,
                                       uint2 (&b)[NTW]) {
  const uint2* wp =
      W + (size_t)((threadIdx.x >> 5) * NTW) * (K / 16) * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < NTW; ++j) b[j] = __ldg(wp + (j * (K / 16) + ks) * 32);
}

// The first RB − 1 steps, fetched before the barrier that precedes the
// product so that their latency overlaps the stage before.
template <int NTW, int K, int RB>
__device__ __forceinline__ void prefetch_b(const uint2* __restrict__ W,
                                           BRing<NTW, RB>& ring) {
#pragma unroll
  for (int ks = 0; ks < RB - 1; ++ks) load_b<NTW, K>(W, ks, ring.b[ks]);
}

// out[ROWS, 8·NTW·WARPS] = X[ROWS, K] (shared bf16, row stride ldx) · W
// (global, fragment order). Warp w owns all six m-tiles of n-tiles
// NTW·w .. NTW·w + NTW − 1, so each weight element is read once per CTA.
// The A fragments go through a ring of six ldmatrix results, written five
// m-tiles ahead of the MMAs that use them; ptxas makes its own order of
// these loads (deeper rings, and a burst one k-step ahead, compiled to the
// same times). epi(row, col, v0, v1) takes the accumulators of (row, col)
// and (row, col + 1).
template <int NTW, int K, int RB, typename Epi>
__device__ __forceinline__ void gemm(const __nv_bfloat16* X, int ldx,
                                     const uint2* __restrict__ W,
                                     BRing<NTW, RB>& ring, Epi epi) {
  constexpr int KS = K / 16, RA = MT;
  static_assert(RB >= 2 && RB <= KS, "B ring depth");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k + 8.
  const uint32_t xaddr = smem_addr(X + (lane & 15) * ldx + ((lane >> 4) << 3));

  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

  // Step t = ks·MT + m multiplies m-tile m at k-step ks from slot t % RA.
  uint32_t a[RA][4];
#pragma unroll
  for (int t = 0; t < RA - 1; ++t)
    ldmatrix_x4(a[t], xaddr + 2u * ((t % MT) * 16 * ldx + (t / MT) * 16));
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks + RB - 1 < KS)
      load_b<NTW, K>(W, ks + RB - 1, ring.b[(ks + RB - 1) % RB]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // Refill the slot whose MMAs were issued last.
      const int t = ks * MT + m, tn = t + RA - 1;
      if (tn < KS * MT)
        ldmatrix_x4(a[tn % RA],
                    xaddr + 2u * ((tn % MT) * 16 * ldx + (tn / MT) * 16));
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        mma_bf16(acc[m][j], a[t % RA], ring.b[ks % RB][j].x,
                 ring.b[ks % RB][j].y);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int r = m * 16 + gid, c = (warp * NTW + j) * 8 + tig * 2;
      epi(r, c, acc[m][j][0], acc[m][j][1]);
      epi(r + 8, c, acc[m][j][2], acc[m][j][3]);
    }
}

// Attention on the warp: its UNITS (pair, head, query set) units in lock
// step, phase by phase, so that the units' MMAs, shuffles and ex2s can
// overlap (alone, a unit is one dependent chain). A unit is the nq query
// rows from qbase on against the nk rows of the source set from kbase on,
// as a 16x16
// tile whose spare rows and keys repeat the last real one (spare keys are
// masked, spare rows never stored; no branch depends on nq or nk). Logits
// QK^T (2 n-tiles x 2 k-steps), softmax in f32 in registers (a row's 16
// logits lie in the 4 lanes of a quad), probabilities rounded to bf16 and
// fed as the A operand of P·V (the accumulator layout of QK^T is the A
// layout), messages rounded and written over the rows' q. The scale is a
// multiplication by 1/sqrt(D), the exponential ex2.approx and the
// normalisation one approximate reciprocal a row: their error (about 2^-21
// relative) is far below the bf16 step the probabilities are rounded to.
// With -DT2P_EXACT_SOFTMAX the build divides by sqrt(D), calls expf and
// divides by the sum as the plain version does;
// scripts/check_gnn_kernel.py holds the two builds against each other.
constexpr int UNITS = 2 * G * HEADS / WARPS;   // 4

#ifdef T2P_EXACT_SOFTMAX
__device__ __forceinline__ float scaled(float s) {
  return s / sqrtf((float)D);
}
__device__ __forceinline__ float soft_exp(float x) { return expf(x); }
__device__ __forceinline__ float soft_den(float sum) { return sum; }
__device__ __forceinline__ float soft_norm(float e, float den) {
  return e / den;
}
#else
__device__ __forceinline__ float scaled(float s) {
  return s * (1.0f / sqrtf((float)D));
}
__device__ __forceinline__ float soft_exp(float x) { return __expf(x); }
__device__ __forceinline__ float soft_den(float sum) {
  return __fdividef(1.0f, sum);
}
__device__ __forceinline__ float soft_norm(float e, float den) {
  return e * den;
}
#endif

__device__ __forceinline__ void attend(__nv_bfloat16* Q, bool cross) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int qbase[UNITS], nq[UNITS], kbase[UNITS], nk[UNITS], col[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = (threadIdx.x >> 5) * UNITS + i;
    const int p = u / (2 * HEADS), ob = p * T0, hb = OBJ + p * T1;
    const bool hints = (u & 1) != 0;     // the query set
    const bool khints = hints != cross;  // the source set
    qbase[i] = hints ? hb : ob;
    nq[i] = hints ? T1 : T0;
    kbase[i] = khints ? hb : ob;
    nk[i] = khints ? T1 : T0;
    col[i] = ((u >> 1) % HEADS) * D;     // the head's channels
  }

  // Logits. K as the B operand: matrix i of an x4 load is keys 8t.. x
  // channels 8i...
  float sc[UNITS][2][4];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    uint32_t qa[2][4];
    const uint32_t addr =
        smem_addr(Q + (qbase[i] + min(lane & 15, nq[i] - 1)) * LDQ + col[i] +
                  ((lane >> 4) << 3));
    ldmatrix_x4(qa[0], addr);
    ldmatrix_x4(qa[1], addr + 32u);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int key = min(8 * t + (lane & 7), nk[i] - 1);
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_addr(Q + (kbase[i] + key) * LDQ + E + col[i] +
                                ((lane >> 3) << 3)));
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][t][j] = 0.0f;
      mma_bf16(sc[i][t], qa[0], kb[0], kb[1]);
      mma_bf16(sc[i][t], qa[1], kb[2], kb[3]);
    }
  }
  // Softmax of rows gid (j = 0, 1) and gid + 8 (j = 2, 3).
  uint32_t pa[UNITS][4];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[i][t][j] = 8 * t + tig * 2 + (j & 1) < nk[i] ? scaled(sc[i][t][j])
                                                         : -INFINITY;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * half;
      float mx = fmaxf(fmaxf(sc[i][0][j], sc[i][0][j + 1]),
                       fmaxf(sc[i][1][j], sc[i][1][j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float e0 = soft_exp(sc[i][0][j] - mx);
      const float e1 = soft_exp(sc[i][0][j + 1] - mx);
      const float e2 = soft_exp(sc[i][1][j] - mx);
      const float e3 = soft_exp(sc[i][1][j + 1] - mx);
      float sum = (e0 + e1) + (e2 + e3);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = soft_den(sum);
      pa[i][half] = pack2(soft_norm(e0, den), soft_norm(e1, den));
      pa[i][2 + half] = pack2(soft_norm(e2, den), soft_norm(e3, den));
    }
  }
  // Messages. V as the B operand, transposed on the way: matrices of an x4
  // load are (keys 0-7 | keys 8-15) x (channels c.. | channels c + 8..).
  float o[UNITS][D / 8][4];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int vkey = min(lane & 15, nk[i] - 1);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_addr(Q + (kbase[i] + vkey) * LDQ + 2 * E +
                                      col[i] + 16 * c + ((lane >> 4) << 3)));
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][2 * c][j] = o[i][2 * c + 1][j] = 0.0f;
      mma_bf16(o[i][2 * c], pa[i], vb[0], vb[1]);
      mma_bf16(o[i][2 * c + 1], pa[i], vb[2], vb[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < UNITS; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      __nv_bfloat16* out = Q + (qbase[i] + gid) * LDQ + col[i] + n * 8 + tig * 2;
      if (gid < nq[i])
        *reinterpret_cast<uint32_t*>(out) = pack2(o[i][n][0], o[i][n][1]);
      if (gid + 8 < nq[i])
        *reinterpret_cast<uint32_t*>(out + 8 * LDQ) =
            pack2(o[i][n][2], o[i][n][3]);
    }
}

__global__ void __launch_bounds__(NT, 1)
superglue_gnn_tc_kernel(const float* __restrict__ desc0,  // [N, T0, E]
                        const float* __restrict__ desc1,  // [N, T1, E]
                        Weights wt, int num_blocks,
                        float* __restrict__ scores,       // [N, T0, T1]
                        int n_pairs) {
  extern __shared__ uint4 smem_tc[];
  float* res = reinterpret_cast<float*>(smem_tc);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(res + ROWS * LDR);
  __nv_bfloat16* Q = A + ROWS * LDA;
  const int tid = threadIdx.x;
  const int pair0 = blockIdx.x * G;
  STAGE_BEGIN

  // Both descriptor sets of the CTA's pairs, set-major; zeros in the
  // padding rows and past the last pair.
  for (int i = tid; i < ROWS * (E / 4); i += NT) {
    const int r = i / (E / 4), c = (i % (E / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < OBJ) {
      if (pair0 + r / T0 < n_pairs)
        x = __ldg(reinterpret_cast<const float4*>(
            desc0 + ((size_t)pair0 * T0 + r) * E + c));
    } else if (r < OBJ + HINT) {
      const int u = r - OBJ;
      if (pair0 + u / T1 < n_pairs)
        x = __ldg(reinterpret_cast<const float4*>(
            desc1 + ((size_t)pair0 * T1 + u) * E + c));
    }
    *reinterpret_cast<float4*>(res + r * LDR + c) = x;
    *reinterpret_cast<uint2*>(A + r * LDA + c) =
        make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
  }

  STAGE(0)

  // Each product's first weight fragments are fetched before the barrier
  // that releases its input.
  for (int l = 0; l < num_blocks; ++l) {
    const bool cross = (l & 1) == 1;
    const size_t wl = (size_t)l;

    // q|k|v of every row.
    {
      const uint2* w = wt.wqkv + wl * (E * 3 * E / 4);
      BRing<6, 2> ring;
      prefetch_b<6, E>(w, ring);
      __syncthreads();
      gemm<6, E>(A, LDA, w, ring, [&](int r, int c, float v0, float v1) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(wt.bqkv + wl * 3 * E + c));
        *reinterpret_cast<uint32_t*>(Q + r * LDQ + c) =
            pack2(v0 + b.x, v1 + b.y);
      });
    }
    STAGE(1)

    // Attention and m = msg·Wm + bm, into the right half of A. A warp takes
    // four of the CTA's 32 (pair, head, query set) units.
    {
      const uint2* w = wt.wm + wl * (E * E / 4);
      BRing<2, 4> ring;
      prefetch_b<2, E>(w, ring);
      __syncthreads();
      attend(Q, cross);
      __syncthreads();
      STAGE(2)
      gemm<2, E>(Q, LDQ, w, ring, [&](int r, int c, float v0, float v1) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(wt.bm + wl * E + c));
        *reinterpret_cast<uint32_t*>(A + r * LDA + E + c) =
            pack2(v0 + b.x, v1 + b.y);
      });
    }
    STAGE(3)

    // h1 = relu(([a | m]·W0) * s0[set] + t0[set]), over q|k.
    {
      const uint2* w = wt.w0 + wl * (4 * E * E / 4);
      BRing<4, 3> ring;
      prefetch_b<4, 2 * E>(w, ring);
      __syncthreads();
      gemm<4, 2 * E>(A, LDA, w, ring, [&](int r, int c, float v0, float v1) {
        const int set = r >= OBJ ? 1 : 0;
        const float2 s = __ldg(reinterpret_cast<const float2*>(wt.s0 + wl * 4 * E + set * 2 * E + c));
        const float2 t = __ldg(reinterpret_cast<const float2*>(wt.t0 + wl * 4 * E + set * 2 * E + c));
        *reinterpret_cast<uint32_t*>(Q + r * LDQ + c) =
            pack2(fmaxf(fmaf(v0, s.x, t.x), 0.0f),
                  fmaxf(fmaf(v1, s.y, t.y), 0.0f));
      });
    }
    STAGE(4)

    // res += h1·W1 + b1; A's left half gets the rounded residual.
    {
      const uint2* w = wt.w1 + wl * (2 * E * E / 4);
      BRing<2, 4> ring;
      prefetch_b<2, 2 * E>(w, ring);
      __syncthreads();
      gemm<2, 2 * E>(Q, LDQ, w, ring, [&](int r, int c, float v0, float v1) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(wt.b1 + wl * E + c));
        float2* rp = reinterpret_cast<float2*>(res + r * LDR + c);
        float2 x = *rp;
        x.x += rnd(v0 + b.x);
        x.y += rnd(v1 + b.y);
        *rp = x;
        *reinterpret_cast<uint32_t*>(A + r * LDA + c) = pack2(x.x, x.y);
      });
    }
    STAGE(5)
  }

  // Final projection of both sets, over q.
  {
    BRing<2, 4> ring;
    prefetch_b<2, E>(wt.wf, ring);
    __syncthreads();
    gemm<2, E>(A, LDA, wt.wf, ring, [&](int r, int c, float v0, float v1) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(wt.bf + c));
      *reinterpret_cast<uint32_t*>(Q + r * LDQ + c) =
          pack2(v0 + b.x, v1 + b.y);
    });
  }
  __syncthreads();
  STAGE(6)

  // scores[n, i, j] = md0_i · md1_j / sqrt(E).
  for (int it = tid; it < G * T0 * T1; it += NT) {
    const int p = it / (T0 * T1), i = (it / T1) % T0, j = it % T1;
    if (pair0 + p >= n_pairs) continue;
    const uint4* a = reinterpret_cast<const uint4*>(Q + (p * T0 + i) * LDQ);
    const uint4* b =
        reinterpret_cast<const uint4*>(Q + (OBJ + p * T1 + j) * LDQ);
    float dot = 0.0f;
#pragma unroll 4
    for (int c = 0; c < E / 8; ++c) {
      float x[8], y[8];
      unpack8(a[c], x);
      unpack8(b[c], y);
#pragma unroll
      for (int d = 0; d < 8; ++d) dot = fmaf(x[d], y[d], dot);
    }
    scores[(size_t)pair0 * T0 * T1 + it] = dot / sqrtf((float)E);
  }
  STAGE(7)
}

int launch(const float* desc0, const float* desc1, const Weights& wt,
           int num_blocks, float* scores, int n_pairs, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      superglue_gnn_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n_pairs + G - 1) / G;
  superglue_gnn_tc_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      desc0, desc1, wt, num_blocks, scores, n_pairs);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------------------
// f32: CUDA cores
// ------------------------------------------------------------------------
namespace f32 {

constexpr int P = T0 + T1;      // token rows a pair (22)
constexpr int NT = 256;         // threads a CTA
constexpr int RT = P / 2;       // rows of a thread tile: half a pair (11)
constexpr int RING = 8;         // k-groups of 4 in a warp's weight ring
// A row, by offset: the residual; k, then m; q, then the messages, then
// the first half of h1, then the final projection; v, then h1's second
// half. So [residual | m] is W0's input and h1 W1's, each contiguous.
constexpr int RES = 0, KM = E, QO = 2 * E, VO = 3 * E;
constexpr int LDR = 4 * E + 4;  // 516 floats: consecutive rows 4 banks apart
static_assert(P % 2 == 0 && RT * 2 == P, "a pair is two thread tiles");

// The rows, then each warp's weight ring (RING x 4 k-rows x 16 columns).
__host__ __device__ constexpr size_t row_bytes(int G) {
  return (size_t)G * P * LDR * sizeof(float);
}
__host__ __device__ constexpr size_t smem_bytes(int G) {
  return row_bytes(G) + (size_t)(NT / 32) * RING * 64 * sizeof(float);
}

// With -DT2P_STAGE_CLOCKS the kernel adds up its stages' clocks as the
// bf16 kernel does (t2p_superglue_gnn_f32_stage_clocks reads them). Two
// timing-only builds (wrong scores, the same products):
// -DT2P_GNN_W_SMEM reads the weights from the ring without copying them
// there, -DT2P_GNN_NO_ATTENTION leaves the attention out.
// scripts/check_gnn_kernel.py --f32 builds and reads all three.
#ifdef T2P_STAGE_CLOCKS
__device__ unsigned long long g_stage_clocks[tc::N_STAGES];
#endif

struct Weights {
  const float* wqkv;  // [L, E, 3E]
  const float* bqkv;  // [L, 3E]
  const float* wm;    // [L, E, E]
  const float* bm;    // [L, E]
  const float* w0;    // [L, 2E, 2E]
  const float* s0;    // [L, 2, 2E]
  const float* t0;    // [L, 2, 2E]
  const float* w1;    // [L, 2E, E]
  const float* b1;    // [L, E]
  const float* wf;    // [E, E]
  const float* bf;    // [E]
};

// G consecutive f32 values, G = 1, 2 or 4, as one store.
__device__ __forceinline__ void st_cols(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void st_cols(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A warp's 16 weight columns of a product (lane (rg, cl) takes G of them),
// 4 k-rows at a time over all its passes of 128 columns, copied from L2
// (row-major W, row length N) by cp.async into the warp's own ring of RING
// groups in shared memory, RING − 1 groups ahead: a group is 4 x 64
// contiguous bytes, 16 lanes' copies. Only the warp reads its ring, so a
// __syncwarp, not a barrier, orders the copies and the reads, and the
// copies run on across the CTA's barriers.
__device__ __forceinline__ void cp_async16_cg(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 2) : "memory");
}

template <int G, int K>
struct Loader {
  static constexpr int CL = 16 / G, K4 = K / 4;
  const float* W;
  float* ring;   // the warp's [RING][4][16] floats
  int N, passes;

  __device__ __forceinline__ Loader(const float* w, int n, int p, float* r)
      : W(w + 16 * (threadIdx.x >> 5)), ring(r + (threadIdx.x >> 5) * RING * 64),
        N(n), passes(p) {}

  // This thread's first column of pass 0.
  __device__ __forceinline__ int col() const {
    return ((threadIdx.x >> 5) * CL + (threadIdx.x & 31) % CL) * G;
  }
  // Copies of group t (lanes 0-15: k-row lane / 4, 16 bytes lane % 4); every
  // lane commits a group, empty past the last.
  __device__ __forceinline__ void issue(int t) const {
    const int lane = threadIdx.x & 31;
#ifndef T2P_GNN_W_SMEM
    if (t < passes * K4 && lane < 16) {
      const int p = t / K4, kg = t % K4, kk = lane >> 2, q = (lane & 3) * 4;
      cp_async16_cg(ring + (t % RING) * 64 + kk * 16 + q,
                    W + (size_t)(4 * kg + kk) * N + 128 * p + q);
    }
    cp_async_commit();
#endif
  }
  // The first RING − 1 groups, issued before the barrier that releases the
  // product's input, so that their latency overlaps the stage before.
  __device__ __forceinline__ void prefetch() const {
    __syncwarp();   // every lane is past its reads of the last product
    for (int t = 0; t < RING - 1; ++t) issue(t);
  }
  // Group t's 4 k-rows of this thread's G columns, after it has landed;
  // then the copy of group t + RING − 1 into the slot read at step t − 1.
  // With -DT2P_GNN_W_SMEM (timing only) no copy is made and the reads take
  // whatever the ring holds.
  __device__ __forceinline__ void next(int t, float (&w)[4][G]) const {
#ifndef T2P_GNN_W_SMEM
    cp_async_wait_ring();
#endif
    __syncwarp();
    const float* src = ring + (t % RING) * 64 + ((threadIdx.x & 31) % CL) * G;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (G == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + kk * 16);
        w[kk][0] = v.x, w[kk][1] = v.y, w[kk][2] = v.z, w[kk][3] = v.w;
      } else if constexpr (G == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + kk * 16);
        w[kk][0] = v.x, w[kk][1] = v.y;
      } else {
        w[kk][0] = src[kk * 16];
      }
    }
    issue(t + RING - 1);
  }
};

// out[G·P, 128·passes] = X[G·P, K] (shared, row stride LDR) · W, pass by
// pass. Thread (warp w, lane l) owns rows RT·rg .. RT·rg + RT − 1, rg = l /
// CL, and the loader's G columns of each pass: RT·G accumulators, each an
// fmaf chain over k from 0 in ascending order. A warp's RG row lanes read
// 16-byte pieces of RG rows 4·RT banks apart (one wavefront); its CL column
// lanes share them. A row's next 4 k-values are loaded as soon as its
// current ones are taken, a k-group ahead of their FMAs. epi(row, column,
// acc[G]).
template <int G, int K, typename Epi>
__device__ __forceinline__ void gemm(const float* X, const Loader<G, K>& ld,
                                     Epi epi) {
  constexpr int K4 = K / 4, CL = Loader<G, K>::CL;
  const int rg = (threadIdx.x & 31) / CL;
  const float* xr = X + RT * rg * LDR;
  float4 x[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
    x[i] = *reinterpret_cast<const float4*>(xr + i * LDR);
  for (int p = 0; p < ld.passes; ++p) {
    float acc[RT][G];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int kg = 0; kg < K4; ++kg) {
      float w[4][G];
      ld.next(p * K4 + kg, w);
      // The next group's k (the first of the next pass after the last).
      const int kn = kg + 1 < K4 ? 4 * (kg + 1) : 0;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
        x[i] = *reinterpret_cast<const float4*>(xr + i * LDR + kn);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < G; ++j)
            acc[i][j] = fmaf(xs[kk], w[kk][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) epi(RT * rg + i, ld.col() + 128 * p, acc[i]);
  }
}

// A thread per (head, query row): logits over the source set, softmax,
// the message written over the row's q (its own q is read before).
template <int G>
__device__ __forceinline__ void attend(float* rows, bool cross) {
  constexpr int R = G * P;
  for (int it = threadIdx.x; it < HEADS * R; it += NT) {
    const int h = it / R, r = it % R;
    const int p = r / P, set = (r % P) >= T0 ? 1 : 0;
    const int kset = cross ? 1 - set : set;
    const int kbase = p * P + (kset ? T0 : 0);
    const int nk = kset ? T1 : T0;
    float* q = rows + r * LDR + QO + h * D;
    float s[T0];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < T0; ++j) {
      if (j < nk) {
        const float* kr = rows + (kbase + j) * LDR + KM + h * D;
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(q + d);
          const float4 b = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(a.x, b.x, dot);
          dot = fmaf(a.y, b.y, dot);
          dot = fmaf(a.z, b.z, dot);
          dot = fmaf(a.w, b.w, dot);
        }
        s[j] = dot / sqrtf((float)D);
        mx = fmaxf(mx, s[j]);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < T0; ++j) {
      if (j < nk) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
    }
    float msg[D];
#pragma unroll
    for (int d = 0; d < D; ++d) msg[d] = 0.0f;
#pragma unroll
    for (int j = 0; j < T0; ++j) {
      if (j < nk) {
        const float pj = s[j] / sum;
        const float* vr = rows + (kbase + j) * LDR + VO + h * D;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vr + d);
          msg[d] = fmaf(pj, v.x, msg[d]);
          msg[d + 1] = fmaf(pj, v.y, msg[d + 1]);
          msg[d + 2] = fmaf(pj, v.z, msg[d + 2]);
          msg[d + 3] = fmaf(pj, v.w, msg[d + 3]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(q + d) =
          make_float4(msg[d], msg[d + 1], msg[d + 2], msg[d + 3]);
  }
}

template <int G>
__global__ void __launch_bounds__(NT, 1)
superglue_gnn_f32_kernel(const float* __restrict__ desc0,  // [N, T0, E]
                         const float* __restrict__ desc1,  // [N, T1, E]
                         Weights wt, int num_blocks,
                         float* __restrict__ scores,       // [N, T0, T1]
                         int n_pairs) {
  constexpr int R = G * P;
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);
  float* ring = rows + row_bytes(G) / sizeof(float);
  const int tid = threadIdx.x;
  const int pair0 = blockIdx.x * G;
  STAGE_BEGIN

  // Both descriptor sets of the CTA's pairs, pair by pair (zeros past the
  // last pair).
  for (int i = tid; i < R * (E / 4); i += NT) {
    const int r = i / (E / 4), c = (i % (E / 4)) * 4;
    const int p = r / P, loc = r % P, n = pair0 + p;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n < n_pairs)
      x = __ldg(reinterpret_cast<const float4*>(
          loc < T0 ? desc0 + ((size_t)n * T0 + loc) * E + c
                   : desc1 + ((size_t)n * T1 + (loc - T0)) * E + c));
    *reinterpret_cast<float4*>(rows + r * LDR + RES + c) = x;
  }
  STAGE(0)

  for (int l = 0; l < num_blocks; ++l) {
    const bool cross = (l & 1) == 1;
    const size_t wl = (size_t)l;

    // q|k|v of every row: q over QO, k over KM, v over VO.
    {
      const Loader<G, E> ld(wt.wqkv + wl * E * 3 * E, 3 * E, 3, ring);
      const float* b = wt.bqkv + wl * 3 * E;
      ld.prefetch();
      __syncthreads();
      gemm(rows + RES, ld, [&](int r, int c, const float (&a)[G]) {
        float v[G];
#pragma unroll
        for (int j = 0; j < G; ++j) v[j] = a[j] + __ldg(b + c + j);
        st_cols(rows + r * LDR + (c < E ? QO + c : c < 2 * E ? c : c + E),
                v);
      });
    }
    STAGE(1)
    __syncthreads();
#ifndef T2P_GNN_NO_ATTENTION
    attend<G>(rows, cross);
#endif
    STAGE(2)

    // m = msg·Wm + bm, over k.
    {
      const Loader<G, E> ld(wt.wm + wl * E * E, E, 1, ring);
      const float* b = wt.bm + wl * E;
      ld.prefetch();
      __syncthreads();
      gemm(rows + QO, ld, [&](int r, int c, const float (&a)[G]) {
        float v[G];
#pragma unroll
        for (int j = 0; j < G; ++j) v[j] = a[j] + __ldg(b + c + j);
        st_cols(rows + r * LDR + KM + c, v);
      });
    }
    STAGE(3)

    // h1 = relu(([a | m]·W0) * s0[set] + t0[set]), over q|v.
    {
      const Loader<G, 2 * E> ld(wt.w0 + wl * 4 * E * E, 2 * E, 2, ring);
      const float* s0 = wt.s0 + wl * 4 * E;
      const float* t0 = wt.t0 + wl * 4 * E;
      ld.prefetch();
      __syncthreads();
      gemm(rows + RES, ld, [&](int r, int c, const float (&a)[G]) {
        const int g = (r % P) >= T0 ? 2 * E : 0;
        float v[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          v[j] = fmaxf(fmaf(a[j], __ldg(s0 + g + c + j),
                            __ldg(t0 + g + c + j)), 0.0f);
        st_cols(rows + r * LDR + QO + c, v);
      });
    }
    STAGE(4)

    // res += h1·W1 + b1.
    {
      const Loader<G, 2 * E> ld(wt.w1 + wl * 2 * E * E, E, 1, ring);
      const float* b = wt.b1 + wl * E;
      ld.prefetch();
      __syncthreads();
      gemm(rows + QO, ld, [&](int r, int c, const float (&a)[G]) {
        float* x = rows + r * LDR + RES + c;
        float v[G];
#pragma unroll
        for (int j = 0; j < G; ++j) v[j] = x[j] + (a[j] + __ldg(b + c + j));
        st_cols(x, v);
      });
    }
    STAGE(5)
  }

  // Final projection of both sets, over q.
  {
    const Loader<G, E> ld(wt.wf, E, 1, ring);
    ld.prefetch();
    __syncthreads();
    gemm(rows + RES, ld, [&](int r, int c, const float (&a)[G]) {
      float v[G];
#pragma unroll
      for (int j = 0; j < G; ++j) v[j] = a[j] + __ldg(wt.bf + c + j);
      st_cols(rows + r * LDR + QO + c, v);
    });
  }
  __syncthreads();
  STAGE(6)

  // scores[n, i, j] = md0_i · md1_j / sqrt(E).
  for (int it = tid; it < G * T0 * T1; it += NT) {
    const int p = it / (T0 * T1), i = (it / T1) % T0, j = it % T1;
    const int n = pair0 + p;
    if (n >= n_pairs) continue;
    const float* a = rows + (p * P + i) * LDR + QO;
    const float* b = rows + (p * P + T0 + j) * LDR + QO;
    float dot = 0.0f;
#pragma unroll 8
    for (int c = 0; c < E; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + c);
      const float4 y = *reinterpret_cast<const float4*>(b + c);
      dot = fmaf(x.x, y.x, dot);
      dot = fmaf(x.y, y.y, dot);
      dot = fmaf(x.z, y.z, dot);
      dot = fmaf(x.w, y.w, dot);
    }
    scores[((size_t)n * T0 + i) * T1 + j] = dot / sqrtf((float)E);
  }
  STAGE(7)
}

// The pairs a CTA for n_pairs pairs on a card of `sms` SMs: the G of 1, 2
// and 4 with the least time, a CTA's time taken as G times a pair's cost
// in it (10, 12 and 18 for G = 4, 2, 1: on an H100 a pair costs 1, 1.17
// and 1.81-1.85 times as much with G = 4, 2, 1, both at 20,480 pairs and at
// 80, scripts/check_gnn_kernel.py --f32) and CTAs in waves of one an SM;
// ties to the larger G. A build with -DT2P_GNN_F32_PAIRS=G takes G pairs
// a CTA at every size (timing only: check_gnn_kernel.py --f32 times each
// form); the scores do not depend on G.
__host__ __device__ inline int pairs_per_cta(int n_pairs, int sms) {
#ifdef T2P_GNN_F32_PAIRS
  return T2P_GNN_F32_PAIRS;
#else
  int best = 4;
  long long best_cost = -1;
  for (int g = 4; g >= 1; g /= 2) {
    const long long ctas = (n_pairs + g - 1) / g;
    const long long waves = (ctas + sms - 1) / sms;
    const long long cost = waves * g * (g == 4 ? 10 : g == 2 ? 12 : 18);
    if (best_cost < 0 || cost < best_cost) best = g, best_cost = cost;
  }
  return best;
#endif
}

int device_sms(int* sms) {
  static int known[64] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && known[dev]) {
    *sms = known[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) known[dev] = *sms;
  return 0;
}

template <int G>
int launch_g(const float* desc0, const float* desc1, const Weights& wt,
             int num_blocks, float* scores, int n_pairs, cudaStream_t stream) {
  const size_t smem = smem_bytes(G);
  cudaError_t e = cudaFuncSetAttribute(
      superglue_gnn_f32_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n_pairs + G - 1) / G;
  superglue_gnn_f32_kernel<G><<<grid, NT, smem, stream>>>(
      desc0, desc1, wt, num_blocks, scores, n_pairs);
  return (int)cudaGetLastError();
}

int launch(const float* desc0, const float* desc1, const Weights& wt,
           int num_blocks, float* scores, int n_pairs, cudaStream_t stream) {
  int sms;
  const int err = device_sms(&sms);
  if (err) return err;
  switch (pairs_per_cta(n_pairs, sms)) {
    case 4: return launch_g<4>(desc0, desc1, wt, num_blocks, scores, n_pairs,
                               stream);
    case 2: return launch_g<2>(desc0, desc1, wt, num_blocks, scores, n_pairs,
                               stream);
    case 1: return launch_g<1>(desc0, desc1, wt, num_blocks, scores,
                               n_pairs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

}  // namespace

// desc0 [N, 16, 128] f32, desc1 [N, 6, 128] f32, scores [N, 16, 6] f32.
// bf16 != 0: matmul weights are bf16 in fragment order (tensor-core kernel);
// else f32 row-major (CUDA-core kernel, its pairs a CTA by the launch's
// size: t2p_superglue_gnn_f32_pairs). Vectors are f32 either way. Returns
// a cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_superglue_gnn(const void* desc0, const void* desc1,
                                 const void* wqkv, const void* bqkv,
                                 const void* wm, const void* bm,
                                 const void* w0, const void* s0,
                                 const void* t0, const void* w1,
                                 const void* b1, const void* wf,
                                 const void* bf, int num_blocks, int n_pairs,
                                 int bf16, void* scores, void* stream) {
  if (n_pairs < 1 || num_blocks < 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    tc::Weights wt{(const uint2*)wqkv, (const float*)bqkv, (const uint2*)wm,
                   (const float*)bm, (const uint2*)w0, (const float*)s0,
                   (const float*)t0, (const uint2*)w1, (const float*)b1,
                   (const uint2*)wf, (const float*)bf};
    return tc::launch((const float*)desc0, (const float*)desc1, wt,
                      num_blocks, (float*)scores, n_pairs,
                      (cudaStream_t)stream);
  }
  f32::Weights wt{(const float*)wqkv, (const float*)bqkv, (const float*)wm,
                  (const float*)bm, (const float*)w0, (const float*)s0,
                  (const float*)t0, (const float*)w1, (const float*)b1,
                  (const float*)wf, (const float*)bf};
  return f32::launch((const float*)desc0, (const float*)desc1, wt, num_blocks,
                     (float*)scores, n_pairs, (cudaStream_t)stream);
}

// Static shape of the kernels, for the Python wrapper's checks: descriptor
// width, objects and hints per pair, and the tensor-core kernel's pairs per
// CTA.
extern "C" int t2p_superglue_gnn_shape(int* e, int* t0, int* t1, int* g) {
  *e = E;
  *t0 = T0;
  *t1 = T1;
  *g = tc::G;
  return 0;
}

// The pairs a CTA of the f32 kernel for a launch on n_pairs pairs on the
// current device (1, 2 or 4; f32::pairs_per_cta).
extern "C" int t2p_superglue_gnn_f32_pairs(int n_pairs, int* g) {
  int sms;
  const int err = f32::device_sms(&sms);
  if (err) return err;
  *g = f32::pairs_per_cta(n_pairs, sms);
  return 0;
}

#ifdef T2P_STAGE_CLOCKS
// Copies the bf16 kernel's summed stage clocks to out[8] (reset == 0) or
// sets them to zero. Synchronizes the device.
extern "C" int t2p_superglue_gnn_stage_clocks(unsigned long long* out,
                                              int reset) {
  if (reset) {
    const unsigned long long zero[tc::N_STAGES] = {};
    return (int)cudaMemcpyToSymbol(tc::g_stage_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, tc::g_stage_clocks,
                                   tc::N_STAGES * sizeof(unsigned long long));
}

// The same for the f32 kernel's stages.
extern "C" int t2p_superglue_gnn_f32_stage_clocks(unsigned long long* out,
                                                  int reset) {
  if (reset) {
    const unsigned long long zero[tc::N_STAGES] = {};
    return (int)cudaMemcpyToSymbol(f32::g_stage_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, f32::g_stage_clocks,
                                   tc::N_STAGES * sizeof(unsigned long long));
}
#endif
