// SuperGlue attention GNN in eval mode at any configured width and set
// sizes: the second hand-written form of text2pos_torch/csrc/superglue_gnn.cu,
// which is tuned for (E, T0, T1) = (128, 16, 6) alone. This one takes any E
// a multiple of 4 (4 heads of E/4 channels, 75 at JAX's default E = 300,
// 192 at 768) and any 1 <= T1 <= T0 (pad_size and num_mentioned), as the
// Pallas kernel does, with f32 or bf16 weights: all 2·num_layers self/cross
// blocks, the final projection and the [N, T0, T1] score matrix, one
// launch.
//
// Replaces the TPU kernel text2pos_tpu/ops/superglue_gnn_pallas.py:253
// (gnn_scores_pallas, which takes any N and E with T1 <= T0), at the shapes
// the tuned kernel does not take. The arithmetic is superglue_gnn.cu's and
// gnn_scores_plain's (ops/superglue_gnn.py), rounding included:
//   qkv = rnd(a·[Wq|Wk|Wv] + b)          a = rnd(res)
//   msg = rnd(softmax_j(q·k_j / sqrt(E/4)) rounded · v_j), per head
//   m   = rnd(msg·Wm + bm)
//   h1  = rnd(relu(([a | m]·W0) * s0[set] + t0[set]))
//   res = res + rnd(h1·W1 + b1)
// then md = rnd(rnd(res)·Wf + bf) and scores = md0·md1^T / sqrt(E), where
// rnd rounds to bf16 in the bf16 form and is the identity in f32. The
// attention scale is 1/sqrt(E/4) and the score scale 1/sqrt(E) of the real
// widths.
//
// Padding (pack_gnn_params, on the host, once). Each head is padded to Dp
// channels, a multiple of 16 in bf16 (75 -> 80 at E = 300) and of 4 in f32
// (75 -> 76), the model width to Ep = 4·Dp (320 and 304); widths that are
// multiples of 64 are not padded, and the bf16 pack is then the tuned
// kernel's. Weight rows and columns, biases and s0/t0 are zero in the pads,
// so relu(0·s + t) = 0 and every padded channel stays exactly 0 through
// every block. q|k|v and the messages are laid out by head (head h at
// h·Dp), the residual, m, h1 and md with their real channels first.
//
// Three routes, chosen by the wrapper (any_plan in ops/superglue_gnn.py),
// each counted under its own launch name:
//
// bf16 "superglue_gnn_any" (namespace tc): the tensor cores, mma.sync
// m16n8k16 with f32 accumulation, as superglue_gnn.cu: the epilogues (bias,
// per-set BN, ReLU, residual) run on the accumulators, the attention is
// 16-row tiles in registers (QK^T, softmax, P·V), and the B fragments come
// from global memory in fragment order, 8 bytes a lane. mma.sync and not
// wgmma: a CTA holds at most 64 rows (48 at the headline), and wgmma's
// 64-row tiles would leave much of a tile empty.
//  - Rows set-major in 16-row tiles: the objects of G pairs, then their
//    hints, each set padded to a multiple of 16, so a tile belongs to one
//    set and the BN affine is uniform over it. G is the most pairs whose
//    rows fit in 64 (4 m-tiles) and in shared memory: 2 at (16, 6) (32 + 12
//    -> 16 rows, 44 real of 48), 2 at (24, 6), 1 at (32, 32). The wrapper's
//    plan chooses G; this file computes the layout from it and fails a
//    launch whose m-tiles it has no instantiation for.
//  - The weight traffic decides the design. The padded bf16 weights are
//    2.05 MB a block at E = 300, 24.8 MB for 12 blocks, and a CTA of R rows
//    does 2·R operations for every 2 bytes of weight it reads from L2, so
//    rows buy L2 bandwidth. A row keeps two bf16 buffers of 2·Ep + 8
//    values, 2,592 bytes at Ep = 320 (124 KB for 48 rows, 207 KB for 80),
//    and nothing else: [a | x] and W. q|k|v are made for two heads at a
//    time (1.5·Ep of W), each head pair's messages go to x, the merge output
//    m to W[0, Ep), h1 to x and W[Ep, 2Ep), md to W. The f32 residual
//    (1,280 bytes a row) lives in a global workspace slice of the CTA
//    (persistent CTAs, one an SM), read and written once a block in W1's
//    epilogue. At G = 2: 10,240 CTAs x 24.8 MB = 253 GB of L2 reads a
//    20,480-pair batch (169 GB at G = 3, 80 rows; see the rounded adds).
//  - 8 warps, each a strip of NTW n-tiles over all m-tiles of a pass (n-tile
//    t of a pass to warp t % 8), so each weight element is read once a CTA:
//    NTW = 5 up to 3 m-tiles (a pass of 320 columns), 4 at 4 m-tiles (256
//    columns: 5 n-tiles' accumulators of 4 m-tiles do not fit in the
//    registers beside the rounded adds; ntw()). The B ring holds 2 k-steps,
//    fetched ahead with no predicate: the first before the barrier that
//    releases the product's input, the next pass's first during this
//    pass's last k-step. A fragments by ldmatrix.x4 through a ring of MT
//    results, a k-step ahead. A warp's full passes run without predicated
//    MMAs.
//  - Every k-step's 16 products, in every product and in the attention, are
//    summed by the tensor cores into a zeroed accumulator and added to the
//    running sum with rounded f32 adds (mma_add). The tensor cores' own
//    accumulation rounds toward zero, and over a block's K of up to 640
//    that bias, carried through 12 blocks of bf16 roundings, moved the
//    E = 300 serving path's scores 1.75 from the plain version's against
//    chip_smoke's 1.51 (1% of the largest score); with the rounded adds
//    1.45. At pad_size 24 (4 m-tiles) they put the scores 1.057 of that
//    tolerance from a float64 evaluation, nearer than the plain f32
//    version's 1.145 (chip_smoke phase 12.1, gnn_depth_check). A row's
//    sums are the same instruction sequence whatever the m-tiles of its
//    CTA, so a pair's scores do not depend on the pairs a CTA holds. The
//    adds' registers set G = 2 at the headline (48 rows); splitting a CTA's
//    m-tiles over two warps that share n-tiles (3 and 2 m-tiles at G = 3,
//    weight loads twice from L1) was slower: 125.8 ms and still spilling.
//    The tensor cores align a k-step's products to the largest operand
//    exponent, keep 2 bits below the 24-bit significand and truncate the
//    sum toward zero (scripts/probe_mma_rounding.py, bit for bit). With
//    that, this route flips ~20% fewer bf16 roundings than f32 products do
//    (tests/test_torch_port_tc_arith.py). Tried: the k-step adds by
//    two-sum (each add's error kept in a second register) halve the flips
//    and lower the median per-pair error at 12 blocks by 13-18%, at 2.43x
//    the time at (300, 16, 6); the 12-block gates against the plain f32
//    version, which itself lies up to 1.57 of them from float64, do not
//    gain margin from it (PERF.md §6).
//  - On an H100 80GB HBM3 at 700 W, 20,480 pairs, 12 blocks: (300, 16, 6)
//    98.1 ms, (300, 24, 6) 134.0 (105.9 with the tensor cores'
//    accumulation at 4 m-tiles), (300, 32, 32) 264.5; at (300, 16, 6) the
//    tensor cores' accumulation ran 80.8 at G = 2, 74.0 at G = 3 (80 rows)
//    and 144 at G = 1. At G = 3 the stage clocks (scripts/
//    check_gnn_kernel.py) read q|k|v 31%, W0 30%, W1 22%, merge 9%,
//    attention 5%, and a third of the products' clocks waiting for
//    weights (the build without weight loads took 52 of 74 ms).
//  - Attention per (pair, head, query set, 16-row query tile) on a warp:
//    QK^T over up to 32 keys, softmax in f32 in registers, P·V; spare query
//    rows repeat the last real one and spare keys are masked.
// Every row goes through the same instruction sequence wherever it sits in
// a tile, so duplicate hints keep bit-identical score columns.
//
// f32 "superglue_gnn_any" (namespace f32): f32 FMAs on the CUDA cores (the
// path whose results must match JAX's up to near-ties; TF32 would not). G
// pairs a CTA, rows pair-major (44 at (16, 6), G = 2), a row [a | x] and W
// of 2·Ep + 4 floats (4,896 bytes at Ep = 304, 215 KB for 44 rows); the
// residual is a's f32 value, and the buffers are used as in bf16. A thread
// owns RT rows x 4 columns of a pass of 128 columns (8 warps: 2 row groups
// x 4 column groups; lanes 4 rows x 8 columns), so a weight element is
// read by 2 warps a CTA (the second mostly from L1) instead of by every
// pair's CTA, streamed from L2 row-major, 16 k-values ahead in a ring of
// registers. The attention is a thread per (row, head). Tried and slower
// on the card (E = 300 headline, H100 80GB HBM3, 700 W): the weights
// staged through shared memory with cp.async (640-701 ms against 612),
// 512 threads (733, spilling under 128 registers), 6x10 and 11x5 thread
// tiles (735-756); the build without weight loads of the 11x5 form ran
// 443 ms: the FMA loop itself is at about 40% of the f32 rate.
//
// "superglue_gnn_any_wide" (namespace wide): the shapes whose rows do not
// fit in shared memory even at G = 1 (f32 where T0 + T1 > 47 at E = 300
// and past E = 656 at (16, 6); bf16 at E > 448 with both sets over 16 and
// past E = 896), and every shape past SHARED_MAX_T objects, whose
// attention the two shared routes keep in registers:
//  - G pairs a CTA (wide_plan in ops/superglue_gnn.py), set-major in
//    16-row tiles as on the tensor-core route, so that each weight k-slice
//    a CTA reads serves all G pairs' rows. Persistent CTAs, one an SM; a
//    CTA's rows live in a global workspace slice (layout): the f32
//    residual, a | m, q | k | v (h1 and md reuse it), the messages and the
//    attention's scratch, 12 KB a row at Ep = 768 in bf16. What a CTA
//    re-reads is the current product's input rows (R x K, once per
//    n-chunk), which the plan keeps under 40 MB over all CTAs (26 MB at
//    (768, 48, 6), G = 1); the rest of a slice is written once and read
//    once a block.
//  - Products in output tiles of up to 128 rows x 256 / WM columns: per
//    k-slice of 64 the rows and the weights' fragment-order tiles are
//    copied by cp.async (16 bytes, coalesced) into a ring of 4 slots in
//    shared memory (204,800 bytes in bf16), 3 ahead; WM warps down the
//    rows, 8 / WM across, a warp's tile 4 x 4 m16n8 tiles.
//  - bf16 products on the tensor cores, mma.sync m16n8k16 (mma_zero), the
//    A fragments by ldmatrix, each k-step's 16 products summed in a zeroed
//    accumulator and added to the running sum with a rounded f32 add, as
//    on the tensor-core route. A full tile (every m-tile and n-tile of a
//    warp real) runs without predicates, its A fragments and products in
//    flight before the adds: predicated, each m-tile's products waited
//    for the one before (the SASS showed WARPSYNC and a dependent add
//    chain per m-tile), 40% longer at (768, 48, 6). The products are one
//    called function (gemm_tc): inlined five times they spilled.
//  - f32 products on the CUDA cores in the same structure (thread tiles
//    of 8 rows x 8 columns, two float4s 128 apart; 64 x 256 a tile, 86,016
//    bytes of ring; 8 x 4 tiles took 13% longer), each group of 4 k-values
//    summed in a register of its own before it is added to the running
//    sum (blocked summation, nearer float64 than a chained one).
//  - bf16 attention a warp per (pair, head, query set, 16-row query tile):
//    QK^T over key chunks of 16 on the tensor cores, the logits kept in the
//    warp's scratch, the row maxima, then the sums of exp(s − max), then
//    for each 64 channels the probabilities normalised in f32, rounded to
//    bf16 and P·V: the plain version's rounding points for any number of
//    keys. f32 attention a thread per (row, head) over the source set's
//    rows. Spare query rows repeat the last real one and spare keys are
//    masked, so duplicate hints keep bit-identical score columns.
//
// Bound. About 20·E²·(T0 + T1) operations a block a pair (the five
// products), 0.48 GFLOP a pair at E = 300 with 12 blocks, against
// (T0 + T1)·E·4 bytes in and T0·T1·4 out: operations bound it, at the bf16
// tensor-core rate in bf16 and the f32 rate in f32. 9.8 TFLOP at the E = 300
// headline's 20,480 pairs: 10 ms at 989 TFLOP/s. Padding adds (320/300)² =
// 14% of operations in bf16, (304/300)² = 3% in f32.
//
// With -DT2P_STAGE_CLOCKS every route adds up, over all CTAs, the clocks
// its first thread spends in each stage (a barrier closes a stage);
// -DT2P_NO_WEIGHT_LOADS replaces the shared routes' weight loads by register
// values (wrong results, the same products), so that the difference of the
// two builds' stage clocks is the time spent waiting for weights.
// scripts/check_gnn_kernel.py builds and reads both for the shared
// routes, scripts/check_gnn_wide_route.py the stage clocks of the wide one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int HEADS = 4;
constexpr int NT = 256;          // threads a CTA, every route
constexpr int WARPS = NT / 32;
// The shared routes' attention keeps a query row's scores over the source
// set in registers (tc: two 16-key chunks; f32: float s[SHARED_MAX_T]):
// past this many objects every shape takes the wide route.
constexpr int SHARED_MAX_T = 32;

enum Route { SHARED = 0, WIDE = 1 };

#ifdef T2P_STAGE_CLOCKS
constexpr int N_STAGES = 8;  // load, qkv, attention, merge, W0, W1, final, scores
__device__ unsigned long long g_stage_clocks[N_STAGES];
#define STAGE_BEGIN long long stage_t0 = clock64();
#define BARRIER(i)                                                        \
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
#define BARRIER(i) __syncthreads();
#endif
enum Stage { S_LOAD, S_QKV, S_ATTN, S_MERGE, S_W0, S_W1, S_FINAL, S_SCORES };

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c += a·b for a 16x16 A tile and a 16x8 B tile, bf16 inputs: the 16
// products are summed by the tensor cores in a zeroed accumulator and added
// to c with rounded f32 adds, in one statement (see the header: the tensor
// cores' own accumulation rounds toward zero).
__device__ __forceinline__ void mma_add(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "{\n.reg .f32 d0, d1, d2, d3;\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{d0,d1,d2,d3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      "add.f32 %0, %0, d0;\nadd.f32 %1, %1, d1;\n"
      "add.f32 %2, %2, d2;\nadd.f32 %3, %3, d3;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// The output columns of a product, in units of u columns (an n-tile of 8 in
// bf16, a group of 4 in f32): local unit t of n maps to the weight's unit
// (t / sw)·ss + o + t % sw. q|k|v of a head pair are three segments (q, k, v)
// of 2·Dp columns at stride Ep; every other product is one segment.
struct ColMap {
  int n, sw, ss, o;
  __device__ __forceinline__ int global(int t) const {
    return (t / sw) * ss + o + t % sw;
  }
};

__host__ __device__ inline ColMap dense_cols(int n) { return ColMap{n, n, 0, 0}; }

// q|k|v of heads 2·hp and 2·hp + 1, in units of `unit` columns.
__host__ __device__ inline ColMap qkv_cols(int Ep, int hp, int unit) {
  const int half = Ep / 2 / unit;
  return ColMap{3 * half, half, Ep / unit, hp * half};
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------
namespace tc {

// n-tiles of a warp in a pass: 5 up to 3 m-tiles (a pass of 40 n-tiles,
// 320 columns), 4 at 4 m-tiles (256 columns), whose accumulators for 5
// n-tiles do not fit in the registers beside the rounded adds.
__host__ __device__ constexpr int ntw(int MT) { return MT <= 3 ? 5 : 4; }
// k-steps in the B ring, 1 in flight: the rounded adds of 3 m-tiles leave
// no registers for more (4 spilled).
constexpr int RB = 2;

struct Weights {
  // Matmul weights in fragment order, [.., N/8, K/16, 32 lanes] uint2.
  const uint2* wqkv;  // [L, 3Ep/8, Ep/16, 32]
  const float* bqkv;  // [L, 3Ep]
  const uint2* wm;    // [L, Ep/8, Ep/16, 32]
  const float* bm;    // [L, Ep]
  const uint2* w0;    // [L, 2Ep/8, 2Ep/16, 32]
  const float* s0;    // [L, 2, 2Ep]
  const float* t0;    // [L, 2, 2Ep]
  const uint2* w1;    // [L, Ep/8, 2Ep/16, 32]
  const float* b1;    // [L, Ep]
  const uint2* wf;    // [Ep/8, Ep/16, 32]
  const float* bf;    // [Ep]
};

__host__ __device__ inline size_t smem_bytes(int MT, int Ep) {
  return (size_t)2 * MT * 16 * (2 * Ep + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint2 fetch(const uint2* p) {
#ifdef T2P_NO_WEIGHT_LOADS
  // Finite bf16 values that depend on the address, so that nothing is
  // folded away: the products run, the weights never arrive.
  const uint32_t v = (uint32_t)(uintptr_t)p & 0x3f7f3f7fu;
  return make_uint2(v, v ^ 0x00100010u);
#else
  return __ldg(p);
#endif
}

// A product's B fragments, streamed k-step by k-step over its passes, a
// warp its n-tiles: a warp's load of an n-tile and k-step is 256 contiguous
// bytes. off[j] is the offset (uint2, lane included) of n-tile j of the
// warp in the current pass; an n-tile past the product's end reads the
// first one, whose values no MMA uses, so that no load is predicated.
template <int NTW>
struct Loader {
  static constexpr int PASS = WARPS * NTW;
  const uint2* W;
  ColMap cm;
  int KS, passes;
  int off[NTW];

  __device__ __forceinline__ int offset(int p, int j) const {
    const int t = p * PASS + j * WARPS + (threadIdx.x >> 5);
    return (t < cm.n ? cm.global(t) : 0) * KS * 32 + (threadIdx.x & 31);
  }
  __device__ __forceinline__ void offsets(int p) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) off[j] = offset(p, j);
  }
  __device__ __forceinline__ void load(int ks, uint2 (&b)[NTW]) const {
#pragma unroll
    for (int j = 0; j < NTW; ++j) b[j] = fetch(W + off[j] + ks * 32);
  }
  // k-step ks of pass p, the offsets computed on the way (the last k-steps
  // of a pass fetch the next pass's first ones).
  __device__ __forceinline__ void load_pass(int p, int ks,
                                           uint2 (&b)[NTW]) const {
#pragma unroll
    for (int j = 0; j < NTW; ++j) b[j] = fetch(W + offset(p, j) + ks * 32);
  }
  __device__ __forceinline__ void start(const uint2* w, int K, ColMap c) {
    W = w;
    cm = c;
    KS = K / 16;
    passes = (c.n + PASS - 1) / PASS;
    offsets(0);
  }
  // The first RB - 1 k-steps, before the barrier that releases the input.
  __device__ __forceinline__ void prefetch(uint2 (&ring)[RB][NTW]) const {
#pragma unroll
    for (int r = 0; r < RB - 1; ++r) load(r, ring[r]);
  }
};

// RB k-steps from ks0 on: B step ks + RB - 1 is loaded into the ring slot
// freed by step ks - 1 (in the last group of pass p, the next pass's first
// steps); A tiles come through a ring of RA ldmatrix results,
// step t = ks·MT + m in slot t % RA, refilled RA - 1 steps ahead. FULL: the
// warp has all NTW n-tiles in this pass, and no MMA is predicated.
template <int MT, int RA, bool LAST, bool FULL, int NTW = ntw(MT)>
__device__ __forceinline__ void k_group(
    int ks0, int KS, int jn, uint32_t x1, uint32_t x2, int ks_split,
    uint32_t mstride, const Loader<NTW>& ld, int p, uint2 (&ring)[RB][NTW],
    uint32_t (&a)[RA][4], float (&acc)[MT][NTW][4]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int ks = ks0 + r;
    if (!LAST)
      ld.load(ks + RB - 1, ring[(r + RB - 1) % RB]);
    else if (r == 0)
      ld.load(KS - 1, ring[RB - 1]);
    else if (p + 1 < ld.passes)
      ld.load_pass(p + 1, r - 1, ring[(r + RB - 1) % RB]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = r * MT + m;
      const int mn = (m + RA - 1) % MT, dk = (m + RA - 1) / MT;
      if (!LAST || r + dk < RB) {
        const int kn = ks + dk;
        ldmatrix_x4(a[(t + RA - 1) % RA],
                    (kn < ks_split ? x1 : x2) + 32u * kn + mn * mstride);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (FULL || j < jn)
          mma_add(acc[m][j], a[t % RA], ring[r][j].x,
                           ring[r][j].y);
    }
  }
}

// out[ROWS, cm.n·8] = X[ROWS, K] · W: X is X1 for k-steps below ks_split and
// X2 above (shared bf16, both of row stride ldx), W streamed by `ld` (started
// and prefetched by the caller). epi(row, local column, weight column, v0,
// v1) takes the accumulators of (row, col) and (row, col + 1).
template <int MT, typename Epi, int NTW = ntw(MT)>
__device__ __forceinline__ void gemm(const __nv_bfloat16* X1,
                                     const __nv_bfloat16* X2, int ldx,
                                     int ks_split, Loader<NTW>& ld,
                                     uint2 (&ring)[RB][NTW], Epi epi) {
  // The A ring: MT ldmatrix results, a k-step ahead.
  constexpr int RA = MT, PASS = Loader<NTW>::PASS;
  static_assert((RB * MT) % RA == 0, "A ring slots repeat every B group");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int KS = ld.KS;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k + 8.
  const uint32_t lane_off = 2u * ((lane & 15) * ldx + ((lane >> 4) << 3));
  const uint32_t x1 = smem_addr(X1) + lane_off;
  const uint32_t x2 = smem_addr(X2) + lane_off - 32u * ks_split;
  const uint32_t mstride = 2u * 16 * ldx;

  for (int p = 0; p < ld.passes; ++p) {
    int jn = 0;   // this warp's n-tiles in this pass
#pragma unroll
    for (int j = 0; j < NTW; ++j) jn += p * PASS + j * WARPS + warp < ld.cm.n;
    float acc[MT][NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
    uint32_t a[RA][4];
#pragma unroll
    for (int t = 0; t < RA - 1; ++t) ldmatrix_x4(a[t], x1 + t * mstride);
    if (jn == NTW) {
      for (int ks0 = 0; ks0 < KS - RB; ks0 += RB)
        k_group<MT, RA, false, true>(ks0, KS, jn, x1, x2, ks_split, mstride,
                                     ld, p, ring, a, acc);
      k_group<MT, RA, true, true>(KS - RB, KS, jn, x1, x2, ks_split, mstride,
                                  ld, p, ring, a, acc);
    } else {
      for (int ks0 = 0; ks0 < KS - RB; ks0 += RB)
        k_group<MT, RA, false, false>(ks0, KS, jn, x1, x2, ks_split, mstride,
                                      ld, p, ring, a, acc);
      k_group<MT, RA, true, false>(KS - RB, KS, jn, x1, x2, ks_split,
                                   mstride, ld, p, ring, a, acc);
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < jn) {
        const int t = p * PASS + j * WARPS + warp;
        const int lc = t * 8 + tig * 2, gc = ld.cm.global(t) * 8 + tig * 2;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          epi(m * 16 + gid, lc, gc, acc[m][j][0], acc[m][j][1]);
          epi(m * 16 + gid + 8, lc, gc, acc[m][j][2], acc[m][j][3]);
        }
      }
    }
    ld.offsets(p + 1);
  }
}

// The softmax's exponential and normalisation: ex2.approx and one
// approximate reciprocal a row, as superglue_gnn.cu (about 2^-21 relative,
// far below the bf16 step the probabilities are rounded to; expf and IEEE
// divisions gave the same errors against the plain version on the card and
// took 9 ms more at the E = 300 headline).
__device__ __forceinline__ float soft_exp(float x) { return __expf(x); }

// BN and ReLU as gnn_scores_plain: h·s rounded, then + t (no fused
// multiply-add, which rounds once).
__device__ __forceinline__ float bn_relu(float v, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), t), 0.0f);
}

// Attention of head pair hp on the warps: units (pair, head, query set,
// 16-row query tile), a unit the nq query rows from qbase on against the nk
// rows of the source set from kbase on (nk <= 32: two chunks of 16 keys).
// q|k|v of the pair lie in W at [q | k | v] (Ep/2 each, a head Dp), the
// messages go to x = A[.., Ep + h·Dp].
__device__ __forceinline__ void attend(const __nv_bfloat16* Wb,
                                       __nv_bfloat16* A, int ldr, int Ep,
                                       int Dp, float inv_scale, int G, int T0,
                                       int T1, int objr, int hp, bool cross) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt0 = (T0 + 15) / 16, qt1 = (T1 + 15) / 16;
  const int per_pair = 2 * (qt0 + qt1);
  const int KC = Dp / 16;
  for (int u = warp; u < G * per_pair; u += WARPS) {
    const int g = u / per_pair, v = u % per_pair;
    const int hh = v & 1, qv = v >> 1;
    const bool hints = qv >= qt0;
    const int qt = hints ? qv - qt0 : qv;
    const int qbase = (hints ? objr + g * T1 : g * T0) + 16 * qt;
    const int nq = min(16, (hints ? T1 : T0) - 16 * qt);
    const bool khints = hints != cross;
    const int kbase = khints ? objr + g * T1 : g * T0;
    const int nk = khints ? T1 : T0;
    const int nkc = (nk + 15) / 16;
    const __nv_bfloat16* Q = Wb + hh * Dp;
    const __nv_bfloat16* K = Wb + Ep / 2 + hh * Dp;
    const __nv_bfloat16* V = Wb + Ep + hh * Dp;

    // Logits: keys as the B operand, matrices of an x4 load (keys 0-7 |
    // 8-15 of the chunk) x (channels c.. | c + 8..).
    float sc[2][2][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[kc][nt][i] = 0.0f;
    const uint32_t qaddr = smem_addr(
        Q + (qbase + min(lane & 15, nq - 1)) * ldr + ((lane >> 4) << 3));
    uint32_t kaddr[2];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const int key = min(16 * kc + ((lane >> 4) << 3) + (lane & 7), nk - 1);
      kaddr[kc] = smem_addr(K + (kbase + key) * ldr + (((lane >> 3) & 1) << 3));
    }
    for (int c = 0; c < KC; ++c) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qaddr + 32u * c);
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        if (kc < nkc) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kaddr[kc] + 32u * c);
          mma_add(sc[kc][0], qa, kb[0], kb[1]);
          mma_add(sc[kc][1], qa, kb[2], kb[3]);
        }
      }
    }
    // Softmax of rows gid (i = 0, 1) and gid + 8 (i = 2, 3); a row's keys
    // lie in the 4 lanes of a quad.
    uint32_t pa[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i0 = 2 * half;
      float mx = -INFINITY;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = 16 * kc + 8 * nt + 2 * tig + i;
            float& s = sc[kc][nt][i0 + i];
            s = key < nk ? s * inv_scale : -INFINITY;
            mx = fmaxf(mx, s);
          }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.0f;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float& e0 = sc[kc][nt][i0];
          float& e1 = sc[kc][nt][i0 + 1];
          e0 = soft_exp(e0 - mx);
          e1 = soft_exp(e1 - mx);
          sum += e0 + e1;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = __fdividef(1.0f, sum);
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        pa[kc][half] = pack2(sc[kc][0][i0] * den, sc[kc][0][i0 + 1] * den);
        pa[kc][2 + half] =
            pack2(sc[kc][1][i0] * den, sc[kc][1][i0 + 1] * den);
      }
    }
    // Messages: V as the B operand, transposed on the way; matrices of an
    // x4 load are (keys 0-7 | 8-15) x (channels c.. | c + 8..).
    uint32_t vaddr[2];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
      vaddr[kc] = smem_addr(V + (kbase + min(16 * kc + (lane & 15), nk - 1)) *
                                    ldr + ((lane >> 4) << 3));
    __nv_bfloat16* out = A + Ep + (2 * hp + hh) * Dp + qbase * ldr + tig * 2;
    for (int c = 0; c < KC; ++c) {
      float o[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        if (kc < nkc) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vaddr[kc] + 32u * c);
          mma_add(o[0], pa[kc], vb[0], vb[1]);
          mma_add(o[1], pa[kc], vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        __nv_bfloat16* po = out + 16 * c + 8 * n;
        if (gid < nq)
          *reinterpret_cast<uint32_t*>(po + gid * ldr) =
              pack2(o[n][0], o[n][1]);
        if (gid + 8 < nq)
          *reinterpret_cast<uint32_t*>(po + (gid + 8) * ldr) =
              pack2(o[n][2], o[n][3]);
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(NT, 1)
tc_kernel(const float* __restrict__ desc0,  // [N, T0, E]
          const float* __restrict__ desc1,  // [N, T1, E]
          Weights wt, int num_blocks, int E, int Ep, int T0, int T1, int G,
          float* __restrict__ scores,       // [N, T0, T1]
          int n_pairs, float* __restrict__ ws) {
  constexpr int ROWS = MT * 16;
  extern __shared__ uint4 smem_tc[];
  const int ldr = 2 * Ep + 8;   // row stride of A and W: 16 B past 256·k
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [a | x]
  __nv_bfloat16* Wb = A + ROWS * ldr;
  float* res = ws + (size_t)blockIdx.x * ROWS * Ep;   // [ROWS, Ep] f32
  const int objr = (G * T0 + 15) / 16 * 16;           // first hint row
  const int Dp = Ep / HEADS;
  const int units = (n_pairs + G - 1) / G;
  const float inv_scale = 1.0f / sqrtf((float)(E / HEADS));
  const float score_scale = sqrtf((float)E);
  const int tid = threadIdx.x;
  STAGE_BEGIN

  Loader<ntw(MT)> ld;
  uint2 ring[RB][ntw(MT)];
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int pair0 = unit * G;
    // The pairs' objects, then their hints, zeros in the padding rows, the
    // padding channels and past the last pair.
    for (int i = tid; i < ROWS * (Ep / 4); i += NT) {
      const int r = i / (Ep / 4), c = (i % (Ep / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < E) {
        const float* src = nullptr;
        if (r < objr) {
          if (r < G * T0 && pair0 + r / T0 < n_pairs)
            src = desc0 + ((size_t)pair0 * T0 + r) * E + c;
        } else {
          const int h = r - objr;
          if (h < G * T1 && pair0 + h / T1 < n_pairs)
            src = desc1 + ((size_t)pair0 * T1 + h) * E + c;
        }
        if (src) x = __ldg(reinterpret_cast<const float4*>(src));
      }
      *reinterpret_cast<float4*>(res + r * Ep + c) = x;
      *reinterpret_cast<uint2*>(A + r * ldr + c) =
          make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
    }
    if (num_blocks > 0)
      ld.start(wt.wqkv, Ep, qkv_cols(Ep, 0, 8));
    else
      ld.start(wt.wf, Ep, dense_cols(Ep / 8));
    ld.prefetch(ring);
    BARRIER(S_LOAD)

    for (int l = 0; l < num_blocks; ++l) {
      const bool cross = (l & 1) == 1;
      const size_t wl = (size_t)l;
      const uint2* wqkv = wt.wqkv + wl * (Ep * 3 * Ep / 4);
      // q|k|v and attention of heads 0-1, then 2-3.
      for (int hp = 0; hp < 2; ++hp) {
        const float* bqkv = wt.bqkv + wl * 3 * Ep;
        gemm<MT>(A, A, ldr, Ep / 16, ld, ring,
                 [&](int r, int lc, int gc, float v0, float v1) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bqkv + gc));
          *reinterpret_cast<uint32_t*>(Wb + r * ldr + lc) =
              pack2(v0 + b.x, v1 + b.y);
        });
        BARRIER(S_QKV)
        attend(Wb, A, ldr, Ep, Dp, inv_scale, G, T0, T1, objr, hp, cross);
        if (hp == 0)
          ld.start(wqkv, Ep, qkv_cols(Ep, 1, 8));
        else
          ld.start(wt.wm + wl * (Ep * Ep / 4), Ep, dense_cols(Ep / 8));
        ld.prefetch(ring);
        BARRIER(S_ATTN)
      }

      // m = msg·Wm + bm into W[0, Ep).
      {
        const float* bm = wt.bm + wl * Ep;
        gemm<MT>(A + Ep, A + Ep, ldr, Ep / 16, ld, ring,
                 [&](int r, int lc, int gc, float v0, float v1) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bm + gc));
          *reinterpret_cast<uint32_t*>(Wb + r * ldr + gc) =
              pack2(v0 + b.x, v1 + b.y);
        });
        ld.start(wt.w0 + wl * (Ep * Ep), 2 * Ep, dense_cols(2 * Ep / 8));
        ld.prefetch(ring);
      }
      BARRIER(S_MERGE)

      // h1 = relu(([a | m]·W0) * s0[set] + t0[set]): columns below Ep into
      // x, the rest into W[Ep, 2Ep).
      {
        const float* s0 = wt.s0 + wl * 4 * Ep;
        const float* t0 = wt.t0 + wl * 4 * Ep;
        gemm<MT>(A, Wb, ldr, Ep / 16, ld, ring,
                 [&](int r, int lc, int gc, float v0, float v1) {
          const int set = r >= objr ? 2 * Ep : 0;
          const float2 s =
              __ldg(reinterpret_cast<const float2*>(s0 + set + gc));
          const float2 t =
              __ldg(reinterpret_cast<const float2*>(t0 + set + gc));
          __nv_bfloat16* dst =
              gc < Ep ? A + r * ldr + Ep + gc : Wb + r * ldr + gc;
          *reinterpret_cast<uint32_t*>(dst) =
              pack2(bn_relu(v0, s.x, t.x), bn_relu(v1, s.y, t.y));
        });
        ld.start(wt.w1 + wl * (Ep * Ep / 2), 2 * Ep, dense_cols(Ep / 8));
        ld.prefetch(ring);
      }
      BARRIER(S_W0)

      // res += rnd(h1·W1 + b1); a gets rnd(res).
      {
        const float* b1 = wt.b1 + wl * Ep;
        gemm<MT>(A + Ep, Wb + Ep, ldr, Ep / 16, ld, ring,
                 [&](int r, int lc, int gc, float v0, float v1) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + gc));
          float2* rp = reinterpret_cast<float2*>(res + r * Ep + gc);
          float2 x = *rp;
          x.x += rnd(v0 + b.x);
          x.y += rnd(v1 + b.y);
          *rp = x;
          *reinterpret_cast<uint32_t*>(A + r * ldr + gc) = pack2(x.x, x.y);
        });
        if (l + 1 < num_blocks)
          ld.start(wt.wqkv + (wl + 1) * (Ep * 3 * Ep / 4), Ep,
                   qkv_cols(Ep, 0, 8));
        else
          ld.start(wt.wf, Ep, dense_cols(Ep / 8));
        ld.prefetch(ring);
      }
      BARRIER(S_W1)
    }

    // md = rnd(a·Wf + bf) into W[0, Ep).
    gemm<MT>(A, A, ldr, Ep / 16, ld, ring,
             [&](int r, int lc, int gc, float v0, float v1) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(wt.bf + gc));
      *reinterpret_cast<uint32_t*>(Wb + r * ldr + gc) =
          pack2(v0 + b.x, v1 + b.y);
    });
    BARRIER(S_FINAL)

    // scores[n, i, j] = md0_i · md1_j / sqrt(E) (the pads add zeros).
    for (int it = tid; it < G * T0 * T1; it += NT) {
      const int g = it / (T0 * T1), i = (it / T1) % T0, j = it % T1;
      if (pair0 + g >= n_pairs) continue;
      const uint4* a = reinterpret_cast<const uint4*>(Wb + (g * T0 + i) * ldr);
      const uint4* b =
          reinterpret_cast<const uint4*>(Wb + (objr + g * T1 + j) * ldr);
      float dot = 0.0f;
#pragma unroll 4
      for (int c = 0; c < Ep / 8; ++c) {
        float x[8], y[8];
        unpack8(a[c], x);
        unpack8(b[c], y);
#pragma unroll
        for (int d = 0; d < 8; ++d) dot = fmaf(x[d], y[d], dot);
      }
      scores[(size_t)pair0 * T0 * T1 + it] = dot / score_scale;
    }
    BARRIER(S_SCORES)
  }
}

template <int MT>
cudaError_t prepare(int Ep) {
  return cudaFuncSetAttribute(tc_kernel<MT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(MT, Ep));
}

// Persistent CTAs: as many as are resident at once, at most one a unit.
template <int MT>
cudaError_t grid_size(int Ep, int units, int* grid) {
  cudaError_t e = prepare<MT>(Ep);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tc_kernel<MT>, NT, smem_bytes(MT, Ep));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = units < sms * per_sm ? units : sms * per_sm;
  return cudaSuccess;
}

template <int MT>
int launch(const float* desc0, const float* desc1, const Weights& wt,
           int num_blocks, int E, int Ep, int T0, int T1, int G,
           float* scores, int n_pairs, float* ws, cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = grid_size<MT>(Ep, (n_pairs + G - 1) / G, &grid);
  if (e != cudaSuccess) return (int)e;
  tc_kernel<MT><<<grid, NT, smem_bytes(MT, Ep), stream>>>(
      desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G, scores, n_pairs, ws);
  return (int)cudaGetLastError();
}

int rows(int G, int T0, int T1) {
  return (G * T0 + 15) / 16 * 16 + (G * T1 + 15) / 16 * 16;
}

}  // namespace tc

// ------------------------------------------------------------------------
// f32: CUDA cores
// ------------------------------------------------------------------------
namespace f32 {

constexpr int CT = 4;              // columns of a thread
constexpr int UNITS = 4 * 8;       // 4-column groups of a pass: 128 columns
constexpr int RB = 4;              // k-groups of 4 in the weight ring
constexpr int MAX_ROWS = 64;       // 8 row lanes x 8 rows

struct Weights {
  const float* wqkv;  // [L, Ep, 3Ep]
  const float* bqkv;  // [L, 3Ep]
  const float* wm;    // [L, Ep, Ep]
  const float* bm;    // [L, Ep]
  const float* w0;    // [L, 2Ep, 2Ep]
  const float* s0;    // [L, 2, 2Ep]
  const float* t0;    // [L, 2, 2Ep]
  const float* w1;    // [L, 2Ep, Ep]
  const float* b1;    // [L, Ep]
  const float* wf;    // [Ep, Ep]
  const float* bf;    // [Ep]
};

__host__ __device__ inline size_t smem_bytes(int R, int Ep) {
  return (size_t)2 * R * (2 * Ep + 4) * sizeof(float);
}

// A thread's 4 weight columns, 4 k-rows at a time over all passes of a
// product (row-major W, row length N), streamed from L2 into a ring of
// registers RB - 1 groups ahead. A warp's load of a k-row is 128
// contiguous bytes (8 column lanes), shared by its 4 row lanes.
struct Loader {
  const float* W;
  ColMap cm;          // in groups of 4 columns
  int N, K4, total, step, kg, pass, off;

  __device__ __forceinline__ void at_pass(int p) {
    const int t = p * UNITS + ((threadIdx.x >> 5) & 3) * 8 + (threadIdx.x & 7);
    off = (t < cm.n ? cm.global(t) : 0) * CT;
  }
  __device__ __forceinline__ void start(const float* w, int n, int K,
                                        ColMap c) {
    W = w;
    N = n;
    cm = c;
    K4 = K / 4;
    total = (c.n + UNITS - 1) / UNITS * K4;
    step = kg = pass = 0;
    at_pass(0);
  }
  __device__ __forceinline__ void next(float4 (&w)[4]) {
    if (step < total) {
      const float* p = W + (size_t)(4 * kg) * N + off;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#ifdef T2P_NO_WEIGHT_LOADS
        const float v = __uint_as_float(
            ((uint32_t)(uintptr_t)(p + kk * N) & 0x007ffff0u) | 0x3c000000u);
        w[kk] = make_float4(v, v, v, v);
#else
        w[kk] = __ldg(reinterpret_cast<const float4*>(p + (size_t)kk * N));
#endif
      }
      ++step;
      if (++kg == K4) {
        kg = 0;
        at_pass(++pass);
      }
    }
  }
  __device__ __forceinline__ void prefetch(float4 (&ring)[RB][4]) {
#pragma unroll
    for (int r = 0; r < RB - 1; ++r) next(ring[r]);
  }
};

// out[R, 4·cm.n] = X[R, K] · W, X1 below k_split and X2 above (shared f32,
// row stride ldx), W from `ld` (started and prefetched by the caller).
// Warp w: row group w / 4 (4·RT rows), column group w % 4; lane: row lane
// lane / 8, column group lane % 8; a thread's rows are 4·RT·(w / 4) +
// lane / 8 + 4·i, its columns 4 consecutive ones of 128 a pass. epi(row,
// local column, weight column, float4) stores columns col .. col + 3.
template <int RT, typename Epi>
__device__ __forceinline__ void gemm(const float* X1, const float* X2,
                                     int ldx, int k_split, int R, Loader& ld,
                                     float4 (&ring)[RB][4], Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K4 = ld.K4, passes = ld.total / K4;
  const int r0 = (warp >> 2) * 4 * RT + (lane >> 3);
  const int k4_split = k_split / 4;
  int xoff[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) xoff[i] = min(r0 + 4 * i, R - 1) * ldx;
  const float* x2 = X2 - k_split;

  for (int p = 0; p < passes; ++p) {
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    for (int g0 = 0; g0 < K4; g0 += RB) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int kg = g0 + r;
        ld.next(ring[(r + RB - 1) % RB]);
        const float* xp = (kg < k4_split ? X1 : x2) + 4 * kg;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(xp + xoff[i]);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = ring[r][kk];
            acc[i][0] = fmaf(xs[kk], w.x, acc[i][0]);
            acc[i][1] = fmaf(xs[kk], w.y, acc[i][1]);
            acc[i][2] = fmaf(xs[kk], w.z, acc[i][2]);
            acc[i][3] = fmaf(xs[kk], w.w, acc[i][3]);
          }
        }
      }
    }
    const int t = p * UNITS + (warp & 3) * 8 + (lane & 7);
    if (t < ld.cm.n) {
      const int lc = t * CT, gc = ld.cm.global(t) * CT;
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (r0 + 4 * i < R)
          epi(r0 + 4 * i, lc, gc,
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Attention of head pair hp, a thread per (row, head): logits over the
// source set's nk rows, softmax, messages into x = A[.., Ep + h·Dp].
__device__ __forceinline__ void attend(const float* Wb, float* A, int ldr,
                                       int Ep, int Dp, float att_scale,
                                       int R, int T0, int T1, int hp,
                                       bool cross) {
  const int P = T0 + T1;
  for (int it = threadIdx.x; it < 2 * R; it += NT) {
    const int r = it % R, hh = it / R;
    const int g = r / P, own = (r % P) >= T0;
    const bool src = cross ? !own : own;
    const int kbase = g * P + (src ? T0 : 0), nk = src ? T1 : T0;
    const float* q = Wb + r * ldr + hh * Dp;
    const float* k = Wb + kbase * ldr + Ep / 2 + hh * Dp;
    const float* v = Wb + kbase * ldr + Ep + hh * Dp;
    float s[SHARED_MAX_T];
#pragma unroll
    for (int j = 0; j < SHARED_MAX_T; ++j) s[j] = 0.0f;
    for (int c = 0; c < Dp; c += 4) {
      const float4 a = ld4(q + c);
#pragma unroll
      for (int j = 0; j < SHARED_MAX_T; ++j) {
        if (j < nk) {
          const float4 b = ld4(k + j * ldr + c);
          float d = s[j];
          d = fmaf(a.x, b.x, d);
          d = fmaf(a.y, b.y, d);
          d = fmaf(a.z, b.z, d);
          d = fmaf(a.w, b.w, d);
          s[j] = d;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < SHARED_MAX_T; ++j)
      if (j < nk) {
        s[j] = s[j] / att_scale;
        mx = fmaxf(mx, s[j]);
      }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < SHARED_MAX_T; ++j)
      if (j < nk) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
#pragma unroll
    for (int j = 0; j < SHARED_MAX_T; ++j)
      if (j < nk) s[j] = s[j] / sum;
    float* out = A + r * ldr + Ep + (2 * hp + hh) * Dp;
    for (int c = 0; c < Dp; c += 4) {
      float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < SHARED_MAX_T; ++j) {
        if (j < nk) {
          const float4 b = ld4(v + j * ldr + c);
          m.x = fmaf(s[j], b.x, m.x);
          m.y = fmaf(s[j], b.y, m.y);
          m.z = fmaf(s[j], b.z, m.z);
          m.w = fmaf(s[j], b.w, m.w);
        }
      }
      st4(out + c, m);
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(NT, 1)
f32_kernel(const float* __restrict__ desc0,  // [N, T0, E]
           const float* __restrict__ desc1,  // [N, T1, E]
           Weights wt, int num_blocks, int E, int Ep, int T0, int T1, int G,
           float* __restrict__ scores,       // [N, T0, T1]
           int n_pairs) {
  extern __shared__ float4 smem_f32[];
  const int P = T0 + T1, R = G * P;
  const int ldr = 2 * Ep + 4;
  float* A = reinterpret_cast<float*>(smem_f32);   // [a (= res) | x]
  float* Wb = A + R * ldr;
  const int Dp = Ep / HEADS;
  const float att_scale = sqrtf((float)(E / HEADS));
  const float score_scale = sqrtf((float)E);
  const int tid = threadIdx.x;
  const int pair0 = blockIdx.x * G;
  STAGE_BEGIN

  for (int i = tid; i < R * (Ep / 4); i += NT) {
    const int r = i / (Ep / 4), c = (i % (Ep / 4)) * 4;
    const int g = r / P, loc = r % P;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < E && pair0 + g < n_pairs)
      x = loc < T0 ? ldg4(desc0 + ((size_t)(pair0 + g) * T0 + loc) * E + c)
                   : ldg4(desc1 + ((size_t)(pair0 + g) * T1 + loc - T0) * E +
                          c);
    st4(A + r * ldr + c, x);
  }
  Loader ld;
  float4 ring[RB][4];
  if (num_blocks > 0)
    ld.start(wt.wqkv, 3 * Ep, Ep, qkv_cols(Ep, 0, CT));
  else
    ld.start(wt.wf, Ep, Ep, dense_cols(Ep / CT));
  ld.prefetch(ring);
  BARRIER(S_LOAD)

  for (int l = 0; l < num_blocks; ++l) {
    const bool cross = (l & 1) == 1;
    const size_t wl = (size_t)l;
    const float* wqkv = wt.wqkv + wl * Ep * 3 * Ep;
    for (int hp = 0; hp < 2; ++hp) {
      const float* bqkv = wt.bqkv + wl * 3 * Ep;
      gemm<RT>(A, A, ldr, Ep, R, ld, ring,
               [&](int r, int lc, int gc, float4 v) {
        const float4 b = ldg4(bqkv + gc);
        st4(Wb + r * ldr + lc,
            make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
      });
      BARRIER(S_QKV)
      attend(Wb, A, ldr, Ep, Dp, att_scale, R, T0, T1, hp, cross);
      if (hp == 0)
        ld.start(wqkv, 3 * Ep, Ep, qkv_cols(Ep, 1, CT));
      else
        ld.start(wt.wm + wl * Ep * Ep, Ep, Ep, dense_cols(Ep / CT));
      ld.prefetch(ring);
      BARRIER(S_ATTN)
    }

    // m = msg·Wm + bm into W[0, Ep).
    {
      const float* bm = wt.bm + wl * Ep;
      gemm<RT>(A + Ep, A + Ep, ldr, Ep, R, ld, ring,
               [&](int r, int lc, int gc, float4 v) {
        const float4 b = ldg4(bm + gc);
        st4(Wb + r * ldr + gc,
            make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
      });
      ld.start(wt.w0 + wl * 4 * Ep * Ep, 2 * Ep, 2 * Ep,
               dense_cols(2 * Ep / CT));
      ld.prefetch(ring);
    }
    BARRIER(S_MERGE)

    // h1 = relu(([a | m]·W0) * s0[set] + t0[set]): below Ep into x, the
    // rest into W[Ep, 2Ep).
    {
      const float* s0 = wt.s0 + wl * 4 * Ep;
      const float* t0 = wt.t0 + wl * 4 * Ep;
      gemm<RT>(A, Wb, ldr, Ep, R, ld, ring,
               [&](int r, int lc, int gc, float4 v) {
        const int set = (r % P) >= T0 ? 2 * Ep : 0;
        const float4 s = ldg4(s0 + set + gc), t = ldg4(t0 + set + gc);
        st4(gc < Ep ? A + r * ldr + Ep + gc : Wb + r * ldr + gc,
            make_float4(tc::bn_relu(v.x, s.x, t.x), tc::bn_relu(v.y, s.y, t.y),
                        tc::bn_relu(v.z, s.z, t.z),
                        tc::bn_relu(v.w, s.w, t.w)));
      });
      ld.start(wt.w1 + wl * 2 * Ep * Ep, Ep, 2 * Ep, dense_cols(Ep / CT));
      ld.prefetch(ring);
    }
    BARRIER(S_W0)

    // res += h1·W1 + b1.
    {
      const float* b1 = wt.b1 + wl * Ep;
      gemm<RT>(A + Ep, Wb + Ep, ldr, Ep, R, ld, ring,
               [&](int r, int lc, int gc, float4 v) {
        const float4 b = ldg4(b1 + gc);
        float* rp = A + r * ldr + gc;
        const float4 x = ld4(rp);
        st4(rp, make_float4(x.x + (v.x + b.x), x.y + (v.y + b.y),
                            x.z + (v.z + b.z), x.w + (v.w + b.w)));
      });
      if (l + 1 < num_blocks)
        ld.start(wt.wqkv + (wl + 1) * Ep * 3 * Ep, 3 * Ep, Ep,
                 qkv_cols(Ep, 0, CT));
      else
        ld.start(wt.wf, Ep, Ep, dense_cols(Ep / CT));
      ld.prefetch(ring);
    }
    BARRIER(S_W1)
  }

  // md = a·Wf + bf into W[0, Ep).
  gemm<RT>(A, A, ldr, Ep, R, ld, ring,
           [&](int r, int lc, int gc, float4 v) {
    const float4 b = ldg4(wt.bf + gc);
    st4(Wb + r * ldr + gc,
        make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
  });
  BARRIER(S_FINAL)

  for (int it = tid; it < G * T0 * T1; it += NT) {
    const int g = it / (T0 * T1), i = (it / T1) % T0, j = it % T1;
    if (pair0 + g >= n_pairs) continue;
    const float* a = Wb + (g * P + i) * ldr;
    const float* b = Wb + (g * P + T0 + j) * ldr;
    float dot = 0.0f;
#pragma unroll 4
    for (int c = 0; c < Ep; c += 4) {
      const float4 x = ld4(a + c), y = ld4(b + c);
      dot = fmaf(x.x, y.x, dot);
      dot = fmaf(x.y, y.y, dot);
      dot = fmaf(x.z, y.z, dot);
      dot = fmaf(x.w, y.w, dot);
    }
    scores[(size_t)pair0 * T0 * T1 + it] = dot / score_scale;
  }
  BARRIER(S_SCORES)
}

template <int RT>
int launch_rt(const float* desc0, const float* desc1, const Weights& wt,
              int num_blocks, int E, int Ep, int T0, int T1, int G,
              float* scores, int n_pairs, cudaStream_t stream) {
  const size_t smem = smem_bytes(G * (T0 + T1), Ep);
  cudaError_t e = cudaFuncSetAttribute(
      f32_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  f32_kernel<RT><<<(n_pairs + G - 1) / G, NT, smem, stream>>>(
      desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G, scores, n_pairs);
  return (int)cudaGetLastError();
}

// Row groups of 4·RT rows: the smallest RT of {2, 4, 6, 8} that holds R.
int launch(const float* desc0, const float* desc1, const Weights& wt,
           int num_blocks, int E, int Ep, int T0, int T1, int G,
           float* scores, int n_pairs, cudaStream_t stream) {
  const int R = G * (T0 + T1);
  if (R > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (R <= 16)
    return launch_rt<2>(desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G,
                        scores, n_pairs, stream);
  if (R <= 32)
    return launch_rt<4>(desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G,
                        scores, n_pairs, stream);
  if (R <= 48)
    return launch_rt<6>(desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G,
                        scores, n_pairs, stream);
  return launch_rt<8>(desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G, scores,
                      n_pairs, stream);
}

}  // namespace f32

// ------------------------------------------------------------------------
// The wide route: G pairs a CTA, rows in a global workspace slice, weight
// and row k-slices staged through shared memory
// ------------------------------------------------------------------------
namespace wide {

constexpr int STAGES = 4;      // k-slices in the ring, STAGES - 1 in flight

__host__ __device__ inline size_t align256(size_t x) {
  return (x + 255) & ~(size_t)255;
}

// Rows of G pairs, set-major in 16-row tiles as on the tensor-core route:
// the objects of all G pairs, then their hints.
__host__ __device__ inline int rows(int G, int T0, int T1) {
  return (G * T0 + 15) / 16 * 16 + (G * T1 + 15) / 16 * 16;
}

// Byte offsets of a CTA's slice of R rows at the padded width: the f32
// residual (bf16 only; in f32 it is a itself), a | m (2Ep), q | k | v (3Ep,
// which h1 and md reuse once the attention has read it), the messages (Ep)
// and the attention's scratch (prob): in bf16 each warp's logits, in f32
// the probabilities of each (row, head) over the source set.
struct Layout {
  int R;
  size_t res, am, qkv, msg, prob, total;
};

// A warp's logits of one attention unit: 8 floats a lane a 16-key chunk,
// for up to ceil(T0 / 16) chunks.
__host__ __device__ inline size_t logit_bytes(int T0) {
  return (size_t)WARPS * ((T0 + 15) / 16) * 32 * 8 * 4;
}

__host__ __device__ inline Layout layout(int Ep, int T0, int T1, int G,
                                         bool bf16) {
  Layout l;
  l.R = rows(G, T0, T1);
  const size_t s = bf16 ? 2 : 4, R = (size_t)l.R;
  l.res = 0;
  l.am = bf16 ? align256(R * Ep * 4) : 0;
  l.qkv = l.am + align256(R * 2 * Ep * s);
  l.msg = l.qkv + align256(R * 3 * Ep * s);
  l.prob = l.msg + align256(R * Ep * s);
  l.total = l.prob + align256(bf16 ? logit_bytes(T0)
                                   : R * HEADS * (size_t)T0 * 4);
  return l;
}

// 16 bytes global -> shared through L2 only: a CTA reads back the rows its
// own epilogues wrote, and no tile reads a row or weight twice.
__device__ __forceinline__ void cp_async16_cg(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
}

// d = a·b for a 16x16 A tile and a 16x8 B tile, bf16 inputs, summed by the
// tensor cores in a zeroed accumulator: mma_add in two steps, so that the
// products of several tiles are in flight before their rounded adds.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Where a CTA's rows lie: the objects of pair g from g·T0, its hints from
// objr + g·T1.
struct Rows {
  int G, T0, T1, objr;
  __device__ __forceinline__ int obj(int g) const { return g * T0; }
  __device__ __forceinline__ int hint(int g) const { return objr + g * T1; }
};

// The pairs' objects, then their hints, as f32 x; zeros in the padding
// rows, the padding channels and past the last pair. put(r, c, x) stores
// channels c .. c + 3 of row r.
template <typename Put>
__device__ __forceinline__ void load_rows(const float* __restrict__ desc0,
                                          const float* __restrict__ desc1,
                                          int E, int Ep, int R, Rows rw,
                                          int pair0, int n_pairs, Put put) {
  for (int i = threadIdx.x; i < R * (Ep / 4); i += NT) {
    const int r = i / (Ep / 4), c = (i % (Ep / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < E) {
      const float* src = nullptr;
      if (r < rw.objr) {
        if (r < rw.G * rw.T0 && pair0 + r / rw.T0 < n_pairs)
          src = desc0 + ((size_t)pair0 * rw.T0 + r) * E + c;
      } else {
        const int h = r - rw.objr;
        if (h < rw.G * rw.T1 && pair0 + h / rw.T1 < n_pairs)
          src = desc1 + ((size_t)pair0 * rw.T1 + h) * E + c;
      }
      if (src) x = __ldg(reinterpret_cast<const float4*>(src));
    }
    put(r, c, x);
  }
}

// ---- bf16: mma.sync on the tensor cores ----------------------------------

constexpr int MC = 128;                 // rows of an m-chunk: 8 m-tiles
constexpr int KSL = 64;                 // k of a slice
constexpr int KK = KSL / 16;            // its k-steps
constexpr int ALD = KSL + 8;            // A row stride in a stage (144 B)
constexpr int A_BYTES = MC * ALD * 2;   // 18,432
constexpr int B_BYTES = 32 * KK * 256;  // 32 n-tiles x KK k-steps, fragments
constexpr int TC_STAGE = A_BYTES + B_BYTES;
constexpr int TC_SMEM = STAGES * TC_STAGE;   // 204,800 bytes

// What a bf16 product does with its sums (epi_tc): QKV, MERGE and FINAL
// add a bias and store rnd(v) to out (row stride ldo); W0 stores
// rnd(relu(v · s0[set] + t0[set])) (s0, t0 the block's [2, 2Ep] rows); W1
// adds rnd(v + b1) to the f32 residual and stores a = rnd(res) to out.
enum Product { P_BIAS, P_W0, P_W1 };

struct EpiTc {
  Product kind;
  const float* bias;   // P_BIAS, P_W1
  const float* s0;     // P_W0
  const float* t0;     // P_W0
  float* res;          // P_W1: [R][Ep]
  __nv_bfloat16* out;
  int ldo, Ep, objr;
};

__device__ __forceinline__ void epi_tc(const EpiTc& e, int r, int c,
                                       float v0, float v1) {
  uint32_t* out =
      reinterpret_cast<uint32_t*>(e.out + (size_t)r * e.ldo + c);
  if (e.kind == P_W0) {
    const int o = (r >= e.objr ? 2 * e.Ep : 0) + c;
    const float2 s = __ldg(reinterpret_cast<const float2*>(e.s0 + o));
    const float2 t = __ldg(reinterpret_cast<const float2*>(e.t0 + o));
    *out = pack2(tc::bn_relu(v0, s.x, t.x), tc::bn_relu(v1, s.y, t.y));
    return;
  }
  const float2 b = __ldg(reinterpret_cast<const float2*>(e.bias + c));
  if (e.kind == P_BIAS) {
    *out = pack2(v0 + b.x, v1 + b.y);
    return;
  }
  float2* rp = reinterpret_cast<float2*>(e.res + (size_t)r * e.Ep + c);
  float2 x = *rp;
  x.x += rnd(v0 + b.x);
  x.y += rnd(v1 + b.y);
  *rp = x;
  *out = pack2(x.x, x.y);
}

// One output tile of gemm_tc: rows m0 .. m0 + 16·mt, columns n0 .. n0 +
// 8·ntc, WM warps down the rows (a warp's m-tiles wm, wm + WM, ...) and 8 /
// WM across (4 n-tiles each, NC = 256 / WM columns). Per k-slice the rows
// (16·mt x KSL) and the weight fragments (KSL x 8·ntc) are copied by
// cp.async into a ring of STAGES slots, STAGES - 1 ahead. FULL: every
// m-tile and n-tile of the warp is real, so that no instruction is
// predicated and a k-step's A fragments and products are all in flight
// before its rounded adds.
template <int WM, bool FULL>
__device__ __forceinline__ void tile_tc(const unsigned char* xs, int ldx,
                                        int mt, int m0, int n0, int ntc,
                                        int KS, int KT, const uint2* W,
                                        unsigned char* smem, const EpiTc& e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const unsigned char* ws =
      reinterpret_cast<const unsigned char*>(W + (size_t)(n0 / 8) * KS * 32);
  // 16-byte copies: A chunk i is part i % (KSL / 8) of row i / (KSL / 8),
  // B chunk i part i % KSL of n-tile i / KSL (its k-steps' fragments, KK x
  // 256 bytes).
  auto stage = [&](int kt) {
    unsigned char* st = smem + (kt % STAGES) * TC_STAGE;
    for (int i = threadIdx.x; i < mt * 2 * KSL; i += NT)
      cp_async16_cg(st + (i / (KSL / 8)) * (ALD * 2) + (i % (KSL / 8)) * 16,
                    xs + (unsigned)((i / (KSL / 8)) * ldx * 2 + kt * KSL * 2 +
                                    (i % (KSL / 8)) * 16));
    for (int i = threadIdx.x; i < ntc * KSL; i += NT)
      cp_async16_cg(st + A_BYTES + i * 16,
                    ws + (unsigned)((i / KSL) * KS * 256 + kt * KK * 256 +
                                    (i % KSL) * 16));
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_ring();
    __syncthreads();
    if (kt + STAGES - 1 < KT) stage(kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * TC_STAGE;
    const uint32_t a_addr = smem_addr(st) + (lane & 15) * (ALD * 2) +
                            (lane >> 4) * 16 + wm * 16 * (ALD * 2);
    const unsigned char* b_ptr = st + A_BYTES + wn * 4 * KK * 256 + lane * 8;
    // Two k-steps at a time (239 registers; one at a time took 13% longer
    // at (768, 48, 6)).
#pragma unroll 2
    for (int kk = 0; kk < KK; ++kk) {
      uint2 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const uint2*>(b_ptr + (j * KK + kk) * 256);
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (FULL || wm + WM * i < mt)
          ldmatrix_x4(a[i], a_addr + i * WM * 16 * (ALD * 2) + kk * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (FULL || wm + WM * i < mt) {
          float d[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || wn * 4 + j < ntc) mma_zero(d[j], a[i], b[j].x, b[j].y);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || wn * 4 + j < ntc)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += d[j][q];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = wm + WM * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (FULL || (m < mt && wn * 4 + j < ntc)) {
        const int r = m0 + m * 16 + gid;
        const int c = n0 + (wn * 4 + j) * 8 + 2 * tig;
        epi_tc(e, r, c, acc[i][j][0], acc[i][j][1]);
        epi_tc(e, r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  __syncthreads();   // the ring's slots and the outputs, for what follows
}

// out[R, N] = X[R, K] · W for the CTA's R rows (a multiple of 16): X bf16
// rows of the workspace (row stride ldx), W bf16 in fragment order
// [N/8, K/16, 32 lanes] uint2, the sums to epi_tc. The rows go in m-chunks
// of up to 128 and the columns in n-chunks: up to 4 m-tiles the 8 warps
// split the columns (NC = 256), past 4 they are 2 x 4 (NC = 128). Every
// k-step's 16 products are summed by the tensor cores in a zeroed
// accumulator and added to the running sum with rounded f32 adds, in k
// order, so a row's sums do not depend on where it sits.
__device__ __noinline__ void gemm_tc(const __nv_bfloat16* X, int ldx, int R,
                                     int K, int N,
                                     const uint2* __restrict__ W,
                                     unsigned char* smem, EpiTc e) {
  const int KS = K / 16, KT = K / KSL;
  for (int m0 = 0; m0 < R; m0 += MC) {
    const int mt = min(MC, R - m0) / 16;
    const unsigned char* xs =
        reinterpret_cast<const unsigned char*>(X + (size_t)m0 * ldx);
    if (mt > 4) {
      for (int n0 = 0; n0 < N; n0 += 128) {
        const int ntc = min(128, N - n0) / 8;
        if (mt == 8 && ntc == 16)
          tile_tc<2, true>(xs, ldx, mt, m0, n0, ntc, KS, KT, W, smem, e);
        else
          tile_tc<2, false>(xs, ldx, mt, m0, n0, ntc, KS, KT, W, smem, e);
      }
    } else {
      for (int n0 = 0; n0 < N; n0 += 256) {
        const int ntc = min(256, N - n0) / 8;
        if (mt == 4 && ntc == 32)
          tile_tc<1, true>(xs, ldx, mt, m0, n0, ntc, KS, KT, W, smem, e);
        else
          tile_tc<1, false>(xs, ldx, mt, m0, n0, ntc, KS, KT, W, smem, e);
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of different rows as one register (p in the low half).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p,
                                            const __nv_bfloat16* q) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(p) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(q) << 16);
}

// Logits of 16 query rows against keys 16·kc .. 16·kc + 15 (rows kr of
// stride ld; keys past nk read the last one and are set to -inf): s[nt]
// holds keys 8·nt + 2·tig + (i & 1) of rows gid (i < 2) and gid + 8.
__device__ __forceinline__ void logits(const __nv_bfloat16* q0,
                                       const __nv_bfloat16* q1,
                                       const __nv_bfloat16* kr, int ld,
                                       int kc, int nk, int Dp,
                                       float att_scale, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
  const __nv_bfloat16* k0 = kr + (size_t)min(16 * kc + gid, nk - 1) * ld;
  const __nv_bfloat16* k1 = kr + (size_t)min(16 * kc + 8 + gid, nk - 1) * ld;
  for (int c = 2 * tig; c < Dp; c += 16) {
    const uint32_t a[4] = {ld_u32(q0 + c), ld_u32(q1 + c), ld_u32(q0 + c + 8),
                           ld_u32(q1 + c + 8)};
    float d[2][4];
    mma_zero(d[0], a, ld_u32(k0 + c), ld_u32(k0 + c + 8));
    mma_zero(d[1], a, ld_u32(k1 + c), ld_u32(k1 + c + 8));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += d[nt][i];
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 16 * kc + 8 * nt + 2 * tig + (i & 1);
      s[nt][i] = key < nk ? __fdiv_rn(s[nt][i], att_scale) : -INFINITY;
    }
}

// The attention of every head on the warps, a unit (pair, head, query
// set, 16-row query tile) a warp; q|k|v of row r at qkv + r·3Ep (head h at
// h·Dp of each), the messages to msg + r·Ep + h·Dp. A first pass over the
// key chunks computes the logits, keeps them in the warp's slice of the
// workspace (lg: 8 floats a lane a chunk) and reads the row maxima; a
// second sums exp(s − max); a third, for each block of 64 channels, rounds
// the normalised probabilities to bf16 and sums P·V: the plain version's
// rounding points for any number of keys, with the logits computed once.
// Spare query rows repeat the last real one.
__device__ __forceinline__ void attend_tc(const __nv_bfloat16* qkv,
                                          __nv_bfloat16* msg, float* lg,
                                          int Ep, int Dp, float att_scale,
                                          Rows rw, bool cross) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt0 = (rw.T0 + 15) / 16, qt1 = (rw.T1 + 15) / 16;
  const int per_head = qt0 + qt1, ld = 3 * Ep, NTD = Dp / 8;
  float4* mine = reinterpret_cast<float4*>(lg) + (warp * qt0 * 32 + lane) * 2;
  for (int u = warp; u < rw.G * HEADS * per_head; u += WARPS) {
    const int g = u / (HEADS * per_head), v = u % (HEADS * per_head);
    const int h = v / per_head, qv = v % per_head;
    const bool hints = qv >= qt0;
    const int qt = hints ? qv - qt0 : qv;
    const int qbase = (hints ? rw.hint(g) : rw.obj(g)) + 16 * qt;
    const int nq = min(16, (hints ? rw.T1 : rw.T0) - 16 * qt);
    const bool khints = hints != cross;
    const int kbase = khints ? rw.hint(g) : rw.obj(g);
    const int nk = khints ? rw.T1 : rw.T0, nkc = (nk + 15) / 16;
    const __nv_bfloat16* q0 =
        qkv + (size_t)(qbase + min(gid, nq - 1)) * ld + h * Dp;
    const __nv_bfloat16* q1 =
        qkv + (size_t)(qbase + min(gid + 8, nq - 1)) * ld + h * Dp;
    const __nv_bfloat16* kr = qkv + (size_t)kbase * ld + Ep + h * Dp;
    const __nv_bfloat16* vr = qkv + (size_t)kbase * ld + 2 * Ep + h * Dp;

    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
    float s[2][4];
    for (int kc = 0; kc < nkc; ++kc) {
      logits(q0, q1, kr, ld, kc, nk, Dp, att_scale, s);
      mine[kc * 64] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
      mine[kc * 64 + 1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    }
    auto load = [&](int kc) {
      const float4 a = mine[kc * 64], b = mine[kc * 64 + 1];
      s[0][0] = a.x, s[0][1] = a.y, s[0][2] = a.z, s[0][3] = a.w;
      s[1][0] = b.x, s[1][1] = b.y, s[1][2] = b.z, s[1][3] = b.w;
    };
    for (int kc = 0; kc < nkc; ++kc) {
      load(kc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i >> 1] += expf(s[nt][i] - mx[i >> 1]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
    }
    for (int cb = 0; cb < NTD; cb += 8) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
      for (int kc = 0; kc < nkc; ++kc) {
        load(kc);
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[nt][i] = __fdiv_rn(expf(s[nt][i] - mx[i >> 1]), sum[i >> 1]);
        const uint32_t pa[4] = {pack2(p[0][0], p[0][1]), pack2(p[0][2], p[0][3]),
                                pack2(p[1][0], p[1][1]), pack2(p[1][2], p[1][3])};
        const int key = 16 * kc + 2 * tig;
        const __nv_bfloat16* v0 = vr + (size_t)min(key, nk - 1) * ld;
        const __nv_bfloat16* v1 = vr + (size_t)min(key + 1, nk - 1) * ld;
        const __nv_bfloat16* v8 = vr + (size_t)min(key + 8, nk - 1) * ld;
        const __nv_bfloat16* v9 = vr + (size_t)min(key + 9, nk - 1) * ld;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (cb + n < NTD) {
            const int ch = (cb + n) * 8 + gid;
            float d[4];
            mma_zero(d, pa, ld_pair(v0 + ch, v1 + ch),
                     ld_pair(v8 + ch, v9 + ch));
#pragma unroll
            for (int i = 0; i < 4; ++i) o[n][i] += d[i];
          }
        }
      }
      __nv_bfloat16* out = msg + (size_t)qbase * Ep + h * Dp + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (cb + n < NTD) {
          __nv_bfloat16* po = out + (cb + n) * 8;
          if (gid < nq)
            *reinterpret_cast<uint32_t*>(po + (size_t)gid * Ep) =
                pack2(o[n][0], o[n][1]);
          if (gid + 8 < nq)
            *reinterpret_cast<uint32_t*>(po + (size_t)(gid + 8) * Ep) =
                pack2(o[n][2], o[n][3]);
        }
      }
    }
  }
}

// ---- f32: FMAs on the CUDA cores -----------------------------------------

constexpr int FMC = 64;                 // rows of an m-chunk: 8 a warp
constexpr int CTW = 2;                  // 4-column groups of a thread
constexpr int FNC = 128 * CTW;          // columns of an n-chunk
constexpr int FKSL = 16;                // k of a slice: 4 groups of 4
constexpr int FALD = FKSL + 4;          // A row stride in a stage (80 B)
constexpr int FA_BYTES = FMC * FALD * 4;     // 5,120
constexpr int F_STAGE = FA_BYTES + FKSL * FNC * 4;
constexpr int F_SMEM = STAGES * F_STAGE;     // 86,016 bytes

// What an f32 product does with its sums, as epi_tc without the roundings:
// W1 adds v + b1 to the residual, which is a itself (out).
struct EpiF32 {
  Product kind;
  const float* bias;   // P_BIAS, P_W1
  const float* s0;     // P_W0
  const float* t0;     // P_W0
  float* out;
  int ldo, Ep, objr;
};

__device__ __forceinline__ void epi_f32(const EpiF32& e, int r, int c,
                                        float4 v) {
  float4* out = reinterpret_cast<float4*>(e.out + (size_t)r * e.ldo + c);
  if (e.kind == P_W0) {
    const int o = (r >= e.objr ? 2 * e.Ep : 0) + c;
    const float4 s = __ldg(reinterpret_cast<const float4*>(e.s0 + o));
    const float4 t = __ldg(reinterpret_cast<const float4*>(e.t0 + o));
    *out = make_float4(tc::bn_relu(v.x, s.x, t.x), tc::bn_relu(v.y, s.y, t.y),
                       tc::bn_relu(v.z, s.z, t.z), tc::bn_relu(v.w, s.w, t.w));
    return;
  }
  const float4 b = __ldg(reinterpret_cast<const float4*>(e.bias + c));
  if (e.kind == P_BIAS) {
    *out = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    return;
  }
  const float4 x = *out;
  *out = make_float4(x.x + (v.x + b.x), x.y + (v.y + b.y), x.z + (v.z + b.z),
                     x.w + (v.w + b.w));
}

// out[R, N] = X[R, K] · W[K, N] (row-major f32), the sums to epi_f32: the
// structure of gemm_tc with thread tiles of 8 rows x CTW groups of 4
// columns (warp w the rows 8w.., lane l the columns 4l + 128g; a warp's
// row loads broadcast), each group of 4 k-values summed in a register of
// its own before it is added to the running sum.
__device__ __noinline__ void gemm_f32(const float* X, int ldx, int R, int K,
                                      int N, const float* __restrict__ W,
                                      unsigned char* smem, EpiF32 e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KT = K / FKSL;
  for (int m0 = 0; m0 < R; m0 += FMC) {
    const int mr = min(FMC, R - m0);
    for (int n0 = 0; n0 < N; n0 += FNC) {
      const int nc4 = min(FNC, N - n0) / 4;
      auto stage = [&](int kt) {
        unsigned char* st = smem + (kt % STAGES) * F_STAGE;
        for (int i = threadIdx.x; i < mr * 4; i += NT) {
          const int r = i >> 2, c = i & 3;
          cp_async16_cg(st + r * (FALD * 4) + c * 16,
                        X + (size_t)(m0 + r) * ldx + kt * FKSL + c * 4);
        }
        for (int i = threadIdx.x; i < FKSL * nc4; i += NT) {
          const int k = i / nc4, c = i % nc4;
          cp_async16_cg(st + FA_BYTES + k * (FNC * 4) + c * 16,
                        W + (size_t)(kt * FKSL + k) * N + n0 + c * 4);
        }
      };
      float acc[8][CTW][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int g = 0; g < CTW; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.0f;
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) stage(s);
        cp_async_commit();
      }
      for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait_ring();
        __syncthreads();
        if (kt + STAGES - 1 < KT) stage(kt + STAGES - 1);
        cp_async_commit();
        const unsigned char* st = smem + (kt % STAGES) * F_STAGE;
        const float* xa = reinterpret_cast<const float*>(st) + warp * 8 * FALD;
        const float* wa =
            reinterpret_cast<const float*>(st + FA_BYTES) + lane * 4;
#pragma unroll
        for (int g4 = 0; g4 < FKSL / 4; ++g4) {
          float4 w[4][CTW];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int g = 0; g < CTW; ++g)
              w[kk][g] = *reinterpret_cast<const float4*>(
                  wa + (4 * g4 + kk) * FNC + 128 * g);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 x =
                *reinterpret_cast<const float4*>(xa + i * FALD + 4 * g4);
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int g = 0; g < CTW; ++g) {
              float part[4] = {xs[0] * w[0][g].x, xs[0] * w[0][g].y,
                               xs[0] * w[0][g].z, xs[0] * w[0][g].w};
#pragma unroll
              for (int kk = 1; kk < 4; ++kk) {
                part[0] = fmaf(xs[kk], w[kk][g].x, part[0]);
                part[1] = fmaf(xs[kk], w[kk][g].y, part[1]);
                part[2] = fmaf(xs[kk], w[kk][g].z, part[2]);
                part[3] = fmaf(xs[kk], w[kk][g].w, part[3]);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][g][j] += part[j];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < CTW; ++g) {
        if (lane + 32 * g < nc4) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (warp * 8 + i < mr)
              epi_f32(e, m0 + warp * 8 + i, n0 + 128 * g + lane * 4,
                      make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2],
                                  acc[i][g][3]));
        }
      }
      __syncthreads();
    }
  }
}

// The attention of every head, a thread per (real row, head): logits over
// the source set's rows, softmax, probabilities to prob; then a thread per
// (real row, channel) sums the messages.
__device__ __forceinline__ void attend_f32(const float* qkv, float* msg,
                                           float* prob, int Ep, int Dp,
                                           float att_scale, Rows rw,
                                           bool cross) {
  const int n0 = rw.G * rw.T0, n = n0 + rw.G * rw.T1, ld = 3 * Ep;
  auto row_of = [&](int q, int& kbase, int& nk) {
    const bool hints = q >= n0;
    const int g = hints ? (q - n0) / rw.T1 : q / rw.T0;
    const bool khints = hints != cross;
    kbase = khints ? rw.hint(g) : rw.obj(g);
    nk = khints ? rw.T1 : rw.T0;
    return hints ? rw.objr + (q - n0) : q;
  };
  for (int it = threadIdx.x; it < n * HEADS; it += NT) {
    int kbase, nk;
    const int r = row_of(it / HEADS, kbase, nk), h = it % HEADS;
    const float* q = qkv + (size_t)r * ld + h * Dp;
    float* pr = prob + ((size_t)r * HEADS + h) * rw.T0;
    float mx = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const float* kr = qkv + (size_t)(kbase + j) * ld + Ep + h * Dp;
      float dot = 0.0f;
      for (int d = 0; d < Dp; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q + d);
        const float4 b = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
      const float s = dot / att_scale;
      pr[j] = s;
      mx = fmaxf(mx, s);
    }
    float sum = 0.0f;
    for (int j = 0; j < nk; ++j) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    for (int j = 0; j < nk; ++j) pr[j] = pr[j] / sum;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < n * (Ep / 4); it += NT) {
    int kbase, nk;
    const int r = row_of(it / (Ep / 4), kbase, nk);
    const int c = (it % (Ep / 4)) * 4, h = c / Dp;
    const float* pr = prob + ((size_t)r * HEADS + h) * rw.T0;
    const float* vc = qkv + (size_t)kbase * ld + 2 * Ep + c;
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < nk; ++j) {
      const float p = pr[j];
      const float4 v = *reinterpret_cast<const float4*>(vc + (size_t)j * ld);
      m.x = fmaf(p, v.x, m.x);
      m.y = fmaf(p, v.y, m.y);
      m.z = fmaf(p, v.z, m.z);
      m.w = fmaf(p, v.w, m.w);
    }
    *reinterpret_cast<float4*>(msg + (size_t)r * Ep + c) = m;
  }
}

// ---- the kernel -----------------------------------------------------------

template <bool BF16> struct Types;
template <> struct Types<true> {
  using T = __nv_bfloat16;
  using Weights = tc::Weights;
  static constexpr int SMEM = TC_SMEM;
};
template <> struct Types<false> {
  using T = float;
  using Weights = f32::Weights;
  static constexpr int SMEM = F_SMEM;
};

// Scores of the CTA's pairs: md0_i · md1_j / sqrt(E) (the pads add zeros),
// md rows of stride Ep.
template <typename T>
__device__ __forceinline__ void scores_of(const T* md, int Ep, Rows rw,
                                          int pair0, int n_pairs,
                                          float score_scale, float* scores) {
  const int TT = rw.T0 * rw.T1;
  for (int it = threadIdx.x; it < rw.G * TT; it += NT) {
    const int g = it / TT, i = (it / rw.T1) % rw.T0, j = it % rw.T1;
    if (pair0 + g >= n_pairs) continue;
    const T* a = md + (size_t)(rw.obj(g) + i) * Ep;
    const T* b = md + (size_t)(rw.hint(g) + j) * Ep;
    float dot = 0.0f;
    if constexpr (sizeof(T) == 2) {
      for (int c = 0; c < Ep; c += 8) {
        float x[8], y[8];
        unpack8(*reinterpret_cast<const uint4*>(a + c), x);
        unpack8(*reinterpret_cast<const uint4*>(b + c), y);
#pragma unroll
        for (int d = 0; d < 8; ++d) dot = fmaf(x[d], y[d], dot);
      }
    } else {
      for (int c = 0; c < Ep; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + c);
        const float4 y = *reinterpret_cast<const float4*>(b + c);
        dot = fmaf(x.x, y.x, dot);
        dot = fmaf(x.y, y.y, dot);
        dot = fmaf(x.z, y.z, dot);
        dot = fmaf(x.w, y.w, dot);
      }
    }
    scores[(size_t)pair0 * TT + it] = dot / score_scale;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 1)
wide_kernel(const float* __restrict__ desc0,  // [N, T0, E]
            const float* __restrict__ desc1,  // [N, T1, E]
            typename Types<BF16>::Weights wt, int num_blocks, int E, int Ep,
            int T0, int T1, int G,
            float* __restrict__ scores,       // [N, T0, T1]
            int n_pairs, unsigned char* workspace) {
  using T = typename Types<BF16>::T;
  extern __shared__ uint4 smem_wide[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_wide);
  const Layout lay = layout(Ep, T0, T1, G, BF16);
  unsigned char* base = workspace + (size_t)blockIdx.x * lay.total;
  float* res = reinterpret_cast<float*>(base + lay.res);   // bf16 only
  T* am = reinterpret_cast<T*>(base + lay.am);     // [R][2Ep]: a | m
  T* qkv = reinterpret_cast<T*>(base + lay.qkv);   // [R][3Ep]; h1, md
  T* msg = reinterpret_cast<T*>(base + lay.msg);   // [R][Ep]
  float* prob = reinterpret_cast<float*>(base + lay.prob);  // attention
  const int R = lay.R, Dp = Ep / HEADS;
  const Rows rw{G, T0, T1, (G * T0 + 15) / 16 * 16};
  const float att_scale = sqrtf((float)(E / HEADS));
  const float score_scale = sqrtf((float)E);
  const int units = (n_pairs + G - 1) / G;
  STAGE_BEGIN

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int pair0 = unit * G;
    load_rows(desc0, desc1, E, Ep, R, rw, pair0, n_pairs,
              [&](int r, int c, float4 x) {
      if constexpr (BF16) {
        *reinterpret_cast<float4*>(res + (size_t)r * Ep + c) = x;
        *reinterpret_cast<uint2*>(am + (size_t)r * 2 * Ep + c) =
            make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
      } else {
        *reinterpret_cast<float4*>(am + (size_t)r * 2 * Ep + c) = x;
      }
    });
    BARRIER(S_LOAD)

    for (int l = 0; l < num_blocks; ++l) {
      const bool cross = (l & 1) == 1;
      const size_t wl = (size_t)l;
      // The epilogues index the biases and BN affines from wl themselves:
      // pointers held across the products cost registers.
      if constexpr (BF16) {
        // q|k|v = rnd(a·Wqkv + b).
        gemm_tc(am, 2 * Ep, R, Ep, 3 * Ep, wt.wqkv + wl * (Ep * 3 * Ep / 4),
                smem, EpiTc{P_BIAS, wt.bqkv + wl * 3 * Ep, nullptr, nullptr,
                            nullptr, qkv, 3 * Ep, Ep, rw.objr});
        BARRIER(S_QKV)
        attend_tc(qkv, msg, prob, Ep, Dp, att_scale, rw, cross);
        BARRIER(S_ATTN)
        // m = rnd(msg·Wm + bm) into a | m.
        gemm_tc(msg, Ep, R, Ep, Ep, wt.wm + wl * (Ep * Ep / 4), smem,
                EpiTc{P_BIAS, wt.bm + wl * Ep, nullptr, nullptr, nullptr,
                      am + Ep, 2 * Ep, Ep, rw.objr});
        BARRIER(S_MERGE)
        // h1 = rnd(relu(([a | m]·W0) * s0[set] + t0[set])) over q|k.
        gemm_tc(am, 2 * Ep, R, 2 * Ep, 2 * Ep, wt.w0 + wl * (Ep * Ep), smem,
                EpiTc{P_W0, nullptr, wt.s0 + wl * 4 * Ep,
                      wt.t0 + wl * 4 * Ep, nullptr, qkv, 2 * Ep, Ep,
                      rw.objr});
        BARRIER(S_W0)
        // res += rnd(h1·W1 + b1); a gets rnd(res).
        gemm_tc(qkv, 2 * Ep, R, 2 * Ep, Ep, wt.w1 + wl * (Ep * Ep / 2), smem,
                EpiTc{P_W1, wt.b1 + wl * Ep, nullptr, nullptr, res, am,
                      2 * Ep, Ep, rw.objr});
        BARRIER(S_W1)
      } else {
        gemm_f32(am, 2 * Ep, R, Ep, 3 * Ep, wt.wqkv + wl * 3 * Ep * Ep, smem,
                 EpiF32{P_BIAS, wt.bqkv + wl * 3 * Ep, nullptr, nullptr, qkv,
                        3 * Ep, Ep, rw.objr});
        BARRIER(S_QKV)
        attend_f32(qkv, msg, prob, Ep, Dp, att_scale, rw, cross);
        BARRIER(S_ATTN)
        gemm_f32(msg, Ep, R, Ep, Ep, wt.wm + wl * Ep * Ep, smem,
                 EpiF32{P_BIAS, wt.bm + wl * Ep, nullptr, nullptr, am + Ep,
                        2 * Ep, Ep, rw.objr});
        BARRIER(S_MERGE)
        gemm_f32(am, 2 * Ep, R, 2 * Ep, 2 * Ep, wt.w0 + wl * 4 * Ep * Ep,
                 smem, EpiF32{P_W0, nullptr, wt.s0 + wl * 4 * Ep,
                              wt.t0 + wl * 4 * Ep, qkv, 2 * Ep, Ep, rw.objr});
        BARRIER(S_W0)
        gemm_f32(qkv, 2 * Ep, R, 2 * Ep, Ep, wt.w1 + wl * 2 * Ep * Ep, smem,
                 EpiF32{P_W1, wt.b1 + wl * Ep, nullptr, nullptr, am, 2 * Ep,
                        Ep, rw.objr});
        BARRIER(S_W1)
      }
    }

    // md = rnd(a·Wf + bf) over q|k|v, then the scores.
    if constexpr (BF16) {
      gemm_tc(am, 2 * Ep, R, Ep, Ep, wt.wf, smem,
              EpiTc{P_BIAS, wt.bf, nullptr, nullptr, nullptr, qkv, Ep, Ep,
                    rw.objr});
    } else {
      gemm_f32(am, 2 * Ep, R, Ep, Ep, wt.wf, smem,
               EpiF32{P_BIAS, wt.bf, nullptr, nullptr, qkv, Ep, Ep, rw.objr});
    }
    BARRIER(S_FINAL)
    scores_of(qkv, Ep, rw, pair0, n_pairs, score_scale, scores);
    BARRIER(S_SCORES)   // the next unit overwrites the rows
  }
}

// Persistent CTAs, one an SM (at most one a unit): the workspace holds a
// slice for each.
int ctas(int units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return units < sms ? units : sms;
}

template <bool BF16>
int launch(const float* desc0, const float* desc1,
           const typename Types<BF16>::Weights& wt, int num_blocks, int E,
           int Ep, int T0, int T1, int G, float* scores, int n_pairs,
           unsigned char* workspace, cudaStream_t stream) {
  constexpr int smem = Types<BF16>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      wide_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wide_kernel<BF16><<<ctas((n_pairs + G - 1) / G), NT, smem, stream>>>(
      desc0, desc1, wt, num_blocks, E, Ep, T0, T1, G, scores, n_pairs,
      workspace);
  return (int)cudaGetLastError();
}

}  // namespace wide

// What the kernels need of a shape: heads of whole 16-channel k-steps in
// bf16 (Ep a multiple of 64) and of float4s in f32 (of 16); no bound on E,
// T0 or T1 but what the card's memory holds.
bool shape_ok(int E, int Ep, int T0, int T1, int bf16) {
  return E >= 4 && E % 4 == 0 && E <= Ep && Ep % (bf16 ? 64 : 16) == 0 &&
         T1 >= 1 && T1 <= T0;
}

// The shared route's rows at G pairs a CTA, in its layout: bf16 objects
// then hints in 16-row tiles, f32 pair by pair. The wrapper's plan
// (any_plan) chooses G; a G whose rows no instantiation takes, or whose
// shared memory the card refuses, fails the launch.
int shared_rows(int T0, int T1, int bf16, int G) {
  if (G < 1 || T0 > SHARED_MAX_T) return 0;
  return bf16 ? tc::rows(G, T0, T1) : G * (T0 + T1);
}

int tc_grid(int MT, int Ep, int units, int* grid) {
  switch (MT) {
    case 2: return (int)tc::grid_size<2>(Ep, units, grid);
    case 3: return (int)tc::grid_size<3>(Ep, units, grid);
    case 4: return (int)tc::grid_size<4>(Ep, units, grid);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of global workspace a launch needs: the bf16 shared route's f32
// residual of its persistent CTAs, the wide route's rows; 0 for the f32
// shared route. route: 0 shared, 1 wide; pairs_per_cta as the plan says.
// Returns a cudaError_t.
extern "C" int t2p_superglue_gnn_any_workspace(int E, int Ep, int T0, int T1,
                                               int bf16, int route,
                                               int pairs_per_cta, int n_pairs,
                                               long long* bytes) {
  if (!shape_ok(E, Ep, T0, T1, bf16) || n_pairs < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = 0;
  if (route == WIDE) {
    if (pairs_per_cta < 1) return (int)cudaErrorInvalidValue;
    const int units = (n_pairs + pairs_per_cta - 1) / pairs_per_cta;
    *bytes = (long long)wide::ctas(units) *
             (long long)wide::layout(Ep, T0, T1, pairs_per_cta, bf16 != 0)
                 .total;
    return 0;
  }
  const int R = shared_rows(T0, T1, bf16, pairs_per_cta);
  if (route != SHARED || R == 0) return (int)cudaErrorInvalidValue;
  if (!bf16) return 0;
  int grid = 0;
  const int e = tc_grid(R / 16, Ep,
                        (n_pairs + pairs_per_cta - 1) / pairs_per_cta, &grid);
  if (e) return e;
  *bytes = (long long)grid * R * Ep * (long long)sizeof(float);
  return 0;
}

// desc0 [N, T0, E] f32, desc1 [N, T1, E] f32, scores [N, T0, T1] f32;
// weights padded to Ep (pack_gnn_params): matmul weights bf16 in fragment
// order (bf16 != 0) or f32 row-major, vectors f32; route and pairs_per_cta
// as any_plan says, workspace as t2p_superglue_gnn_any_workspace says (may
// be null where it says 0). Returns a cudaError_t; 0 means the launch was
// accepted.
extern "C" int t2p_superglue_gnn_any(
    const void* desc0, const void* desc1, const void* wqkv, const void* bqkv,
    const void* wm, const void* bm, const void* w0, const void* s0,
    const void* t0, const void* w1, const void* b1, const void* wf,
    const void* bf, int num_blocks, int n_pairs, int E, int Ep, int T0,
    int T1, int bf16, int route, int pairs_per_cta, void* workspace,
    void* scores, void* stream) {
  if (n_pairs < 1 || num_blocks < 0 || !shape_ok(E, Ep, T0, T1, bf16))
    return (int)cudaErrorInvalidValue;
  const float* d0 = (const float*)desc0;
  const float* d1 = (const float*)desc1;
  float* out = (float*)scores;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == WIDE) {
    if (workspace == nullptr || pairs_per_cta < 1)
      return (int)cudaErrorInvalidValue;
    unsigned char* ws = (unsigned char*)workspace;
    if (bf16) {
      tc::Weights wt{(const uint2*)wqkv, (const float*)bqkv, (const uint2*)wm,
                     (const float*)bm, (const uint2*)w0, (const float*)s0,
                     (const float*)t0, (const uint2*)w1, (const float*)b1,
                     (const uint2*)wf, (const float*)bf};
      return wide::launch<true>(d0, d1, wt, num_blocks, E, Ep, T0, T1,
                                pairs_per_cta, out, n_pairs, ws, st);
    }
    f32::Weights wt{(const float*)wqkv, (const float*)bqkv, (const float*)wm,
                    (const float*)bm, (const float*)w0, (const float*)s0,
                    (const float*)t0, (const float*)w1, (const float*)b1,
                    (const float*)wf, (const float*)bf};
    return wide::launch<false>(d0, d1, wt, num_blocks, E, Ep, T0, T1,
                               pairs_per_cta, out, n_pairs, ws, st);
  }
  const int R = shared_rows(T0, T1, bf16, pairs_per_cta);
  if (route != SHARED || R == 0) return (int)cudaErrorInvalidValue;
  const int G = pairs_per_cta;
  if (bf16) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    tc::Weights wt{(const uint2*)wqkv, (const float*)bqkv, (const uint2*)wm,
                   (const float*)bm, (const uint2*)w0, (const float*)s0,
                   (const float*)t0, (const uint2*)w1, (const float*)b1,
                   (const uint2*)wf, (const float*)bf};
    float* ws = (float*)workspace;
    switch (R / 16) {
      case 2: return tc::launch<2>(d0, d1, wt, num_blocks, E, Ep, T0, T1, G, out, n_pairs, ws, st);
      case 3: return tc::launch<3>(d0, d1, wt, num_blocks, E, Ep, T0, T1, G, out, n_pairs, ws, st);
      case 4: return tc::launch<4>(d0, d1, wt, num_blocks, E, Ep, T0, T1, G, out, n_pairs, ws, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  f32::Weights wt{(const float*)wqkv, (const float*)bqkv, (const float*)wm,
                  (const float*)bm, (const float*)w0, (const float*)s0,
                  (const float*)t0, (const float*)w1, (const float*)b1,
                  (const float*)wf, (const float*)bf};
  return f32::launch(d0, d1, wt, num_blocks, E, Ep, T0, T1, G, out, n_pairs,
                     st);
}

#ifdef T2P_STAGE_CLOCKS
// Copies the bf16 route's summed stage clocks to out[8] (reset == 0) or
// sets them to zero. Synchronizes the device.
extern "C" int t2p_superglue_gnn_any_stage_clocks(unsigned long long* out,
                                                  int reset) {
  if (reset) {
    const unsigned long long zero[N_STAGES] = {};
    return (int)cudaMemcpyToSymbol(g_stage_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_stage_clocks,
                                   N_STAGES * sizeof(unsigned long long));
}
#endif
