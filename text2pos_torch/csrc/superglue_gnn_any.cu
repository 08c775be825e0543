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
// "superglue_gnn_any_wide" (namespace wide): the first form of this file,
// kept for the shapes whose rows do not fit in shared memory even at G = 1
// (f32 where T0 + T1 > 47 at E = 300 and past E = 656 at (16, 6); bf16 at
// E > 448 with both sets over 16 and past E = 896), and for every shape
// past SHARED_MAX_T objects, whose attention the two shared routes keep in
// registers: one CTA a pair, 8x4 register tiles, the rows in a global
// workspace slice of a persistent CTA whose size follows T0, T1 and Ep
// (layout), weights read straight from global memory (bf16 ones from
// fragment order, element by element). None of its loops has a bound of
// its own: a (row, head) of the attention loops over the source set's rows,
// the messages over them, the products over K and N. Its products sum
// each group of 4 k-values in a register of its own before adding it to the
// running sum (blocked summation: K/4 roundings of the running sum instead
// of K): at the widths where only this route runs it serves in bf16 at
// full depth, where chip_smoke's depth gate holds it to drift from a
// float64 evaluation no more than the plain version does.
//
// Bound. About 20·E²·(T0 + T1) operations a block a pair (the five
// products), 0.48 GFLOP a pair at E = 300 with 12 blocks, against
// (T0 + T1)·E·4 bytes in and T0·T1·4 out: operations bound it, at the bf16
// tensor-core rate in bf16 and the f32 rate in f32. 9.8 TFLOP at the E = 300
// headline's 20,480 pairs: 10 ms at 989 TFLOP/s. Padding adds (320/300)² =
// 14% of operations in bf16, (304/300)² = 3% in f32.
//
// With -DT2P_STAGE_CLOCKS the shared routes add up, over all CTAs, the
// clocks their first thread spends in each stage (a barrier closes a
// stage); -DT2P_NO_WEIGHT_LOADS replaces their weight loads by register
// values (wrong results, the same products), so that the difference of the
// two builds' stage clocks is the time spent waiting for weights.
// scripts/check_gnn_kernel.py builds and reads both.

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
// The wide route: one CTA a pair, rows in a global workspace
// ------------------------------------------------------------------------
namespace wide {

constexpr int RT = 8;   // rows of a thread's product tile
constexpr int CT = 4;   // columns of a thread's product tile

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of a pair's rows (R = T0 + T1 rounded up to 8), at the
// padded width.
struct Layout {
  int R;
  size_t res, a, q, prob, total;
};

__host__ __device__ inline Layout layout(int Ep, int T0, int T1, bool bf16) {
  Layout l;
  l.R = (T0 + T1 + RT - 1) / RT * RT;
  const size_t s = bf16 ? 2 : 4;
  l.res = 0;
  l.a = bf16 ? align16((size_t)l.R * Ep * 4) : 0;   // f32: res = a's left half
  l.q = l.a + align16((size_t)l.R * 2 * Ep * s);
  l.prob = l.q + align16((size_t)l.R * 3 * Ep * s);
  l.total = l.prob + align16((size_t)(T0 + T1) * HEADS * T0 * 4);
  return l;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void ldg(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // Columns c .. c + 3 of row k of a row-major [K, N] weight.
  __device__ static void weight(const float* W, int K, int N, int k, int c,
                                float (&v)[4]) {
    ldg(W + (size_t)k * N + c, v);
  }
  __device__ static float rnd(float x) { return x; }
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float x) { *p = x; }
};
template <> struct Vec<__nv_bfloat16> {
  __device__ static void unpack(uint2 u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    unpack(*reinterpret_cast<const uint2*>(p), v);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  // Columns c .. c + 3 of row k of a [K, N] weight in fragment order
  // [N/8, K/16, 32 lanes, 4]: lane 4·g + t holds column g of its n-tile at
  // k = 8·u + 2·t + v as element 2·u + v.
  __device__ static void weight(const __nv_bfloat16* W, int K, int N, int k,
                                int c, float (&v)[4]) {
    const int kk = k & 15, u = kk >> 3, t = (kk & 7) >> 1;
    const size_t base = ((size_t)(c >> 3) * (K / 16) + (k >> 4)) * 128 +
                        t * 4 + u * 2 + (kk & 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __bfloat162float(W[base + ((c & 7) + i) * 16]);
  }
  __device__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

template <typename T>
struct Weights {
  const T* wqkv;      // [L, Ep, 3Ep]
  const float* bqkv;  // [L, 3Ep]
  const T* wm;        // [L, Ep, Ep]
  const float* bm;    // [L, Ep]
  const T* w0;        // [L, 2Ep, 2Ep]
  const float* s0;    // [L, 2, 2Ep]
  const float* t0;    // [L, 2, 2Ep]
  const T* w1;        // [L, 2Ep, Ep]
  const float* b1;    // [L, Ep]
  const T* wf;        // [Ep, Ep]
  const float* bf;    // [Ep]
};

// out[R, N] = X[R, K] (resident, row stride ldx) · W[K, N] (global);
// epi(row, col, v[4]) takes columns col .. col + 3 of a row.
template <typename T, typename Epi>
__device__ __forceinline__ void matmul(const T* X, int ldx, int R, int K,
                                       int N, const T* __restrict__ W,
                                       Epi epi) {
  const int ncg = N / CT, units = (R / RT) * ncg;
  for (int u = threadIdx.x; u < units; u += NT) {
    const int c = (u % ncg) * CT, r0 = (u / ncg) * RT;
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    const T* xp = X + (size_t)r0 * ldx;
    for (int k = 0; k < K; k += 4) {
      float w[4][CT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Vec<T>::weight(W, K, N, k + kk, c, w[kk]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float x[4], part[CT];
        Vec<T>::load(xp + (size_t)i * ldx + k, x);
#pragma unroll
        for (int j = 0; j < CT; ++j) part[j] = x[0] * w[0][j];
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < CT; ++j) part[j] = fmaf(x[kk], w[kk][j], part[j]);
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] += part[j];
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) epi(r0 + i, c, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
wide_kernel(const float* __restrict__ desc0,  // [N, T0, E]
            const float* __restrict__ desc1,  // [N, T1, E]
            Weights<T> wt, int num_blocks, int E, int Ep, int T0, int T1,
            float* __restrict__ scores,       // [N, T0, T1]
            int n_pairs, unsigned char* workspace) {
  constexpr bool BF16 = sizeof(T) == 2;
  const Layout lay = layout(Ep, T0, T1, BF16);
  unsigned char* base = workspace + (size_t)blockIdx.x * lay.total;
  T* A = reinterpret_cast<T*>(base + lay.a);          // [R][2Ep]: a | m
  T* Q = reinterpret_cast<T*>(base + lay.q);          // [R][3Ep]: q | k | v
  float* prob = reinterpret_cast<float*>(base + lay.prob);  // [P][HEADS][T0]
  // The f32 residual: its own rows in bf16, a's left half in f32.
  float* res = reinterpret_cast<float*>(base + lay.res);
  const int ldres = BF16 ? Ep : 2 * Ep;
  const int R = lay.R, P = T0 + T1, Dp = Ep / HEADS;
  const int tid = threadIdx.x;
  const float att_scale = sqrtf((float)(E / HEADS)), score_scale = sqrtf((float)E);

  for (int n = blockIdx.x; n < n_pairs; n += gridDim.x) {
    // Objects, then hints, then zero rows; zeros in the padding channels.
    for (int i = tid; i < R * (Ep / 4); i += NT) {
      const int r = i / (Ep / 4), c = (i % (Ep / 4)) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c < E && r < T0)
        Vec<float>::ldg(desc0 + ((size_t)n * T0 + r) * E + c, v);
      else if (c < E && r < P)
        Vec<float>::ldg(desc1 + ((size_t)n * T1 + (r - T0)) * E + c, v);
      if (BF16) Vec<float>::store(res + (size_t)r * ldres + c, v);
      Vec<T>::store(A + (size_t)r * 2 * Ep + c, v);
    }
    __syncthreads();

    for (int l = 0; l < num_blocks; ++l) {
      const bool cross = (l & 1) == 1;
      // q|k|v of every row.
      {
        const float* b = wt.bqkv + (size_t)l * 3 * Ep;
        matmul<T>(A, 2 * Ep, R, Ep, 3 * Ep, wt.wqkv + (size_t)l * Ep * 3 * Ep,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], o[4];
          Vec<float>::ldg(b + c, bb);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
          Vec<T>::store(Q + (size_t)r * 3 * Ep + c, o);
        });
      }
      __syncthreads();

      // Probabilities of each (row, head) over the source set's rows.
      for (int it = tid; it < P * HEADS; it += NT) {
        const int r = it / HEADS, h = it % HEADS;
        const bool own = r >= T0;
        const bool src = cross ? !own : own;
        const int kbase = src ? T0 : 0, nk = src ? T1 : T0;
        const T* q = Q + (size_t)r * 3 * Ep + h * Dp;
        float* pr = prob + (size_t)it * T0;
        float mx = -INFINITY;
        for (int j = 0; j < nk; ++j) {
          const T* kr = Q + (size_t)(kbase + j) * 3 * Ep + Ep + h * Dp;
          float dot = 0.0f;
          for (int d = 0; d < Dp; ++d)
            dot = fmaf(Vec<T>::get(q + d), Vec<T>::get(kr + d), dot);
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
        for (int j = 0; j < nk; ++j) pr[j] = Vec<T>::rnd(pr[j] / sum);
      }
      __syncthreads();

      // Messages over q: msg[r, c] = Σ_j p[r, head(c), j] · v[j, c].
      for (int it = tid; it < P * Ep; it += NT) {
        const int r = it / Ep, c = it % Ep, h = c / Dp;
        const bool own = r >= T0;
        const bool src = cross ? !own : own;
        const int kbase = src ? T0 : 0, nk = src ? T1 : T0;
        const float* pr = prob + (size_t)(r * HEADS + h) * T0;
        const T* vc = Q + (size_t)kbase * 3 * Ep + 2 * Ep + c;
        float m = 0.0f;
        for (int j = 0; j < nk; ++j)
          m = fmaf(pr[j], Vec<T>::get(vc + (size_t)j * 3 * Ep), m);
        Vec<T>::put(Q + (size_t)r * 3 * Ep + c, m);
      }
      __syncthreads();

      // m = msg·Wm + bm into a's right half.
      {
        const float* b = wt.bm + (size_t)l * Ep;
        matmul<T>(Q, 3 * Ep, R, Ep, Ep, wt.wm + (size_t)l * Ep * Ep,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], o[4];
          Vec<float>::ldg(b + c, bb);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
          Vec<T>::store(A + (size_t)r * 2 * Ep + Ep + c, o);
        });
      }
      __syncthreads();

      // h1 = relu(([a | m]·W0) * s0[set] + t0[set]) over q|k.
      {
        const float* s0 = wt.s0 + (size_t)l * 4 * Ep;
        const float* t0 = wt.t0 + (size_t)l * 4 * Ep;
        matmul<T>(A, 2 * Ep, R, 2 * Ep, 2 * Ep, wt.w0 + (size_t)l * 4 * Ep * Ep,
                  [&](int r, int c, float (&v)[4]) {
          const int set = r >= T0 ? 1 : 0;
          float s[4], t[4], o[4];
          Vec<float>::ldg(s0 + set * 2 * Ep + c, s);
          Vec<float>::ldg(t0 + set * 2 * Ep + c, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = fmaxf(fmaf(v[j], s[j], t[j]), 0.0f);
          Vec<T>::store(Q + (size_t)r * 3 * Ep + c, o);
        });
      }
      __syncthreads();

      // res += rnd(h1·W1 + b1); a's left half gets rnd(res).
      {
        const float* b = wt.b1 + (size_t)l * Ep;
        matmul<T>(Q, 3 * Ep, R, 2 * Ep, Ep, wt.w1 + (size_t)l * 2 * Ep * Ep,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], x[4];
          Vec<float>::ldg(b + c, bb);
          float* rp = res + (size_t)r * ldres + c;
          Vec<float>::load(rp, x);
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] += Vec<T>::rnd(v[j] + bb[j]);
          Vec<float>::store(rp, x);
          if (BF16) Vec<T>::store(A + (size_t)r * 2 * Ep + c, x);
        });
      }
      __syncthreads();
    }

    // md = rnd(rnd(res)·Wf + bf) over q.
    matmul<T>(A, 2 * Ep, R, Ep, Ep, wt.wf, [&](int r, int c, float (&v)[4]) {
      float bb[4], o[4];
      Vec<float>::ldg(wt.bf + c, bb);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
      Vec<T>::store(Q + (size_t)r * 3 * Ep + c, o);
    });
    __syncthreads();

    for (int it = tid; it < T0 * T1; it += NT) {
      const int i = it / T1, j = it % T1;
      const T* a = Q + (size_t)i * 3 * Ep;
      const T* b = Q + (size_t)(T0 + j) * 3 * Ep;
      float dot = 0.0f;
      for (int c = 0; c < Ep; c += 4) {
        float x[4], y[4];
        Vec<T>::load(a + c, x);
        Vec<T>::load(b + c, y);
#pragma unroll
        for (int d = 0; d < 4; ++d) dot = fmaf(x[d], y[d], dot);
      }
      scores[(size_t)n * T0 * T1 + it] = dot / score_scale;
    }
    __syncthreads();   // the next pair overwrites the rows
  }
}

int ctas(int n_pairs) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_pairs < 4 * sms ? n_pairs : 4 * sms;
}

template <typename T>
int launch(const float* desc0, const float* desc1, const Weights<T>& wt,
           int num_blocks, int E, int Ep, int T0, int T1, float* scores,
           int n_pairs, unsigned char* workspace, cudaStream_t stream) {
  wide_kernel<T><<<ctas(n_pairs), NT, 0, stream>>>(
      desc0, desc1, wt, num_blocks, E, Ep, T0, T1, scores, n_pairs,
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
    *bytes = (long long)wide::ctas(n_pairs) *
             (long long)wide::layout(Ep, T0, T1, bf16 != 0).total;
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
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    unsigned char* ws = (unsigned char*)workspace;
    if (bf16) {
      using T = __nv_bfloat16;
      wide::Weights<T> wt{(const T*)wqkv, (const float*)bqkv, (const T*)wm,
                          (const float*)bm, (const T*)w0, (const float*)s0,
                          (const float*)t0, (const T*)w1, (const float*)b1,
                          (const T*)wf, (const float*)bf};
      return wide::launch<T>(d0, d1, wt, num_blocks, E, Ep, T0, T1, out,
                             n_pairs, ws, st);
    }
    wide::Weights<float> wt{(const float*)wqkv, (const float*)bqkv,
                            (const float*)wm, (const float*)bm,
                            (const float*)w0, (const float*)s0,
                            (const float*)t0, (const float*)w1,
                            (const float*)b1, (const float*)wf,
                            (const float*)bf};
    return wide::launch<float>(d0, d1, wt, num_blocks, E, Ep, T0, T1, out,
                               n_pairs, ws, st);
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
