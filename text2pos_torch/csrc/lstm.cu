// Length-masked bidirectional LSTM: the final hidden state of each
// direction, with the input projections folded in as a token-table gather.
//
// Replaces the TPU kernel text2pos_tpu/ops/lstm_pallas.py:60
// (lstm_final_hidden_pallas, body _lstm_kernel :29; both directions as in
// bilstm_final_hidden_pallas :117). The input of step t of sequence b is
// row tokens[b, t] of a per-direction table [V, 4H] = emb·W_ih + b, built
// outside by one small matmul (ops/lstm.py): for a token embedding,
// emb[tok]·W_ih + b equals (emb·W_ih + b)[tok], so no [T, B, 4H] projection
// is ever written. The generic caller (x arbitrary) passes x·W_ih + b as a
// table of T·B rows with running indices: one kernel, two callers.
//
// Design.
// - One launch for both directions: blockIdx.z is the direction, blockIdx.y
//   a tile of BT = 32 sequences, blockIdx.x the CTA's rank in a thread-block
//   cluster of CS = H / 32 CTAs (8 for the coarse encoder's H = 256, 4 for
//   the fine one's H = 128). B = 2048 coarse sequences: 64 tiles x 2
//   directions x 8 = 1024 CTAs, one an SM.
// - W_hh on chip for the whole recurrence. The 4H gate columns are split
//   by hidden unit: CTA r owns units 32r … 32r+31 and keeps their i|f|g|o
//   columns of W_hh in shared memory (128 KiB at H = 256, 64 KiB at
//   H = 128), read once from L2 instead of at every step. A cluster holds
//   all of W_hh, one slice an SM; BT = 32 keeps slice + h (double-buffered,
//   64 KiB at H = 256) within an SM's shared memory.
// - The step's product gates^T [128 columns, 32 sequences] += W^T · h^T
//   runs on the tensor cores as mma.sync.m16n8k8 in 3xTF32, which keeps
//   f32 accuracy: each operand x is split into a TF32 big part and a
//   small rest (the tensor cores read 10 mantissa bits), and the kernel
//   adds small·big, big·small and big·big. The tensor cores truncate a
//   TF32 operand's low bits and their accumulation rounds toward zero at
//   the magnitude of what it holds, so with W_hh in shared memory
//   (H <= 256) both parts are rounded to nearest, small·big and big·small
//   share one accumulator chain, and each k-step's big·big product starts
//   from zero and joins the gate sum by an f32 add. On the K360 server's
//   calibration text (H = 256, 64 tokens) the earlier arithmetic put a
//   final h 1.396e-4 from a float64 evaluation, the plain f32 recurrence
//   8.1e-6 and this one 1.28e-5, at 1.19-1.20x the time (H100 80GB HBM3,
//   700.00 W). The form that reads W_hh from L2 (H > 256) keeps the
//   earlier arithmetic: big truncated, small exact, the three products in
//   three chains on top of the gate inputs. With the repair it takes
//   1.25-1.26x the time at H = 300 and changes the E = 300 hint encodings
//   enough to move chip_smoke phase 12's 12-block bf16 GNN checks past
//   their gate; phase 13.1 reads its error on the K360 calibration text,
//   zero-padded to H = 300. Plain TF32 would not hold f32 serving's top-k.
//   Warp w takes units 8·(w % 4) … +7 (m-tile 0: their i and f rows,
//   m-tile 1: g and o) and sequences 16·(w / 4) … +15 (two n-tiles), so
//   each lane's accumulators hold all four gates of one unit for 4
//   sequences: the cell update needs no exchange inside the CTA, and c and
//   h stay in registers. W is stored in A-fragment order (one
//   float4 a lane per m-tile and k-step) and h as [H/8][BT][8] with a
//   lane's b0, b1 adjacent (one float2).
// - h is exchanged through distributed shared memory. A CTA's 32 units are
//   4 k-steps of h, one contiguous 4 KiB block per buffer: after the cell
//   update each CTA writes its block locally and one thread sends it by
//   cp.async.bulk to the other CTAs of the cluster, completing on the
//   receiver's mbarrier of that buffer; every thread then waits on its own
//   mbarrier (no cluster-wide barrier a step). Double buffering is safe: a
//   CTA can only send step s+1's block after receiving every other CTA's
//   step-s block, which each sends after it has finished reading the buffer
//   that the block overwrites. A wait that never completes traps instead
//   of hanging.
// - The gate inputs of step s+1 (16 table values a thread) are loaded while
//   step s computes. At most 128 registers a thread, so two CTAs share an
//   SM where their shared memory fits (H = 128: 96 KiB each).
//
// Bound. 2·H·4H FLOPs per valid step of each sequence and direction, in
// three TF32 passes at the tensor cores' rate: operations, not bytes, bound
// it. Steps past the
// longest sequence of a tile are skipped (they leave every state
// unchanged), so the work done follows the data's lengths.
//
// Masking. Step t updates sequence b only if t < len[b] (lengths clamped to
// [0, T]); only valid steps read the table, so padding tokens are never
// looked up. A token outside [0, V) gives NaN gates. The backward
// direction visits t = maxlen-1 … 0, which equals the reference's scan over
// the reversed padded sequence with reversed validity.
//
// Widths past 256 (the JAX default embed_dim is 300). The wrapper pads H
// to Hp = 32·ceil(H/32) with zero gate columns and zero W_hh rows, which
// keep every padded unit at exactly 0 (g = tanh(0) = 0, so c = 0 and
// h = σ(0)·tanh(0) = 0) and leave the real units' sums unchanged. Up to
// Hp = 256 the kernel above runs as it is. From 288 to 512 a cluster has
// CS = Hp/32 = 9..16 CTAs, above the portable 8 (the launch allows the
// non-portable size; H100 takes 16), and a CTA's W_hh slice (Hp·512 B,
// 160 KiB at Hp = 320) no longer fits beside the h buffers at BT = 32. That
// form (WSMEM = false) reads the slice's A fragments from global memory
// (L2: both directions' W_hh are 0.8-4 MiB) each step instead, packed by
// the wrapper in the same fragment order the smem form builds on chip
// (ops/lstm.py w_hh_fragments), so the step's code is the same; shared
// memory holds only the h buffers (80 KiB at Hp = 320, 128 at 512).
//
// Ablation builds for scripts/check_lstm_kernel.py (wrong results, timing
// only): -DT2P_LSTM_NO_EXCHANGE sends no h between CTAs,
// -DT2P_LSTM_NO_PRODUCT skips the recurrent product.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 32;                 // hidden units per CTA
constexpr int SMEM_MAX_H = 8 * UNITS;     // W_hh slice on chip up to here
constexpr int MAX_H = 16 * UNITS;         // the largest cluster, 16 CTAs
constexpr int BT = 32;                    // sequences per cluster tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

struct Args {
  const float* table[2];   // per direction [V, 4H] (gate order i, f, g, o)
  const float* whh[2];     // per direction [H, 4H]
  const float* wpack[2];   // per direction [CS][H/8][2][4][32][4], or null
  const int* tokens;       // [B, T]
  const int* lengths;      // [B]
  float* out;              // [2, B, H]
  int V, T, B, H;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Waits for the phase of parity `parity` of an mbarrier; traps (a launch
// failure) instead of hanging if it never completes.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 26)) __trap();
  }
}

// x = big + small. ROUND: big is x rounded to TF32's 10 mantissa bits, to
// nearest (an integer add and AND; a carry into the exponent is the right
// result), and small = x - big rounded the same way, which the tensor
// cores would otherwise truncate. Else big is x truncated to TF32 and small
// = x - big, exact in f32 (the tensor cores truncate it).
template <bool ROUND>
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  const unsigned bits = __float_as_uint(x);
  big = (ROUND ? bits + 0x1000u : bits) & 0xffffe000u;
  const unsigned rest = __float_as_uint(x - __uint_as_float(big));
  small = ROUND ? (rest + 0x1000u) & 0xffffe000u : rest;
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Position of hidden unit u's h within its k-step of 8 (b0 and b1 of a
// lane adjacent).
__device__ __forceinline__ int hpos(int u) {
  return ((u >> 3) * BT) * 8 + 2 * (u & 3) + ((u >> 2) & 1);
}

// WSMEM: W_hh's slice in shared memory (H <= 256), else read from the
// wrapper's fragment-ordered copy in global memory each step.
template <bool WSMEM>
__global__ void __launch_bounds__(THREADS, 2) lstm_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int len_s[BT];
  // full[b] completes when the other CTAs' blocks of buffer b have arrived.
  __shared__ __align__(8) unsigned long long full[2];
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.H, T = a.T, B = a.B;
  const int CS = H / UNITS;
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.z;
  const int b0 = blockIdx.y * BT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int ug = warp & 3, sh = warp >> 2;
  const int unit = rank * UNITS + ug * 8 + gid;

  float* wf = reinterpret_cast<float*>(smem4);           // [H/8][2][4][32][4]
  float* hbuf = wf + (WSMEM ? (size_t)H * UNITS * 4 : 0);  // [2][H/8][BT][8]
  const int HB = H * BT;                                  // floats a buffer

  const float* whh = dir ? a.whh[1] : a.whh[0];
  // Read in global order (u fastest: coalesced), store in A-fragment order
  // [k/8][mt][u/8][lane][4]: lane = 4·(row & 7) + (k & 3), element
  // 2·((k & 7) >> 2) + (row >> 3), row = 8·(gate & 1) + (u & 7).
  for (int i = threadIdx.x; WSMEM && i < H * 4 * UNITS; i += THREADS) {
    const int u = i % UNITS, gate = (i / UNITS) & 3, k = i / (4 * UNITS);
    const int row = 8 * (gate & 1) + (u & 7);
    const int ln = 4 * (row & 7) + (k & 3);
    const int j = 2 * ((k & 7) >> 2) + (row >> 3);
    wf[((((k >> 3) * 2 + (gate >> 1)) * 4 + (u >> 3)) * 32 + ln) * 4 + j] =
        whh[(size_t)k * 4 * H + gate * H + rank * UNITS + u];
  }
  for (int i = threadIdx.x; i < 2 * HB; i += THREADS) hbuf[i] = 0.0f;
  if (threadIdx.x < BT) {
    const int b = b0 + threadIdx.x;
    len_s[threadIdx.x] = b < B ? min(max(a.lengths[b], 0), T) : 0;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  unsigned phase = 0;   // bit b: parity of buffer b's next completion

  int maxlen = 0;
#pragma unroll
  for (int q = 0; q < BT; ++q) maxlen = max(maxlen, len_s[q]);

  // This thread's sequences: seq[nt][e] = sh*16 + nt*8 + 2*tid + e.
  int len[2][2];
  const int* tok[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = sh * 16 + nt * 8 + 2 * tid + e;
      len[nt][e] = len_s[q];
      tok[nt][e] = a.tokens + (size_t)min(b0 + q, B - 1) * T;
    }
  const float* table = (dir ? a.table[1] : a.table[0]) + unit;
  const int H4 = 4 * H, V = a.V;
  const bool rev = dir == 1;

  float xin[2][2][4];   // [nt][e][gate]
  auto gather = [&](int t) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (t < len[nt][e]) {
          const int tk = __ldg(tok[nt][e] + t);
          if ((unsigned)tk < (unsigned)V) {
            const float* row = table + (size_t)tk * H4;
#pragma unroll
            for (int g = 0; g < 4; ++g) xin[nt][e][g] = __ldg(row + g * H);
          } else {
#pragma unroll
            for (int g = 0; g < 4; ++g) xin[nt][e][g] = __int_as_float(0x7fc00000);
          }
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) xin[nt][e][g] = 0.0f;
        }
      }
  };

  float c[2][2], h[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) c[nt][e] = h[nt][e] = 0.0f;
  if (maxlen > 0) gather(rev ? maxlen - 1 : 0);

  const float4* wa =
      (WSMEM ? reinterpret_cast<const float4*>(wf)
             : reinterpret_cast<const float4*>(a.wpack[dir]) +
                   (size_t)rank * H * UNITS) + ug * 32 + lane;
  int cur = 0;
  for (int s = 0; s < maxlen; ++s) {
    const int t = rev ? maxlen - 1 - s : s;
    // acc[mt][nt]: rows gid / gid+8 = gates (i, f) for mt 0, (g, o) for
    // mt 1; columns 2*tid, 2*tid+1 = sequences e = 0, 1.
    float acc[2][2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[0][nt][e] = xin[nt][e][0];
        acc[0][nt][2 + e] = xin[nt][e][1];
        acc[1][nt][e] = xin[nt][e][2];
        acc[1][nt][2 + e] = xin[nt][e][3];
      }
    float acc2[2][2][4] = {}, acc3[2][2][4] = {};
    if (s + 1 < maxlen) gather(rev ? t - 1 : t + 1);

    const float* hs = hbuf + cur * HB + (sh * 16 + gid) * 8 + 2 * tid;
#ifndef T2P_LSTM_NO_PRODUCT
    // Two k-steps in flight: at 4 the global-memory form's addresses and
    // loads, and the shared-memory form's rounded split and f32 adds, pass
    // the 128 registers that two CTAs an SM allow.
#pragma unroll 2
    for (int kk = 0; kk < H / 8; ++kk) {
      unsigned abig[2][4], asml[2][4], bbig[2][2], bsml[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 w = WSMEM ? wa[(kk * 2 + mt) * 4 * 32]
                               : __ldg(wa + (kk * 2 + mt) * 4 * 32);
        split<WSMEM>(w.x, abig[mt][0], asml[mt][0]);
        split<WSMEM>(w.y, abig[mt][1], asml[mt][1]);
        split<WSMEM>(w.z, abig[mt][2], asml[mt][2]);
        split<WSMEM>(w.w, abig[mt][3], asml[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 hv = *reinterpret_cast<const float2*>(hs + (kk * BT + nt * 8) * 8);
        split<WSMEM>(hv.x, bbig[nt][0], bsml[nt][0]);
        split<WSMEM>(hv.y, bbig[nt][1], bsml[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(acc2[mt][nt], asml[mt], bbig[nt][0], bbig[nt][1]);
          if constexpr (WSMEM) {
            mma(acc2[mt][nt], abig[mt], bsml[nt][0], bsml[nt][1]);
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma(part, abig[mt], bbig[nt][0], bbig[nt][1]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
          } else {
            mma(acc3[mt][nt], abig[mt], bsml[nt][0], bsml[nt][1]);
            mma(acc[mt][nt], abig[mt], bbig[nt][0], bbig[nt][1]);
          }
        }
    }
#endif
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt][q] += WSMEM ? acc2[mt][nt][q]
                                  : acc2[mt][nt][q] + acc3[mt][nt][q];

    float* hn = hbuf + (cur ^ 1) * HB;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ig = sigmoid_f(acc[0][nt][e]);
        const float fg = sigmoid_f(acc[0][nt][2 + e]);
        const float gg = tanhf(acc[1][nt][e]);
        const float og = sigmoid_f(acc[1][nt][2 + e]);
        const float cn = fg * c[nt][e] + ig * gg;
        const float hv = og * tanhf(cn);
        const bool v = t < len[nt][e];
        c[nt][e] = v ? cn : c[nt][e];
        h[nt][e] = v ? hv : h[nt][e];
        hn[hpos(unit) + (sh * 16 + nt * 8 + 2 * tid + e) * 8] = h[nt][e];
      }
    // This CTA's units are k-steps 4·rank … 4·rank+3 of h: one contiguous
    // block of 4·BT·8 floats, sent by bulk copy to every other CTA of the
    // cluster, completing on the receiver's mbarrier of that buffer.
    const int nxt = cur ^ 1;
    if (s + 1 < maxlen) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
#ifdef T2P_LSTM_NO_EXCHANGE
      if (false) {
#else
      if (threadIdx.x == 0 && CS > 1) {
#endif
        const unsigned bar = smem_addr(&full[nxt]);
        const unsigned bytes = 4 * BT * 8 * 4;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes * (CS - 1)) : "memory");
        const unsigned src = smem_addr(hn + rank * 4 * BT * 8);
        for (int r = 0; r < CS; ++r) {
          if (r == rank) continue;
          unsigned dst, rbar;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(src), "r"(r));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(r));
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
              :: "r"(dst), "r"(src), "r"(bytes), "r"(rbar) : "memory");
        }
      }
#ifdef T2P_LSTM_NO_EXCHANGE
      if (false) {
#else
      if (CS > 1) {
#endif
        mbar_wait(smem_addr(&full[nxt]), (phase >> nxt) & 1);
        phase ^= 1u << nxt;
      } else {
        __syncthreads();
      }
    }
    cur = nxt;
  }
  // No CTA leaves while a copy from or into its shared memory may run.
  cluster.sync();

#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = b0 + sh * 16 + nt * 8 + 2 * tid + e;
      if (b < B) a.out[((size_t)dir * B + b) * H + unit] = h[nt][e];
    }
}

}  // namespace

namespace {

// Shared memory a CTA takes at width H: its W_hh slice (H <= 256) and two
// h buffers.
int smem_bytes(int H) {
  return (H <= SMEM_MAX_H ? H * UNITS * 16 : 0) + 2 * H * BT * 4;
}

template <bool WSMEM>
cudaError_t set_attributes(int H) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_kernel<WSMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(H));
  if (e == cudaSuccess && H / UNITS > 8)
    e = cudaFuncSetAttribute(lstm_kernel<WSMEM>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t config(int H, int B, cudaStream_t stream,
                          cudaLaunchAttribute (&attr)[1]) {
  const unsigned cs = (unsigned)(H / UNITS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (unsigned)((B + BT - 1) / BT), 2);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes(H);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of the kernel at width H the card holds at once.
extern "C" int t2p_lstm_max_active_clusters(int H, int B, int* out) {
  if (H < UNITS || H > MAX_H || H % UNITS != 0)
    return (int)cudaErrorInvalidValue;
  const bool wsmem = H <= SMEM_MAX_H;
  cudaError_t e = wsmem ? set_attributes<true>(H) : set_attributes<false>(H);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(H, B, nullptr, attr);
  return (int)(wsmem ? cudaOccupancyMaxActiveClusters(out, lstm_kernel<true>, &cfg)
                     : cudaOccupancyMaxActiveClusters(out, lstm_kernel<false>, &cfg));
}

// Both directions in one launch. H a multiple of 32 in [32, 512]; past 256
// wpack_f and wpack_b hold W_hh in fragment order (ops/lstm.py). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_lstm_final_hidden(const void* table_f, const void* table_b,
                                     const void* whh_f, const void* whh_b,
                                     const void* wpack_f, const void* wpack_b,
                                     const void* tokens, const void* lengths,
                                     void* out, int V, int T, int B, int H,
                                     void* stream) {
  const bool wsmem = H <= SMEM_MAX_H;
  if (H < UNITS || H > MAX_H || H % UNITS != 0 || T < 1 || B < 1 ||
      V < 1 || (B + BT - 1) / BT > 65535 ||
      (!wsmem && (wpack_f == nullptr || wpack_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = wsmem ? set_attributes<true>(H) : set_attributes<false>(H);
  if (e != cudaSuccess) return (int)e;

  Args args;
  args.table[0] = (const float*)table_f;
  args.table[1] = (const float*)table_b;
  args.whh[0] = (const float*)whh_f;
  args.whh[1] = (const float*)whh_b;
  args.wpack[0] = (const float*)wpack_f;
  args.wpack[1] = (const float*)wpack_b;
  args.tokens = (const int*)tokens;
  args.lengths = (const int*)lengths;
  args.out = (float*)out;
  args.V = V;
  args.T = T;
  args.B = B;
  args.H = H;

  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(H, B, (cudaStream_t)stream, attr);
  e = wsmem ? cudaLaunchKernelEx(&cfg, lstm_kernel<true>, args)
            : cudaLaunchKernelEx(&cfg, lstm_kernel<false>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
