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
//   the magnitude of what it holds, so both parts are rounded to nearest,
//   small·big and big·small share one accumulator chain, and each k-step's
//   big·big product starts from zero and joins the gate sum by an f32 add:
//   one arithmetic for both forms below. On the K360 server's calibration
//   text (H = 256, 64 tokens) an earlier arithmetic (big truncated, small
//   exact, three chains on top of the gate inputs) put a final h 1.396e-4
//   from a float64 evaluation, the plain f32 recurrence 8.1e-6 and this
//   one 1.28e-5 (also zero-padded to H = 300, where W_hh is read from
//   L2), at 1.17-1.20x that arithmetic's time with W_hh in shared memory
//   and, reading it from L2, 1.25x at H = 300 and 384 and 1.18x at 512
//   (7.33 against 5.86 ms at H = 300, 2048 sequences of 64 tokens; 124
//   registers, no spill; H100 80GB HBM3, 700.00 W; PERF.md §6). Plain
//   TF32 would not hold f32 serving's top-k.
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
// Hp = 256 the kernel above runs as it is. From 288 to 512 (the L2 form,
// lstm_l2_kernel) a cluster has CS = Hp/32 = 9..16 CTAs, above the portable
// 8 (the launch allows the non-portable size; H100 takes 16), and a CTA's
// W_hh slice (Hp·512 B, 160 KiB at Hp = 320) no longer fits beside h. So:
// - W's A fragments come from global memory (L2: both directions' W_hh are
//   0.8-4 MiB), packed by the wrapper in the order the shared form builds
//   on chip (ops/lstm.py w_hh_fragments), the next k-step's in flight
//   while a k-step computes; W does not depend on h, so the stream runs on
//   from a step's last k-step into the next step's first.
// - A warp takes 8 units and all 32 sequences (4 n-tiles), 4 warps a CTA,
//   so each fragment is loaded and split once a CTA and its split serves
//   four n-tiles (the shared form's 8 warps load and split it twice).
// - One h buffer (Hp·BT·4 B: 40 KiB at Hp = 320, 64 at 512) instead of two,
//   c in shared memory and the last h of a unit read back from its place
//   in that buffer, so three CTAs share an SM at every width (162
//   registers, no spill): each thread arrives on the cluster barrier once
//   it has read the step's h, and waits on it after the cell update and
//   the next gate inputs' loads, before it writes h; then the h blocks go
//   out by bulk copy, a thread a peer, as above.
// The arithmetic is the shared form's, term for term and in the same order,
// so the outputs are bit-identical to the earlier L2 form (8 warps and two
// h buffers a CTA). It takes 0.80x that form's time on the E = 300
// serving path's text and hints, 0.69-0.81x at 2048 x 64 for H = 288-416
// and 0.55x at 512, where that form held one CTA an SM
// (scripts/ab_kernel_times.py; H100 80GB HBM3, 700.00 W; PERF.md §6).
//
// Widths past 512: the grid form (lstm_grid_kernel, launch name
// "lstm_grid"). A cluster holds at most 16 CTAs, 512 units, so past that the
// CTAs that share a batch tile exchange h through global memory instead:
// - A persistent cooperative launch of as many CTAs as the card holds at
//   once. They form groups of CS CTAs; a group takes (direction, tile of
//   BT = 32 sequences) tasks in turn, and CTA r of a group owns the
//   32-unit slices r, r + CS, ... of Hp / 32 (one slice a CTA wherever the
//   card holds Hp / 32 CTAs at once, 8,448 units at two CTAs an SM; more
//   slices a CTA past that, so no width is refused but by the card's
//   memory).
// - A step of a slice has the L2 form's arithmetic: the same
//   fragment-ordered W_hh from L2 (w_hh_fragments), the same rounded 3xTF32
//   products in the same order and the same cell update, so it keeps that
//   form's distance from float64. h comes from the group's double buffer in global
//   memory ([2][Hp/8][BT][8], read through L2 with ld.global.cg), c from a
//   global [Hp][BT] slice that only its own thread reads and writes.
// - One barrier a step for the group: each CTA adds one to the group's
//   counter (release, after a __syncthreads) and waits until the counter
//   reaches the step's target (acquire); a wait that never completes traps
//   instead of hanging. The cooperative launch refuses a grid the card
//   cannot hold at once, so every CTA a barrier waits for is resident. Step
//   0 reads no h (it is 0), and a group passes one more barrier after a
//   task, so that no CTA writes the buffers of its next task while another
//   still reads them.
// The wrapper sizes the workspace (t2p_lstm_grid_workspace: both h buffers,
// c and the counters a group, zeroed) for the plan the launch computes
// again. Bound: the recurrent products, as above, in three TF32 passes;
// W_hh (16·H² bytes in f32: 9.4 MB at H = 768, 16.8 MB at 1024, both in L2;
// 67 MB at 2048, past it) is read from L2 or memory by every task's steps.
//
// Ablation builds of the cluster forms for scripts/check_lstm_kernel.py
// (wrong results, timing only): -DT2P_LSTM_NO_EXCHANGE sends no h between
// CTAs, -DT2P_LSTM_NO_PRODUCT skips the recurrent product; in the L2 form
// -DT2P_LSTM_W_SMEM reads every k-step's W fragments from a shared-memory
// copy of the first four (W_hh's loads from L2 dropped, its splits and the
// product kept) and -DT2P_LSTM_NO_WSPLIT hands the loaded W values to the
// tensor cores as both parts (W's splits dropped).

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

// x = big + small: big is x rounded to TF32's 10 mantissa bits, to
// nearest (an integer add and AND; a carry into the exponent is the right
// result), and small = x - big rounded the same way, which the tensor cores
// would otherwise truncate.
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
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

// The shared form (H <= 256): W_hh's slice in shared memory.
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
  float* hbuf = wf + (size_t)H * UNITS * 4;               // [2][H/8][BT][8]
  const int HB = H * BT;                                  // floats a buffer

  const float* whh = dir ? a.whh[1] : a.whh[0];
  // Read in global order (u fastest: coalesced), store in A-fragment order
  // [k/8][mt][u/8][lane][4]: lane = 4·(row & 7) + (k & 3), element
  // 2·((k & 7) >> 2) + (row >> 3), row = 8·(gate & 1) + (u & 7).
  for (int i = threadIdx.x; i < H * 4 * UNITS; i += THREADS) {
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

  const float4* wa = reinterpret_cast<const float4*>(wf) + ug * 32 + lane;
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
    float acc2[2][2][4] = {};
    if (s + 1 < maxlen) gather(rev ? t - 1 : t + 1);

    const float* hs = hbuf + cur * HB + (sh * 16 + gid) * 8 + 2 * tid;
#ifndef T2P_LSTM_NO_PRODUCT
#pragma unroll 2
    for (int kk = 0; kk < H / 8; ++kk) {
      unsigned abig[2][4], asml[2][4], bbig[2][2], bsml[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 w = wa[(kk * 2 + mt) * 4 * 32];
        split(w.x, abig[mt][0], asml[mt][0]);
        split(w.y, abig[mt][1], asml[mt][1]);
        split(w.z, abig[mt][2], asml[mt][2]);
        split(w.w, abig[mt][3], asml[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 hv = *reinterpret_cast<const float2*>(hs + (kk * BT + nt * 8) * 8);
        split(hv.x, bbig[nt][0], bsml[nt][0]);
        split(hv.y, bbig[nt][1], bsml[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(acc2[mt][nt], asml[mt], bbig[nt][0], bbig[nt][1]);
          mma(acc2[mt][nt], abig[mt], bsml[nt][0], bsml[nt][1]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma(part, abig[mt], bbig[nt][0], bbig[nt][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
        }
    }
#endif
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt][q] += acc2[mt][nt][q];

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

// ------------------------------------------------------------------------
// The L2 form: 256 < H <= 512
// ------------------------------------------------------------------------

// A warp takes 8 units and all 32 sequences of the tile (4 n-tiles), so a
// CTA of 4 warps loads and splits each W fragment once and its split serves
// four n-tiles. Three CTAs share an SM at every width (162 registers).
constexpr int L2_WARPS = 4;
constexpr int L2_THREADS = L2_WARPS * 32;
constexpr int L2_BLOCKS = 3;
constexpr int NT = BT / 8;                 // n-tiles a warp
constexpr int C_FLOATS = UNITS * BT;       // c of the CTA's units, in smem

#ifdef T2P_LSTM_W_SMEM
constexpr int W_ABL = 4 * 2 * 4 * 32 * 4;  // floats: four k-steps' fragments
#else
constexpr int W_ABL = 0;
#endif

__global__ void __launch_bounds__(L2_THREADS, L2_BLOCKS)
    lstm_l2_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int len_s[BT];
  // full completes when the other CTAs' blocks of h have arrived.
  __shared__ __align__(8) unsigned long long full;
  cg::cluster_group cluster = cg::this_cluster();

  const int H = a.H, T = a.T, B = a.B;
  const int CS = H / UNITS, K = H / 8;
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.z;
  const int b0 = blockIdx.y * BT;
  const int lane = threadIdx.x & 31, ug = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int unit = rank * UNITS + ug * 8 + gid;

  // [W_ABL] ablation copy, then h [H/8][BT][8], then c [UNITS][BT].
  float* hbuf = reinterpret_cast<float*>(smem4) + W_ABL;
  float* cst = hbuf + H * BT + (ug * 8 + gid) * BT + 2 * tid;
  const float4* wa = reinterpret_cast<const float4*>(a.wpack[dir]) +
                     (size_t)rank * H * UNITS + ug * 32 + lane;
  for (int i = threadIdx.x; i < H * BT; i += L2_THREADS) hbuf[i] = 0.0f;
#ifdef T2P_LSTM_W_SMEM
  for (int i = threadIdx.x; i < W_ABL; i += L2_THREADS)
    reinterpret_cast<float*>(smem4)[i] =
        a.wpack[dir][(size_t)rank * H * UNITS * 4 + i];
#endif
  if (threadIdx.x < BT) {
    const int b = b0 + threadIdx.x;
    len_s[threadIdx.x] = b < B ? min(max(a.lengths[b], 0), T) : 0;
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  unsigned phase = 0;

  int maxlen = 0;
#pragma unroll
  for (int q = 0; q < BT; ++q) maxlen = max(maxlen, len_s[q]);

  const float* table = (dir ? a.table[1] : a.table[0]) + unit;
  const int H4 = 4 * H, V = a.V;
  const bool rev = dir == 1;
  // This thread's sequences: nt*8 + 2*tid + e. The gate inputs of the next
  // step are loaded after the product, while the cell update runs.
  float xin[NT][2][4];   // [nt][e][gate]
  auto gather = [&](int t) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = nt * 8 + 2 * tid + e;
        if (t < len_s[q]) {
          const int tk = __ldg(a.tokens + (size_t)min(b0 + q, B - 1) * T + t);
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
  for (int i = threadIdx.x; i < C_FLOATS; i += L2_THREADS)
    hbuf[H * BT + i] = 0.0f;
  __syncthreads();
  float h[NT][2];
  if (maxlen > 0) gather(rev ? maxlen - 1 : 0);

  // W's fragments of the next k-step: W does not depend on h, so the
  // stream runs on from a step's last k-step into the next step's first.
  auto wload = [&](int k, int mt) {
#ifdef T2P_LSTM_W_SMEM
    return reinterpret_cast<const float4*>(smem4)[((k & 3) * 2 + mt) * 4 * 32 +
                                                  ug * 32 + lane];
#else
    return __ldg(wa + (k * 2 + mt) * 4 * 32);
#endif
  };
  float4 wn[2] = {wload(0, 0), wload(0, 1)};

  const float* hs = hbuf + gid * 8 + 2 * tid;
  for (int s = 0; s < maxlen; ++s) {
    const int t = rev ? maxlen - 1 - s : s;
    // acc[mt][nt]: rows gid / gid+8 = gates (i, f) for mt 0, (g, o) for
    // mt 1; columns 2*tid, 2*tid+1 = sequences e = 0, 1.
    float acc[2][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[0][nt][e] = xin[nt][e][0];
        acc[0][nt][2 + e] = xin[nt][e][1];
        acc[1][nt][e] = xin[nt][e][2];
        acc[1][nt][2 + e] = xin[nt][e][3];
      }
    float acc2[2][NT][4] = {};
#ifndef T2P_LSTM_NO_PRODUCT
    for (int k = 0; k < K; ++k) {
      unsigned abig[2][4], asml[2][4], bbig[NT][2], bsml[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 w = wn[mt];
#ifdef T2P_LSTM_NO_WSPLIT
        abig[mt][0] = asml[mt][0] = __float_as_uint(w.x);
        abig[mt][1] = asml[mt][1] = __float_as_uint(w.y);
        abig[mt][2] = asml[mt][2] = __float_as_uint(w.z);
        abig[mt][3] = asml[mt][3] = __float_as_uint(w.w);
#else
        split(w.x, abig[mt][0], asml[mt][0]);
        split(w.y, abig[mt][1], asml[mt][1]);
        split(w.z, abig[mt][2], asml[mt][2]);
        split(w.w, abig[mt][3], asml[mt][3]);
#endif
      }
      const int nk = k + 1 < K ? k + 1 : 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) wn[mt] = wload(nk, mt);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 hv = *reinterpret_cast<const float2*>(hs + (k * BT + nt * 8) * 8);
        split(hv.x, bbig[nt][0], bsml[nt][0]);
        split(hv.y, bbig[nt][1], bsml[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(acc2[mt][nt], asml[mt], bbig[nt][0], bbig[nt][1]);
          mma(acc2[mt][nt], abig[mt], bsml[nt][0], bsml[nt][1]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma(part, abig[mt], bbig[nt][0], bbig[nt][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
        }
    }
#endif
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt][q] += acc2[mt][nt][q];

    // One h buffer: every CTA of the cluster has read this step's h once
    // all have arrived; the wait comes after the cell update and the next
    // gate inputs' loads. c lives in shared memory and the last h of a
    // unit in its place in the h buffer (registers for the product).
    const bool more = s + 1 < maxlen;
    if (more) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (more) gather(rev ? t - 1 : t + 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = nt * 8 + 2 * tid + e;
        const float ig = sigmoid_f(acc[0][nt][e]);
        const float fg = sigmoid_f(acc[0][nt][2 + e]);
        const float gg = tanhf(acc[1][nt][e]);
        const float og = sigmoid_f(acc[1][nt][2 + e]);
        const float c0 = cst[nt * 8 + e];
        const float cn = fg * c0 + ig * gg;
        const float hv = og * tanhf(cn);
        const bool v = t < len_s[q];
        cst[nt * 8 + e] = v ? cn : c0;
        h[nt][e] = v ? hv : hbuf[hpos(unit) + q * 8];
      }
    if (!more)   // the last step: the final h
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = b0 + nt * 8 + 2 * tid + e;
          if (b < B) a.out[((size_t)dir * B + b) * H + unit] = h[nt][e];
        }
    if (more) {
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hbuf[hpos(unit) + (nt * 8 + 2 * tid + e) * 8] = h[nt][e];
      // This CTA's units are k-steps 4·rank … 4·rank+3 of h: one contiguous
      // block of 4·BT·8 floats, sent by bulk copy to every other CTA of the
      // cluster (a thread a peer), completing on the receiver's mbarrier.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
#ifndef T2P_LSTM_NO_EXCHANGE
      const unsigned bar = smem_addr(&full);
      const unsigned bytes = 4 * BT * 8 * 4;
      if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes * (CS - 1)) : "memory");
      if (threadIdx.x < CS - 1) {
        const int r = threadIdx.x < rank ? threadIdx.x : threadIdx.x + 1;
        const unsigned src = smem_addr(hbuf + rank * 4 * BT * 8);
        unsigned dst, rbar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(src), "r"(r));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(r));
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            :: "r"(dst), "r"(src), "r"(bytes), "r"(rbar) : "memory");
      }
      mbar_wait(bar, phase);
      phase ^= 1u;
#else
      __syncthreads();
#endif
    }
  }
  // No CTA leaves while a copy from or into its shared memory may run.
  cluster.sync();

  if (maxlen == 0)   // no step: h = 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = b0 + nt * 8 + 2 * tid + e;
        if (b < B) a.out[((size_t)dir * B + b) * H + unit] = 0.0f;
      }
}

// ------------------------------------------------------------------------
// The grid form: any H a multiple of 32 (used past 512)
// ------------------------------------------------------------------------

struct GridArgs {
  const float* table[2];   // per direction [V, 4H]
  const float* wpack[2];   // per direction [H/32][H/8][2][4][32][4]
  const int* tokens;       // [B, T]
  const int* lengths;      // [B]
  float* out;              // [2, B, H]
  float* hbuf;             // [groups][2][H/8][BT][8]
  float* cbuf;             // [groups][H][BT]
  unsigned* count;         // [groups], zero at launch
  int V, T, B, H, ctas;    // ctas: CTAs a group
};

// Every CTA of the group arrives; returns when all `target` arrivals of the
// group's counter have happened. Writes before it are visible after it.
__device__ __forceinline__ void group_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
    for (unsigned n = 0;; ++n) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (n > (1u << 26)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2) lstm_grid_kernel(const GridArgs a) {
  __shared__ int len_s[BT];
  const int H = a.H, T = a.T, B = a.B, CS = a.ctas;
  const int S = H / UNITS;                       // slices of 32 units
  const int group = blockIdx.x / CS, rank = blockIdx.x % CS;
  const int groups = gridDim.x / CS;
  const int tiles = (B + BT - 1) / BT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tid = lane & 3;
  const int ug = warp & 3, sh = warp >> 2;
  const int HB = H * BT;                         // floats a buffer
  // The group's buffers are addressed from the arguments and the sequence
  // lengths read from len_s where they are used, and W's offset in the
  // product is an int: so the product's two k-steps in flight fit the 128
  // registers that two CTAs an SM allow (held pointers or a 64-bit offset
  // spilled).
  const size_t hbuf = (size_t)group * 2 * HB, cbuf = (size_t)group * HB;
  unsigned epoch = 0;

  for (int task = group; task < 2 * tiles; task += groups) {
    const int dir = task & 1, b0 = (task >> 1) * BT;
    const bool rev = dir == 1;
    __syncthreads();                             // len_s of the last task read
    if (threadIdx.x < BT) {
      const int b = b0 + threadIdx.x;
      len_s[threadIdx.x] = b < B ? min(max(a.lengths[b], 0), T) : 0;
    }
    __syncthreads();
    int maxlen = 0;
#pragma unroll
    for (int q = 0; q < BT; ++q) maxlen = max(maxlen, len_s[q]);
    int cur = 0;
    for (int s = 0; s < maxlen; ++s) {
      const int t = rev ? maxlen - 1 - s : s;
      for (int sl = rank; sl < S; sl += CS) {
        const int unit = sl * UNITS + ug * 8 + gid;
        const float* table = (dir ? a.table[1] : a.table[0]) + unit;
        // acc[mt][nt]: rows gid / gid+8 = gates (i, f) for mt 0, (g, o)
        // for mt 1; columns 2*tid, 2*tid+1 = sequences e = 0, 1.
        float acc[2][2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = sh * 16 + nt * 8 + 2 * tid + e;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (t < len_s[q]) {
              const int tk = __ldg(a.tokens + (size_t)min(b0 + q, B - 1) * T + t);
              if ((unsigned)tk < (unsigned)a.V) {
                const float* row = table + (size_t)tk * 4 * H;
#pragma unroll
                for (int g = 0; g < 4; ++g) x[g] = __ldg(row + g * H);
              } else {
#pragma unroll
                for (int g = 0; g < 4; ++g) x[g] = __int_as_float(0x7fc00000);
              }
            }
            acc[0][nt][e] = x[0];
            acc[0][nt][2 + e] = x[1];
            acc[1][nt][e] = x[2];
            acc[1][nt][2 + e] = x[3];
          }
        float acc2[2][2][4] = {};
        if (s > 0) {                             // h = 0 before step 0
          const float4* wa =
              reinterpret_cast<const float4*>(dir ? a.wpack[1] : a.wpack[0]) +
              (size_t)sl * H * UNITS + ug * 32 + lane;
          const float* hs = a.hbuf + hbuf + cur * HB + (sh * 16 + gid) * 8 +
                            2 * tid;
#pragma unroll 2
          for (int kk = 0; kk < H / 8; ++kk) {
            unsigned abig[2][4], asml[2][4], bbig[2][2], bsml[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const float4 w = __ldg(wa + (kk * 2 + mt) * 4 * 32);
              split(w.x, abig[mt][0], asml[mt][0]);
              split(w.y, abig[mt][1], asml[mt][1]);
              split(w.z, abig[mt][2], asml[mt][2]);
              split(w.w, abig[mt][3], asml[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float2 hv = __ldcg(
                  reinterpret_cast<const float2*>(hs + (kk * BT + nt * 8) * 8));
              split(hv.x, bbig[nt][0], bsml[nt][0]);
              split(hv.y, bbig[nt][1], bsml[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                mma(acc2[mt][nt], asml[mt], bbig[nt][0], bbig[nt][1]);
                mma(acc2[mt][nt], abig[mt], bsml[nt][0], bsml[nt][1]);
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma(part, abig[mt], bbig[nt][0], bbig[nt][1]);
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
              }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[mt][nt][q] += acc2[mt][nt][q];

        const float* hc = a.hbuf + hbuf + cur * HB;
        float* hn = a.hbuf + hbuf + (cur ^ 1) * HB;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = sh * 16 + nt * 8 + 2 * tid + e;
            float* cp = a.cbuf + cbuf + (size_t)unit * BT + q;
            const int hp = hpos(unit) + q * 8;
            const float c0 = s > 0 ? *cp : 0.0f;
            const float h0 = s > 0 ? __ldcg(hc + hp) : 0.0f;
            const float ig = sigmoid_f(acc[0][nt][e]);
            const float fg = sigmoid_f(acc[0][nt][2 + e]);
            const float gg = tanhf(acc[1][nt][e]);
            const float og = sigmoid_f(acc[1][nt][2 + e]);
            const float cn = fg * c0 + ig * gg;
            const float hv = og * tanhf(cn);
            const bool v = t < len_s[q];
            const float c1 = v ? cn : c0, h1 = v ? hv : h0;
            *cp = c1;
            hn[hp] = h1;
            const int b = b0 + q;
            if (s + 1 == maxlen && b < B)
              a.out[((size_t)dir * B + b) * H + unit] = h1;
          }
      }
      // The group's h of this step is complete; after a task's last step
      // the barrier keeps the next task's writes from the buffers others
      // still read.
      group_sync(a.count + group, ++epoch * (unsigned)CS);
      cur ^= 1;
    }
    if (maxlen == 0) {
      // No step: every sequence of the tile has length 0 and h = 0.
      for (int sl = rank; sl < S; sl += CS)
        for (int i = threadIdx.x; i < UNITS * BT; i += THREADS) {
          const int b = b0 + i / UNITS;
          if (b < B)
            a.out[((size_t)dir * B + b) * H + sl * UNITS + i % UNITS] = 0.0f;
        }
    }
  }
}

}  // namespace

namespace {

// The cluster forms' plan at width H (a multiple of 32, at most 512):
// threads and shared memory a CTA (ops/lstm.py cluster_plan mirrors it).
struct ClusterPlan {
  int threads, smem;
};

ClusterPlan cluster_plan(int H) {
  if (H <= SMEM_MAX_H)   // W_hh's slice and two h buffers
    return {THREADS, H * UNITS * 16 + 2 * H * BT * 4};
  return {L2_THREADS, (W_ABL + H * BT + C_FLOATS) * 4};  // one h buffer, c
}

template <typename F>
cudaError_t set_attributes(F kernel, int H, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && H / UNITS > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t config(int H, int B, const ClusterPlan& p,
                          cudaStream_t stream, cudaLaunchAttribute (&attr)[1]) {
  const unsigned cs = (unsigned)(H / UNITS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (unsigned)((B + BT - 1) / BT), 2);
  cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Calls f(kernel) with the cluster form of width H, its attributes set.
template <typename F>
cudaError_t with_kernel(int H, const ClusterPlan& p, F f) {
  const auto kernel = H <= SMEM_MAX_H ? lstm_kernel : lstm_l2_kernel;
  const cudaError_t e = set_attributes(kernel, H, p.smem);
  return e == cudaSuccess ? f(kernel) : e;
}

bool cluster_width(int H) {
  return H >= UNITS && H <= MAX_H && H % UNITS == 0;
}

}  // namespace

// The cluster forms' plan at width H: out = {threads, shared-memory bytes}
// a CTA. Returns a cudaError_t.
extern "C" int t2p_lstm_cluster_plan(int H, int* out) {
  if (!cluster_width(H)) return (int)cudaErrorInvalidValue;
  const ClusterPlan p = cluster_plan(H);
  out[0] = p.threads;
  out[1] = p.smem;
  return 0;
}

// How many clusters of the kernel at width H the card holds at once.
extern "C" int t2p_lstm_max_active_clusters(int H, int B, int* out) {
  if (!cluster_width(H)) return (int)cudaErrorInvalidValue;
  const ClusterPlan p = cluster_plan(H);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(H, B, p, nullptr, attr);
  return (int)with_kernel(H, p, [&](auto kernel) {
    return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  });
}

namespace {

// The grid form's plan at width H (a multiple of 32) and B sequences:
// CTAs a group (at most `ctas` where it is positive, for tests of several
// slices a CTA), groups running at once, and the bytes of its workspace:
// per group two h buffers and c of H·BT floats each, then the counters.
struct GridPlan {
  int ctas, groups;
  long long bytes, hbuf, cbuf, count;
};

cudaError_t grid_plan(int H, int B, int ctas, GridPlan* p) {
  if (H < UNITS || H % UNITS != 0 || B < 1 || ctas < 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      lstm_grid_kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return e;
  const int resident = sms * per_sm;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  int cs = H / UNITS;
  if (ctas > 0 && ctas < cs) cs = ctas;
  if (cs > resident) cs = resident;
  const int tasks = 2 * ((B + BT - 1) / BT);
  int groups = resident / cs;
  if (groups > tasks) groups = tasks;
  p->ctas = cs;
  p->groups = groups;
  const long long hb = (long long)H * BT * 4;    // bytes of one h buffer
  p->hbuf = 0;
  p->cbuf = (long long)groups * 2 * hb;
  p->count = p->cbuf + (long long)groups * hb;
  p->bytes = p->count + (long long)groups * 4;
  return cudaSuccess;
}

}  // namespace

// Bytes of zeroed global workspace the grid form takes at width H (a
// multiple of 32) for B sequences; ctas as for t2p_lstm_final_hidden_grid.
// Returns a cudaError_t.
extern "C" int t2p_lstm_grid_workspace(int H, int B, int ctas,
                                       long long* bytes) {
  GridPlan p;
  const cudaError_t e = grid_plan(H, B, ctas, &p);
  if (e != cudaSuccess) return (int)e;
  *bytes = p.bytes;
  return 0;
}

// The grid form: both directions in one cooperative launch at any H a
// multiple of 32 (the wrapper takes it past 512). wpack_f and wpack_b hold
// W_hh in fragment order (ops/lstm.py w_hh_fragments); workspace as
// t2p_lstm_grid_workspace sizes it, zeroed; ctas 0 lets each CTA own one
// slice of 32 units where the card holds them all at once, a positive value
// caps the CTAs a group. Returns a cudaError_t; 0 means the launch was
// accepted.
extern "C" int t2p_lstm_final_hidden_grid(const void* table_f,
                                          const void* table_b,
                                          const void* wpack_f,
                                          const void* wpack_b,
                                          const void* tokens,
                                          const void* lengths, void* out,
                                          void* workspace, int V, int T,
                                          int B, int H, int ctas,
                                          void* stream) {
  if (T < 1 || V < 1 || wpack_f == nullptr || wpack_b == nullptr ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  GridPlan p;
  cudaError_t e = grid_plan(H, B, ctas, &p);
  if (e != cudaSuccess) return (int)e;
  unsigned char* ws = (unsigned char*)workspace;
  GridArgs args;
  args.table[0] = (const float*)table_f;
  args.table[1] = (const float*)table_b;
  args.wpack[0] = (const float*)wpack_f;
  args.wpack[1] = (const float*)wpack_b;
  args.tokens = (const int*)tokens;
  args.lengths = (const int*)lengths;
  args.out = (float*)out;
  args.hbuf = (float*)(ws + p.hbuf);
  args.cbuf = (float*)(ws + p.cbuf);
  args.count = (unsigned*)(ws + p.count);
  args.V = V;
  args.T = T;
  args.B = B;
  args.H = H;
  args.ctas = p.ctas;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)lstm_grid_kernel,
                                  dim3((unsigned)(p.groups * p.ctas)),
                                  dim3(THREADS), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
  if (!cluster_width(H) || T < 1 || B < 1 || V < 1 ||
      (B + BT - 1) / BT > 65535 ||
      (H > SMEM_MAX_H && (wpack_f == nullptr || wpack_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ClusterPlan p = cluster_plan(H);

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
  cudaLaunchConfig_t cfg = config(H, B, p, (cudaStream_t)stream, attr);
  const cudaError_t e = with_kernel(H, p, [&](auto kernel) {
    return cudaLaunchKernelEx(&cfg, kernel, args);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
