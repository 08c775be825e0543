// SuperGlue attention GNN in eval mode with calibrated per-set BatchNorm:
// all 2·num_layers weight-shared self/cross blocks, the final projection and
// the [N, T0, T1] score matrix, one launch.
//
// Replaces the TPU kernel text2pos_tpu/ops/superglue_gnn_pallas.py:253
// (gnn_scores_pallas, body _gnn_kernel :103, parameters from
// fold_gnn_params :45). The TPU kernel stacks pairs along matrix rows and
// masks a cross-pair [R, R] score matrix, and pads hints 6 -> 16, to satisfy
// Mosaic's tiling; none of that is carried over. Here a CTA holds G=2
// pose-cell pairs (2 × (16 objects + 6 hints) = 44 token rows) in shared
// memory for all blocks, and attention runs per pair over real tokens only.
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
// f32. With BF16 the weights are stored in bf16 and every rounded value is
// kept in f32 shared memory (rnd() below), so one code path serves both.
//
// Bound. About 89 MFLOP per pair (1.8 TFLOP at N=20480), against 14.3 KB of
// descriptors in and 384 B of scores out per pair: operations bound it.
// This first version runs the matmuls on the CUDA cores in f32 FMA, with
// weights streamed from L2 (7.9 MB f32 / 3.9 MB bf16 for 12 blocks) and each
// weight element reused across the CTA's 44 rows; tensor cores come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int E = 128;       // descriptor width
constexpr int HEADS = 4;
constexpr int D = E / HEADS;  // 32
constexpr int T0 = 16;       // objects per cell
constexpr int T1 = 6;        // hints per query
constexpr int P = T0 + T1;   // token rows per pair
constexpr int G = 2;         // pairs per CTA
constexpr int R = G * P;     // token rows per CTA (44)
constexpr int NT = 512;      // threads per CTA
constexpr int COL_THREADS = 128;
constexpr int ROW_GROUPS = NT / COL_THREADS;  // 4
constexpr int ROWS = R / ROW_GROUPS;          // 11 rows per thread
static_assert(R % ROW_GROUPS == 0, "rows must split evenly");

// Shared-memory row strides (floats). A pad of 4 keeps rows 16-byte aligned
// and puts consecutive rows 4 banks apart, so per-row float4 reads in the
// attention step are free of bank conflicts.
constexpr int LDRES = E;          // residual stream, f32
constexpr int LDA = 2 * E + 4;    // [rounded residual | merge output]
constexpr int LDB = 3 * E + 4;    // q|k|v, then h1, then the final projection
constexpr int LDC = E + 4;        // attention messages
constexpr int SMEM_FLOATS = R * (LDRES + LDA + LDB + LDC);

struct Weights {
  const void* wqkv;   // [L, E, 3E]  compute dtype
  const float* bqkv;  // [L, 3E]
  const void* wm;     // [L, E, E]
  const float* bm;    // [L, E]
  const void* w0;     // [L, 2E, 2E]
  const float* s0;    // [L, 2, 2E]
  const float* t0;    // [L, 2, 2E]
  const void* w1;     // [L, 2E, E]
  const float* b1;    // [L, E]
  const void* wf;     // [E, E]
  const float* bf;    // [E]
};

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool BF16>
__device__ __forceinline__ float ldw(const void* w, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(w)[i]);
  } else {
    return __ldg(reinterpret_cast<const float*>(w) + i);
  }
}

// acc = X[R, K] (shared, row stride ldx) · W[K, N] (global, row-major),
// N = COLS·128; thread (row group rg, column thread tc) owns rows
// rg·ROWS … and columns tc + 128·cc; epi(row, col, acc) stores.
template <bool BF16, int COLS, typename Epi>
__device__ __forceinline__ void matmul(const float* X, int ldx, int K,
                                       const void* W, Epi epi) {
  constexpr int N = COLS * COL_THREADS;
  const int tc = threadIdx.x % COL_THREADS;
  const int r0 = (threadIdx.x / COL_THREADS) * ROWS;
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) acc[r][cc] = 0.0f;

  for (int k = 0; k < K; k += 4) {
    float w[4][COLS];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc)
        w[kk][cc] = ldw<BF16>(W, (size_t)(k + kk) * N + tc + COL_THREADS * cc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(X + (r0 + r) * ldx + k);
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        float a = acc[r][cc];
        a = fmaf(x.x, w[0][cc], a);
        a = fmaf(x.y, w[1][cc], a);
        a = fmaf(x.z, w[2][cc], a);
        a = fmaf(x.w, w[3][cc], a);
        acc[r][cc] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc)
      epi(r0 + r, tc + COL_THREADS * cc, acc[r][cc]);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 1)
superglue_gnn_kernel(const float* __restrict__ desc0,  // [N, T0, E]
                     const float* __restrict__ desc1,  // [N, T1, E]
                     Weights wt, int num_blocks,
                     float* __restrict__ scores,       // [N, T0, T1]
                     int n_pairs) {
  extern __shared__ float4 smem4[];
  float* res = reinterpret_cast<float*>(smem4);
  float* A = res + R * LDRES;
  float* Bq = A + R * LDA;
  float* C = Bq + R * LDB;
  const int tid = threadIdx.x;
  const int pair0 = blockIdx.x * G;

  // Load both descriptor sets of the CTA's pairs (zeros past the end).
  for (int i = tid; i < R * E; i += NT) {
    const int r = i / E, c = i % E;
    const int p = r / P, loc = r % P, n = pair0 + p;
    float x = 0.0f;
    if (n < n_pairs)
      x = loc < T0 ? desc0[((size_t)n * T0 + loc) * E + c]
                   : desc1[((size_t)n * T1 + (loc - T0)) * E + c];
    res[r * LDRES + c] = x;
    A[r * LDA + c] = rnd<BF16>(x);
  }
  __syncthreads();

  for (int l = 0; l < num_blocks; ++l) {
    const bool cross = (l & 1) == 1;
    const size_t wl = (size_t)l;

    // q|k|v of every row.
    {
      const float* bqkv = wt.bqkv + wl * 3 * E;
      const void* w = BF16 ? (const void*)((const __nv_bfloat16*)wt.wqkv + wl * E * 3 * E)
                           : (const void*)((const float*)wt.wqkv + wl * E * 3 * E);
      matmul<BF16, 3>(A, LDA, E, w, [&](int r, int c, float acc) {
        Bq[r * LDB + c] = rnd<BF16>(acc + __ldg(bqkv + c));
      });
    }
    __syncthreads();

    // Per (head, query row): softmax over the source set, then the message.
    for (int it = tid; it < HEADS * R; it += NT) {
      const int h = it / R, r = it % R;
      const int p = r / P, set = (r % P) >= T0 ? 1 : 0;
      const int kset = cross ? 1 - set : set;
      const int kbase = p * P + (kset ? T0 : 0);
      const int nk = kset ? T1 : T0;
      const float* q = Bq + r * LDB + h * D;
      float s[T0];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < T0; ++j) {
        if (j < nk) {
          const float* kr = Bq + (kbase + j) * LDB + E + h * D;
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
          const float pj = rnd<BF16>(s[j] / sum);
          const float* vr = Bq + (kbase + j) * LDB + 2 * E + h * D;
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
      float* out = C + r * LDC + h * D;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        *reinterpret_cast<float4*>(out + d) =
            make_float4(rnd<BF16>(msg[d]), rnd<BF16>(msg[d + 1]),
                        rnd<BF16>(msg[d + 2]), rnd<BF16>(msg[d + 3]));
      }
    }
    __syncthreads();

    // m = msg·Wm + bm, into the right half of A.
    {
      const float* bm = wt.bm + wl * E;
      const void* w = BF16 ? (const void*)((const __nv_bfloat16*)wt.wm + wl * E * E)
                           : (const void*)((const float*)wt.wm + wl * E * E);
      matmul<BF16, 1>(C, LDC, E, w, [&](int r, int c, float acc) {
        A[r * LDA + E + c] = rnd<BF16>(acc + __ldg(bm + c));
      });
    }
    __syncthreads();

    // h1 = relu(([a | m]·W0) * s0[set] + t0[set]).
    {
      const float* s0 = wt.s0 + wl * 2 * 2 * E;
      const float* t0 = wt.t0 + wl * 2 * 2 * E;
      const void* w = BF16 ? (const void*)((const __nv_bfloat16*)wt.w0 + wl * 4 * E * E)
                           : (const void*)((const float*)wt.w0 + wl * 4 * E * E);
      matmul<BF16, 2>(A, LDA, 2 * E, w, [&](int r, int c, float acc) {
        const int g = (r % P) >= T0 ? 1 : 0;
        const float y = fmaf(acc, __ldg(s0 + g * 2 * E + c), __ldg(t0 + g * 2 * E + c));
        Bq[r * LDB + c] = rnd<BF16>(fmaxf(y, 0.0f));
      });
    }
    __syncthreads();

    // res += h1·W1 + b1; A's left half gets the rounded residual.
    {
      const float* b1 = wt.b1 + wl * E;
      const void* w = BF16 ? (const void*)((const __nv_bfloat16*)wt.w1 + wl * 2 * E * E)
                           : (const void*)((const float*)wt.w1 + wl * 2 * E * E);
      matmul<BF16, 1>(Bq, LDB, 2 * E, w, [&](int r, int c, float acc) {
        const float x = res[r * LDRES + c] + rnd<BF16>(acc + __ldg(b1 + c));
        res[r * LDRES + c] = x;
        A[r * LDA + c] = rnd<BF16>(x);
      });
    }
    __syncthreads();
  }

  // Final projection of both sets.
  matmul<BF16, 1>(A, LDA, E, wt.wf, [&](int r, int c, float acc) {
    Bq[r * LDB + c] = rnd<BF16>(acc + __ldg(wt.bf + c));
  });
  __syncthreads();

  // scores[n, i, j] = md0_i · md1_j / sqrt(E).
  for (int it = tid; it < G * T0 * T1; it += NT) {
    const int p = it / (T0 * T1), i = (it / T1) % T0, j = it % T1;
    const int n = pair0 + p;
    if (n >= n_pairs) continue;
    const float* a = Bq + (p * P + i) * LDB;
    const float* b = Bq + (p * P + T0 + j) * LDB;
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
}

template <bool BF16>
int launch(const float* desc0, const float* desc1, const Weights& wt,
           int num_blocks, float* scores, int n_pairs, cudaStream_t stream) {
  const size_t smem = (size_t)SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      superglue_gnn_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n_pairs + G - 1) / G;
  superglue_gnn_kernel<BF16><<<grid, NT, smem, stream>>>(
      desc0, desc1, wt, num_blocks, scores, n_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// desc0 [N, 16, 128] f32, desc1 [N, 6, 128] f32, scores [N, 16, 6] f32.
// Matmul weights are bf16 when bf16 != 0, else f32; vectors are f32.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_superglue_gnn(const void* desc0, const void* desc1,
                                 const void* wqkv, const void* bqkv,
                                 const void* wm, const void* bm,
                                 const void* w0, const void* s0,
                                 const void* t0, const void* w1,
                                 const void* b1, const void* wf,
                                 const void* bf, int num_blocks, int n_pairs,
                                 int bf16, void* scores, void* stream) {
  if (n_pairs < 1 || num_blocks < 0) return (int)cudaErrorInvalidValue;
  Weights wt{wqkv, (const float*)bqkv, wm, (const float*)bm,
             w0, (const float*)s0, (const float*)t0,
             w1, (const float*)b1, wf, (const float*)bf};
  if (bf16)
    return launch<true>((const float*)desc0, (const float*)desc1, wt,
                        num_blocks, (float*)scores, n_pairs,
                        (cudaStream_t)stream);
  return launch<false>((const float*)desc0, (const float*)desc1, wt,
                       num_blocks, (float*)scores, n_pairs,
                       (cudaStream_t)stream);
}

// Static shape of the kernel, for the Python wrapper's checks.
extern "C" int t2p_superglue_gnn_shape(int* e, int* t0, int* t1) {
  *e = E;
  *t0 = T0;
  *t1 = T1;
  return 0;
}
